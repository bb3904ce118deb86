"""The solve path's spans and its readback counter (``utils/timing.py``,
``solvers/multigrid.outer_iterate``), on the CPU under ``torch.profiler``.

Each solve entry emits one ``mg.solve``; each outer step one ``mg.outer``
under it; each read of a norm one ``mg.readback`` (the start's and one per
step); each top-level cycle one ``mg.cycle`` under its step; an FMG start
one ``mg.fmg``. With tracing off no ``record_function`` is entered, and the
answers are the same bit for bit either way.
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import (
    multigrid as mg_mod,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.utils import timing

CFG = T.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-10)


def _setup2d(level_dtype):
    prob = T.poisson_mms_sinsin(17)
    levels = T.build_hierarchy(prob.grid, prob.spec, dtype=level_dtype,
                               device="cpu", cfg=CFG)
    return levels, prob.rhs(torch.float64), prob.initial_guess(torch.float64)


def _setup3d(level_dtype):
    prob = T.poisson3d_mms_sinsinsin(9)
    levels = T.build_hierarchy3d(prob.grid, prob.spec, dtype=level_dtype,
                                 device="cpu", cfg=CFG)
    return levels, prob.rhs(torch.float64), prob.initial_guess(torch.float64)


# name: (set-up, solve, cycles per outer step, FMG starts)
CASES = {
    "ir_solve_fmg": (
        lambda: _setup2d(torch.float32),
        lambda lv, f, u0: T.ir_solve(lv, f, u0, CFG, inner_cycles=2,
                                     use_fmg=True),
        2, 1),
    "ir_solve3d": (
        lambda: _setup3d(torch.float32),
        lambda lv, f, u0: T.ir_solve3d(lv, f, u0, CFG),
        2, 0),
    "mg_solve": (
        lambda: _setup2d(torch.float64),
        lambda lv, f, u0: T.mg_solve(lv, f, u0, CFG),
        1, 0),
    "mg_solve3d": (
        lambda: _setup3d(torch.float64),
        lambda lv, f, u0: T.mg_solve3d(lv, f, u0, CFG),
        1, 0),
}


@pytest.fixture(params=sorted(CASES))
def case(request):
    setup, solve, cycles, fmgs = CASES[request.param]
    levels, f, u0 = setup()
    return (lambda: solve(levels, f, u0)), cycles, fmgs


@pytest.fixture
def tracing_on():
    previous = timing.set_tracing(True)
    yield
    timing.set_tracing(previous)


def _spans(prof):
    """(name, parent) of each ``mg.*`` span of the profile, the parent the
    innermost ``mg.*`` span around it or None (read from the profiler's
    own events: ``prof.events()`` takes seconds over a plain CPU solve's
    operators)."""
    spans = sorted(((ev.name(), ev.start_ns(), ev.end_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith("mg.")),
                   key=lambda sp: (sp[1], -sp[2]))
    out, stack = [], []
    for name, start, end in spans:
        while stack and stack[-1][2] <= start:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out


def test_spans_count_and_nest(case, tracing_on):
    run, cycles, fmgs = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = run()
    it = info["iterations"]
    assert it >= 2 and info["converged"]
    spans = _spans(prof)
    counts = collections.Counter(name for name, _ in spans)
    assert counts == collections.Counter({
        "mg.solve": 1, "mg.outer": it, "mg.readback": it + 1,
        "mg.cycle": cycles * it, **({"mg.fmg": fmgs} if fmgs else {})})
    parent = {"mg.solve": None, "mg.outer": "mg.solve",
              "mg.readback": "mg.solve", "mg.fmg": "mg.solve",
              "mg.cycle": "mg.outer"}
    for name, above in spans:
        assert above == parent[name], name


def test_tracing_off_enters_no_record_function(case, monkeypatch):
    run, cycles, fmgs = case
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert timing.set_tracing(False) is False  # off by default
    _, info = run()
    assert calls == []
    timing.set_tracing(True)
    try:
        _, info = run()
    finally:
        timing.set_tracing(False)
    it = info["iterations"]
    assert len(calls) == 1 + it + (it + 1) + cycles * it + fmgs
    assert all(name.startswith("mg.") for name in calls)


@pytest.mark.parametrize("on", [False, True])
def test_readbacks_count_each_read(case, on):
    run, _, _ = case
    previous = timing.set_tracing(on)
    try:
        before = mg_mod.outer_iterate.readbacks
        _, info = run()
        after = mg_mod.outer_iterate.readbacks
    finally:
        timing.set_tracing(previous)
    assert after - before == info["iterations"] + 1


def test_answers_equal_with_tracing_on_and_off(case, tracing_on):
    run, _, _ = case
    with profile(activities=[ProfilerActivity.CPU]):
        u_on, info_on = run()
    timing.set_tracing(False)
    u_off, info_off = run()
    assert torch.equal(u_on, u_off)
    assert info_on["iterations"] == info_off["iterations"]
    assert list(info_on["history"]) == list(info_off["history"])


@pytest.mark.parametrize("previous", [False, True])
def test_trace_profile_turns_spans_on_for_its_block(tmp_path, previous):
    setup, solve, _, _ = CASES["ir_solve3d"]
    levels, f, u0 = setup()
    old = timing.set_tracing(previous)
    try:
        path = tmp_path / "trace.json"
        with timing.trace_profile(path) as prof:
            assert timing._tracing is True
            _, info = solve(levels, f, u0)
        assert timing._tracing is previous
    finally:
        timing.set_tracing(old)
    counts = collections.Counter(name for name, _ in _spans(prof))
    assert counts["mg.solve"] == 1
    assert counts["mg.outer"] == info["iterations"]
    names = {e.get("name") for e in
             json.loads(path.read_text())["traceEvents"]}
    assert {"mg.solve", "mg.outer", "mg.readback", "mg.cycle"} <= names


def test_span_is_shared_null_context_when_off():
    previous = timing.set_tracing(False)
    try:
        assert timing.span("mg.x") is timing.span("mg.y")
    finally:
        timing.set_tracing(previous)
