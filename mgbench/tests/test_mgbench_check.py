"""The comparison that decides ``correct``, at sizes a test run holds:
the reference is exact on its modes, the program passes, the control (the
reference one precision below the configuration's) fails, and a run with
its timed path broken underneath comes out not correct."""

import contextlib
import time

import pytest
import torch

from mgbench import readings
from mgbench.harness import check, runner, spec, traffic
from mgbench.reference import poisson

# each cell's configuration and mix, cut to a size the CPU holds
SMALL = {"poisson3d-513-ir": {"n": 17},
         "poisson2d-2049-ir": {"n": 129, "tail_entry": 17}}


def small(cell):
    _, conf, mix = spec.cell_files(spec.benchmark(), cell)
    conf.update(SMALL[cell])
    mix.update(samples=1, trace_solves=3)
    return conf, mix


@pytest.mark.parametrize("dims,n,k", [(2, 17, (1, 3)), (2, 33, (7, 7)),
                                      (3, 9, (1, 2, 3)), (3, 17, (7, 1, 5))])
def test_reference_solution_is_exact(dims, n, k):
    f = traffic.rhs(n, dims, k, 1.25, "cpu")
    u = poisson.discrete_solution(f, k)
    assert poisson.relative_residual(u, f) < 1e-13
    # the control: the same solution one precision below
    u32 = poisson.discrete_solution(f, k, torch.float32)
    assert u32.dtype == torch.float32 and poisson.relative_residual(
        u32, f) > 1e-9


def test_reference_operator_by_hand():
    u = torch.zeros(5, 5, dtype=torch.float64)
    u[2, 2] = 1.0
    au = poisson.apply(u)            # h = 1/4: 1/h^2 = 16
    assert au[1, 1] == 64.0 and au[0, 1] == -16.0 and au[1, 0] == -16.0
    assert au[0, 0] == 0.0


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_and_program_passes(cell):
    conf, mix = small(cell)
    out = readings.collect(conf, mix, torch.device("cpu"), [5, 6, 7])
    for c in mix["checks"]:
        name, limit = c["number"], c["limit"]
        program = [v[name] for v in out["program"].values()]
        control = [v[name] for v in out["control"].values()]
        assert max(program) <= limit, (cell, program)
        assert min(control) > limit, (cell, control)


@contextlib.contextmanager
def broken_answer(port, mix):
    """The answer altered where it is produced: the entry's solution with
    its largest node lost."""
    mod_name, fn = mix["entry"].rsplit(".", 1)
    mod = spec.resolve(port, mod_name)
    saved = getattr(mod, fn)

    def entry(*a, **kw):
        u, info = saved(*a, **kw)
        return readings.altered(u), info

    setattr(mod, fn, entry)
    try:
        yield
    finally:
        setattr(mod, fn, saved)


@pytest.mark.parametrize("fault", ["unchanged", "altered", None])
@pytest.mark.parametrize("cell", list(SMALL))
def test_a_broken_run_is_not_correct(cell, fault):
    conf, mix = small(cell)
    port = runner.port_module()
    if fault == "unchanged":
        ctx = readings.unchanged_cycle(port, mix)
    elif fault == "altered":
        ctx = broken_answer(port, mix)
    else:
        ctx = contextlib.nullcontext()
    end_to_end = spec.cell_metrics(spec.benchmark(), cell, "end_to_end")
    with ctx:
        res, lines = runner.run_cell(
            conf, mix, seed=2**31 + 11, seconds=0.3, trace=False,
            device=torch.device("cpu"), per_layer=[], end_to_end=end_to_end,
            t_start=time.perf_counter())
    assert res["correct"] is (fault is None), (fault, res["checks"])
    assert set(res["metrics"]) == {m["name"] for m in end_to_end}
    assert all(m["value"] > 0 for name, m in res["metrics"].items()
               if name != "peak_mem_gib")  # no card: no allocator peak
    assert list(res)[-1] == "checks"
    assert lines and all(ln.startswith("check ") and " limit " in ln
                         for ln in lines)


def test_judge_takes_the_worst_answer():
    conf = {"n": 9, "dims": 2}
    f = traffic.rhs(9, 2, (1, 1), 1.0, "cpu")
    good = poisson.discrete_solution(f, (1, 1))
    bad = good.clone()
    bad[4, 4] *= 1.01
    checks = [{"number": "relative_residual", "limit": 1e-9}]
    got = check.judge(checks, [(good, f, (1, 1)), (bad, f, (1, 1))], conf)
    v, lim = got["relative_residual"]
    read = spec.check_reader("relative_residual")
    assert v == read(bad, f, (1, 1), conf) == poisson.relative_residual(
        bad, f) and lim == 1e-9
    assert not check.passed(got)
    assert check.passed(check.judge(checks, [(good, f, (1, 1))], conf))


@pytest.mark.parametrize("samples", [1, 3])
def test_a_run_judges_one_answer_per_sample_point_and_the_last(
        samples, monkeypatch):
    conf, mix = small("poisson3d-513-ir")
    conf["n"] = 9
    mix["samples"] = samples
    seen = []
    real = check.judge

    def judge(checks, answers, conf):
        answers = list(answers)
        seen.append(len(answers))
        return real(checks, answers, conf)

    monkeypatch.setattr(check, "judge", judge)
    res, _ = runner.run_cell(
        conf, mix, seed=2**31 + 5, seconds=1.0, trace=False,
        device=torch.device("cpu"), per_layer=[], end_to_end=[],
        t_start=time.perf_counter())
    assert res["correct"] and res["attempted"] >= samples + 2
    assert seen == [samples + 1]


def test_sample_points_lie_one_in_each_stratum():
    mix = {"samples": 4}
    for seed in (0, 7, 2**31 + 3, -5):
        pts = traffic.sample_points(mix, seed)
        assert len(pts) == 4
        assert all(j / 4 <= p < (j + 1) / 4 for j, p in enumerate(pts))
        assert traffic.sample_points(mix, seed) == pts
    assert traffic.sample_points(mix, 1) != traffic.sample_points(mix, 2)


def test_readings_judge_the_draws_of_a_traced_run():
    _, conf, mix = spec.cell_files(spec.benchmark(), "poisson3d-513-ir")
    draws = readings.judged_draws(mix, conf["dims"], 2**31 + 9)
    assert len(draws) == mix["samples"] + 1
