"""The port's tooling (``utils/timing.py``, ``utils/config.py``,
``utils/logging_utils.py``, ``analysis/convergence.py``,
``benchmarking/suite.py``, ``benchmarking/profiler.py``) against the JAX
package's, on the CPU (``device="cpu"``).

Tolerances, each with its reason:

- config files, presets, convergence reports and logging output: equal
  (the same code over the same inputs; logging with its timestamps, rates
  and durations stripped and the package names unified).
- ``BenchmarkSuite`` records: the same iterations, ``converged`` and
  ``rho_kind``, ``error_l2`` within 2% (the fp32 records solve in fp32 on
  two libraries; every record's error is the discretization error).
- ``MultigridProfiler``'s counts: equal to the JAX package's formula at
  the logical node count.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as J  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    analysis as janalysis,
    utils as jutils,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.benchmarking import (  # noqa: E402
    BenchmarkSuite as JSuite,
    MultigridProfiler as JProfiler,
    profiler as jprofiler,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (  # noqa: E402
    problems as JP,
)

import mixed_precision_multigrid_solvers_for_pdes_torch as T  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_torch import (  # noqa: E402
    analysis,
    utils,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking import (  # noqa: E402
    BenchmarkSuite,
    MultigridProfiler,
    profiler,
    suite as suite_mod,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.utils import (  # noqa: E402
    timing,
)

REPO = Path(__file__).resolve().parents[2]
PRESETS = ("create_default_config", "create_performance_config",
           "create_accuracy_config")


# ---- utils/config.py --------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_jax_config_files_load(preset, suffix, tmp_path):
    if suffix == ".yaml":
        pytest.importorskip("yaml")
    jcfg = getattr(jutils, preset)()
    path = tmp_path / f"cfg{suffix}"
    jcfg.save(path)
    cfg = utils.FrameworkConfig.load(path)
    assert cfg.to_dict() == jcfg.to_dict()
    assert getattr(utils, preset)().to_dict() == jcfg.to_dict()
    mgc, jmgc = cfg.solver.build(), jcfg.solver.build()
    assert isinstance(mgc, T.MultigridConfig)
    shared = ({f.name for f in dataclasses.fields(mgc)}
              & {f.name for f in dataclasses.fields(jmgc)})
    assert len(shared) >= 12
    for name in shared:
        assert getattr(mgc, name) == getattr(jmgc, name), name
    assert cfg.grid.build() == T.Grid(jcfg.grid.nx, jcfg.grid.ny,
                                      jcfg.grid.domain)
    pol, jpol = cfg.precision.build(), jcfg.precision.build()
    assert (pol.mode.value, pol.fine.value, pol.coarse.value,
            pol.convergence_threshold) == (
        jpol.mode.value, jpol.fine.value, jpol.coarse.value,
        jpol.convergence_threshold)


BAD = [("solver", "omega", 2.5), ("grid", "nx", 2),
       ("grid", "domain", (1.0, 0.0, 0.0, 1.0)), ("solver", "cycle", "X"),
       ("solver", "smoother", "ilu"), ("solver", "max_iterations", 0),
       ("precision", "mode", "fp16"), ("time_stepping", "scheme", "rk4"),
       ("time_stepping", "t_final", 0.0), ("logging", "level", "LOUD")]


@pytest.mark.parametrize("block,key,value", BAD)
def test_bad_configs_refused_as_in_jax(block, key, value):
    for mod in (utils, jutils):
        cfg = mod.FrameworkConfig()
        setattr(getattr(cfg, block), key, value)
        with pytest.raises(ValueError):
            cfg.validate()
    for mod in (utils, jutils):
        with pytest.raises(ValueError, match="unknown solver config keys"):
            mod.FrameworkConfig.from_dict({"solver": {"no_such_key": 1}})


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_jax_backend_names_refused(backend, tmp_path):
    jcfg = jutils.FrameworkConfig()
    jcfg.solver.backend = backend
    path = tmp_path / "cfg.json"
    jcfg.save(path)
    assert jutils.FrameworkConfig.load(path).solver.backend == backend
    with pytest.raises(ValueError, match="torch"):
        utils.FrameworkConfig.load(path)
    for ok in ("auto", "torch"):
        cfg = utils.FrameworkConfig()
        cfg.solver.backend = ok
        cfg.validate()


# ---- analysis/convergence.py ------------------------------------------------

def _histories():
    rng = np.random.default_rng(7)
    k = np.arange(20)
    return {
        "fast": 0.1 ** k * (1 + 0.05 * rng.standard_normal(20)),
        "stagnating": np.r_[1.0, 0.5, 0.25, 0.25 * 0.999 ** k[:12]],
        "diverging": np.r_[1.0, 0.1, 0.05, 0.07, 1.0, 3.0],
        "noisy": np.abs(rng.standard_normal(15)) + 1e-3,
        "holes": np.array([1.0, np.nan, 0.1, 0.0, 0.01, np.inf, 1e-3]),
        "short": np.array([1.0]),
    }


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and np.isnan(x):
            assert isinstance(y, float) and np.isnan(y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("window", [3, 5])
def test_convergence_analyzer_equals_jax(window):
    a = analysis.ConvergenceAnalyzer(window=window)
    j = janalysis.ConvergenceAnalyzer(window=window)
    hists = _histories()
    for name, h in hists.items():
        _same(a.analyze(h).to_dict(), j.analyze(h).to_dict())
        np.testing.assert_array_equal(a.rates(h), j.rates(h))
    gi = a.grid_independence({n: hists[k] for n, k in
                              ((33, "fast"), (65, "noisy"))})
    gj = j.grid_independence({n: hists[k] for n, k in
                              ((33, "fast"), (65, "noisy"))})
    _same(gi, gj)
    with pytest.raises(ValueError):
        a.analyze([np.nan, 0.0])


def test_convergence_monitor_equals_jax():
    seen = set()
    for h in _histories().values():
        mons = []
        for mod in (analysis, janalysis):
            mon = mod.ConvergenceMonitor(check_every=2)
            kinds = []
            mon.add_callback(lambda kind, ev, kinds=kinds: kinds.append(kind))
            for r in h:
                mon.record(r)
            mons.append((mon, kinds))
        (m, km), (mj, kj) = mons
        assert km == kj
        seen.update(km)
        assert json.dumps(m.events, default=str) == json.dumps(
            mj.events, default=str)
        assert m.recommendations() == mj.recommendations()
        _same(m.report().to_dict(), mj.report().to_dict())
    assert seen == {"stagnation", "divergence"}


# ---- utils/logging_utils.py -------------------------------------------------

_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ")
_RATE = re.compile(r"\([0-9.]+/s, ETA [0-9.]+s\)|\([0-9.]+s\)")


def _run_logging(mod, log_file):
    pkg = mod.__name__.rsplit(".", 2)[0]
    log = mod.setup_logging("DEBUG", log_file=str(log_file), colored=False,
                            name=pkg)
    child = mod.get_logger("solver")
    child.info("levels %d, omega %.2f", 9, 1.0)
    child.warning("slow convergence")
    with mod.LoggingContext(log, "ERROR"):
        child.info("hidden")
        child.error("shown")
    prog = mod.ProgressLogger(3, logger=child, every=2, label="cycles")
    for _ in range(3):
        prog.update()

    def work(x):
        return 2 * x

    assert mod.log_function_call(child)(work)(3) == 6
    for h in log.handlers:
        h.flush()
    log.handlers.clear()
    text = Path(log_file).read_text().replace(pkg, "PKG")
    return [_RATE.sub("(..)", _STAMP.sub("", line))
            for line in text.splitlines()]


def test_logging_output_equals_jax(tmp_path, capsys):
    from mixed_precision_multigrid_solvers_for_pdes_torch.utils import (
        logging_utils as tl,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.utils import (
        logging_utils as jl,
    )

    got = _run_logging(tl, tmp_path / "t.log")
    want = _run_logging(jl, tmp_path / "j.log")
    assert got == want
    assert len(got) == 7 and "hidden" not in "\n".join(got)
    assert tl.get_logger().name == T.__name__


# ---- utils/timing.py --------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to see which tensors the
    timing helpers wait on without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def synced(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    return calls


def test_sync_finds_every_tensor():
    u, v = torch.zeros(3), torch.ones(2)
    info = {"iterations": 3, "history": np.ones(4), "residual_norm": 1e-9}
    res = T.PoissonResult(u=u, info=info)
    for value, want in (((u, info), [u]), ([u, v], [u, v]),
                        ({"u": u}, [u]), (res, [u]),
                        ({"a": (u, [v])}, [u, v]), (info, []), (None, [])):
        got = list(timing._tensors(value))
        assert len(got) == len(want) and all(
            g is w for g, w in zip(got, want)), value


def test_benchmark_function_waits_on_tuple_results(synced):
    u = torch.zeros(4).as_subclass(_FakeCuda)
    stats = timing.benchmark_function(lambda: (u, {"iterations": 1}),
                                      warmup=2, runs=3)
    assert stats["runs"] == 3 and stats["min_s"] >= 0
    assert synced == [torch.device("cuda", 0)] * 5
    synced.clear()
    timing.benchmark_function(lambda: [torch.zeros(2), u], warmup=0, runs=2)
    timing.benchmark_function(lambda: T.PoissonResult(u=u, info={}),
                              warmup=0, runs=1)
    timing.benchmark_function(lambda: torch.zeros(2), warmup=0, runs=1)
    assert len(synced) == 3
    with utils.Timer("t", sync=(u, None)) as t:
        pass
    prof = utils.PerformanceProfiler()
    prof.start("x")
    prof.end("x", sync={"u": u})
    assert len(synced) == 5 and t.elapsed >= 0


def test_timer_profiler_and_trace(tmp_path):
    with utils.Timer("x", sync=torch.ones(8)) as t:
        sum(range(1000))
    assert t.elapsed > 0
    prof = utils.PerformanceProfiler()
    for _ in range(2):
        with prof.region("op"):
            sum(range(1000))
    prof.start("other")
    prof.end("other", sync=torch.ones(2))
    s = prof.summary()
    assert s["op"]["count"] == 2 and s["op"]["total_s"] > 0
    jprof = jutils.PerformanceProfiler()
    with jprof.region("op"):
        pass
    assert set(s["op"]) == set(jprof.summary()["op"])
    path = tmp_path / "trace.json"
    with utils.trace_profile(path) as p:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(p.key_averages()) > 0


# ---- benchmarking/suite.py --------------------------------------------------

@pytest.fixture(scope="module")
def suites():
    st = BenchmarkSuite(T.poisson_mms_sinsin, device="cpu")
    st.run(sizes=(17, 33), precisions=("fp32", "fp64"), runs=1)
    sj = JSuite(JP.poisson_mms_sinsin)
    sj.run(sizes=(17, 33), precisions=("fp32", "fp64"), runs=1)
    return st, sj


def test_suite_records_match_jax(suites):
    st, sj = suites
    assert len(st.records) == len(sj.records) == 4
    for a, b in zip(st.records, sj.records):
        assert (a.name, a.n, a.precision, a.backend) == (
            b.name, b.n, b.precision, b.backend)
        assert (a.iterations, a.converged, a.rho_kind) == (
            b.iterations, b.converged, b.rho_kind)
        assert a.error_l2 == pytest.approx(b.error_l2, rel=0.02)
        assert a.wall_s > 0 and a.dof_per_s > 0
    assert [r.rho_kind for r in st.records] == ["ir_outer", "cycle"] * 2


def test_suite_report_matches_jax(suites, tmp_path):
    st, sj = suites
    rep, jrep = st.report(), sj.report()
    assert set(rep) == set(jrep)
    assert set(rep["config"]) >= set(jrep["config"]) - {"w_depth"}
    assert set(rep["precision_speedups"]) == set(jrep["precision_speedups"])
    assert set(rep["scaling_exponents"]) == {"fp32", "fp64"}
    assert rep["system"]["backend"] == "cpu" and rep["system"]["torch"]
    md = st.report_markdown()
    assert "measured" in md and md.count("| poisson_sinsin |") == 4
    st.save(tmp_path / "b.json")
    st.save(tmp_path / "b.md")
    assert json.loads((tmp_path / "b.json").read_text())["records"]


def test_suite_backend_speedups_key_the_plain_path():
    st = BenchmarkSuite(T.poisson_mms_sinsin, device="cpu")
    st.run(sizes=(17,), precisions=("fp64",), runs=1,
           backends=("auto", "torch"))
    assert [r.backend for r in st.records] == ["auto", "torch"]
    assert set(st.backend_speedups()) == {"17/fp64"}
    assert st.records[0].iterations == st.records[1].iterations


def test_system_info_keys():
    info = suite_mod.system_info()
    assert {"platform", "python", "torch", "cuda", "backend", "device",
            "n_devices", "power_limit", "timestamp"} == set(info)


# ---- benchmarking/profiler.py -----------------------------------------------

def test_profiler_counts_match_jax_formula():
    levels = T.build_hierarchy(T.Grid(65, 33), dtype="float32",
                               device="cpu")
    for lev in levels:
        fake = types.SimpleNamespace(
            grid=types.SimpleNamespace(shape_padded=lev.grid.shape),
            dtype=jnp.float32)
        for stage in ("smooth", "residual", "restrict", "prolong", "none"):
            for sweeps in (1, 2):
                assert profiler._stage_flops_bytes(lev, stage, sweeps) == \
                    jprofiler._stage_flops_bytes(fake, stage, sweeps)


def test_profiler_records_match_jax(tmp_path):
    cfg = T.MultigridConfig(smoother="rbgs", omega=1.0)
    p = T.poisson_mms_sinsin(33)
    prof = MultigridProfiler(
        T.build_hierarchy(p.grid, p.spec, dtype="float32", device="cpu",
                          cfg=cfg), cfg)
    recs = prof.profile_all(runs=2)
    pj = JP.poisson_mms_sinsin(33)
    jprof = JProfiler(J.build_hierarchy(pj.grid, pj.spec, dtype="float32",
                                        cfg=J.MultigridConfig(
                                            smoother="rbgs", omega=1.0)))
    jprof.profile_level(0, runs=2)
    jprof.profile_level(4, runs=2)
    assert set(recs) == {f"level_{k}" for k in range(5)}
    for key in ("level_0", "level_4"):
        assert set(recs[key]) == set(jprof.records[key])
        assert recs[key]["dtype"] == jprof.records[key]["dtype"]
        for stage in ("smooth", "residual"):
            assert set(recs[key][stage]) == set(jprof.records[key][stage])
    b = prof.bottlenecks()
    assert set(b) == set(jprof.bottlenecks())
    assert b["cycle_estimate_s"] > 0 and b["dominant"].split("/")[1] in (
        "smooth", "residual", "restrict", "prolong")
    prof.export(tmp_path / "prof.json")
    assert json.loads((tmp_path / "prof.json").read_text())["bottlenecks"]


# ---- no JAX ------------------------------------------------------------------

def test_support_modules_import_no_jax():
    """The support layers and visualization import neither JAX nor the JAX
    package, and the package's top level imports no matplotlib."""
    mods = ["validation", "validation.theory", "validation.mms",
            "validation.baselines", "benchmarking", "benchmarking.suite",
            "benchmarking.profiler", "analysis", "analysis.convergence",
            "utils", "utils.timing", "utils.config", "utils.logging_utils"]
    viz = ["visualization", "visualization._backend",
           "visualization.solution_plots", "visualization.convergence_plots",
           "visualization.performance_plots",
           "visualization.grid_visualization",
           "visualization.analysis_plots", "visualization.interactive_plots",
           "visualization.dashboard"]
    pkg = "mixed_precision_multigrid_solvers_for_pdes_torch"
    code = (f"import sys, importlib; import {pkg}; "
            "assert 'matplotlib' not in sys.modules; "
            + "; ".join(f"importlib.import_module('{pkg}.{m}')"
                        for m in mods + viz)
            + "; bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', "
            "'mixed_precision_multigrid_solvers_for_pdes_tpu'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
