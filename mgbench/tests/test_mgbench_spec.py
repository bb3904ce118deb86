"""Configuration, traffic, kernel and metric files load by the names that
BENCHMARK.json gives, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from mgbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        for x in BENCH[group]:
            assert NAME.match(x["name"]), x["name"]
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in x:
                    assert 1 <= len(x[key]) <= 200 and "\n" not in x[key]


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    w, conf, mix = spec.cell_files(BENCH, cell)
    assert w["chips"] == 1
    assert conf["name"] == w["config"]
    assert spec.traffic(w["traffic"]) == mix
    for key in ("driver", "entry", "plan", "freq", "amp", "checks",
                "control_dtype", "cycle_fn", "samples", "trace_solves",
                "warmup"):
        assert key in mix
    assert callable(spec.driver(mix["driver"]).setup)
    for c in mix["checks"]:
        assert callable(spec.check_reader(c["number"]))
    per_layer = spec.cell_metrics(BENCH, cell, "per_layer")
    assert per_layer and all(m["moves"] == "solve_ms" for m in per_layer)
    assert {m["name"] for m in spec.cell_metrics(
        BENCH, cell, "end_to_end")} >= {"setup_s", "solve_ms"}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    d = spec.load_json(spec.ROOT / conf["file"])
    assert conf["file"].startswith("mgbench/configs/")
    assert d["name"] == conf["name"] and d["reduced"] == conf["reduced"]
    assert d["source"] and "assumed" in d
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_kernel_files_load_and_split_the_names():
    files = spec.kernels()
    names = {k.name for k in files}
    assert names >= {"A", "B", "C", "D", "E", "F", "G", "A_bf16", "E_bf16"}
    kmap = spec.KernelMap(files)
    cases = {
        "void smooth_kernel<64, 64, 2, false, float, float, float>"
        "(float const*, float const*, float*, int, int, Stencil5)": "A",
        "void smooth_kernel<32, 64, 2, false, __nv_bfloat16, float, "
        "__nv_bfloat16>(...)": "A_bf16",
        "_Z13smooth_kernelILi64ELi64ELi2ELb0EfffEvPKT3_PKT4_PT5_ii": "A",
        "void residual_restrict_kernel<float, float>(...)": "B",
        "void prolong_correct_kernel<float, float>(...)": "C",
        "void tail_vcycle_kernel<float>(float*, float const*, TailParams)":
            "D",
        "void rbgs3d_wave_kernel<2, float, float, float>(...)": "E",
        "void rbgs3d_block_kernel<32, float, float, float>(...)": "E",
        "void residual_restrict3d_kernel<float, float>(...)": "F",
        "void residual_restrict3d_kernel<__nv_bfloat16, "
        "__nv_bfloat16>(...)": "F_bf16",
        "void prolong_correct3d_kernel<float, float>(...)": "G",
        "void smooth_var_kernel<float>(...)": None,
        "void tail_var_vcycle_kernel<float>(...)": None,
        "void residual_restrict_var_kernel<0, float, float>(...)": None,
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<double>>(...)": None,
        "Memcpy DtoH (Device -> Pageable)": None,
    }
    for name, want in cases.items():
        got = kmap(name)
        assert (got.name if got else None) == want, name
    assert {k.stage for k in files} == set(spec.STAGES)


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="no-such"):
        spec.check_reader("no-such")
    with pytest.raises(FileNotFoundError, match="no-such"):
        spec.driver("no-such")


def test_a_configuration_may_name_a_coefficient():
    """The levels driver feeds a named problem's coefficient to the
    hierarchy builder: a 2D jump-coefficient configuration arrives as a
    file."""
    import torch

    from mgbench.harness import runner

    port = runner.port_module()
    conf = spec.config("poisson2d-2049")
    conf.update(n=33, tail_entry=9, coefficient={
        "factory": "models.problems.jump_coefficient_problem",
        "args": [33, 1000.0]})
    mix = spec.traffic("ir-3e-8-fmg")
    cell = runner.system_under_test(port, conf, mix, torch.device("cpu"))
    plain = runner.system_under_test(port, spec.config("poisson2d-2049") | {
        "n": 33, "tail_entry": 9}, mix, torch.device("cpu"))
    assert not cell.levels[0].stencil.scalar
    assert plain.levels[0].stencil.scalar
    u, info = cell.solve(runner.rhs(conf, (1, 2), 1.0, "cpu"))
    assert info["converged"] and u.shape == (33, 33)


def test_resolve_finds_the_entries():
    from mgbench.harness import runner

    port = runner.port_module()
    for cell in CELLS:
        _, conf, mix = spec.cell_files(BENCH, cell)
        for dotted in (mix["entry"], mix["cycle_fn"], conf["grid"],
                       conf["boundary"], conf["hierarchy"]):
            assert callable(spec.resolve(port, dotted))
