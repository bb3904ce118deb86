"""The trace reduction and the per-layer readers on a small synthetic
profile."""

import pytest

from mgbench.harness import runner, spec, trace, work

CONF = {"n": 9, "dims": 3, "level_dtype": "float32", "tail_entry": None}
MIX = {"plan": {"fmg": False, "cycles_per_iteration": 2}}
A = "void rbgs3d_wave_kernel<2, float, float, float>(...)"
F = "void residual_restrict3d_kernel<float, float>(...)"
G = "void prolong_correct3d_kernel<float, float>(...)"
FILL = "void at::native::vectorized_elementwise_kernel<4, Fill>(...)"


def profile():
    """Two solves: span [0, 100] and [200, 300] us; the right-hand side's
    fill at 150-160, between them."""
    solves = [(0.0, 100.0), (200.0, 300.0)]
    device = []
    for base in (0.0, 200.0):
        device += [(A, base + 10, base + 30), (F, base + 30, base + 40),
                   (G, base + 50, base + 55), (FILL, base + 60, base + 70)]
    device.append((FILL, 150.0, 160.0))
    host = [("mgbench.solve", 0.0, 100.0), ("mgbench.solve", 200.0, 300.0),
            ("mgbench.rhs", 140.0, 165.0), ("aten::zeros", 40.0, 45.0),
            ("cudaLaunchKernel", 42.0, 44.0), ("aten::item", 70.0, 99.0),
            ("aten::item", 270.0, 299.0)]
    return device, host, solves


def test_merge_and_gaps():
    assert trace.merge([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    dev = [("x", 1.0, 2.0), ("y", 1.5, 4.0), ("z", 6.0, 7.0)]
    assert trace.busy_us(dev) == 4.0
    assert trace.gaps(dev, 0.0, 8.0) == [(0.0, 1.0), (4.0, 6.0),
                                         (7.0, 8.0)]


def test_host_at_takes_the_innermost_event():
    host = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("deep", 3.0, 3.5),
            ("later", 6.0, 8.0)]
    assert trace.host_at(host, [1.0, 3.2, 3.8, 5.0, 7.0, 11.0]) == [
        "outer", "deep", "inner", "outer", "later", None]


def test_reduce_splits_solves_stages_and_gaps():
    device, host, solves = profile()
    red = trace.reduce(device, host, solves, 300e-6,
                       spec.KernelMap(spec.kernels()))
    assert red.solves == 2
    assert red.ops_in_solves == 8           # the rhs fill is left out
    assert red.seconds_by_stage == pytest.approx({"smooth": 40e-6,
                                                  "transfer": 30e-6})
    assert red.plain_seconds == pytest.approx(20e-6)
    assert red.busy_s == pytest.approx(100e-6)
    assert red.unmatched == {FILL: 3}
    labels = dict(red.idle_gaps)
    # each gap goes to what the host ran when the card fell idle:
    # 40-50 aten::zeros; 70-150 and 270-300 aten::item; 160-210 the
    # right-hand side's span; 0-10, 55-60, 240-250, 255-260 a solve's
    # Python between operators
    assert labels == pytest.approx({
        "aten::item": 110e-6, "python in mgbench.rhs": 50e-6,
        "python in mgbench.solve": 30e-6, "aten::zeros": 10e-6})
    assert red.idle_gaps[0][0] == "aten::item"
    assert red.device_ops[0] == ("E", pytest.approx(40e-6))


def test_readers_on_the_synthetic_profile():
    device, host, solves = profile()
    red = trace.reduce(device, host, solves, 300e-6,
                       spec.KernelMap(spec.kernels()))
    peaks = {"hbm_bytes_per_s": 3.35e12}
    ctx = runner.Ctx(CONF, MIX, red, [5, 5], launches=60, peaks=peaks)
    read = {m: spec.metric_reader(m)(ctx) for m in (
        "solver_iterations", "plain_ops_device_ms", "device_ops_per_solve",
        "kernel_launches_per_solve", "smooth_roofline", "transfer_roofline",
        "tail_device_ms", "device_idle_share")}
    nbytes = work.solve_bytes(CONF, MIX, 5)
    assert read["solver_iterations"] == 5
    assert read["plain_ops_device_ms"] == pytest.approx(0.01)
    assert read["device_ops_per_solve"] == 4
    assert read["kernel_launches_per_solve"] == 30
    assert read["smooth_roofline"] == pytest.approx(
        nbytes["smooth"] / 3.35e12 / 20e-6 * 100)
    assert read["transfer_roofline"] == pytest.approx(
        nbytes["transfer"] / 3.35e12 / 15e-6 * 100)
    assert read["tail_device_ms"] is None     # nothing to read: left out
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 1 / 3))
    # no peak for the card: no share
    ctx.peaks = None
    assert spec.metric_reader("smooth_roofline")(ctx) is None
