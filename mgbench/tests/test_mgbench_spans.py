"""The span reduction (``harness/spans.py``) and the readback reader on a
small synthetic profile."""

import types

import pytest

from mgbench.harness import runner, spans, spec, trace

CONF = {"n": 9, "dims": 3, "level_dtype": "float32"}
MIX = {"warmup": 2}
E = "void rbgs3d_wave_kernel<2, float, float, float>(...)"
PLAIN = "void at::native::vectorized_elementwise_kernel<4, Fill>(...)"
COPY = "Memcpy DtoH (Device -> Pinned)"


def profile():
    """Two solves, [0, 100] and [200, 300] us. The first is card-paced:
    the host launches a cycle's operations and waits in a readback while
    they run, so the plain operation launched at 20 in ``mg.cycle`` runs at
    40-45, after its span has closed. The second is host-paced, with an
    FMG start. The right-hand side's fill (150-160) and a readback outside
    any ``mg.solve`` (150-151) lie between them."""
    solves = [(0.0, 100.0), (200.0, 300.0)]
    port = [("mg.solve", 1.0, 95.0), ("mg.readback", 2.0, 8.0),
            ("mg.outer", 8.0, 30.0), ("mg.cycle", 10.0, 25.0),
            ("mg.readback", 30.0, 90.0),
            ("mg.readback", 150.0, 151.0),
            ("mg.solve", 201.0, 290.0), ("mg.readback", 202.0, 203.5),
            ("mg.fmg", 204.0, 220.0), ("mg.outer", 220.0, 260.0),
            ("mg.cycle", 222.0, 250.0), ("mg.readback", 260.0, 285.0)]
    # (name, device start, device end, correlation, host launch)
    ops = [(PLAIN, 3, 4, 1, 3.0), (PLAIN, 12, 14, 2, 9.0),
           (E, 14, 40, 3, 12.0), (PLAIN, 40, 45, 4, 20.0),
           (PLAIN, 45, 70, 5, 27.0), (COPY, 70, 71, 6, 31.0),
           (PLAIN, 150, 160, 7, 150.0),
           (PLAIN, 203, 204, 8, 203.0), (PLAIN, 206, 208, 9, 205.0),
           (E, 211, 215, 10, 210.0), (E, 230, 235, 11, 223.0),
           (PLAIN, 241, 244, 12, 240.0), (PLAIN, 256, 258, 13, 255.0),
           (COPY, 262, 263, 14, 261.0)]
    device = [(n, float(s), float(e), c) for n, s, e, c, _ in ops]
    launches = {c: t for _, _, _, c, t in ops}
    return device, launches, port, solves


def reduced():
    device, launches, port, solves = profile()
    return spans.reduce(device, launches, port, solves,
                        spec.KernelMap(spec.kernels()))


def test_ops_go_to_their_launching_span():
    red = reduced()
    assert red.solves == 2 and red.unlaunched == 0
    # outside cycles: 1 + 2 + 25 + 1 (first solve), 1 + 2 + 1 (second)
    assert red.outer_step_s == pytest.approx(33e-6)
    # plain ops launched in a cycle: 5 (run after the cycle closed), then
    # FMG's 2 and the cycle's 3; E is a kernel file's, not plain
    assert red.cycle_plain_s == pytest.approx(10e-6)


def test_idle_gaps_go_to_the_span_open_at_their_start():
    red = reduced()
    assert red.idle_by_span == pytest.approx({
        None: 6e-6,                      # 0-3, 200-203: before mg.solve
        "mg.readback": 37e-6 + 37e-6,    # 4-12, 71-100; 263-300
        "mg.fmg": 20e-6,                 # 204-206, 208-211, 215-230
        "mg.cycle": 18e-6,               # 235-241, 244-256
        "mg.outer": 4e-6})               # 258-262
    assert red.idle_in_solves_s == pytest.approx(122e-6)


def test_host_issue_leaves_out_the_readbacks_of_solves():
    # mg.solve 94 + 89 us, less the readbacks inside them (6 + 60 + 1.5 +
    # 25); the one at 150-151 lies in no mg.solve
    assert reduced().host_issue_s == pytest.approx(90.5e-6)


def test_host_self_time_by_span():
    got = reduced().host_self_s
    assert got == pytest.approx({
        # 94 - 6 - 22 - 60 and 89 - 1.5 - 16 - 40 - 25
        "mg.solve": 6e-6 + 6.5e-6,
        "mg.readback": 6e-6 + 60e-6 + 1e-6 + 1.5e-6 + 25e-6,
        "mg.outer": 7e-6 + 12e-6, "mg.cycle": 15e-6 + 28e-6,
        "mg.fmg": 16e-6})


def test_an_operation_without_a_launch_is_counted_apart():
    device, launches, port, solves = profile()
    device.append((PLAIN, 96.0, 97.0, 99))
    red = spans.reduce(device, launches, port, solves,
                       spec.KernelMap(spec.kernels()))
    assert red.unlaunched == 1
    assert red.outer_step_s == pytest.approx(33e-6)


def test_readings_by_hand():
    peaks = {"hbm_bytes_per_s": 3.35e12}
    got = spans.readings(reduced(), CONF, 5.0, peaks)
    # 729 nodes x (20 + 32 x 5) B over 16.5 us a solve
    bound_s = 729 * (20 + 32 * 5) / 3.35e12
    assert got == pytest.approx({
        "outer_step_device_ms": 0.0165,
        "outer_step_roofline": bound_s / 16.5e-6 * 100,
        "cycle_plain_device_ms": 0.005,
        "host_issue_ms": 0.04525,
        "cycle_idle_ms": 0.019,
        "outer_idle_ms": 0.039})
    assert spans.outer_step_bytes(CONF, 5.0) == 729 * 180
    assert spans.outer_step_bytes(dict(CONF, level_dtype="bfloat16"),
                                  5.0) == 729 * (18 + 28 * 5)
    assert spans.readings(reduced(), CONF, 5.0, None)[
        "outer_step_roofline"] is None


def test_no_port_spans_no_readings():
    """A port without spans (the parent of this change, or tracing off)
    gives nothing to read."""
    device, launches, _, solves = profile()
    red = spans.reduce(device, launches, [], solves,
                       spec.KernelMap(spec.kernels()))
    got = spans.readings(red, CONF, 5.0, {"hbm_bytes_per_s": 3.35e12})
    assert set(got.values()) == {None}


def test_identities_with_the_trace_reduction():
    """Outer-step and cycle plain time make up ``plain_ops_device_ms``;
    cycle and outer idle time are the idle time inside solves, less the
    gaps before ``mg.solve`` opens."""
    device, launches, port, solves = profile()
    red = trace.reduce([op[:3] for op in device], [], solves, 300e-6,
                       spec.KernelMap(spec.kernels()))
    got = spans.readings(reduced(), CONF, 5.0, None)
    assert (got["outer_step_device_ms"] + got["cycle_plain_device_ms"]
            == pytest.approx(red.plain_seconds / red.solves * 1e3))
    idle = reduced().idle_in_solves_s / 2 * 1e3
    assert got["cycle_idle_ms"] + got["outer_idle_ms"] <= idle
    assert (got["cycle_idle_ms"] + got["outer_idle_ms"]
            == pytest.approx(idle - 3e-3))


class _Ev:
    def __init__(self, name, start, end, device_type, id=0, thread=1,
                 is_user_annotation=False):
        self.name, self.id, self.thread = name, id, thread
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = device_type
        self.is_user_annotation = is_user_annotation


def test_from_profiler_leaves_out_span_shadows():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    host = [_Ev("mgbench.solve", 0, 100, cpu), _Ev("mg.solve", 1, 95, cpu),
            _Ev("mg.cycle", 10, 25, cpu), _Ev("mg.cycle", 500, 510, cpu,
                                              thread=2),
            _Ev("aten::add", 11, 13, cpu, id=3),
            _Ev("cudaLaunchKernel", 12, 13, cpu, id=7)]
    ops = [_Ev(E, 14, 40, cuda, id=7)]
    shadows = [_Ev("mg.cycle", 14, 40, cuda, is_user_annotation=True),
               _Ev("mg.solve", 14, 40, cuda),
               _Ev("mgbench.solve", 14, 40, cuda)]
    bare = spans.from_profiler(types.SimpleNamespace(
        events=lambda: host + ops))
    shadowed = spans.from_profiler(types.SimpleNamespace(
        events=lambda: host + shadows + ops))
    assert bare == shadowed
    device, launches, port, solves = bare
    assert device == [(E, 14.0, 40.0, 7)]
    assert launches == {7: 12.0}            # the runtime call, not aten
    assert port == [("mg.solve", 1.0, 95.0), ("mg.cycle", 10.0, 25.0)]
    assert solves == [(0.0, 100.0)]


def test_host_syncs_reader(monkeypatch):
    outer = spec.resolve(runner.port_module(),
                         "solvers.multigrid.outer_iterate")
    read = spec.metric_reader("host_syncs_per_solve")
    ctx = runner.Ctx(CONF, MIX, None, [5, 5], launches=0, peaks=None)
    monkeypatch.setattr(outer, "readbacks", 24)
    assert read(ctx) == 6.0                  # 24 reads over 2 + 2 solves
    monkeypatch.delattr(outer, "readbacks")
    assert read(ctx) is None                 # a port without the counter
