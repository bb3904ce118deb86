"""The port's visualization (``visualization/``, 8 modules) against the JAX
package's, on the CPU under Agg.

Every figure function of the port renders and saves. For the same data (a
numpy field, the same histories and records; the JAX package gets its
padded field, the port the logical one or a tensor) the port's figure
carries the JAX package's artist data: titles and labels, line x/y data,
image arrays, contour levels, mesh arrays, bar heights, tick labels and
texts, compared to 1e-12 relative (the same numpy and matplotlib calls on
the same values; measured: equal). The block-layout figure is the port's
own (``parallel.distributed``'s layout, not the JAX package's padded
split) and is checked against that layout.
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("matplotlib")

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu import (  # noqa: E402
    visualization as JV,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import (  # noqa: E402
    grid as jgrid,
    grid3d as jgrid3d,
)

from mixed_precision_multigrid_solvers_for_pdes_torch import (  # noqa: E402
    visualization as TV,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core import (  # noqa: E402
    grid as tgrid,
    grid3d as tgrid3d,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.core.bc import (  # noqa: E402
    BoundarySpec,
)
from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import (  # noqa: E402
    distributed,
    mesh as mesh_mod,
)

pytestmark = pytest.mark.filterwarnings("ignore")

N = 17
RECORDS = [
    {"n": 129, "precision": "fp32", "dof_per_s": 1e8, "wall_s": 1e-3,
     "error_l2": 3e-5},
    {"n": 257, "precision": "fp32", "dof_per_s": 2e8, "wall_s": 3e-3,
     "error_l2": 8e-6},
    {"n": 129, "precision": "fp64", "dof_per_s": 5e7, "wall_s": 2e-3,
     "error_l2": 3e-5},
    {"n": 257, "precision": "fp64", "dof_per_s": 1e8, "wall_s": 6e-3,
     "error_l2": None},
]
ROWS = [{"solver": "ours_fp64", "n": 129, "wall_s": 1e-3, "available": True},
        {"solver": "scipy_cg", "n": 129, "wall_s": 1e-2, "available": True},
        {"solver": "ours_fp64", "n": 257, "wall_s": 4e-3, "available": True},
        {"solver": "pyamg", "n": 257, "wall_s": float("nan"),
         "available": False}]
HISTS = {"V(2,2)": [1, 0.1, 0.01, 1e-3], "W": [1, 0.05, 0.003, 0.0, 2e-4]}
STUDY = {"h": np.array([1 / 16, 1 / 32, 1 / 64]),
         "l2": np.array([3.2e-3, 8.0e-4, 2.0e-4]), "order_l2": 2.0}


def _side(viz, grid_mod, grid3d_mod, padded):
    """Everything a figure case needs from one package: its classes, a
    grid and the field sin(pi x) sin(pi y) as that package takes it (the
    JAX package padded, the port logical)."""
    g = grid_mod.Grid(N, N)
    X, Y = g.coordinates(padded=True) if padded else g.coordinates()
    field = np.sin(np.pi * X) * np.sin(np.pi * Y)
    g3 = grid3d_mod.Grid3D(9, 9, 9)
    X3, Y3, Z3 = g3.coordinates(padded=True) if padded else g3.coordinates()
    field3 = np.sin(np.pi * X3) * np.sin(np.pi * Y3) * np.cos(np.pi * Z3)
    return types.SimpleNamespace(V=viz, Grid=grid_mod.Grid, g=g, f=field,
                                 g3=g3, f3=field3)


JAX = _side(JV, jgrid, jgrid3d, padded=True)
PORT = _side(TV, tgrid, tgrid3d, padded=False)


def _draw_panel(ax):
    ax.plot([1, 2, 3], [3, 1, 2])


CASES = {
    "surface": lambda s, **k: s.V.SolutionVisualizer().plot_surface(
        s.g, s.f, title="u", **k),
    "contour": lambda s, **k: s.V.SolutionVisualizer().plot_contour(
        s.g, s.f, **k),
    "comparison": lambda s, **k: s.V.SolutionVisualizer().plot_comparison(
        s.g, s.f, s.f * 0.99, **k),
    "error_map": lambda s, **k: s.V.SolutionVisualizer().plot_error_map(
        s.g, s.f, s.f * 0.75, **k),
    "error_map_linear": lambda s, **k: s.V.SolutionVisualizer(
    ).plot_error_map(s.g, s.f, s.f * 0.75, log=False, **k),
    "time_series": lambda s, **k: s.V.SolutionVisualizer().plot_time_series(
        s.g, [(0.0, s.f), (0.1, s.f * 0.5), (0.2, s.f * 0.25)], **k),
    "slices3d": lambda s, **k: s.V.SolutionVisualizer().plot_slices3d(
        s.g3, s.f3, axis="y", **k),
    "residual_history": lambda s, **k: s.V.ConvergencePlotter(
    ).plot_residual_history(HISTS, tol=1e-8, **k),
    "grid_convergence": lambda s, **k: s.V.ConvergencePlotter(
    ).plot_grid_convergence(STUDY["h"], STUDY["l2"], **k),
    "convergence_factors": lambda s, **k: s.V.ConvergencePlotter(
    ).plot_convergence_factors({"129": 0.08, "257": 0.09}, **k),
    "mms_study": lambda s, **k: s.V.ConvergencePlotter().plot_mms_study(
        STUDY, **k),
    "throughput": lambda s, **k: s.V.PerformancePlotter().plot_throughput(
        RECORDS, **k),
    "solve_times": lambda s, **k: s.V.PerformancePlotter().plot_solve_times(
        RECORDS, **k),
    "precision_speedup": lambda s, **k: s.V.PerformancePlotter(
    ).plot_precision_speedup({129: {"fp32": 2.0, "mixed": 2.5},
                              257: {"fp32": 2.2}}, **k),
    "scaling_efficiency": lambda s, **k: s.V.PerformancePlotter(
    ).plot_scaling_efficiency([1, 2, 4, 8], [1.0, 0.95, 0.9, 0.85], **k),
    "baseline_comparison": lambda s, **k: s.V.PerformancePlotter(
    ).plot_baseline_comparison(ROWS, **k),
    "hierarchy": lambda s, **k: s.V.GridVisualizer().plot_hierarchy(
        [s.g, s.g.coarsen(), s.g.coarsen().coarsen()], **k),
    "coarsening_path": lambda s, **k: s.V.GridVisualizer(
    ).plot_coarsening_path(s.Grid(65, 33), **k),
    "error_spectrum": lambda s, **k: s.V.AnalysisVisualizer(
    ).plot_error_spectrum(s.g, s.f, **k),
    "smoothing_effect": lambda s, **k: s.V.AnalysisVisualizer(
    ).plot_smoothing_effect(s.g, s.f, s.f * 0.3, **k),
    "precision_tradeoff": lambda s, **k: s.V.AnalysisVisualizer(
    ).plot_precision_tradeoff(RECORDS, **k),
    "method_comparison": lambda s, **k: s.V.AnalysisVisualizer(
    ).plot_method_comparison(HISTS, **k),
    "parameter_sweep": lambda s, **k: s.V.InteractivePlotter(
    ).parameter_sweep(lambda v: {"iterations": v * 2,
                                 "convergence_factor": 0.1 / v},
                      [1, 2, 3], param_name="sweeps", **k)[0],
    "comparison_dashboard": lambda s, **k: s.V.InteractivePlotter(
    ).comparison_dashboard({"a": _draw_panel, "b": _draw_panel,
                            "c": _draw_panel}, **k),
}


def _values(x):
    return np.ma.filled(np.ma.asarray(x, dtype=float), np.nan)


def _content(fig, axes=None):
    """The data a figure shows, per axes."""
    out = [fig._suptitle.get_text() if fig._suptitle else None]
    for k, ax in enumerate(fig.axes):
        if axes is not None and k not in axes:
            continue
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "lines": [(_values(ln.get_xdata()), _values(ln.get_ydata()),
                       ln.get_label()) for ln in ax.get_lines()],
            "images": [_values(im.get_array()) for im in ax.get_images()],
            "levels": [np.asarray(c.levels, float) for c in ax.collections
                       if hasattr(c, "levels")],
            "arrays": [_values(c.get_array()) for c in ax.collections
                       if not hasattr(c, "levels")
                       and c.get_array() is not None],
            "bars": [p.get_height() for p in ax.patches
                     if hasattr(p, "get_height")],
            "texts": [t.get_text() for t in ax.texts],
            "ticks": [t.get_text() for t in ax.get_xticklabels()],
        })
    return out


def _assert_same(a, b, where="figure"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, equal_nan=True,
                                   err_msg=where)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(CASES))
def test_figure_carries_jax_artist_data(name, tmp_path):
    draw = CASES[name]
    fig = draw(PORT, save=tmp_path / f"{name}.png")
    jfig = draw(JAX)
    try:
        assert (tmp_path / f"{name}.png").stat().st_size > 0
        _assert_same(_content(fig), _content(jfig), name)
    finally:
        plt.close(fig)
        plt.close(jfig)


@pytest.mark.parametrize("name", ["contour", "error_map", "slices3d",
                                  "smoothing_effect"])
def test_tensor_fields_plot_as_numpy(name):
    """A field given as a tensor (any dtype) is moved to the host once and
    plotted as its float64 values."""
    tens = types.SimpleNamespace(**vars(PORT))
    tens.f = torch.from_numpy(PORT.f)
    tens.f3 = torch.from_numpy(PORT.f3).to(torch.float64)
    fig, nfig = CASES[name](tens), CASES[name](PORT)
    try:
        _assert_same(_content(fig), _content(nfig), name)
    finally:
        plt.close(fig)
        plt.close(nfig)


def test_dashboard_panels_match_jax(tmp_path):
    dash, jdash = TV.SolverDashboard(), JV.SolverDashboard()
    for r in [1.0, 0.5, 0.49, 0.488, 0.4875, 0.4874, 0.48738, 0.4873]:
        dash.record(r)
        jdash.record(r)
    fig = dash.render(save=tmp_path / "dash.png")
    jfig = jdash.render()
    try:
        assert (tmp_path / "dash.png").stat().st_size > 0
        # panel 2 is the host's memory, which differs between the runs
        _assert_same(_content(fig, axes=(0, 1, 3)),
                     _content(jfig, axes=(0, 1, 3)), "dashboard")
        assert "residual stagnating" in fig.axes[3].texts[0].get_text()
    finally:
        plt.close(fig)
        plt.close(jfig)


def test_sharding_layout_is_the_ports(tmp_path):
    """1025^2 on a (2, 2) mesh is laid out at 1152^2 in four 576^2 blocks
    (``parallel.distributed.make_tilings``), with no process group."""
    g = tgrid.Grid(1025, 1025)
    fig = TV.GridVisualizer().plot_sharding_layout(
        g, (2, 2), save=tmp_path / "layout.png")
    try:
        ax = fig.axes[0]
        owner = np.asarray(ax.get_images()[0].get_array()).T
        assert owner.shape == (1152, 1152)
        levels = []
        gg = g
        while True:
            levels.append(types.SimpleNamespace(grid=gg,
                                                spec=BoundarySpec()))
            if not gg.can_coarsen():
                break
            gg = gg.coarsen()
        t0 = distributed.make_tilings(mesh_mod.Mesh((2, 2)), levels)[0]
        assert t0.extent == (1152, 1152)
        for bx in range(2):
            for by in range(2):
                block = owner[bx * 576:(bx + 1) * 576, by * 576:(by + 1) * 576]
                assert (block == bx * 2 + by).all()
        assert "laid out at 1152x1152" in ax.get_title()
        assert (tmp_path / "layout.png").stat().st_size > 0
    finally:
        plt.close(fig)
    fig = TV.GridVisualizer().plot_sharding_layout(tgrid.Grid(17, 17),
                                                   (2, 2))
    try:
        owner = np.asarray(fig.axes[0].get_images()[0].get_array())
        assert owner.shape == (17, 17) and (owner == 0).all()
        assert "replicated" in fig.axes[0].get_title()
    finally:
        plt.close(fig)
