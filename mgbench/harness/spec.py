"""Find a cell's files by name: its configuration, traffic mix, kernel
mapping and per-layer metric readers.

- ``configs/<name>.json``: the deployment (grid size, dimensions, level
  dtype, the solver's settings, where the coarse tail starts);
- ``traffic/<name>.json``: the entry that the window drives, its keyword
  arguments and tolerance, and the right-hand-side draws;
- ``kernels/<name>.json``: one kernel of the port, a regular expression
  over device-kernel names and the stage its work counts under;
- ``metrics/<name>.py``: a reader with ``read(ctx)`` that returns the
  metric's value, or None where the run gives it nothing to read;
- ``checks/<name>.py``: a number that decides ``correct``, with
  ``read(u, f, k, conf)`` that judges one answer against the plain
  reference (the mix lists the numbers and their limits);
- ``drivers/<name>.py``: the set-up and the call of one kind of entry,
  with ``setup(port, conf, mix, device)`` that returns an object whose
  ``solve(f)`` gives (u, info) (the mix names its driver).

A later cell, kernel or metric adds files here and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
STAGES = ("smooth", "transfer", "tail")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in bench['workloads']]})")


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return load_json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return load_json(bench_dir / "traffic" / f"{name}.json")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel of the port: the file's name, its stage, its pattern."""

    name: str
    stage: str
    pattern: "re.Pattern"


def kernels(bench_dir: Path = BENCH_DIR) -> List[Kernel]:
    out = []
    for path in sorted((bench_dir / "kernels").glob("*.json")):
        d = load_json(path)
        if d["stage"] not in STAGES:
            raise ValueError(f"{path.name}: stage {d['stage']!r} is none "
                             f"of {STAGES}")
        out.append(Kernel(path.stem, d["stage"], re.compile(d["pattern"])))
    return out


class KernelMap:
    """Maps a device-kernel name to the one kernel file that matches it,
    or None. A name that two files match is an error: the files must
    split the names between them."""

    def __init__(self, files: List[Kernel]):
        self.files = files
        self._memo: Dict[str, Optional[Kernel]] = {}

    def __call__(self, name: str) -> Optional[Kernel]:
        if name not in self._memo:
            hits = [k for k in self.files if k.pattern.search(name)]
            if len(hits) > 1:
                raise ValueError(f"kernel files {[k.name for k in hits]} "
                                 f"all match {name!r}")
            self._memo[name] = hits[0] if hits else None
        return self._memo[name]


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark (a file name may
    hold dots and dashes)."""
    path = bench_dir / kind / f"{name}.py"
    mod_name = f"mgbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR
                  ) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return load_module("metrics", name, bench_dir).read


def check_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read`` of ``checks/<name>.py``."""
    return load_module("checks", name, bench_dir).read


def driver(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``drivers/<name>.py`` (its ``setup``)."""
    return load_module("drivers", name, bench_dir)


def cell_metrics(bench: Dict[str, Any], cell: str, kind: str
                 ) -> List[Dict[str, Any]]:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that ``cell``
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def resolve(root_module, dotted: str) -> Callable:
    """``root_module``'s attribute at ``dotted`` ('solvers.multigrid3d.
    ir_solve3d'), importing submodules on the way."""
    obj = root_module
    parts = dotted.split(".")
    for i, part in enumerate(parts):
        if not hasattr(obj, part):
            importlib.import_module(
                ".".join([root_module.__name__] + parts[:i + 1]))
        obj = getattr(obj, part)
    return obj


def cell_files(bench: Dict[str, Any], cell: str
               ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(workload entry, configuration, traffic mix) of ``cell``."""
    w = workload(bench, cell)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return w, load_json(ROOT / conf["file"]), traffic(w["traffic"])
