"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``. The
build runs at first use, into ``build/kernels-<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the flags, so a changed source
is rebuilt and an unchanged one is not. Nothing is compiled at import time.

Each C entry point launches one kernel on the stream it is given (PyTorch's
current stream) and returns ``cudaGetLastError()``; ``launch`` raises on any
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build"
LIB_NAME = "libmg_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP, _FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    # name: (argtypes, restype)
    "mg_rbgs_color": ([_P, _P, _I, _I] + [_F] * 6 + [_I, _I, _P], _I),
    "mg_jacobi": ([_P, _P, _P, _I, _I] + [_F] * 6 + [_I, _P], _I),
    "mg_rbgs_var_color": ([_P] * 7 + [_I, _I, _F, _I, _I, _P], _I),
    "mg_jacobi_var": ([_P] * 8 + [_I, _I, _F, _I, _P], _I),
    "mg_residual_restrict": ([_P, _P, _P, _I, _I, _I] + [_F] * 5 + [_I, _P],
                             _I),
    "mg_residual_restrict_var": ([_P] * 8 + [_I] * 5 + [_I, _P], _I),
    "mg_prolong_correct": ([_P, _P, _I, _I, _I, _I, _I, _P], _I),
    "mg_tail_workspace_floats": ([_I, _IP, _IP], ctypes.c_long),
    "mg_tail_vcycle": ([_P, _P, _P, _I, _IP, _IP, _FP, _I, _I, _F, _I, _I,
                        _I, _I, _P], _I),
    "mg_tail_var_vcycle": ([_P, _P, _P, _I, _IP, _IP, _PP, _I, _I, _F, _I,
                            _I, _I, _I, _P], _I),
    "mg_rbgs3d_color": ([_P, _P, _I, _I, _I] + [_F] * 8 + [_I, _I, _P], _I),
    "mg_residual_restrict3d": ([_P, _P, _P] + [_I] * 5 + [_F] * 7
                               + [_I, _P], _I),
    "mg_prolong_correct3d": ([_P, _P] + [_I] * 5 + [_I, _P], _I),
    "mg_planes_rbgs_color": ([_P, _P] + [_I] * 4 + [_F] * 6 + [_I, _I, _P],
                             _I),
    "mg_rbgs_parity": ([_P] * 3 + [_I, _I] + [_F] * 6 + [_I, _I, _P], _I),
    "mg_probe_color": ([_P] * 3 + [_I] * 4 + [_I, _P], _I),
    "mg_copy2x": ([_P, _P, ctypes.c_long, _I, _P], _I),
    "mg_error_string": ([_I], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    built: bool            # False when an earlier build was reused
    build_seconds: float   # nvcc wall time (0.0 when reused)
    log: str               # nvcc's output (ptxas register/spill report)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels are built from source at first use")


def _compile_and_link(nvcc: str, out_dir: Path, path: Path) -> str:
    """One nvcc per source, all running at once, then one link into
    ``path``; returns nvcc's output. Every process is waited for before an
    error is raised."""
    tag = f"tmp{os.getpid()}"
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"  # nvcc goes by the suffix
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, path)  # atomic: concurrent builders never see halves
    return log


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    built, seconds = False, 0.0
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(find_nvcc(), out_dir, path)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        built = True
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=path, built=built,
                         build_seconds=seconds, log=log)


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise if it reports a CUDA error."""
    lib = library().lib
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.mg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_fp32(name: str, *tensors: torch.Tensor,
                    ndim: int = 2) -> None:
    """Raise unless every tensor is a contiguous ``ndim``-D float32 CUDA
    tensor on one device, at least 3 nodes along each axis."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous {ndim}-D "
                             f"tensors, got shape {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if min(t.shape) < 3:
            raise ValueError(f"{name}: grids must have at least 3 nodes "
                             f"per axis, got {tuple(t.shape)}")
