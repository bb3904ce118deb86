"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a`` into one
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP, _FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # name: (argtypes, restype)
    "mg_rbgs_color": ([_P, _P, _I, _I] + [_F] * 6 + [_I, _I, _P], _I),
    "mg_jacobi": ([_P, _P, _P, _I, _I] + [_F] * 6 + [_I, _P], _I),
    "mg_residual_restrict": ([_P, _P, _P, _I, _I, _I] + [_F] * 5 + [_I, _P],
                             _I),
    "mg_prolong_correct": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "mg_tail_workspace_floats": ([_I, _IP, _IP], ctypes.c_long),
    "mg_tail_vcycle": ([_P, _P, _P, _I, _IP, _IP, _FP, _I, _I, _F, _I, _I,
                        _I, _I, _P], _I),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    built, seconds = False, 0.0
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in sorted(CSRC_DIR.glob("*.cu")))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)  # atomic: concurrent builders never see halves
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


def check_cuda_fp32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 2-D float32 CUDA tensor on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous 2-D "
                             f"tensors, got shape {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if min(t.shape) < 3:
            raise ValueError(f"{name}: grids must be at least 3x3, got "
                             f"{tuple(t.shape)}")
