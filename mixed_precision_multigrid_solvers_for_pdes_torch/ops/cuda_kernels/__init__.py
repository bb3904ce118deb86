"""Wrappers of the hand-written CUDA kernels, each beside its plain twin.

Importing these modules compiles nothing: the library is built with nvcc
on first launch (``_build.library``).
"""

from . import (  # noqa: F401
    refine3d, smooth, smooth3d, smooth_planes, smooth_var, tail, transfer,
    transfer3d)
