"""Wrappers of the hand-written CUDA kernels, each beside its plain twin.

Importing these modules compiles nothing: the library is built with nvcc
on first launch (``_build.library``).
"""

from . import smooth, smooth3d, tail, transfer, transfer3d  # noqa: F401
