"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout: ``csrc/*.cu`` holds the CUDA C++ sources, ``_build.py`` compiles
them (one ``nvcc`` call, on first use) into a ctypes-loaded library,
``scoped_topk.py`` / ``bitmap_ops.py`` the launch wrappers with their launch
counters, ``ops.py`` the public device-dispatching wrappers, and ``ref.py``
the plain versions the CPU path and the tests use. Importing builds nothing.
"""
from . import ops, ref
from .ops import (bitmap_patch, mask_and_popcount, multi_scope_topk,
                  scoped_topk)

__all__ = ["ops", "ref", "scoped_topk", "multi_scope_topk", "bitmap_patch",
           "mask_and_popcount"]
