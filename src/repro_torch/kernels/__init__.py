"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout: ``csrc/*.cu`` holds the CUDA C++ sources, ``_build.py`` compiles
them (one ``nvcc -c`` per source, in parallel, on first use) into a
ctypes-loaded library, ``scoped_topk.py`` / ``bitmap_ops.py`` /
``flash_decode.py`` the launch wrappers with their launch counters,
``ops.py`` the public device-dispatching wrappers, and ``ref.py``
the plain versions the CPU path and the tests use. Importing builds nothing.
"""
from . import ops, ref
from .ops import (bitmap_patch, flash_decode, ivf_gather_topk,
                  ivf_gather_topk_i8, ivf_gather_topk_pq, ivf_probe_topk,
                  ivf_probe_topk_i8, ivf_probe_topk_pq, mask_and_popcount,
                  multi_scope_topk, multi_scope_topk_i8, multi_scope_topk_pq,
                  scoped_topk, scoped_topk_i8, scoped_topk_pq)

__all__ = ["ops", "ref", "scoped_topk", "multi_scope_topk",
           "scoped_topk_i8", "multi_scope_topk_i8", "scoped_topk_pq",
           "multi_scope_topk_pq", "ivf_gather_topk", "ivf_gather_topk_i8",
           "ivf_gather_topk_pq", "ivf_probe_topk", "ivf_probe_topk_i8",
           "ivf_probe_topk_pq", "bitmap_patch", "mask_and_popcount",
           "flash_decode"]
