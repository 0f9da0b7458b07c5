"""Build and load the port's CUDA kernels: one ``nvcc -c`` per source, all
started together, linked into one shared library with a plain C interface,
loaded with ctypes.

Nothing is built at import. :func:`library` compiles ``csrc/*.cu`` for
``sm_90a`` on first use into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``); the library's file name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it. A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("scoped_topk.cu", "bitmap_ops.cu", "flash_decode.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (every pointer and the stream as c_void_p,
# so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "repro_scan_topk_tiled": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P],
    "repro_tiled_plan": [_I, _I, _I, _I, _P],
    "repro_scan_topk_stream": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_stream_plan": [_I, _I, _I, _I, _P, _P, _P],
    "repro_list_plan": [_I, _I, _I, _I, _P, _P, _P, _P],
    "repro_scan_topk_list": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _P, _P, _P, _P, _P],
    "repro_bitmap_patch": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_mask_and_popcount": [_P, _P, _P, _I, _P, _P],
    "repro_flash_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when a built library was reused) and the
#: compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
build_seconds: Optional[float] = None
build_log = ""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_seconds, build_log
    if out.exists():
        build_seconds = 0.0
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{Path(name).stem}.o") for name in SOURCES]
    tmp = out.with_name(f"{tag}.so.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            build_log += link.stdout
            failed = [link.returncode] if link.returncode != 0 else []
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
