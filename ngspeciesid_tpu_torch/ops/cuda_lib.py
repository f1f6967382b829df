"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.  The library lands in ``ngspeciesid_tpu_torch/_build/`` (ignored
by git) under a name keyed on a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused.  A failed build raises with
nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
#: Wall seconds of the last nvcc run in this process (None: library reused).
BUILD_SECONDS: Optional[float] = None
#: nvcc's output of that build (ptxas register and shared-memory report).
BUILD_LOG = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin directory "
                       "on PATH or set CUDA_HOME")


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                       + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libngsid_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> str:
    """Run the commands at once; raise with their output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    for p, c in zip(procs, cmds):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{log}")
    return log


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    global BUILD_SECONDS, BUILD_LOG
    so = library_path()
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for src, obj in zip(sources, objs)])
        log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp,
                          *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    os.replace(tmp, so)           # atomic: concurrent builders never see half
    return so


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ngsid_stats_scratch_ints.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.ngsid_stats_scratch_ints.restype = ci
        lib.ngsid_stats_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, ci, vp]
        lib.ngsid_stats_launch.restype = ci
        lib.ngsid_moves_scratch_ints.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.ngsid_moves_scratch_ints.restype = ci
        lib.ngsid_moves_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, ci, ci, ci, vp]
        lib.ngsid_moves_launch.restype = ci
        lib.ngsid_full_dp_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                             ci, ci, ci, ci, vp]
        lib.ngsid_full_dp_launch.restype = ci
        lib.ngsid_error_string.argtypes = [ci]
        lib.ngsid_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().ngsid_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
