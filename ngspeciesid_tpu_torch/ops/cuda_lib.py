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
import functools
import glob
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from typing import List, NamedTuple, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
#: One build and load at a time: rank threads may make their first launch
#: together, and a build's temporary files are named by process.
_LOAD_LOCK = threading.Lock()
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


_vp, _ci = ctypes.c_void_p, ctypes.c_int
#: The C entry points of ``csrc/*.cu``: name -> (argtypes, restype), set on
#: the library by :func:`load`.  Pointers and the stream are ``c_void_p``
#: (a plain int would cut them to 32 bits).  tests/test_torch_cuda_abi.py
#: holds this table against the sources' ``extern "C"`` definitions.
SIGNATURES = {
    "ngsid_stats_state_ints": ([_ci], _ci),
    "ngsid_stats_launch": ([_vp] * 5 + [_ci] * 11 + [_vp], _ci),
    "ngsid_moves_state_ints": ([_ci], _ci),
    "ngsid_moves_launch": ([_vp] * 7 + [_ci] * 13 + [_vp], _ci),
    "ngsid_full_dp_launch": ([_vp] * 6 + [_ci] * 11 + [_vp], _ci),
    "ngsid_error_string": ([_ci], ctypes.c_char_p),
}


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C signatures set."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# launch geometry of the wavefront kernels (csrc/wavefront.cuh)
# ---------------------------------------------------------------------------

#: Lanes per thread of each kernel's register-mode instantiations, fewest
#: first (csrc/stats_kernel.cu; csrc/moves_kernel.cu, whose geometries the
#: full DP, csrc/full_dp_kernel.cu, shares).
REGISTER_LANES = {"stats": (2, 4), "moves": (2, 4, 8)}
#: Threads per block at most (wf::kMaxBlockThreads); pairs per block at
#: most (wf::kMaxPairs), 15 when a pair spans several warps (named barriers
#: 1-15).
MAX_BLOCK_THREADS = 512
MAX_PAIRS = 16
#: Memory mode: one pair per block of this many threads (wf::kMemThreads).
MEM_THREADS = 256
#: Threads of a launch per SM above which it takes more lanes per thread
#: (fewer instructions per cell) rather than more threads (a shorter chain
#: per diagonal).  128 picks the fastest lane count of chip_smoke.py's
#: geometry sweep at all four timed shapes (stats at 4096 and 128 pairs,
#: moves at 512 and 100; H100 80GB HBM3 at 700 W, PERF.md).
BUSY_THREADS_PER_SM = 128
#: Warps per block that pairs are packed to a multiple of, when a launch has
#: more pairs than the card has SMs and the pairs fit one block: one warp
#: for each of an SM's four schedulers (the sweep's best at the stats
#: kernel's 4096-pair shape, 4 lanes x 2 warps x 2 pairs, and at the full
#: DP's 512-pair polish shape, 8 lanes x 3 warps x 4 pairs; timed on the
#: moves kernel's 384-lane window too, 4 lanes x 3 warps at 256 and 512
#: pairs; H100 80GB HBM3 at 700 W, PERF.md).  Beside the rule of 128
#: threads a block it replaced, it changes only the moves kernel's windows
#: of 384, 768 and 1536 lanes.
PACK_WARPS = 4


class Geometry(NamedTuple):
    lanes: int      # lanes per thread (1 in memory mode)
    warps: int      # warps per pair
    pairs: int      # pairs per block
    memory: bool    # DP state in global scratch instead of registers

    @property
    def threads(self) -> int:
        return self.pairs * self.warps * 32


def block_threads(kind: str, lanes: int) -> int:
    """Threads per block at most of a register-mode instantiation (its
    __launch_bounds__, wf::block_threads): 256 for the stats kernel at 4
    lanes per thread, whose registers need more than 128 a thread."""
    return 256 if kind == "stats" and lanes >= 4 else MAX_BLOCK_THREADS


def geometries(kind: str, W: int) -> List[Geometry]:
    """Every geometry a ``kind`` kernel takes at window width W with one
    pair per block: each register-mode lane count whose warps tile W within
    a block, then memory mode."""
    out = [Geometry(L, W // (32 * L), 1, False) for L in REGISTER_LANES[kind]
           if W % (32 * L) == 0 and W // L <= block_threads(kind, L)]
    return out + [Geometry(1, MEM_THREADS // 32, 1, True)]


def launch_geometry(kind: str, W: int, B: int, sms: int) -> Geometry:
    """Lanes per thread, warps per pair and pairs per block of a ``kind``
    ("stats" or "moves") launch of B pairs at window width W on a card with
    ``sms`` SMs.  A pair's window lies in registers (W == warps * 32 *
    lanes) unless it is too wide for one block (memory mode).  Few pairs:
    the fewest lanes per thread, so that each diagonal is a short chain;
    many pairs: more lanes per thread while the threads would exceed what
    the SMs keep busy.  Pairs per block: one while the pairs fit one per
    SM, then the fewest that make a multiple of PACK_WARPS warps, if they
    fit a block."""
    fits = [g.lanes for g in geometries(kind, W) if not g.memory]
    if not fits:
        return geometries(kind, W)[-1]
    lanes = fits[0]
    for more in fits[1:]:
        if B * (W // lanes) > sms * BUSY_THREADS_PER_SM:
            lanes = more
    warps = W // (32 * lanes)
    per_sm = -(-B // max(sms, 1))
    pack = PACK_WARPS // math.gcd(PACK_WARPS, warps)
    if pack * warps * 32 > block_threads(kind, lanes):
        pack = 1
    return Geometry(lanes, warps, max(1, min(pack, per_sm)), False)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().ngsid_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
