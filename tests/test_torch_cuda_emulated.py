"""The CUDA sources of the stats, moves and full-DP kernels, run on the CPU.

``csrc/stats_kernel.cu``, ``csrc/moves_kernel.cu`` and
``csrc/full_dp_kernel.cu`` are compiled with g++ against
``tests/cuda_emu/emu.h``, a SIMT emulation (one OS thread per CUDA thread;
warp shuffles, ballots and named barriers as thread barriers), and their
rows and op streams must equal the plain PyTorch versions bit for bit under
every launch geometry the kernels take.  This checks the kernels' logic
(lane frames, halos, the window schedule's bits, the fixed frame, trackers,
the batched traceback); that they build for the card and how fast they run
is chip_smoke.py's part.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ngspeciesid_tpu_torch.ops import align_full as F
from ngspeciesid_tpu_torch.ops import align_moves as M
from ngspeciesid_tpu_torch.ops import align_stats as A
from ngspeciesid_tpu_torch.ops import cuda_lib
from ngspeciesid_tpu_torch.ops.poa import (POA_EXT, POA_MATCH, POA_MISMATCH,
                                           POA_OPEN)

CPU = torch.device("cpu")
EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
GLOBALS = """#include "emu.h"
thread_local dim3v threadIdx, blockIdx;
thread_local uint8_t* emu_dyn;
thread_local Ctx* emu_ctx;
"""


def translate(src):
    """A kernel source as C++ for the emulation: its one inline PTX line
    and its launch syntax become calls into emu.h."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = src.replace("extern __shared__ __align__(16) uint8_t dyn[];",
                      "uint8_t* dyn = emu_dyn;")
    src = src.replace(
        'asm volatile("bar.sync %0, %1;" ::"r"(p.bar), "r"(p.nthreads) : '
        '"memory");', "emu_bar(p.bar, p.nthreads);")
    return re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<([^>]*)>>>\((\w+)\)",
                  r"emu_launch(\1, \2, \3)", src)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the emulated kernels need a C++ compiler")
    out = tmp_path_factory.mktemp("cuda_emu")
    shutil.copy(os.path.join(EMU, "emu.h"), out / "emu.h")
    for name in ("wavefront.cuh", "moves_policy.cuh", "stats_kernel.cu",
                 "moves_kernel.cu", "full_dp_kernel.cu"):
        with open(os.path.join(cuda_lib.CSRC, name)) as f:
            text = translate(f.read())
        (out / name.replace(".cu", ".cpp", 1 if name.endswith(".cu")
                            else 0)).write_text(text)
    (out / "globals.cpp").write_text(GLOBALS)
    found = {}
    for kind in ("stats", "moves", "full_dp"):
        so = out / f"lib{kind}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared",
                        "-pthread", "-w", f"-I{out}", "-o", str(so),
                        str(out / f"{kind}_kernel.cpp"),
                        str(out / "globals.cpp")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for fn in (f for f in cuda_lib.SIGNATURES
                   if f.startswith(f"ngsid_{kind}_")):
            argtypes, restype = cuda_lib.SIGNATURES[fn]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        found[kind] = lib
    return found


def seqs_for(rng, B, lo, hi):
    """B pairs with lengths in [lo, hi]: half near-copies, half unrelated."""
    out = []
    for p in range(B):
        a = rng.integers(65, 69, size=int(rng.integers(lo, hi + 1)))
        if p % 2 == 0:
            b = a[rng.random(a.size) > 0.08].copy()
            sub = rng.random(b.size) < 0.05
            b[sub] = rng.integers(65, 69, size=int(sub.sum()))
        else:
            b = rng.integers(65, 69, size=int(rng.integers(lo, hi + 1)))
        out += [a.astype(np.uint8), b.astype(np.uint8)]
    return out


def every_geometry(kind, W):
    """Each register-mode lane count at one and three pairs per block, and
    memory mode."""
    out = []
    for g in cuda_lib.geometries(kind, W):
        for pairs in ((1,) if g.memory else (1, 3)):
            geo = g._replace(pairs=pairs)
            if geo.memory or geo.threads <= cuda_lib.block_threads(
                    kind, geo.lanes):
                out.append(geo)
    return out


def chunks(kind, rng, B, lo, hi, k, band, scoring=(2, -2, 1)):
    """The chunks of B seeded pairs: (pool, pm, base, W, d_max) each."""
    seqs = seqs_for(rng, B, lo, hi)
    pool = A.SeqPool(CPU)
    pool.ensure(seqs)
    r1, r2 = list(range(0, 2 * B, 2)), list(range(1, 2 * B, 2))
    plan = (A._plan_chunks if kind == "stats" else M._plan)(seqs, r1, r2)
    opens = ([POA_OPEN] * B if scoring[0] == POA_MATCH
             else rng.integers(2, 6, size=B).tolist())
    for sl in plan:
        n = len(sl)
        mids = [int(rng.integers(0, k + 1)) for _ in sl]
        pm, base, W, d_max, _, _ = A.stage_chunk(
            pool, seqs, [r1[i] for i in sl], [r2[i] for i in sl],
            [opens[i] for i in sl], [k if kind == "stats" else 0] * n,
            mids if kind == "stats" else [0] * n, band)
        yield pool.buf, pm, base, W, d_max


@pytest.mark.parametrize("B,lo,hi,k,band", [
    (3, 20, 40, 13, 0),       # W 128: both lane counts, one warp per pair
    (3, 90, 120, 20, 150),
    (2, 150, 200, 26, 0),     # W 384: three warps at 4 lanes
    (2, 130, 180, 13, 0),     # W 256: two and four warps per pair
])
def test_stats_kernel_source_equals_plain(libs, B, lo, hi, k, band):
    rng = np.random.default_rng(B * 1000 + lo + k + band)
    lib = libs["stats"]
    for pool, pm, base, W, d_max in chunks("stats", rng, B, lo, hi, k, band):
        want = A.stats_rows_plain(pool, pm, base, W, d_max, band)
        for geo in every_geometry("stats", W):
            out = torch.full((pm.shape[0], 16), 12345, dtype=torch.int32)
            scratch = (torch.empty(pm.shape[0] * lib.ngsid_stats_state_ints(W),
                                   dtype=torch.int32) if geo.memory else None)
            err = lib.ngsid_stats_launch(
                pool.data_ptr(), pm.data_ptr(), base.data_ptr(),
                out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                pm.shape[0], W, d_max, band, 2, -2, 1, geo.lanes, geo.warps,
                geo.pairs, int(geo.memory), None)
            assert err == 0
            assert torch.equal(out, want), geo


@pytest.mark.parametrize("B,lo,hi,band,poa", [
    (3, 20, 40, 0, True),
    (3, 90, 120, 150, False),
    (2, 130, 180, 0, True),     # W 256: one, two and four warps per pair
    (2, 200, 260, 0, False),
])
def test_moves_kernel_source_equals_plain(libs, B, lo, hi, band, poa):
    rng = np.random.default_rng(B * 1000 + lo + band + poa)
    lib = libs["moves"]
    scoring = (POA_MATCH, POA_MISMATCH, POA_EXT) if poa else (2, -2, 1)
    for pool, pm, base, W, d_max in chunks("moves", rng, B, lo, hi, 0, band,
                                           scoring):
        args = (pool, pm, base, W, d_max, band, *scoring)
        want_best, want_ops = M.moves_rows_plain(*args)
        for geo in every_geometry("moves", W):
            n = pm.shape[0]
            best = torch.full((n, 16), 12345, dtype=torch.int32)
            ops = torch.zeros((n, base.numel()), dtype=torch.uint8)
            store = torch.empty((n, d_max + 1, W), dtype=torch.uint8)
            scratch = (torch.empty(n * lib.ngsid_moves_state_ints(W),
                                   dtype=torch.int32) if geo.memory else None)
            err = lib.ngsid_moves_launch(
                pool.data_ptr(), pm.data_ptr(), base.data_ptr(),
                store.data_ptr(), ops.data_ptr(), best.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, W, d_max,
                base.numel(), band, *scoring, geo.lanes, geo.warps,
                geo.pairs, int(geo.memory), 1, None)
            assert err == 0
            assert torch.equal(best, want_best), geo
            assert torch.equal(ops, want_ops), geo


@pytest.mark.parametrize("B,lo,hi,poa", [
    (3, 20, 40, True),          # W 128
    (2, 130, 180, False),       # W 256: one, two and four warps per pair
    (1, 6, 200, False),         # 6 bp against 200 bp and back, W 256
])
def test_full_dp_kernel_source_equals_plain(libs, B, lo, hi, poa):
    rng = np.random.default_rng(B * 1000 + lo + poa)
    lib = libs["full_dp"]
    scoring = (POA_MATCH, POA_MISMATCH, POA_EXT) if poa else (2, -2, 1)
    if lo == 6:
        a, b = (rng.integers(65, 69, size=k).astype(np.uint8) for k in (6, 200))
        pairs = [(a, b), (b, a)]
    else:
        seqs = seqs_for(rng, B, lo, hi)
        pairs = list(zip(seqs[0::2], seqs[1::2]))
    opens = ([POA_OPEN] * len(pairs) if poa
             else rng.integers(2, 6, size=len(pairs)).tolist())
    pool, pm, W, d_max, _, _ = F.stage_pairs(pairs, opens, CPU)
    want_best, want_ops = F.full_dp_rows_plain(pool, pm, W, d_max, *scoring)
    for geo in every_geometry("moves", W):
        n = pm.shape[0]
        best = torch.full((n, 16), 12345, dtype=torch.int32)
        ops = torch.zeros((n, d_max + 1), dtype=torch.uint8)
        store = torch.empty((n, d_max + 1, W), dtype=torch.uint8)
        scratch = (torch.empty(n * libs["moves"].ngsid_moves_state_ints(W),
                               dtype=torch.int32) if geo.memory else None)
        err = lib.ngsid_full_dp_launch(
            pool.data_ptr(), pm.data_ptr(), store.data_ptr(),
            ops.data_ptr(), best.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, W, d_max,
            *scoring, geo.lanes, geo.warps, geo.pairs, int(geo.memory), 1,
            None)
        assert err == 0
        assert torch.equal(best, want_best), geo
        assert torch.equal(ops, want_ops), geo
