"""Plain reference of stage 4: which consensuses there are, and each one's
sequence.

Which: upstream forms a consensus for every cluster of at least the
abundance cutoff (``int(abundance_ratio * reads clustered)``), merges
consensuses whose sequences match forward or reverse, and polishes what is
left.  So the clusters of ``final_clusters.tsv`` at or above the cutoff have
to be split among the consensuses whole: each such cluster lies in exactly
one consensus's reads (``reads_to_consensus_<id>.fastq`` beside a
``*_cl_id_<id>/consensus.fasta``), and those reads hold nothing else
(``partition_faults``).

Each sequence: the generator knows every read's species and every species'
core.  The species that hold at least ``CONTENDER`` of the reads that the
most frequent one holds are the consensus's contenders.  With one, the
error is the least number of edits that turn its core, or its reverse
complement, into a substring of the consensus (bases around it, such as
primer remnants, are free), over the core's length.  Where congeners share
a cluster about evenly, a consensus of its reads is decided column by
column by the reads' noise: any mosaic of the contenders' cores is as
right as another.  So the truth is then a profile of the cores aligned to
the most frequent one, each column allowing every contender's base (or its
gap), and the error counts the edits the consensus needs beyond it.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b
_CODE = np.full(256, 5, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
ACGT = np.frombuffer(b"ACGT", np.uint8)

#: Share of the most frequent species' reads that makes another species a
#: contender for a consensus's truth.
CONTENDER = 0.5
#: Bases that a contender's core may insert between two columns of the
#: most frequent one's.
MAX_INSERT = 6
GAP = 4


def edits_into(allowed: np.ndarray, optional: np.ndarray,
               cons: np.ndarray) -> int:
    """Edits turning a profile into a substring of ``cons``: rows over the
    profile's columns (``allowed``: a bit per base of ACGT; ``optional``:
    the column may be skipped free), columns over the consensus, free
    leading and trailing consensus bases; one row at a time, the left
    dependency as a running minimum."""
    m = cons.size
    j = np.arange(m + 1, dtype=np.int64)
    bits = np.where(_CODE[cons] < 4, 1 << _CODE[cons].astype(np.int64), 0)
    prev = np.zeros(m + 1, np.int64)
    for ok, skip in zip(allowed.tolist(), optional.tolist()):
        gap = 0 if skip else 1
        t = np.empty(m + 1, np.int64)
        t[0] = prev[0] + gap
        t[1:] = np.minimum(prev[1:] + gap, prev[:-1] + ((bits & ok) == 0))
        prev = np.minimum.accumulate(t - j) + j
    return int(prev.min())


def profile(cores: Sequence[np.ndarray], device="cpu"):
    """(allowed, optional) columns of ``cores[0]`` with every other core
    aligned to it: each column allows each core's base there, and may be
    skipped where a core has a gap; bases a core inserts are columns of
    their own that may be skipped."""
    first = np.asarray(cores[0], np.uint8)
    allowed = (1 << _CODE[first].astype(np.int64)).tolist()
    optional = [False] * first.size
    inserted: List[List[int]] = [[] for _ in range(first.size + 1)]
    for other in cores[1:]:
        col, ins, n_ins = (t[0].cpu().numpy() for t in
                           _align(first, [np.asarray(other, np.uint8)], device))
        for i, c in enumerate(col.tolist()):
            if c == GAP:
                optional[i] = True
            else:
                allowed[i] |= 1 << c
        for slot in np.flatnonzero(n_ins).tolist():
            inserted[slot] += [1 << int(b) for b in
                               ins[slot, : min(int(n_ins[slot]), MAX_INSERT)]]
    out_a, out_o = [], []
    for slot in range(first.size + 1):
        out_a += inserted[slot]
        out_o += [True] * len(inserted[slot])
        if slot < first.size:
            out_a.append(allowed[slot])
            out_o.append(optional[slot])
    return np.asarray(out_a, np.int64), np.asarray(out_o, bool)


def error(cores: Sequence[np.ndarray], cons: np.ndarray,
          device="cpu") -> float:
    """Edits per base of ``cores[0]`` that the consensus (either strand)
    needs beyond the profile of ``cores``."""
    allowed, optional = profile(cores, device)
    return min(edits_into(allowed, optional, s)
               for s in (cons, _COMP[cons[::-1]])) / max(cores[0].size, 1)


def _align(backbone: np.ndarray, reads: Sequence[np.ndarray], device):
    """Edit-distance alignment of every read (either strand) to the whole
    backbone, the read's own ends free.  Returns, per read, the base (or
    ``GAP``) at each backbone column and the bases inserted before each
    column (``MAX_INSERT`` at most, in order), as (B, m) and (B, m+1, K)
    uint8 tensors, and each read's count of inserted bases per slot."""
    dev = torch.device(device)
    m = backbone.size
    both = list(reads) + [_COMP[r[::-1]] for r in reads]
    B, N = len(both), max(r.size for r in both)
    R = torch.full((B, N), 5, dtype=torch.uint8)
    for b, r in enumerate(both):
        R[b, : r.size] = torch.from_numpy(_CODE[r])
    R = R.to(dev)
    lens = torch.tensor([r.size for r in both], device=dev)
    bb = torch.from_numpy(_CODE[backbone]).to(dev)
    jj = torch.arange(N + 1, device=dev, dtype=torch.int32)[None, :]
    prev = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    # 0 a base against the column, 1 the column missing in the read,
    # 2 a read base inserted; ties in that order
    mv = torch.empty((m, B, N + 1), dtype=torch.uint8, device=dev)
    for i in range(1, m + 1):
        diag = prev[:, :-1] + (R != bb[i - 1]).to(torch.int32)
        up = prev + 1
        t = up.clone()
        t[:, 1:] = torch.minimum(up[:, 1:], diag)
        cur = torch.cummin(t - jj, dim=1).values + jj
        mv[i - 1] = torch.where(cur == up, 1, 2).to(torch.uint8)
        mv[i - 1, :, 1:] = torch.where(cur[:, 1:] == diag, 0, mv[i - 1, :, 1:])
        prev = cur
    end = torch.where(jj <= lens[:, None], prev, torch.iinfo(torch.int32).max)
    cost, j = end.min(1)
    # each read on the strand that aligns with fewer edits
    n = len(reads)
    keep = torch.where(cost[:n] <= cost[n:], torch.arange(n, device=dev),
                       torch.arange(n, 2 * n, device=dev))
    j = j[keep].long()
    R = R[keep]
    rows = keep
    i = torch.full((n,), m, dtype=torch.long, device=dev)
    col = torch.full((n, m), GAP, dtype=torch.uint8, device=dev)
    ins = torch.zeros((n, m + 1, MAX_INSERT), dtype=torch.uint8, device=dev)
    n_ins = torch.zeros((n, m + 1), dtype=torch.long, device=dev)
    ar = torch.arange(n, device=dev)
    while True:
        live = i > 0
        if not bool(live.any()):
            break
        step = mv[(i - 1).clamp(min=0), rows, j]
        step = torch.where(j > 0, step, torch.ones_like(step))
        base = R[ar, (j - 1).clamp(min=0)]
        is_m = live & (step == 0)
        is_i = live & (step == 2)
        ic = (i - 1).clamp(min=0)
        col[ar[is_m], ic[is_m]] = base[is_m]
        # inserted bases come last first: keep the slot's count, and place
        # them once the slot is left
        k = n_ins[ar, i]
        put = is_i & (k < MAX_INSERT)
        ins[ar[put], i[put], k[put]] = base[put]
        n_ins[ar[is_i], i[is_i]] += 1
        i = i - (live & ~is_i).long()
        j = j - (is_m | is_i).long()
    # the bases of each slot were stored last first: reverse them in place
    kk = torch.arange(MAX_INSERT, device=dev)[None, None, :]
    cnt = n_ins.clamp(max=MAX_INSERT)[:, :, None]
    src = torch.where(kk < cnt, cnt - 1 - kk, kk)
    ins = ins.gather(2, src)
    return col, ins, n_ins


def _fastq_members(path: str) -> List[int]:
    with open(path, "rb") as f:
        heads = f.read().split(b"\n")[0::4]
    return [int(h.split(b"_")[1]) for h in heads if h.startswith(b"@")]


def consensuses(outfolder: str) -> Dict[str, Tuple[np.ndarray, str]]:
    """{consensus id: (sequence, its reads' file)} of a run's folder."""
    out = {}
    for path in sorted(glob.glob(os.path.join(outfolder, "*_cl_id_*",
                                              "consensus.fasta"))):
        c_id = os.path.basename(os.path.dirname(path)).rsplit("_", 1)[1]
        with open(path, "rb") as f:
            cons = np.frombuffer(b"".join(f.read().split(b"\n")[1:]).strip(),
                                 np.uint8)
        out[c_id] = (cons, os.path.join(outfolder,
                                        f"reads_to_consensus_{c_id}.fastq"))
    return out


def partition_faults(outfolder: str, cutoff: int) -> List[str]:
    """Clusters of ``final_clusters.tsv`` at or above ``cutoff`` that do not
    lie whole in exactly one consensus's reads, and consensuses whose reads
    are not whole such clusters."""
    clusters: Dict[str, set] = {}
    with open(os.path.join(outfolder, "final_clusters.tsv")) as f:
        for line in f:
            cl, acc = line.rstrip("\n").split("\t")
            clusters.setdefault(cl, set()).add(int(acc.split("_")[1]))
    big = {cl: reads for cl, reads in clusters.items() if len(reads) >= cutoff}
    owner: Dict[int, str] = {r: cl for cl, reads in big.items() for r in reads}
    faults = []
    held: Dict[str, List[str]] = {cl: [] for cl in big}
    for c_id, (_, reads_path) in consensuses(outfolder).items():
        members = set(_fastq_members(reads_path)) \
            if os.path.isfile(reads_path) else set()
        if not members:
            faults.append(f"consensus {c_id}: no reads")
            continue
        stray = [r for r in members if r not in owner]
        if stray:
            faults.append(f"consensus {c_id}: {len(stray)} reads of no "
                          f"cluster at the cutoff")
        for cl in {owner[r] for r in members if r in owner}:
            if not big[cl] <= members:
                faults.append(f"consensus {c_id}: part of cluster {cl}")
            held[cl].append(c_id)
    for cl, ids in held.items():
        if len(ids) != 1:
            faults.append(f"cluster {cl} ({len(big[cl])} reads) in "
                          f"{len(ids)} consensuses")
    return faults


def judge(outfolder: str, cores: Sequence[np.ndarray], species: np.ndarray,
          device="cpu") -> Tuple[List[float], int]:
    """(each consensus's error, how many had more than one contender)."""
    errs, mixed = [], 0
    for c_id, (cons, reads_path) in consensuses(outfolder).items():
        members = _fastq_members(reads_path)
        if not members:
            continue
        counts = np.bincount(species[members], minlength=len(cores))
        order = np.argsort(-counts, kind="stable")
        top = counts[order[0]]
        contenders = [int(sp) for sp in order if counts[sp] >= CONTENDER * top]
        mixed += len(contenders) > 1
        errs.append(error([cores[sp] for sp in contenders], cons, device))
    return errs, mixed
