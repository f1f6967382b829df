"""Minimal pure-Python BAM reader for the offline quality evaluator (C17).

The reference derives truth classes from a BAM with pysam (reference
scripts/compute_cluster_quality.py:27-101): reference-name classes for
simulated data and overlap-interval classes for real data.  pysam is a
heavyweight htslib binding; the evaluator only needs four fields per
primary mapped record (name, reference, position, reference end), so this
module parses the BAM container directly.

BGZF is a sequence of gzip members (the htslib spec's BC extra subfield
only encodes block sizes for random access, which we don't need), so the
stdlib ``gzip`` module decompresses a BAM byte-exactly.  Record layout per
SAM spec section 4.2.
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Iterator, List, Tuple

FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

#: CIGAR ops that consume the reference: M, D, N, =, X
_REF_CONSUMING = {0, 2, 3, 7, 8}


def read_bam(path: str) -> Iterator[Tuple[str, int, str, int, int]]:
    """Yield (query_name, flag, reference_name, ref_start, ref_end) for
    every record; unmapped records yield reference_name = None and
    start/end = -1.  reference_end follows pysam: start + reference-
    consuming CIGAR length."""
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic {magic!r})")
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)  # SAM header text
        (n_ref,) = struct.unpack("<i", f.read(4))
        refs: List[str] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            name = f.read(l_name)[:-1].decode()  # strip NUL
            f.read(4)  # l_ref
            refs.append(name)
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            block = f.read(block_size)
            if len(block) < block_size:
                raise ValueError(f"{path}: truncated BAM record")
            (ref_id, pos, l_read_name, _mapq, _bin, n_cigar, flag,
             _l_seq, _next_ref, _next_pos, _tlen) = struct.unpack(
                "<iiBBHHHiiii", block[:32])
            qname = block[32 : 32 + l_read_name - 1].decode()
            off = 32 + l_read_name
            ref_len = 0
            for c in range(n_cigar):
                (op_len,) = struct.unpack_from("<I", block, off + 4 * c)
                if (op_len & 0xF) in _REF_CONSUMING:
                    ref_len += op_len >> 4
            if ref_id < 0 or (flag & FLAG_UNMAPPED):
                yield qname, flag, None, -1, -1
            else:
                yield qname, flag, refs[ref_id], pos, pos + ref_len


def _primary_mapped(path: str) -> Iterator[Tuple[str, str, int, int]]:
    for qname, flag, rname, start, end in read_bam(path):
        if rname is None or flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
            continue
        yield qname, rname, start, end


def classes_from_ref_names(path: str) -> Dict[str, int]:
    """Truth classes = reference names (the reference's --simulated mode,
    compute_cluster_quality.py:96-101)."""
    class_ids: Dict[str, int] = {}
    out: Dict[str, int] = {}
    for qname, rname, _start, _end in _primary_mapped(path):
        out[qname] = class_ids.setdefault(rname, len(class_ids))
    return out


def classes_from_intervals(path: str) -> Dict[str, int]:
    """Truth classes = connected components of alignment-interval overlap
    per reference (the reference's real-data mode,
    compute_cluster_quality.py:27-93).  On a line, the components of the
    interval-overlap graph are exactly the maximal chains of overlapping
    intervals, so one sweep per reference replaces the graph walk."""
    by_ref: Dict[str, List[Tuple[int, int, str]]] = {}
    for qname, rname, start, end in _primary_mapped(path):
        by_ref.setdefault(rname, []).append((start, end, qname))
    out: Dict[str, int] = {}
    class_id = 0
    for rname in sorted(by_ref):
        ivals = sorted(by_ref[rname])
        cur_max_end = None
        for start, end, qname in ivals:
            if cur_max_end is None or start >= cur_max_end:
                class_id += 1
                cur_max_end = end
            else:
                cur_max_end = max(cur_max_end, end)
            out[qname] = class_id
    return out
