"""fasta/fastq codec.

Parsing semantics follow the lh3 ``readfq`` contract the reference uses
(modules/help_functions.py:13-42): records start at '>' or '@'; the full
header line (minus the marker) is the accession, internal whitespace kept;
sequences may span multiple lines; fastq quality is read until its length
reaches the sequence length.  Unlike the reference we do not chop the final
character when a file lacks a trailing newline.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple


def read_fastx(path: str) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield ``(name, seq, qual)`` records; ``qual`` is None for fasta."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    i, n = 0, len(lines)
    while i < n:
        line = lines[i]
        if not line or line[0] not in (62, 64):  # '>' '@'
            i += 1
            continue
        name = line[1:].decode("ascii")
        i += 1
        seq_parts: List[bytes] = []
        while i < n and lines[i][:1] not in (b"+", b">", b"@"):
            seq_parts.append(lines[i])
            i += 1
        seq = b"".join(seq_parts)
        if i < n and lines[i][:1] == b"+":
            i += 1
            qual_parts: List[bytes] = []
            qlen = 0
            while i < n and qlen < len(seq):
                qual_parts.append(lines[i])
                qlen += len(lines[i])
                i += 1
            qual = b"".join(qual_parts)
            if qlen >= len(seq):
                yield name, seq.decode("ascii"), qual.decode("ascii")
            else:  # truncated fastq record -> fasta fallback, like readfq
                yield name, seq.decode("ascii"), None
        else:
            yield name, seq.decode("ascii"), None


def scan_fastq(path: str):
    """Vectorized scan of a well-formed 4-line fastq.

    Returns ``(data, starts, ends)`` where ``data`` is the whole file as one
    immutable bytes object and ``starts``/``ends`` are (n_records, 4) int64
    arrays of the byte ranges of the name (marker excluded), sequence, plus
    separator and quality lines.  No per-record Python objects are created —
    callers slice ``data`` (or a uint8 view of it) lazily.

    Returns ``None`` when the file is not strict 4-line fastq (multiline
    records, fasta, truncated tail) — callers fall back to :func:`read_fastx`,
    which implements the full readfq contract.
    """
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"@"):
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    from .. import native
    nl = native.find_newlines(arr)
    if nl is None:
        nl = np.flatnonzero(arr == 10)  # '\n'
    if nl.size == 0:
        return None
    n_lines = nl.size + (1 if nl[-1] != arr.size - 1 else 0)
    if n_lines % 4 != 0:
        return None
    # line k spans [line_start[k], line_end[k])
    line_end = np.empty(n_lines, dtype=np.int64)
    line_end[: nl.size] = nl
    if n_lines > nl.size:
        line_end[-1] = arr.size
    line_start = np.empty(n_lines, dtype=np.int64)
    line_start[0] = 0
    line_start[1:] = line_end[: n_lines - 1] + 1
    starts = line_start.reshape(-1, 4)
    ends = line_end.reshape(-1, 4)
    # strict shape: every record starts '@', separator line starts '+',
    # len(qual) == len(seq), and no empty header/seq lines
    if not (
        np.all(arr[starts[:, 0]] == 64)
        and np.all(arr[starts[:, 2]] == 43)
        and np.all(ends[:, 3] - starts[:, 3] == ends[:, 1] - starts[:, 1])
        and np.all(ends[:, 0] > starts[:, 0])
    ):
        return None
    starts = starts.copy()
    starts[:, 0] += 1  # drop the '@' marker from the name span
    return data, starts, ends


def read_fastx_bytes(path: str):
    """Yield ``(name, seq, qual)`` with seq/qual as uint8 array views.

    Zero-decode fast path: strict 4-line fastq is scanned once with
    :func:`scan_fastq` and records are yielded as views into the single file
    buffer — no per-record string objects for sequence/quality data (the
    name IS decoded: accessions are short and downstream keying needs str).
    Falls back to :func:`read_fastx` (full readfq contract) for anything
    else; ``qual`` is then re-encoded, or None for fasta records.
    """
    import numpy as np

    scanned = scan_fastq(path)
    if scanned is not None:
        data, starts, ends = scanned
        arr = np.frombuffer(data, dtype=np.uint8)
        for r in range(starts.shape[0]):
            name = data[starts[r, 0] : ends[r, 0]].decode("ascii")
            yield (name,
                   arr[starts[r, 1] : ends[r, 1]],
                   arr[starts[r, 3] : ends[r, 3]])
        return
    for name, seq, qual in read_fastx(path):
        yield (name,
               np.frombuffer(seq.encode("ascii"), dtype=np.uint8),
               None if qual is None
               else np.frombuffer(qual.encode("ascii"), dtype=np.uint8))


def write_fastq_byte_records(path: str, records) -> None:
    """Write ``(name:str, seq:uint8 array, qual:uint8 array)`` records as
    4-line fastq without materializing per-record strings."""
    with open(path, "wb") as f:
        parts = []
        for name, seq, qual in records:
            parts.append(b"@" + name.encode("ascii") + b"\n"
                         + seq.tobytes() + b"\n+\n" + qual.tobytes() + b"\n")
        f.write(b"".join(parts))


def write_fastq_records(path: str, records) -> None:
    """Write ``(name, seq, qual)`` records as 4-line fastq."""
    with open(path, "w") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def write_fasta_records(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


def mkdir_p(path: str) -> None:
    os.makedirs(path, exist_ok=True)
