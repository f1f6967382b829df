"""What the harness records of the program, from its own files.

The program is driven through ``cli.main``; these wrappers sit on its public
seams for the length of a run:

* every call of the two DP wrappers, ``align_stats.sg_stats_pool_torch``
  and ``align_moves.sg_moves_pool_torch``: its inputs and outputs, kept for
  the libraries that the check samples (``keep``: the largest library of
  the window and a seeded sample of the others, chosen as libraries end),
  and for every library its pairs' lengths and band (``launches``), which
  the roofline reads;
* every clustering pass (``reads_to_clusters`` as ``pipeline`` and the
  merge tree call it): the reads it was given in order, those it skipped as
  already in the carried database, and its decision for each read, as a few
  arrays a pass.

Inside a library's call the wrappers only keep references and copy read ids;
what is not sampled is let go between libraries, outside the timed calls.
With ``ranges`` they also open a ``torch.profiler.record_function`` range
around each layer's entry, so that a trace can say where the host was.
Recording adds no device work.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass
class Call:
    """One call of a DP wrapper."""
    kind: str                 # "stats" or "moves"
    lib: int
    seqs: Any
    rows1: list
    rows2: list
    gap_opens: list
    ks: Optional[list]
    match_ids: Optional[list]
    scoring: tuple            # (match, mismatch, gap_ext)
    band: int
    out: list
    ids: Optional[np.ndarray] = None   # read id of each row (clustering)


@dataclass
class Pass:
    """One clustering pass: read ids in order, whether each was skipped,
    and each read's decision (the representative it joined, -1 for a new
    representative, -2 for none; -3 where skipped)."""
    lib: int
    ids: np.ndarray
    skipped: np.ndarray
    decision: np.ndarray
    alive: np.ndarray

    @property
    def decisions(self) -> Dict[int, int]:
        keep = ~self.skipped
        return dict(zip(self.ids[keep].tolist(),
                        self.decision[keep].tolist()))


@dataclass
class Launch:
    """A DP call's pairs, by their lengths."""
    kind: str
    lib: int
    len1: np.ndarray
    len2: np.ndarray
    band: int


@dataclass
class Recorder:
    keep: int = 3
    seed: int = 0
    lib: int = -1
    calls: List[Call] = field(default_factory=list)
    passes: List[Pass] = field(default_factory=list)
    launches: List[Launch] = field(default_factory=list)
    _reads: Dict[int, int] = field(default_factory=dict)
    _store_ids: Dict[int, np.ndarray] = field(default_factory=dict)
    _undo: List[Callable[[], None]] = field(default_factory=list)

    def new_library(self, index: int) -> None:
        self.lib = index
        self._store_ids.clear()

    def _priority(self, index: int) -> float:
        return float(np.random.default_rng(
            [self.seed % (1 << 64), 78, index]).random())

    def end_library(self, reads: int) -> None:
        """Between libraries: the lengths of the library's calls, then its
        calls kept only while it is the largest library so far or among
        the ``keep - 1`` others of lowest seeded priority."""
        index = self.lib
        for c in self.calls:
            if c.lib == index:
                self.launches.append(Launch(
                    c.kind, index,
                    np.fromiter((c.seqs[r].size for r in c.rows1), np.int64),
                    np.fromiter((c.seqs[r].size for r in c.rows2), np.int64),
                    c.band))
        self._reads[index] = reads
        if len(self._reads) > self.keep:
            largest = max(self._reads, key=lambda i: (self._reads[i], -i))
            rest = sorted(set(self._reads) - {largest}, key=self._priority)
            for i in rest[self.keep - 1:]:
                del self._reads[i]
            self.calls = [c for c in self.calls if c.lib in self._reads]
        self._store_ids.clear()

    @property
    def sampled(self) -> List[int]:
        """The libraries whose calls are kept."""
        return sorted(self._reads)

    # -- patching ----------------------------------------------------------

    def _patch(self, module, name: str, make) -> None:
        real = getattr(module, name)
        setattr(module, name, make(real))
        self._undo.append(lambda: setattr(module, name, real))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def install(self, ranges: bool = False) -> None:
        """Wrap the program's seams (``ranges``: and its layers, in profiler
        ranges)."""
        from ngspeciesid_tpu_torch import pipeline
        from ngspeciesid_tpu_torch.cluster import engine
        from ngspeciesid_tpu_torch.consensus import stage
        from ngspeciesid_tpu_torch.ops import align_moves, align_stats
        from ngspeciesid_tpu_torch.parallel import merge

        rf = _range if ranges else None
        self._patch(align_stats, "sg_stats_pool_torch",
                    lambda real: self._stats(real, rf))
        self._patch(align_moves, "sg_moves_pool_torch",
                    lambda real: self._moves(real, rf))
        for mod in (pipeline, merge):
            self._patch(mod, "reads_to_clusters", self._pass)
        if not ranges:
            return
        for mod, name, label in (
                (pipeline, "score_and_sort", "stage1.sort"),
                (pipeline, "cluster_read_array", "stage23.cluster"),
                (pipeline, "write_cluster_tables", "stage3.tables"),
                (engine, "_decide_waves", "cluster.decide"),
                (engine, "_run_alignments", "cluster.align"),
                (engine, "_conflict_positions", "cluster.conflict"),
                (stage, "form_draft_consensus", "stage4.draft"),
                (stage, "remove_barcodes", "stage4.trim"),
                (stage, "detect_reverse_complements", "stage4.rc"),
                (stage, "polish_sequences", "stage4.polish")):
            self._patch(mod, name, lambda real, label=label: _ranged(real, label))

    # -- wrappers ----------------------------------------------------------

    def _stats(self, real, rf):
        def call(seqs, rows1, rows2, gap_opens, ks, match_ids, match=2,
                 mismatch=-2, gap_ext=1, band=0, device=None):
            with (rf("ops.stats") if rf else contextlib.nullcontext()):
                out = real(seqs, rows1, rows2, gap_opens, ks, match_ids,
                           match=match, mismatch=mismatch, gap_ext=gap_ext,
                           band=band, device=device)
            self.calls.append(Call("stats", self.lib, seqs, list(rows1),
                                   list(rows2), list(gap_opens), list(ks),
                                   list(match_ids), (match, mismatch, gap_ext),
                                   band, out, self._store_ids.get(id(seqs))))
            return out
        return call

    def _moves(self, real, rf):
        def call(seqs, rows1, rows2, gap_opens, match=2, mismatch=-2,
                 gap_ext=1, band=0, device=None):
            with (rf("ops.moves") if rf else contextlib.nullcontext()):
                out = real(seqs, rows1, rows2, gap_opens, match=match,
                           mismatch=mismatch, gap_ext=gap_ext, band=band,
                           device=device)
            self.calls.append(Call("moves", self.lib, seqs, list(rows1),
                                   list(rows2), list(gap_opens), None, None,
                                   (match, mismatch, gap_ext), band, out))
            return out
        return call

    def _pass(self, real):
        def call(store, clusters, rep_rows, gap_table, cfg, carried_db=None,
                 skip_batch_index=None, new_batch_index=1):
            rows = np.asarray(rep_rows, dtype=np.int64)
            ids = np.asarray(store.ids[rows], np.int64)
            if skip_batch_index is None:
                skipped = np.zeros(ids.size, bool)
            else:
                skipped = np.asarray(store.batch_indices[rows]
                                     == skip_batch_index, bool)
            accs = [store.accs[r] for r in rows.tolist()]
            self._store_ids[id(store.seq_b)] = store.ids
            out = real(store, clusters, rep_rows, gap_table, cfg,
                       carried_db=carried_db,
                       skip_batch_index=skip_batch_index,
                       new_batch_index=new_batch_index)
            owner = {a: key for key, members in out[0].items()
                     for a in members}
            decision = np.full(ids.size, -3, np.int64)
            for n, (rid, acc, skip) in enumerate(zip(ids.tolist(), accs,
                                                     skipped.tolist())):
                if not skip:
                    key = owner.get(acc)
                    decision[n] = -1 if key == rid else (
                        -2 if key is None else int(key))
            self.passes.append(Pass(self.lib, ids, skipped, decision,
                                    np.asarray(out[1], np.int64)))
            return out
        return call


def _range(label: str):
    import torch

    return torch.profiler.record_function(label)


def _ranged(real, label: str):
    def call(*args, **kwargs):
        with _range(label):
            return real(*args, **kwargs)
    return call
