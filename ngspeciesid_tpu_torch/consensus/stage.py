"""Stage 4: consensus, trimming, RC dedup and polishing.

Port of ngspeciesid_tpu/consensus/stage.py: the draft POA and the polish
pileup align through the moves kernel, the RC merge's column identity
through the stats kernel (on the ``cuda`` backend), and ``--medaka_model
<params npz>`` runs the GRU polisher (models/polisher.py).  It reproduces the
reference's consensus pipeline (reference NGSpeciesID:124-158,
modules/consensus.py, modules/barcode_trimmer.py) with every compute step on
our batched kernels instead of spoa/edlib/parasail/medaka/racon subprocesses.

File contract mirrored (SURVEY.md section 5):
  work_dir/reads_c_id_{c_id}.fq             cluster member reads
  outfolder/consensus_reference_{c_id}.fasta draft (or re-polished) center
  outfolder/reads_to_consensus_{c_id}.fastq  pooled polishing reads
  outfolder/medaka_cl_id_{c_id}/consensus.fasta   (--medaka)
  outfolder/racon_cl_id_{c_id}/consensus.fasta    (--racon)

Center records are mutable lists ``[nr_reads, c_id, seq, reads_paths]`` like
the reference's, including its quirks: RC-merge double-absorption is possible
(consensus.py:167-178 has no inner already_removed check) and merged read
files accumulate.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..io.fastx import mkdir_p, read_fastx, write_fastq_byte_records
from ..ops.align import identity_batch
from ..ops.edit import infix_search
from ..ops.mapping import map_reads_to_center, write_paf
from ..ops.poa import msa_consensus_batch, orient_reads, polish_round
from ..spans import span
from ..utils.seqs import (
    bytes_to_str,
    reverse_complement,
    reverse_complement_bytes,
    seq_bytes,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# draft consensus (C11)
# ---------------------------------------------------------------------------

def form_draft_consensus(
    clusters: Dict[int, List[str]],
    rep_scores: Dict[int, float],
    sorted_reads_fastq_file: str,
    work_dir: str,
    abundance_cutoff: int,
    cfg: Config,
) -> List[List]:
    """Batched-POA draft centers for clusters above the abundance cutoff
    (reference consensus.py:249-278).  All qualifying clusters run as one
    lockstep device batch."""
    from ..io.fastx import read_fastx_bytes

    reads = {acc: (seq, qual)
             for acc, seq, qual in read_fastx_bytes(sorted_reads_fastq_file)}
    centers: List[List] = []
    singletons = 0
    discarded: List[int] = []
    batch_reads: List[List[np.ndarray]] = []
    batch_meta: List[Tuple[int, int, str]] = []
    for c_id, all_read_acc in sorted(
        clusters.items(), key=lambda x: (len(x[1]), rep_scores[x[0]]), reverse=True
    ):
        nr_reads = len(all_read_acc)
        if nr_reads >= abundance_cutoff:
            reads_path = os.path.join(work_dir, f"reads_c_id_{c_id}.fq")
            cluster_seqs: List[np.ndarray] = []
            with open(reads_path, "wb") as f:
                parts = []
                for i, acc in enumerate(all_read_acc):
                    if cfg.max_seqs_for_consensus >= 0 and i >= cfg.max_seqs_for_consensus:
                        break
                    seq, qual = reads[acc]
                    parts.append(b"@" + acc.encode("ascii") + b"\n" + seq.tobytes()
                                 + b"\n+\n" + qual.tobytes() + b"\n")
                    cluster_seqs.append(seq)
                f.write(b"".join(parts))
            batch_reads.append(cluster_seqs)
            batch_meta.append((nr_reads, c_id, reads_path))
        elif nr_reads == 1:
            singletons += 1
        elif nr_reads > 1:
            discarded.append(nr_reads)
    # When a polish pass follows (it re-votes every column with ALL reads),
    # the draft profile converges after a few tens of reads — cap the
    # sequential profile rounds and let the pileup do the rest.  Without a
    # polisher the draft is the final sequence, so use everything.
    draft_cap = 30 if (cfg.medaka or cfg.racon) else -1
    consensuses = msa_consensus_batch(batch_reads, max_reads=draft_cap)
    for (nr_reads, c_id, reads_path), cons in zip(batch_meta, consensuses):
        centers.append([nr_reads, c_id, bytes_to_str(cons), reads_path])
    logger.debug("%d singletons were discarded", singletons)
    logger.debug(
        "%d clusters were discarded due to not passing the abundance_cutoff: "
        "a total of %d reads were discarded. Highest abundance among them: %d reads.",
        len(discarded), sum(discarded), max(discarded or [0]),
    )
    return centers


# ---------------------------------------------------------------------------
# primer / universal tail trimming (C12)
# ---------------------------------------------------------------------------

def read_barcodes(primer_file: str) -> Dict[str, str]:
    """Primer fasta -> {name_fw: seq, name_rc: revcomp} (barcode_trimmer.py:15-23)."""
    barcodes = {}
    for acc, seq, _ in read_fastx(primer_file):
        barcodes[acc + "_fw"] = seq.strip()
    for acc in list(barcodes.keys()):
        barcodes[acc[:-3] + "_rc"] = reverse_complement(barcodes[acc].upper())
    return barcodes


def get_universal_tails() -> Dict[str, str]:
    """Hardcoded universal tails (barcode_trimmer.py:25-31)."""
    barcodes = {
        "1_F_fw": "TTTCTGTTGGTGCTGATATTGC",
        "2_R_rc": "ACTTGCCTGTCGCTCTATCTTC",
    }
    barcodes["1_F_rc"] = reverse_complement(barcodes["1_F_fw"])
    barcodes["2_R_fw"] = reverse_complement(barcodes["2_R_rc"])
    return barcodes


def find_barcode_locations(center: str, barcodes: Dict[str, str], primer_max_ed: int):
    """All primers' first optimal infix hits (barcode_trimmer.py:34-58)."""
    hits = []
    target = seq_bytes(center)
    for acc, primer in barcodes.items():
        res = infix_search(seq_bytes(primer), target, primer_max_ed)
        if res is not None:
            start, end, ed = res
            hits.append((acc, start, end, ed))
    return hits


def remove_barcodes(centers: List[List], barcodes: Dict[str, str], cfg: Config) -> bool:
    """Trim primer hits from the first/last trim_window bases
    (barcode_trimmer.py:61-104).  Mutates center records in place."""
    centers_updated = False
    for i, (nr_reads, c_id, center, reads_path) in enumerate(centers):
        if 2 * cfg.trim_window > len(center):
            trim_window = len(center) // 2
        else:
            trim_window = cfg.trim_window
        begin_hits = find_barcode_locations(center[:trim_window], barcodes, cfg.primer_max_ed)
        end_hits = find_barcode_locations(center[-trim_window:], barcodes, cfg.primer_max_ed)
        cut_start = 0
        for _, start, stop, _ in begin_hits:
            if stop > cut_start:
                cut_start = stop
        cut_end = len(center)
        if end_hits:
            earliest = min(start for _, start, _, _ in end_hits)
            cut_end = len(center) - (trim_window - earliest)
        if cut_start > 0 or cut_end < len(center):
            centers[i][2] = center[cut_start:cut_end]
            centers_updated = True
    return centers_updated


# ---------------------------------------------------------------------------
# reverse-complement / duplicate center merge (C13)
# ---------------------------------------------------------------------------

#: Outer centers whose pair identities are aligned speculatively per device
#: batch in detect_reverse_complements.  Identity is a pure function of the
#: (center, center, orientation) triple, so batching ahead of the sequential
#: absorption walk cannot change any decision; only pairs of outers that get
#: absorbed within their own block are wasted DP.  32 outers x both
#: orientations keeps launches in the multi-thousand-pair regime where the
#: TPU kernel amortizes its link round trip (was: one shrinking batch per
#: outer center — ~200 device sync points, ~30 s at 200 centers; now ~4 s).
_RC_BLOCK = 32


def detect_reverse_complements(centers: List[List], rc_identity_threshold: float,
                               band: int = 150) -> List[List]:
    """Merge centers that align (FW or RC) above the identity threshold
    (reference consensus.py:148-183).  Pair identities are computed in
    block-speculative device batches; the absorption walk itself runs
    sequentially with the reference's exact semantics (later centers stay
    in every inner scan even when already absorbed — the reference's
    double-absorption quirk)."""
    n = len(centers)
    filtered: List[List] = []
    already_removed = set()
    s_bytes = [seq_bytes(c[2]) for c in centers]
    rc_bytes = [reverse_complement_bytes(b) for b in s_bytes]
    idents: dict = {}          # (i, j) -> [fw, rc]
    block_end = 0
    for i, (nr_reads, c_id, seq, reads_path) in enumerate(centers):
        all_reads = list(reads_path) if isinstance(reads_path, list) else [reads_path]
        merged_nr = nr_reads
        if c_id in already_removed:
            # absorbed after its block's identities were computed: drop them
            for j in range(i + 1, n):
                idents.pop((i, j), None)
            continue
        if i >= block_end:
            block_end = min(i + _RC_BLOCK, n)
            pairs, keys = [], []
            for bi in range(i, block_end):
                if centers[bi][1] in already_removed:
                    continue       # this outer will be skipped anyway
                lb = s_bytes[bi].size
                for j in range(bi + 1, n):
                    lj = s_bytes[j].size
                    # identity = matches / columns <= min(len) / max(len)
                    # (matches <= the shorter length, the alignment spans
                    # the longer incl. terminal gaps), so pairs below the
                    # threshold on length ratio alone can never merge —
                    # skip their DP, decision unchanged
                    if min(lb, lj) < rc_identity_threshold * max(lb, lj):
                        idents[(bi, j)] = [0.0, 0.0]
                        continue
                    pairs.append((s_bytes[bi], s_bytes[j]))
                    keys.append((bi, j, 0))
                    pairs.append((s_bytes[bi], rc_bytes[j]))
                    keys.append((bi, j, 1))
            vals = identity_batch(pairs, [3] * len(pairs), band=band)
            for (bi, j, o), v in zip(keys, vals):
                idents.setdefault((bi, j), [0.0, 0.0])[o] = v
        if i == n - 1:
            filtered.append([merged_nr, c_id, seq, all_reads])
            continue
        for j in range(i + 1, n):
            nr2, c_id2, seq2, rp2 = centers[j]
            # pop: each (i, j) is consumed exactly once, and keeping the
            # full O(n^2) identity table alive costs ~100 MB at 1k centers
            ident_fw, ident_rc = idents.pop((i, j))
            if max(ident_fw, ident_rc) >= rc_identity_threshold:
                merged_nr += nr2
                already_removed.add(c_id2)
                if isinstance(rp2, list):
                    all_reads.extend(rp2)
                else:
                    all_reads.append(rp2)
        filtered.append([merged_nr, c_id, seq, all_reads])
    assert not idents, f"{len(idents)} identities left unconsumed"
    logger.debug("%d consensus formed.", len(filtered))
    return filtered


# ---------------------------------------------------------------------------
# polishing drivers (C14)
# ---------------------------------------------------------------------------

#: medaka model names (reference forwards --medaka_model as medaka's -m,
#: consensus.py:100-101): basecaller-profile strings like
#: ``r941_min_high_g360`` or ``r1041_e82_400bps_sup_v4.2.0`` — any
#: ``r<digits>``-prefixed non-path token (segments of letters / digits /
#: dots separated by underscores).
_MEDAKA_NAME = re.compile(r"^r\d+[a-z0-9.]*(_[a-z0-9.]+)*$", re.IGNORECASE)


def _load_neural_polisher(medaka_model: str):
    """Resolve --medaka_model.

    * empty (reference default) -> deterministic quality-weighted pileup
      caller.
    * a known medaka model NAME (e.g. ``r941_min_high_g360``) -> also the
      deterministic caller: scripts/eval_polisher.py shows it matches the
      bundled GRU at every amplicon depth x error cell, so model names map
      to the caller rather than to an unproven net (SURVEY N6 demotion).
    * a path to trained GRU params (models/train.py npz) -> the GRU head,
      returned as ``(model, neural_polish_round)``, with the model on
      :func:`~ngspeciesid_tpu_torch.device.polisher_device`.
    * anything else -> error (never a silent fallback to a different
      polisher than the one asked for).
    """
    if not medaka_model:
        return None
    if os.path.isfile(medaka_model):
        from ..device import polisher_device, stats_backend_default
        from ..models.polisher import load_params, neural_polish_round
        device = polisher_device(stats_backend_default())
        return load_params(medaka_model, device), neural_polish_round
    if _MEDAKA_NAME.match(medaka_model):
        logger.warning(
            "medaka model %r: substituting the quality-weighted pileup "
            "caller (no neural net runs; accuracy-equivalent at amplicon "
            "depth per scripts/eval_polisher.py) — this diverges from the "
            "reference, which would pass the name through to medaka",
            medaka_model)
        return None
    raise ValueError(
        f"--medaka_model {medaka_model!r} is neither a medaka model name "
        f"nor a GRU params file (models/train.py npz)")


#: Polishing depth cap: beyond ~1000x the pileup plurality is statistically
#: saturated, so centers of huge clusters subsample uniformly for the polish
#: alignments (the full read set is still written to reads_to_consensus_*).
POLISH_MAX_READS = 1000


def _pooled_reads(all_reads_files: Sequence[str]):
    """Pool member reads of (possibly merged) clusters, dict-dedup by
    accession like the reference (consensus.py:210-215).  seq/qual stay
    uint8 buffer views end-to-end."""
    from ..io.fastx import read_fastx_bytes

    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    records = []
    for path in all_reads_files:
        reads = {acc: (seq, qual) for acc, seq, qual in read_fastx_bytes(path)}
        for acc, (seq, qual) in reads.items():
            records.append((acc.split()[0], seq, qual))
            seqs.append(seq)
            quals.append(qual)
    return records, seqs, quals


def _polish_subset(seqs, quals):
    """Uniformly spaced subsample for polishing above the depth cap;
    returns (seqs, quals, source indices)."""
    n = len(seqs)
    if n <= POLISH_MAX_READS:
        return seqs, quals, list(range(n))
    idx = np.linspace(0, n - 1, POLISH_MAX_READS).astype(np.int64)
    return [seqs[i] for i in idx], [quals[i] for i in idx], idx.tolist()


def polish_sequences(centers: List[List], cfg: Config) -> List[List]:
    """Polish every center with the pileup polisher, writing the
    reference's file layout (consensus.py:186-246).  A GRU params file is
    loaded (and checked) once, before any center is polished."""
    neural = _load_neural_polisher(cfg.medaka_model) if cfg.medaka else None
    if cfg.medaka:
        pattern = os.path.join(cfg.outfolder, "medaka_cl_id_*")
    elif cfg.racon:
        pattern = os.path.join(cfg.outfolder, "racon_cl_id_*")
    else:
        pattern = None
    with span("polish.files"):
        if pattern:
            for folder in glob.glob(pattern):
                shutil.rmtree(folder)
        for f in glob.glob(os.path.join(cfg.outfolder, "consensus_reference_*")):
            os.remove(f)

    for i, (nr_reads, c_id, center, all_reads) in enumerate(centers):
        with span("polish.files"):
            ref_file = os.path.join(cfg.outfolder, f"consensus_reference_{c_id}.fasta")
            with open(ref_file, "w") as f:
                f.write(f">consensus_cl_id_{c_id}_total_supporting_reads_{nr_reads}\n{center}\n")
            records, seqs, quals = _pooled_reads(all_reads)
            all_reads_file = os.path.join(cfg.outfolder, f"reads_to_consensus_{c_id}.fastq")
            write_fastq_byte_records(all_reads_file, records)

        if cfg.medaka:
            outdir = os.path.join(cfg.outfolder, f"medaka_cl_id_{c_id}")
            mkdir_p(outdir)
            logger.debug("polishing (medaka-class) center %s with %d reads", c_id, len(records))
            polished = seq_bytes(center)
            p_seqs, p_quals, _ = _polish_subset(seqs, quals)
            # RC-merged centers pool both orientations (consensus.py:167-180);
            # the reference's minimap2-driven polishers are strand-aware, so
            # flip reverse-strand reads before the pileup
            p_seqs, p_quals, _ = orient_reads(polished, p_seqs, p_quals)
            if neural is not None:
                model, neural_round = neural
                polished = polish_round(polished, p_seqs, p_quals)
                polished = neural_round(model, polished, p_seqs, p_quals)
            else:
                for _ in range(2):
                    polished = polish_round(polished, p_seqs, p_quals)
            centers[i][2] = bytes_to_str(polished)
            name = f"consensus_cl_id_{c_id}_total_supporting_reads_{nr_reads}"
            with span("polish.files"):
                if cfg.medaka_fastq:
                    with open(os.path.join(outdir, "consensus.fastq"), "w") as f:
                        f.write(f"@{name}\n{centers[i][2]}\n+\n{'I' * len(centers[i][2])}\n")
                else:
                    with open(os.path.join(outdir, "consensus.fasta"), "w") as f:
                        f.write(f">{name}\n{centers[i][2]}\n")
        elif cfg.racon:
            outdir = os.path.join(cfg.outfolder, f"racon_cl_id_{c_id}")
            mkdir_p(outdir)
            logger.debug("polishing (racon-class) center %s with %d reads", c_id, len(records))
            polished = seq_bytes(center)
            p_seqs, _, p_idx = _polish_subset(seqs, quals)
            p_names = [records[i][0] for i in p_idx]
            p_seqs, _, _ = orient_reads(polished, p_seqs)
            for it in range(cfg.racon_iter):
                # per-iteration read->center PAF, the reference's minimap2
                # observability artifact (consensus.py:118-121); the polish
                # itself aligns reads exactly with the batched DP
                with span("poa.orient"):
                    mappings = map_reads_to_center(polished, p_seqs)
                with span("polish.files"):
                    write_paf(
                        os.path.join(outdir, f"mapping_it_{it}.paf"),
                        p_names, mappings,
                        f"consensus_cl_id_{c_id}")
                polished = polish_round(polished, p_seqs)
                with span("polish.files"):
                    with open(os.path.join(outdir, f"racon_polished_it_{it}.fasta"), "w") as f:
                        f.write(f">consensus_cl_id_{c_id}\n{bytes_to_str(polished)}\n")
            centers[i][2] = bytes_to_str(polished)
            with span("polish.files"):
                with open(os.path.join(outdir, "consensus.fasta"), "w") as f:
                    f.write(f">consensus_cl_id_{c_id}\n{centers[i][2]}\n")
    return centers


# ---------------------------------------------------------------------------
# full stage driver (C11-C15; reference NGSpeciesID:124-158)
# ---------------------------------------------------------------------------

def run_consensus_stage(
    clusters: Dict[int, List[str]],
    rep_scores: Dict[int, float],
    sorted_reads_fastq_file: str,
    work_dir: str,
    abundance_cutoff: int,
    cfg: Config,
) -> List[List]:
    """The phases, each in its span: ``stage4.draft``, ``stage4.trim``,
    ``stage4.rc`` and ``stage4.polish`` (summed over the post-polish
    recheck)."""
    with span("stage4.draft"):
        centers = form_draft_consensus(clusters, rep_scores,
                                       sorted_reads_fastq_file, work_dir,
                                       abundance_cutoff, cfg)
    barcodes = None
    if cfg.primer_file or cfg.remove_universal_tails:
        barcodes = (
            get_universal_tails() if cfg.remove_universal_tails
            else read_barcodes(cfg.primer_file)
        )
        with span("stage4.trim"):
            remove_barcodes(centers, barcodes, cfg)
    logger.debug("%d centers formed", len(centers))
    with span("stage4.rc"):
        centers_filtered = detect_reverse_complements(
            centers, cfg.rc_identity_threshold, band=cfg.align_band)
    with span("stage4.polish"):
        centers_polished = polish_sequences(centers_filtered, cfg)
    if barcodes is not None:
        # post-polish recheck (reference NGSpeciesID:148-152)
        with span("stage4.trim"):
            trimmed = remove_barcodes(centers_polished, barcodes, cfg)
        if trimmed:
            with span("stage4.rc"):
                centers_filtered = detect_reverse_complements(
                    centers_polished, cfg.rc_identity_threshold,
                    band=cfg.align_band)
            with span("stage4.polish"):
                centers_polished = polish_sequences(centers_filtered, cfg)
    return centers_polished
