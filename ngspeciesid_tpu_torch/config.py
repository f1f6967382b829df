"""Pipeline configuration.

One dataclass mirroring the reference CLI surface (reference NGSpeciesID:187-246)
so every stage takes a single typed config instead of an argparse namespace.
Defaults reproduce the behavioural contract exactly (SURVEY.md section 5 table).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # I/O
    fastq: Optional[str] = None
    use_old_sorted_file: bool = False
    outfolder: Optional[str] = None

    # Execution
    nr_cores: int = 8                 # --t: batch/shard count for merge clustering
    print_output: int = 10000         # --d: progress heartbeat interval
    debug: bool = False

    # Read filtering
    quality_threshold: float = 7.0    # --q
    target_length: int = 0            # --m
    target_deviation: int = 0         # --s
    sample_size: int = 0
    top_reads: bool = False

    # Minimizer / clustering parameters
    k: int = 13
    w: int = 20
    min_shared: int = 5
    mapped_threshold: float = 0.7
    aligned_threshold: float = 0.4
    min_fraction: float = 0.8
    min_prob_no_hits: float = 0.1
    symmetric_map_align_thresholds: bool = False
    batch_type: str = "total_nt"

    # Consensus / polishing
    consensus: bool = False
    abundance_ratio: float = 0.1
    rc_identity_threshold: float = 0.9
    max_seqs_for_consensus: int = -1
    medaka: bool = False
    racon: bool = False
    medaka_model: str = ""
    medaka_fastq: bool = False
    racon_iter: int = 2

    # Primer / tail trimming
    remove_universal_tails: bool = False
    primer_file: str = ""
    primer_max_ed: int = 2
    trim_window: int = 150

    # TPU execution knobs (no reference analog)
    wave_size: int = 0                # reads scored per wave; 0 = auto (256
                                      # native / 4096 pallas, engine.py)
    seed: int = 0                     # RNG seed for subsampling (reference is unseeded)
    align_band: int = 150             # DP band half-width (0 = full/reference-exact DP)
    resume: bool = False              # content-addressed stage artifact reuse
    profile: bool = False             # torch.profiler trace + INFO stage timings

    def apply_preset(self, ont: bool = False, isoseq: bool = False) -> None:
        """--ont / --isoseq k,w presets (reference NGSpeciesID:261-269)."""
        if isoseq:
            self.k, self.w = 15, 50
        elif ont:
            self.k, self.w = 13, 20

    def validate(self) -> None:
        if 100 < self.w or self.w < self.k:
            raise ValueError(
                "Please specify a window of size larger or equal to k, and smaller than 100."
            )
