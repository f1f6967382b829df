"""Command-line interface of the PyTorch/CUDA port.

The same flags, defaults, presets, groups, subcommand and validation as
ngspeciesid_tpu/cli.py (reference NGSpeciesID:187-287).  Under a launcher
such as ``torchrun`` with NGSID_DISTRIBUTED=1, each rank runs this CLI and
the clustering stage's shards are spread over the ranks (pipeline.py).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import Config

from . import pipeline


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Reference-free clustering and consensus forming of targeted ONT or PacBio reads (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--version", action="version", version="%(prog)s 0.1.0")
    parser.add_argument("--debug", action="store_true", help="Enable debug logging")
    reads_file = parser.add_mutually_exclusive_group(required=False)
    reads_file.add_argument("--fastq", type=str, help="Path to consensus fastq file(s)")
    reads_file.add_argument("--use_old_sorted_file", action="store_true",
                            help="Use an already existing sorted file in the output directory.")
    parser.add_argument("--t", dest="nr_cores", type=int, default=8,
                        help="Number of clustering shards (merge-tree schedule)")
    parser.add_argument("--d", dest="print_output", type=int, default=10000,
                        help="Debug print interval")
    parser.add_argument("--q", dest="quality_threshold", type=float, default=7.0,
                        help="Filter reads with average phred quality below this")
    parser.add_argument("--ont", action="store_true", help="ONT reads (k=13, w=20)")
    parser.add_argument("--isoseq", action="store_true", help="PacBio Iso-Seq reads (k=15, w=50)")
    parser.add_argument("--consensus", action="store_true",
                        help="Form consensus, detect reverse complements, polish")
    parser.add_argument("--abundance_ratio", type=float, default=0.1,
                        help="Minimum cluster size as a fraction of total reads")
    parser.add_argument("--rc_identity_threshold", type=float, default=0.9,
                        help="Identity threshold for reverse-complement center merging")
    parser.add_argument("--max_seqs_for_consensus", type=int, default=-1,
                        help="Maximum reads per draft consensus (-1 = all)")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--medaka", action="store_true",
                       help="Quality-weighted (medaka-class) polishing")
    group.add_argument("--racon", action="store_true",
                       help="Count-based (racon-class) polishing")
    parser.add_argument(
        "--medaka_model", type=str, default="",
        help="Polisher model: a medaka model NAME maps to the built-in "
             "quality-weighted pileup caller (accuracy-equivalent at "
             "amplicon depth; no neural net runs — diverges from the "
             "reference, which passes the name to medaka), a PATH loads "
             "trained GRU params (models/train.py npz)")
    parser.add_argument("--medaka_fastq", action="store_true", help="Write fastq consensus output")
    parser.add_argument("--racon_iter", type=int, default=2, help="Polishing iterations")
    group2 = parser.add_mutually_exclusive_group()
    group2.add_argument("--remove_universal_tails", action="store_true",
                        help="Trim the universal tail adapters from consensus ends")
    group2.add_argument("--primer_file", type=str, default="",
                        help="Fasta of primers to trim from consensus ends")
    parser.add_argument("--primer_max_ed", type=int, default=2,
                        help="Max edit distance for primer detection")
    parser.add_argument("--trim_window", type=int, default=150,
                        help="Window at each consensus end searched for primers")
    parser.add_argument("--m", dest="target_length", type=int, default=0,
                        help="Intended amplicon length (0 = no length filter)")
    parser.add_argument("--s", dest="target_deviation", type=int, default=0,
                        help="Maximum amplicon length deviation")
    parser.add_argument("--sample_size", type=int, default=0,
                        help="Subsample this many reads (0 = all)")
    parser.add_argument("--top_reads", action="store_true",
                        help="Take the top-scoring sample_size reads instead of a random sample")
    parser.add_argument("--k", type=int, default=13, help="Kmer size")
    parser.add_argument("--w", type=int, default=20, help="Window size")
    parser.add_argument("--min_shared", type=int, default=5,
                        help="Minimum shared minimizers for candidate clusters")
    parser.add_argument("--mapped_threshold", type=float, default=0.7,
                        help="Minimum mapped fraction for cluster join")
    parser.add_argument("--aligned_threshold", type=float, default=0.4,
                        help="Minimum aligned fraction for cluster join")
    parser.add_argument("--symmetric_map_align_thresholds", action="store_true",
                        help="Also require thresholds on the representative side")
    parser.add_argument("--batch_type", type=str, default="total_nt",
                        help='Shard balancing: "total_nt", "nr_reads", or "read_lengths_squared"')
    parser.add_argument("--min_fraction", type=float, default=0.8,
                        help="Candidate pruning fraction vs best hit")
    parser.add_argument("--min_prob_no_hits", type=float, default=0.1,
                        help="Minimum probability for a minimizer gap to count as mapped")
    parser.add_argument("--outfolder", type=str, default=None, help="Output folder")
    parser.add_argument("--wave_size", type=int, default=0,
                        help="Reads scored per wave; 0 = auto "
                             "(4096 cuda / 256 otherwise)")
    parser.add_argument("--align_band", type=int, default=150,
                        help="Alignment DP band half-width (0 = full DP, reference-exact)")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed for --sample_size subsampling")
    parser.add_argument("--resume", action="store_true",
                        help="Reuse content-addressed stage artifacts (sorted reads, "
                             "clustering) when inputs and parameters are unchanged")
    parser.add_argument("--profile", action="store_true",
                        help="Write a torch.profiler trace to <outfolder>/profile "
                             "and log per-stage wall-clock at INFO")
    parser.set_defaults(which="main")

    subparsers = parser.add_subparsers(help="sub-command help")
    wf = subparsers.add_parser("write_fastq", help="write each cluster to its own fastq file")
    wf.add_argument("--clusters", type=str, help='the file "final_clusters.tsv"')
    wf.add_argument("--fastq", type=str, help="Input fastq file")
    wf.add_argument("--outfolder", type=str, help="Output folder")
    wf.add_argument("--N", type=int, default=0, help="Minimum reads per written cluster")
    wf.set_defaults(which="write_fastq")
    return parser


def args_to_config(args: argparse.Namespace) -> Config:
    cfg = Config(
        fastq=args.fastq,
        use_old_sorted_file=args.use_old_sorted_file,
        outfolder=args.outfolder,
        nr_cores=args.nr_cores,
        print_output=args.print_output,
        debug=args.debug,
        quality_threshold=args.quality_threshold,
        target_length=args.target_length,
        target_deviation=args.target_deviation,
        sample_size=args.sample_size,
        top_reads=args.top_reads,
        k=args.k,
        w=args.w,
        min_shared=args.min_shared,
        mapped_threshold=args.mapped_threshold,
        aligned_threshold=args.aligned_threshold,
        min_fraction=args.min_fraction,
        min_prob_no_hits=args.min_prob_no_hits,
        symmetric_map_align_thresholds=args.symmetric_map_align_thresholds,
        batch_type=args.batch_type,
        consensus=args.consensus,
        abundance_ratio=args.abundance_ratio,
        rc_identity_threshold=args.rc_identity_threshold,
        max_seqs_for_consensus=args.max_seqs_for_consensus,
        medaka=args.medaka,
        racon=args.racon,
        medaka_model=args.medaka_model,
        medaka_fastq=args.medaka_fastq,
        racon_iter=args.racon_iter,
        remove_universal_tails=args.remove_universal_tails,
        primer_file=args.primer_file,
        primer_max_ed=args.primer_max_ed,
        trim_window=args.trim_window,
        wave_size=args.wave_size,
        seed=args.seed,
        align_band=args.align_band,
        resume=args.resume,
        profile=args.profile,
    )
    cfg.apply_preset(ont=args.ont, isoseq=args.isoseq)
    return cfg


def main(argv=None, stage_walls=None) -> int:
    """Run the CLI on ``argv``; returns the exit code.  ``stage_walls``: an
    optional dict, the sink of the run's spans (in-process callers such as
    the benchmark and chip_smoke.py): each span's host seconds under its
    name, the count ``poa.reads``, and the older per-stage keys ``sort``,
    ``cluster``, ``consensus_polish`` and ``stage4_*`` (``pipeline.run``
    lists them)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO, format="%(message)s"
    )
    if args.which == "write_fastq":
        pipeline.write_fastq_subcommand(args.clusters, args.fastq, args.outfolder, args.N)
        logging.info("Wrote clusters to separate fastq files.")
        return 0
    if args.ont and args.isoseq:
        logging.error("Arguments mutually exclusive, specify either --isoseq or --ont.")
        return 1
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
        return 0
    if not args.fastq and not args.use_old_sorted_file:
        logging.error("one of --fastq / --use_old_sorted_file is required")
        return 1
    cfg = args_to_config(args)
    if 100 < cfg.w or cfg.w < cfg.k:
        logging.error("Please specify a window of size larger or equal to k, and smaller than 100.")
        return 1
    pipeline.run(cfg, stage_walls)
    return 0


def main_and_exit(argv=None) -> None:
    """Console-script entry: exit with main()'s code."""
    sys.exit(main(argv))


if __name__ == "__main__":
    main_and_exit()
