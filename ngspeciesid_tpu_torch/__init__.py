"""ngspeciesid_tpu_torch — the PyTorch/CUDA port of ngspeciesid_tpu.

Runs the whole pipeline (score and sort the reads; greedy minimizer
clustering, single pass or merge tree; with --consensus, the draft POA,
primer / universal-tail trim, reverse-complement merge and pileup polish,
and with --medaka_model <npz> the GRU polisher) with the same flags and the
same output files as the JAX package, which stays the reference; with
NGSID_DISTRIBUTED=1 it spreads the clustering over a launcher's ranks; it
also trains the GRU polisher and carries the offline evaluation tools.  Every
alignment runs in a hand-written CUDA kernel on an NVIDIA Hopper card: the
clustering statistics and the RC-merge identity in
``csrc/stats_kernel.cu``, the draft, polish and training-label alignments
in ``csrc/moves_kernel.cu``, and the full unbanded DP of
``ops/align_full.py`` in ``csrc/full_dp_kernel.cu``, all three on
``csrc/wavefront.cuh``.  The GRU runs in ``nn.GRU`` (cuDNN on the card).

This package imports ``torch``, never ``jax``, and nothing of the JAX
package: the JAX-free modules it needs are copies that keep the reference's
relative paths (``config``, ``utils/*``, ``data/p_minimizers.npz``,
``io/fastx``, ``io/bam``, ``native`` with ``sgdp.cpp``, ``ops/{score,
minimizers,edit,mapping}``, ``cluster/store``, ``preprocess``,
``artifacts``, ``eval``); ``simulate``, ``quality`` and
``generate_p_table`` are scripts/simulate_reads.py,
scripts/compute_cluster_quality.py and scripts/generate_p_table.py.  The
ported modules:

  device.py            backend choice (NGSID_STATS_BACKEND) and device
  ops/align.py         numpy alignment oracle and the backend dispatch
  ops/align_stats.py   host side of the stats DP, its plain PyTorch version
                       and the kernel wrapper
  ops/align_moves.py   host side of the moves DP, its plain PyTorch version
                       and the kernel wrapper
  ops/align_full.py    the full unbanded DP's entry point, its plain
                       version and the kernel wrapper
  ops/cuda_lib.py      nvcc build and ctypes load of csrc/*.cu
  ops/poa.py           draft POA and polish pileup
  cluster/engine.py    wave-batched greedy clustering engine
  parallel/merge.py    merge-tree schedule (--t N)
  parallel/dist.py     the merge tree over ranks (NGSID_DISTRIBUTED=1):
                       gloo all-gathers, rank threads, process launch
  consensus/stage.py   stage 4: draft, trim, RC merge, polish drivers
  models/polisher.py   the GRU polisher: JAX weights carry-over both ways,
                       serving, loss and Adam train step
  models/train.py      GRU training on synthetic amplicons
  eval_polisher.py     the GRU against the deterministic caller, on a grid
  graft_entry.py       driver entry points: the GRU forward, and a data-
                       and tensor-parallel dry run with the clustering
  pipeline.py, cli.py  the stages and the command line
  stage_profile.py     stage walls, host profile and device time on a GPU
"""

__version__ = "0.1.0"
