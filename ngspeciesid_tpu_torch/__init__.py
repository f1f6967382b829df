"""ngspeciesid_tpu_torch — the PyTorch/CUDA port of ngspeciesid_tpu.

Runs the whole pipeline (score and sort the reads; greedy minimizer
clustering, single pass or merge tree; with --consensus, the draft POA,
primer / universal-tail trim, reverse-complement merge and pileup polish)
with the same flags and the same output files as the JAX package, which
stays the reference.  Every alignment runs in a hand-written CUDA kernel on
an NVIDIA Hopper card: the clustering statistics and the RC-merge identity
in ``csrc/stats_kernel.cu``, the draft and polish alignments in
``csrc/moves_kernel.cu``.

This package imports ``torch``, never ``jax``, and nothing of the JAX
package: the JAX-free modules it needs are copies that keep the reference's
relative paths (``config``, ``utils/*``, ``data/p_minimizers.npz``,
``io/fastx``, ``native`` with ``sgdp.cpp``, ``ops/{score,minimizers,edit,
mapping}``, ``cluster/store``, ``preprocess``, ``artifacts``; ``simulate``
is scripts/simulate_reads.py).  The ported modules:

  device.py            backend choice (NGSID_STATS_BACKEND) and device
  ops/align.py         numpy alignment oracle and the backend dispatch
  ops/align_stats.py   host side of the stats DP, its plain PyTorch version
                       and the kernel wrapper
  ops/align_moves.py   host side of the moves DP, its plain PyTorch version
                       and the kernel wrapper
  ops/cuda_lib.py      nvcc build and ctypes load of csrc/*.cu
  ops/poa.py           draft POA and polish pileup
  cluster/engine.py    wave-batched greedy clustering engine
  parallel/merge.py    merge-tree schedule (--t N)
  consensus/stage.py   stage 4: draft, trim, RC merge, polish drivers
  pipeline.py, cli.py  the stages and the command line
  stage_profile.py     stage walls, host profile and device time on a GPU
"""

__version__ = "0.1.0"
