"""ngspeciesid_tpu_torch — the PyTorch/CUDA port of ngspeciesid_tpu.

Runs stages 1-3 of the pipeline (score and sort the reads, then greedy
minimizer clustering, single pass or merge tree) with the same flags and the
same output files as the JAX package, which stays the reference.  Every
fallback alignment of the clustering engine runs in a hand-written CUDA
kernel (``csrc/stats_kernel.cu``) on an NVIDIA Hopper card.

This package imports ``torch`` and never ``jax``.  Modules whose import chain
holds no JAX are shared with the reference instead of copied: ``config``,
``io.fastx``, ``preprocess``, ``cluster.store``, ``utils.*``,
``ops.score``, ``ops.minimizers``, ``artifacts`` and ``native``.  The copies
keep the reference's module names:

  device.py           stats backend choice (NGSID_STATS_BACKEND) and device
  ops/align.py        numpy alignment oracle and the stats dispatch
  ops/align_stats.py  host side of the stats DP, its plain PyTorch version
                      and the kernel wrapper
  ops/cuda_lib.py     nvcc build and ctypes load of csrc/*.cu
  cluster/engine.py   wave-batched greedy clustering engine
  parallel/merge.py   merge-tree schedule (--t N)
  pipeline.py, cli.py stages 1-3 and the command line
"""

__version__ = "0.1.0"
