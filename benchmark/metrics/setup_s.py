"""Seconds from the process's start to the window: imports, the CUDA
context, the kernels' library and the warm-up library."""


def read(rec):
    return rec.setup_s
