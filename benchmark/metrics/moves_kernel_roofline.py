"""The moves kernel's share of its roofline, in %: the least time of the
window's moves launches (``roofline.least_seconds`` from each call's pair
lengths and band, as the harness records them) over their device time in the trace (kernels whose name
holds ``MovesK``, the kernel's policy type)."""

from benchmark.roofline import least_seconds

KIND, NEEDLE = "moves", "MovesK"


def read(rec):
    if rec.trace is None:
        return None
    least = 0.0
    for c in rec.calls:
        if c.kind == KIND and c.len1.size:
            least += least_seconds(KIND, c.len1, c.len2, c.band)
    device = rec.trace.kernel_seconds(NEEDLE)
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
