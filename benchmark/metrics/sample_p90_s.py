"""90th percentile (linear between order statistics) of the per-library
wall, ``cli.main`` call to return, over the window's libraries."""

import numpy as np


def read(rec):
    walls = [lib.wall for lib in rec.libraries]
    return float(np.percentile(walls, 90)) if walls else None
