"""Empirical shared-minimizer probability table.

Monte-Carlo estimates of P(two reads from the same template share a
minimizer) indexed by (k, w, e1, e2); the behavioural contract loads the
table at startup and keeps entries with ``k == args.k`` and
``|w - args.w| <= 2``, inserting both (e1,e2) and (e2,e1)
(reference NGSpeciesID:72-77).  Lookups clamp error rates to [0.01, 0.15]
and round to 2 decimals (reference cluster.py:356-368).

Shipped as a compressed npz asset (see scripts/make_ptable_asset.py /
scripts/generate_p_table.py).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

_ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "p_minimizers.npz")


def load_p_table(k: int, w: int, asset_path: str = _ASSET) -> Dict[Tuple[float, float], float]:
    """Filtered {(e1, e2): p} dict for the given minimizer parameters."""
    data = np.load(asset_path)
    mask = (data["k"] == k) & (np.abs(data["w"].astype(np.int64) - w) <= 2)
    out: Dict[Tuple[float, float], float] = {}
    for e1, e2, p in zip(data["e1"][mask], data["e2"][mask], data["p"][mask]):
        out[(float(e1), float(e2))] = float(p)
        out[(float(e2), float(e1))] = float(p)
    return out


def clamp_error_rate(e: float) -> float:
    """Round-then-clamp, matching reference cluster.py:356-366 op order."""
    e = round(e, 2)
    if e > 0.15:
        e = 0.15
    if e < 0.01:
        e = 0.01
    return e


def p_shared_minimizer(
    error_rate_read: float, error_rate_center: float, p_table: Dict[Tuple[float, float], float]
) -> float:
    return p_table[(clamp_error_rate(error_rate_read), clamp_error_rate(error_rate_center))]


def p_table_as_matrix(p_table: Dict[Tuple[float, float], float]) -> np.ndarray:
    """Dense 15x15 matrix P[i, j] for e = 0.01*(i+1), used by device kernels."""
    m = np.zeros((15, 15), dtype=np.float64)
    for (e1, e2), p in p_table.items():
        i = int(round(e1 * 100)) - 1
        j = int(round(e2 * 100)) - 1
        if 0 <= i < 15 and 0 <= j < 15:
            m[i, j] = p
    return m
