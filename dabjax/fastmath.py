"""LUT-based fast atan2 — the ``compAtan`` utility's analog
(``src/various/Xtan2.cpp``, unused by the reference's main path too).

The production demod uses ``jnp.angle``; this table-quantized variant exists for capability
parity and for host-side code that wants the reference's exact
quantization behavior (256-entry quarter table over ``y/x``).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["comp_atan2", "ATAN_TABLE_SIZE"]

ATAN_TABLE_SIZE = 256


@functools.lru_cache(maxsize=None)
def _table() -> np.ndarray:
    r = np.arange(ATAN_TABLE_SIZE + 1) / ATAN_TABLE_SIZE
    return np.arctan(r).astype(np.float32)


def comp_atan2(y, x):
    """Quantized atan2(y, x) in (-pi, pi]; vectorized over numpy arrays.

    Quadrant logic mirrors compAtan::atan2: the first octant comes from
    the table on ``min/max`` ratio, the rest by reflection.
    """
    y = np.asarray(y, np.float32)
    x = np.asarray(x, np.float32)
    tab = _table()
    ax, ay = np.abs(x), np.abs(y)
    big = np.maximum(ax, ay)
    small = np.minimum(ax, ay)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(big > 0, small / big, 0.0)
    base = tab[np.round(ratio * ATAN_TABLE_SIZE).astype(np.int64)]
    oct1 = np.where(ay > ax, np.float32(np.pi / 2) - base, base)
    q2 = np.where(x >= 0, oct1, np.float32(np.pi) - oct1)
    return np.where(y >= 0, q2, -q2).astype(np.float32)
