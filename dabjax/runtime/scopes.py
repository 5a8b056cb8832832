"""Terminal scope rendering: spectrum + IQ constellation as text.

The reference draws these with Qwt widgets (``scopes-qwt6/scope.cpp``
spectrum/waterfall, ``iqdisplay.cpp:34-100`` constellation scatter); this
receiver is headless, so the same taps — ``Metrics.spectrum``
(mean PRS magnitude, fftshifted) and ``Metrics.constellation`` (one data
symbol's DQPSK points) — render as Unicode block graphics for
``dabjax info --scope`` / ``--watch``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_spectrum", "render_constellation", "render_waterfall"]

_BARS = " ▁▂▃▄▅▆▇█"


def render_spectrum(spectrum: np.ndarray, width: int = 78,
                    height: int = 8, floor_db: float = -50.0) -> str:
    """Log-magnitude spectrum as a bar chart (``height`` text rows).

    ``spectrum``: magnitude bins, DC-centred (the receiver's tap).  Each
    column is the peak of its bin span, scaled to [floor_db, 0] dB
    relative to the maximum — the reference scope's dB view
    (spectrum-scope semantics, scope.cpp).
    """
    spec = np.asarray(spectrum, np.float64)
    if spec.size == 0 or not np.isfinite(spec).any():
        return "(no spectrum)"
    edges = np.linspace(0, spec.size, width + 1).astype(int)
    cols = np.array([spec[a:b].max() if b > a else 0.0
                     for a, b in zip(edges[:-1], edges[1:])])
    ref = cols.max()
    if ref <= 0:
        return "(no spectrum)"
    db = 20 * np.log10(np.maximum(cols / ref, 1e-12))
    # each column maps to height*8 sub-levels of block characters
    level = np.clip((db - floor_db) / -floor_db, 0, 1) * height * 8
    rows = []
    for r in range(height - 1, -1, -1):
        chars = np.clip(level - r * 8, 0, 8).astype(int)
        rows.append("".join(_BARS[c] for c in chars))
    rows.append("-" * width)
    lo = -width // 2
    label = f"{lo} bins".ljust(width // 2) + f"+{width + lo} bins"
    rows.append(label[:width])
    return "\n".join(rows)


def render_waterfall(history, width: int = 78,
                     floor_db: float = -50.0) -> str:
    """Scrolling spectrum history (newest row at the bottom).

    ``history``: iterable of magnitude-spectrum taps, oldest first — the
    time-history panel of the reference's scope widget (scope.cpp:384
    region keeps a scrolling waterfall under the live spectrum).  Each
    row is one block's spectrum rendered as intensity shades on the same
    dB scale as :func:`render_spectrum`.
    """
    shades = " .:-=+*#%@"
    rows = []
    for spec in history:
        spec = np.asarray(spec, np.float64)
        if spec.size == 0 or not np.isfinite(spec).any():
            continue
        edges = np.linspace(0, spec.size, width + 1).astype(int)
        cols = np.array([spec[a:b].max() if b > a else 0.0
                         for a, b in zip(edges[:-1], edges[1:])])
        ref = cols.max()
        if ref <= 0:
            continue
        db = 20 * np.log10(np.maximum(cols / ref, 1e-12))
        lvl = (np.clip((db - floor_db) / -floor_db, 0, 1)
               * (len(shades) - 1)).astype(int)
        rows.append("".join(shades[v] for v in lvl))
    if not rows:
        return "(no waterfall history)"
    return "\n".join(rows)


def render_constellation(points: np.ndarray, size: int = 21,
                         clip: float = 1.6) -> str:
    """DQPSK constellation scatter (square text grid).

    ``points``: complex soft symbols (unit circle nominal).  Density per
    cell renders as ``.:*#@`` — the iqdisplay.cpp scatter, one character
    per bucket.  Axes cross at 0; the four decision quadrants of a clean
    signal show as four clusters.
    """
    pts = np.asarray(points).ravel()
    pts = pts[np.isfinite(pts.real) & np.isfinite(pts.imag)]
    if pts.size == 0:
        return "(no constellation)"
    ix = np.clip(((pts.real + clip) / (2 * clip) * size), 0,
                 size - 1).astype(int)
    iy = np.clip(((clip - pts.imag) / (2 * clip) * size), 0,
                 size - 1).astype(int)
    grid = np.zeros((size, size), int)
    np.add.at(grid, (iy, ix), 1)
    shades = " .:*#@"
    mx = grid.max()
    rows = []
    mid = size // 2
    for y in range(size):
        row = []
        for x in range(size):
            n = grid[y, x]
            if n == 0:
                row.append("|" if x == mid else
                           ("-" if y == mid else " "))
            else:
                row.append(shades[min(1 + (4 * n) // max(mx, 1), 5)])
        rows.append("".join(row) + ("" if y != mid else "  re"))
    return "\n".join(rows) + "\n" + " " * mid + "im"
