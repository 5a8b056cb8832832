"""MSC time de-interleaver (ETSI EN 300 401 §12).

The reference keeps a 16-deep per-bit delay line updated one CIF at a time
(``dab-concurrent.cpp:41-43,162-175``).  Here the whole de-interleave over a
*block* of consecutive CIFs is one static gather:

    out[t, i] = in[t - DELAYS[i mod 16], i]

which XLA turns into 16 strided slices — no sequential state at all.  The
caller supplies 15 CIFs of history (or accepts the 15-CIF warm-up skip the
reference also has, dab-concurrent.cpp:172-175).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["DELAYS", "time_deinterleave", "HISTORY"]

#: Receive-side delay per bit index mod 16 (dab-concurrent.cpp:41-43).
DELAYS = np.array([15, 7, 11, 3, 13, 5, 9, 1, 14, 6, 10, 2, 12, 4, 8, 0])
#: CIFs of history needed for a fully-primed de-interleave.
HISTORY = 15


def time_deinterleave(subch_soft: jnp.ndarray) -> jnp.ndarray:
    """De-interleave a block of consecutive CIF slices of one subchannel.

    ``subch_soft``: [..., T, n_bits] soft bits, T consecutive CIFs (T > 15);
    leading batch dims (e.g. subchannels) pass through.
    Returns [..., T - 15, n_bits]: output t corresponds to input CIF t + 15
    (fully primed; logical frame t+15's output mixes inputs t..t+15).

    out[t, i] = in[t + 15 - DELAYS[i mod 16], i]: bits sharing i mod 16
    share a delay, so the whole de-interleave is 16 *static time slices*
    of the [..., T, n/16, 16] view stacked back together, in place of a
    2-D gather.
    """
    T, n = subch_soft.shape[-2:]
    x = subch_soft.reshape(subch_soft.shape[:-1] + (n // 16, 16))
    cols = [x[..., HISTORY - DELAYS[j]: T - DELAYS[j], :, j]
            for j in range(16)]
    out = jnp.stack(cols, axis=-1)              # [..., T-15, n/16, 16]
    return out.reshape(subch_soft.shape[:-2] + (T - HISTORY, n))
