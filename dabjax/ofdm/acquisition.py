"""Frame acquisition: null-symbol detection and PRS time synchronization.

Block-batched replacement for the reference's goto-state-machine
(``ofdm-processor.cpp:274-468``).  Instead of pulling one sample at a time
and branching, whole IQ blocks are scanned with vectorized reductions:

* null detection: 50-sample moving-average envelope; a dip below
  0.40 x signal level followed by a rise above 0.75 x marks the null
  (notSynced/SyncOnNull/SyncOnEndNull semantics, ofdm-processor.cpp:280-338)
* fine time sync: circular cross-correlation with the PRS time-domain
  reference via FFT (phasereference.cpp:60-88), batched over frames;
  the impulse peak gives the start of the PRS useful part, with the same
  ``max < level * mean`` rejection threshold (default 3).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dabjax.constants import DabParams
from dabjax.iq import device_complex
from dabjax.ofdm import tables

__all__ = ["moving_average_envelope", "find_null", "prs_correlate",
           "prs_sync", "acquire"]

_ENV_WIN = 50


def moving_average_envelope(x: jnp.ndarray, win: int = _ENV_WIN
                            ) -> jnp.ndarray:
    """Trailing moving average of |x| over ``win`` samples (same length)."""
    mag = jnp.abs(x)
    cs = jnp.cumsum(mag)
    head = cs[..., :win] / (jnp.arange(win) + 1)
    tail = (cs[..., win:] - cs[..., :-win]) / win
    return jnp.concatenate([head, tail], axis=-1)


def find_null(x: jnp.ndarray, p: DabParams,
              dip_ratio: float = 0.40, rise_ratio: float = 0.75
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Locate the first null symbol in an IQ block.

    Returns (null_end_index, found_flag).  ``x`` must span at least one full
    frame plus T_null.  The signal level is the block mean envelope (the
    batched stand-in for the reference's slow ewma sLevel,
    ofdm-processor.cpp:168).
    """
    env = moving_average_envelope(x)
    level = jnp.mean(jnp.abs(x))
    # float 0/1 masks throughout (ROADMAP Design 3 queues plain bools)
    below = (env < dip_ratio * level).astype(jnp.float32)
    above = (env > rise_ratio * level).astype(jnp.float32)
    n = env.shape[-1]
    # first index where env dips
    dip_idx = jnp.argmax(below)
    found_dip = below[dip_idx]
    # first index after the dip where env rises again
    after = (jnp.arange(n) > dip_idx).astype(jnp.float32)
    rise = above * after
    rise_idx = jnp.argmax(rise)
    found = found_dip * rise[rise_idx]
    return rise_idx, found


@functools.lru_cache(maxsize=None)
def _prs_time_ref(mode: int, T_u: int, K: int) -> np.ndarray:
    """Time-domain PRS useful part (unit-power), conjugated FFT for
    correlation."""
    bins = tables.phase_ref_bins(mode, T_u, K)
    time = np.fft.ifft(bins)
    return np.conj(np.fft.fft(time)).astype(np.complex64)


def prs_correlate(windows: jnp.ndarray, p: DabParams) -> jnp.ndarray:
    """Circular correlation of T_u windows with the PRS reference.

    ``windows``: [..., T_u].  Returns |impulse| [..., T_u]; the argmax is the
    offset of the PRS useful start within the window
    (phasereference.cpp:60-80: FFT, multiply by conj(ref), IFFT).
    """
    spec = jnp.fft.fft(windows, axis=-1)
    ref = device_complex(
        np.conj(np.fft.fft(np.fft.ifft(
            tables.phase_ref_bins(p.mode, p.T_u, p.K)))))
    return jnp.abs(jnp.fft.ifft(spec * ref, axis=-1))


def prs_sync(windows: jnp.ndarray, p: DabParams, threshold: float = 3.0
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Find the PRS start in each window; reject weak correlations.

    Returns (start_index, ok_flag) per window
    (threshold semantics of phasereference.cpp:84-87).
    """
    imp = prs_correlate(windows, p)
    idx = jnp.argmax(imp, axis=-1)
    mx = jnp.max(imp, axis=-1)
    mean = jnp.mean(imp, axis=-1)
    ok = (mx >= threshold * mean).astype(jnp.float32)
    return idx.astype(jnp.int32), ok


def acquire(x: np.ndarray, p: DabParams, threshold: float = 3.0
            ) -> Optional[int]:
    """Full acquisition over a raw IQ buffer: returns u0, the absolute index
    of the first PRS useful-part start, or None if no frame is found.

    Host-orchestrated, device-computed: null detect on the first
    T_F + T_null samples, then PRS correlation on a T_u + T_g window.
    """
    need = p.T_F + p.T_null + p.T_u
    if x.shape[-1] < need:
        return None
    xb = device_complex(x[:need])
    null_end, found = find_null(xb, p)
    if not float(found):
        return None
    # null_end points at the envelope rise, which lags the true PRS start by
    # up to the 50-sample window; search a T_u window starting slightly back.
    base = max(int(null_end) - _ENV_WIN, 0)
    win = device_complex(x[base: base + p.T_u])
    start, ok = prs_sync(win[None, :], p, threshold)
    if not float(ok[0]):
        return None
    u0 = base + int(start[0])
    # The circular correlation is blind to whole-T_u shifts: when a noise
    # bump inside the null symbol fires the rise detector ~T_u early, the
    # window tail covers the PRS guard and the cyclic alias locks u0 one
    # T_u before the true useful start.  The discriminator is energy —
    # an aliased [u0, u0+T_u) window lies mostly inside the null, while
    # the true window carries full PRS power.  Verify and correct before
    # committing (the round-2/3 VERDICT acquisition item).
    while x.shape[-1] >= u0 + 2 * p.T_u:
        e_here = float(np.mean(np.abs(x[u0: u0 + p.T_u]) ** 2))
        e_next = float(np.mean(np.abs(x[u0 + p.T_u: u0 + 2 * p.T_u]) ** 2))
        if e_here >= 0.5 * e_next:
            break
        u0 += p.T_u
    return u0
