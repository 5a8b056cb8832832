"""Batched OFDM demodulation: frame-aligned IQ -> DQPSK soft bits.

Re-design of the reference's per-symbol loop (``ofdm-decoder.cpp:85-258``):
instead of one 2048-pt FFT at a time on a dedicated thread, a whole batch
of frames is demodulated as a single ``[F, L, T_u]`` FFT (cuFFT on the GPU)
followed by a gather (frequency de-interleave, ``mapper.cpp``) and
vectorized DQPSK.

Conventions match the reference exactly:
* soft bit i      = -Re(F_l[k_i] conj(F_{l-1}[k_i])) / |.| * 127
* soft bit K+i    = -Im(...) * 127                 (ofdm-decoder.cpp:188-189)
* symbol l's FFT window starts T_s samples after symbol l-1's; the PRS
  useful part defines t=0 (ofdm-processor.cpp OFDM_PRS/OFDM_SYMBOLS).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dabjax.constants import DabParams
from dabjax.iq import device_complex
from dabjax.ofdm import tables

__all__ = ["frame_window_index", "demodulate_frames",
           "demodulate_frames_cfo", "demodulate_frames_np", "snr_estimate",
           "fine_cfo_estimate", "coarse_cfo_estimate", "apply_cfo"]


@functools.lru_cache(maxsize=None)
def frame_window_index(T_s: int, T_u: int, L: int) -> np.ndarray:
    """(L, T_u) sample indices of each symbol's FFT window, rel. to PRS
    useful start (symbol l useful part begins at l*T_s)."""
    return (np.arange(L)[:, None] * T_s + np.arange(T_u)[None, :])


def min_frame_samples(p: DabParams) -> int:
    """Samples needed per frame row for demodulation (incl. guard lookback)."""
    return (p.L - 1) * p.T_s + p.T_u


def demodulate_frames(samples: jnp.ndarray, p: DabParams
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate frame-aligned IQ (CFO already applied; see
    :func:`demodulate_frames_cfo` for the fused hot path).

    ``samples``: [F, >= (L-1)*T_s + T_u] complex64, each row starting at the
    PRS *useful part* (t = u0).
    Returns ``(soft, spectra0)``:
      soft: [F, L-1, 2K] float32 soft bits in -127..127
      spectra0: [F, T_u] complex PRS spectra (for SNR / coarse CFO).
    """
    return demodulate_frames_cfo(samples, jnp.zeros(samples.shape[0]), p)


def demodulate_frames_cfo(samples: jnp.ndarray, cfo_hz: jnp.ndarray,
                          p: DabParams, fs: float = 2_048_000.0
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Demodulate UNROTATED frame-aligned IQ with the CFO mix fused in.

    The full NCO rotation ``e^{-jw(l*T_s+t)}`` of apply_cfo factors per
    symbol window into a shared per-frame ramp ``e^{-jwt}`` (one [F, T_u]
    cos/sin table broadcast over L — 75x fewer transcendentals than
    rotating the raw stream) times a per-symbol constant ``e^{-jwlT_s}``.
    The constant cancels to exactly ``e^{-jwT_s}`` in the DQPSK
    conjugate product, where it is one scalar complex multiply per frame
    — algebraically identical to rotating every sample, at a fraction of
    the cost (ofdm-processor.cpp:76-81,167 does the per-sample mix).

    ``samples``: [F, >= (L-1)*T_s + T_u] complex64 rows (PRS useful at 0).
    ``cfo_hz``: [F] total CFO (fine + coarse) in Hz.
    Returns ``(soft, spectra0)`` exactly as :func:`demodulate_frames`
    (spectra0 matches the rotated-stream convention; at l=0 the ramp IS
    the full rotation).
    """
    T_s, T_u, L, K = p.T_s, p.T_u, p.L, p.K
    re, im = jnp.real(samples), jnp.imag(samples)
    # symbol windows as L static slices, which XLA fuses into the
    # rotation that follows
    wr = jnp.stack([re[:, l * T_s: l * T_s + T_u]
                    for l in range(L)], axis=1)           # [F, L, T_u]
    wi = jnp.stack([im[:, l * T_s: l * T_s + T_u]
                    for l in range(L)], axis=1)
    t = jnp.arange(T_u, dtype=jnp.float32)
    ang = (-2.0 * jnp.pi / fs) * cfo_hz[:, None].astype(jnp.float32) * t
    cr, ci = jnp.cos(ang)[:, None, :], jnp.sin(ang)[:, None, :]
    wr, wi = wr * cr - wi * ci, wr * ci + wi * cr
    spec = jnp.fft.fft(jax.lax.complex(wr, wi), axis=-1)  # [F, L, T_u]
    cb = jnp.asarray(tables.carrier_bins(p.mode, T_u, K))
    sre = jnp.real(spec)[:, :, cb]                    # [F, L, K]
    sim = jnp.imag(spec)[:, :, cb]
    # r1 = F_l * conj(F_{l-1}) per active carrier
    r1re = sre[:, 1:] * sre[:, :-1] + sim[:, 1:] * sim[:, :-1]
    r1im = sim[:, 1:] * sre[:, :-1] - sre[:, 1:] * sim[:, :-1]
    # fold the per-symbol rotation constant back in: one complex scalar
    # e^{-jwT_s} per frame (phase-only — |r1| is unchanged)
    pang = ((-2.0 * jnp.pi / fs) * cfo_hz.astype(jnp.float32)
            * T_s)[:, None, None]
    pr, pi_ = jnp.cos(pang), jnp.sin(pang)
    r1re, r1im = r1re * pr - r1im * pi_, r1re * pi_ + r1im * pr
    inv = jax.lax.rsqrt(r1re * r1re + r1im * r1im + 1e-38)
    soft = jnp.concatenate([-r1re * inv * 127.0,
                            -r1im * inv * 127.0], axis=-1)
    # integer soft bits (the reference's int16-clamped-to-+-127 convention,
    # ofdm-decoder.cpp:188-189): downstream stages preserve integrality
    # (de-interleave permutes, depuncture inserts zeros), which lets the
    # CUDA Viterbi kernel stream int8 soft values (viterbi_cuda.py)
    soft = jnp.round(soft).astype(jnp.float32)
    return soft, spec[:, 0, :]


def demodulate_frames_np(samples: np.ndarray, cfo_hz: np.ndarray,
                         p: DabParams, fs: float = 2_048_000.0) -> np.ndarray:
    """Plain numpy reference of :func:`demodulate_frames_cfo`'s soft bits
    (float64, every sample rotated by the CFO ramp, ``np.fft``): [F, L-1,
    2K] rounded soft bits."""
    T_s, T_u, L, K = p.T_s, p.T_u, p.L, p.K
    samples = np.asarray(samples, np.complex128)
    n = np.arange(samples.shape[-1])
    rot = samples * np.exp(-2j * np.pi * np.asarray(cfo_hz, np.float64)[:, None]
                           * n / fs)
    win = rot[:, frame_window_index(T_s, T_u, L)]         # [F, L, T_u]
    spec = np.fft.fft(win, axis=-1)[:, :, tables.carrier_bins(p.mode, T_u, K)]
    r1 = spec[:, 1:] * np.conj(spec[:, :-1])
    r1 = r1 / np.maximum(np.abs(r1), 1e-30)
    return np.round(np.concatenate([-r1.real * 127.0, -r1.imag * 127.0],
                                   axis=-1))


def snr_estimate(spectrum0: jnp.ndarray, p: DabParams) -> jnp.ndarray:
    """Per-frame SNR (dB) from the PRS spectrum (ofdm-decoder.cpp:212-230)."""
    T_u, K = p.T_u, p.K
    v = jnp.abs(jnp.roll(spectrum0, T_u // 2, axis=-1))  # center carriers
    low = T_u // 2 - K // 2
    high = low + K
    sig = jnp.mean(v[..., T_u // 2 - K // 4: T_u // 2 + K // 4], axis=-1)
    # the reference's two out-of-band windows
    noise = (jnp.sum(v[..., 10: low - 20], axis=-1) +
             jnp.sum(v[..., high + 20: T_u - 10], axis=-1))
    noise = noise / (low - 30 + T_u - high - 30)
    db = lambda x: 20.0 * jnp.log10((x + 1.0) / 256.0)
    return db(sig) - db(noise)


def fine_cfo_estimate(samples: jnp.ndarray, p: DabParams) -> jnp.ndarray:
    """Per-frame fine CFO from guard-interval correlation.

    ``samples``: [F, >= (L-1)*T_s + T_u] frame-aligned rows (PRS useful at 0).
    Returns CFO estimate in Hz: arg(sum over all data-symbol guards of
    s[i] conj(s[i - T_u])) / pi * (carrier_diff / 2)
    (ofdm-processor.cpp:424-425,445-446, summed over the whole frame).
    """
    T_s, T_u, T_g, L = p.T_s, p.T_u, p.T_g, p.L
    # guard of symbol l (l >= 1) occupies [l*T_s - T_g, l*T_s); static
    # slices per symbol instead of a 2-D gather
    g = jnp.stack([samples[:, l * T_s - T_g: l * T_s]
                   for l in range(1, L)], axis=1)          # [F, L-1, T_g]
    ref = jnp.stack([samples[:, l * T_s - T_g + T_u: l * T_s + T_u]
                     for l in range(1, L)], axis=1)
    # guard is a copy of the *end* of the useful part: corr s[i]*conj(s[i+Tu])
    corr = jnp.sum(g * jnp.conj(ref), axis=(-2, -1))
    return -jnp.angle(corr) / jnp.pi * (p.carrier_diff / 2.0)


def coarse_cfo_estimate(spectrum0: jnp.ndarray, p: DabParams,
                        search: int = 35) -> jnp.ndarray:
    """Integer-carrier CFO from the PRS spectrum, +-``search`` carriers.

    Differential-coherent matched filter: correlates the received
    adjacent-bin conjugate products d_rx[k] = F[k+c] conj(F[k+c+1]) against
    the PRS reference products over all K in-band carriers and picks the
    shift c with the largest coherent sum.  The differential form cancels
    the linear phase from any residual timing offset.

    This replaces the reference's three heuristic methods
    (ofdm-decoder.cpp:106-161,233-258) with a single estimator that is
    unambiguous on clean signals (the angle-magnitude metric of
    freqSyncMethod 1 has false peaks from the period-16 structure of the
    phase tables).  Returns carrier offsets [F] int32: the spectrum sits
    ``offset`` carriers too high (subtract offset * carrier_diff Hz).
    """
    T_u, K = p.T_u, p.K
    ref = tables.phase_ref_bins(p.mode, T_u, K)
    # adjacent-bin products over the contiguous in-band region in centered
    # (fftshifted) coordinates
    ref_c = np.roll(ref, T_u // 2)
    d_ref = ref_c[:-1] * np.conj(ref_c[1:])
    band = slice(T_u // 2 - K // 2, T_u // 2 + K // 2)
    d_ref_band = device_complex(d_ref[band])

    spec_c = jnp.roll(spectrum0, T_u // 2, axis=-1)
    d_rx = spec_c[..., :-1] * jnp.conj(spec_c[..., 1:])
    lo = T_u // 2 - K // 2
    shift_idx = (np.arange(-search, search + 1)[:, None]
                 + lo + np.arange(K)[None, :])
    # real and imaginary parts gathered separately (ROADMAP Design 3
    # queues the plain complex gather)
    cand = (jnp.real(d_rx)[..., shift_idx]
            + 1j * jnp.imag(d_rx)[..., shift_idx])  # [..., 2*search+1, K]
    score = jnp.abs(jnp.sum(cand * jnp.conj(d_ref_band), axis=-1))
    best = jnp.argmax(score, axis=-1)
    return (best - search).astype(jnp.int32)


def apply_cfo(samples: jnp.ndarray, cfo_hz: jnp.ndarray,
              fs: float = 2_048_000.0, t0: jnp.ndarray | None = None
              ) -> jnp.ndarray:
    """Mix frames down by per-frame CFO (the batched NCO; replaces the
    2048000-entry oscillator table of ofdm-processor.cpp:76-81)."""
    n = jnp.arange(samples.shape[-1])
    if t0 is not None:
        n = n + t0[..., None]
    ph = -2j * jnp.pi * cfo_hz[..., None] * n / fs
    return samples * jnp.exp(ph)
