"""Batched Viterbi decoder for the DAB K=7, rate-1/4 convolutional code.

Re-design of the reference's SPIRAL-generated SSE decoder
(``viterbi.cpp:25-371``, ``spiral-sse.c``): instead of one codeword at a
time through a hand-scheduled SIMD inner loop, a *batch* of codewords is
decoded at once (4 FIC codewords x frames x all subchannels of a CIF),
which the reference cannot do (it decodes one service;
``msc-handler.cpp:183-192``).  On the GPU that batch runs in the CUDA
kernel of :mod:`dabjax.fec.viterbi_cuda`, one warp per codeword; on the
CPU it is the ``lax.scan`` decoder below.

Conventions (identical to the reference decode semantics):

* soft input: one value per coded bit, negative = bit 0, positive = bit 1,
  nominal range -127..127 (``ofdm-decoder.cpp:188-189``);
  punctured positions carry 0 = "do not know".
* input length per codeword: 4*(nbits+6); the 6 tail bits return the
  encoder to state 0, so traceback starts at state 0
  (``viterbi.cpp:333-357``).
* state = last 6 data bits, newest in the LSB; register value
  r = (state<<1)|bit selects expected coded bits via ``conv.POLYS``.
"""

from __future__ import annotations

import functools

import numpy as np

from dabjax.fec import conv

__all__ = ["viterbi_decode_np", "viterbi_decode_jax", "viterbi_decode",
           "branch_signs"]


@functools.lru_cache(maxsize=None)
def _tables():
    """Static ACS gather tables.

    Returns (signs, prev0, prev1) where
      signs[r, k] = +1 if transition r=(s<<1)|b expects coded bit 1 else -1
      prev0[n] = predecessor state for new state n via r = n        (= n>>1)
      prev1[n] = predecessor state for new state n via r = n | 64   (= n>>1 | 32)
    """
    exp = conv.expected_bits_table()            # (128, 4) 0/1
    signs = (exp.astype(np.int32) * 2 - 1)      # (128, 4) ±1
    n = np.arange(64)
    prev0 = n >> 1
    prev1 = (n >> 1) | 32
    return signs, prev0.astype(np.int32), prev1.astype(np.int32)


def branch_signs() -> np.ndarray:
    """(128, 4) ±1 expected-bit signs for register value r."""
    return _tables()[0]


def viterbi_decode_np(soft: np.ndarray, nbits: int) -> np.ndarray:
    """Reference numpy decoder. ``soft``: (..., 4*(nbits+6)) -> (..., nbits)."""
    signs, prev0, prev1 = _tables()
    soft = np.asarray(soft, dtype=np.float32)
    T = nbits + conv.K - 1
    assert soft.shape[-1] == 4 * T, (soft.shape, nbits)
    lead = soft.shape[:-1]
    s = soft.reshape(lead + (T, 4))

    # branch score for every register value r at every step: (..., T, 128)
    bs = np.einsum("...tk,rk->...tr", s, signs.astype(np.float32))

    pm = np.full(lead + (64,), -1e9, dtype=np.float32)
    pm[..., 0] = 0.0
    decisions = np.empty(lead + (T, 64), dtype=np.uint8)
    n = np.arange(64)
    r0 = n            # r for decision 0
    r1 = n | 64       # r for decision 1
    for t in range(T):
        m0 = pm[..., prev0] + bs[..., t, r0]
        m1 = pm[..., prev1] + bs[..., t, r1]
        d = (m1 > m0)
        decisions[..., t, :] = d
        pm = np.where(d, m1, m0)

    # traceback from state 0
    out = np.empty(lead + (T,), dtype=np.uint8)
    state = np.zeros(lead, dtype=np.int64)
    for t in range(T - 1, -1, -1):
        out[..., t] = state & 1
        d = np.take_along_axis(
            decisions[..., t, :], state[..., None], axis=-1)[..., 0]
        state = (state >> 1) | (d.astype(np.int64) << 5)
    return out[..., :nbits]


def viterbi_decode(soft, nbits: int):
    """Decode with the platform's decoder: the CUDA kernel on the GPU,
    the ``lax.scan`` decoder on the CPU.  Both are bit-exact vs
    :func:`viterbi_decode_np` on integer-valued soft bits."""
    import jax
    platform = jax.default_backend()
    if platform == "gpu":
        from dabjax.fec.viterbi_cuda import viterbi_decode_cuda
        return viterbi_decode_cuda(soft, nbits)
    if platform == "cpu":
        return viterbi_decode_jax(soft, nbits)
    raise NotImplementedError(f"no Viterbi decoder for platform {platform!r}")


def viterbi_decode_jax(soft, nbits: int):
    """Batched JAX decoder: ``soft`` (..., 4*(nbits+6)) -> (..., nbits) int32.

    Pure function of static ``nbits``; jit/vmap/shard_map friendly.  The ACS
    recursion is a ``lax.scan`` over time with a [..., 64] carry; decisions
    are staged as a bool tensor and traced back with a second reversed scan
    (gather over 64 states).
    """
    import jax
    import jax.numpy as jnp

    signs, prev0, prev1 = _tables()
    T = nbits + conv.K - 1
    lead = soft.shape[:-1]
    s = soft.reshape(lead + (T, 4)).astype(jnp.float32)
    # (T, ..., 128) branch scores — time leading for scan.
    # HIGHEST: a default-precision f32 einsum may round its operands
    # (TF32 on the GPU), which would flip near-tie branch decisions for
    # soft bits that are not small integers
    bs = jnp.einsum("...tk,rk->t...r", s, jnp.asarray(signs, jnp.float32),
                    precision=jax.lax.Precision.HIGHEST)

    n = np.arange(64)
    r0 = jnp.asarray(n, jnp.int32)
    r1 = jnp.asarray(n | 64, jnp.int32)
    p0 = jnp.asarray(prev0)
    p1 = jnp.asarray(prev1)

    pm0 = jnp.full(lead + (64,), -1e9, dtype=jnp.float32)
    pm0 = pm0.at[..., 0].set(0.0)

    def acs(pm, bst):
        m0 = pm[..., p0] + bst[..., r0]
        m1 = pm[..., p1] + bst[..., r1]
        d = m1 > m0
        return jnp.where(d, m1, m0), d

    _, decisions = jax.lax.scan(acs, pm0, bs)   # decisions: (T, ..., 64) bool

    def tb(state, dt):
        # state: (...,) int32 current state; dt: (..., 64) decisions at t
        bit = state & 1
        d = jnp.take_along_axis(dt.astype(jnp.int32),
                                state[..., None], axis=-1)[..., 0]
        prev = (state >> 1) | (d << 5)
        return prev, bit

    state0 = jnp.zeros(lead, dtype=jnp.int32)
    _, bits_rev = jax.lax.scan(tb, state0, decisions, reverse=True)
    # bits_rev: (T, ...) with time leading (already in forward order due to
    # reverse=True writing outputs at matching indices)
    bits = jnp.moveaxis(bits_rev, 0, -1)
    return bits[..., :nbits]
