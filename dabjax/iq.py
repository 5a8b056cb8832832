"""Host <-> device IQ boundary.

Every jit entry point moves IQ as float32 ``(re, im)`` pairs on the last
axis and rebuilds complex64 on-device as the first op (ROADMAP Design 3
queues moving complex64 directly).  This is the analog of the reference's
native-format conversion at the device boundary (``getSamples`` converting u8/i16 IQ to DSPCOMPLEX,
``src/input/virtual-input.h:51-70``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_iq", "unpack_iq", "device_complex"]


def pack_iq(x: np.ndarray) -> np.ndarray:
    """Host side: complex (..., n) -> float32 (..., n, 2)."""
    x = np.asarray(x)
    out = np.empty(x.shape + (2,), np.float32)
    out[..., 0] = x.real
    out[..., 1] = x.imag
    return out


def unpack_iq(pairs: jnp.ndarray) -> jnp.ndarray:
    """Device side: float32 (..., n, 2) -> complex64 (..., n)."""
    return jax.lax.complex(pairs[..., 0], pairs[..., 1])


def device_complex(x: np.ndarray) -> jnp.ndarray:
    """Upload a host complex array as two float transfers + on-device
    ``lax.complex`` — safe to call eagerly and under tracing."""
    x = np.asarray(x)
    return jax.lax.complex(jnp.asarray(x.real.astype(np.float32)),
                           jnp.asarray(x.imag.astype(np.float32)))
