"""Viterbi decoders against the numpy reference.

* ``viterbi_decode_jax`` (the CPU path) on ties, batch shapes, punctured
  positions and pure noise;
* the CUDA wrapper's layout (clip, int8 cast, step padding to 32, packed
  output words) with the kernel replaced by a numpy stand-in, so its
  shapes and padding run here;
* the choice of decoder by platform;
* the CUDA kernel itself, on the card only (``gpu`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dabjax.fec import conv, viterbi, viterbi_cuda
from dabjax.fec.viterbi import viterbi_decode_jax, viterbi_decode_np


def _noisy(rng, shape, nbits, scale):
    bits = rng.integers(0, 2, shape + (nbits,), np.uint8)
    coded = conv.encode(bits)
    soft = (coded.astype(np.float32) * 2 - 1) * 100
    soft += np.round(rng.standard_normal(soft.shape) * scale)
    return bits, np.clip(soft, -127, 127)       # the int8 soft-bit contract


def test_jax_high_noise_ties():
    """Heavy noise creates near-tie path metrics; decisions must still be
    bit-identical to the numpy decoder (strict >, ties pick 0)."""
    _, soft = _noisy(np.random.default_rng(99), (6,), 768, 80)
    want = viterbi_decode_np(soft, 768)
    got = np.asarray(viterbi_decode_jax(jnp.asarray(soft), 768))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbits,shape", [
    (768, (4,)),          # FIC codewords
    (2304, (3, 2)),       # MSC 96 kbps, [subch, frames]
    (100, ()),            # unbatched
])
def test_jax_matches_numpy(nbits, shape):
    bits, soft = _noisy(np.random.default_rng(nbits), shape, nbits, 40)
    want = viterbi_decode_np(soft, nbits)
    got = np.asarray(viterbi_decode_jax(jnp.asarray(soft), nbits))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, bits)     # noise within margin


def test_jax_punctured_positions():
    # zeros at punctured positions ("do not know") create exact ties
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (2, 768), np.uint8)
    soft = (conv.encode(bits).astype(np.float32) * 2 - 1) * 127
    soft[rng.random(soft.shape) < 0.3] = 0.0      # 30% punctured
    want = viterbi_decode_np(soft, 768)
    got = np.asarray(viterbi_decode_jax(jnp.asarray(soft), 768))
    np.testing.assert_array_equal(got, want)


def test_jax_pure_noise():
    """Uniform random integer soft bits (no codeword structure): state 0
    does not dominate the final metrics, so any step past the true last
    one would walk the traceback away from state 0."""
    rng = np.random.default_rng(1)
    for nbits in (768, 2304):
        soft = rng.integers(-127, 128, (4, 4 * (nbits + 6))).astype(
            np.float32)
        want = viterbi_decode_np(soft, nbits)
        got = np.asarray(viterbi_decode_jax(jnp.asarray(soft), nbits))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- CUDA wrapper layout

def _numpy_kernel(soft_i8, steps):
    """Stand-in for the CUDA call with the same contract: int8 [B, Tp, 4]
    -> uint32 [B, Tp // 32], bit j of word c = decoded step 32c + j."""
    def host(s):
        s = np.asarray(s)
        B, Tp, _ = s.shape
        assert Tp % 32 == 0 and 0 <= Tp - steps < 32
        out = np.zeros((B, Tp), np.uint32)
        if B:
            out[:, : steps - 6] = viterbi_decode_np(
                s[:, :steps].reshape(B, -1).astype(np.float32), steps - 6)
        w = (out.reshape(B, Tp // 32, 32) << np.arange(32, dtype=np.uint32))
        return w.sum(axis=-1, dtype=np.uint32)

    B, Tp, _ = soft_i8.shape
    return jax.pure_callback(
        host, jax.ShapeDtypeStruct((B, Tp // 32), jnp.uint32), soft_i8)


@pytest.mark.parametrize("nbits,shape", [
    (768, (5,)),          # 5 codewords: not a multiple of the 4-warp block
    (100, ()),            # unbatched; 106 steps pad to 128
])
def test_cuda_wrapper_layout(monkeypatch, nbits, shape):
    monkeypatch.setattr(viterbi_cuda, "_kernel", _numpy_kernel)
    rng = np.random.default_rng(5)
    soft = rng.integers(-140, 141, shape + (4 * (nbits + 6),)).astype(
        np.float32)                     # out-of-range values are clipped
    got = jax.jit(viterbi_cuda.viterbi_decode_cuda,
                  static_argnums=1)(jnp.asarray(soft), nbits)
    assert got.shape == shape + (nbits,) and got.dtype == jnp.int32
    want = viterbi_decode_np(np.clip(soft, -127, 127), nbits)
    np.testing.assert_array_equal(np.asarray(got), want)


# ---------------------------------------------------- decoder by platform

@pytest.mark.parametrize("platform,decoder", [
    ("gpu", "cuda"), ("cpu", "jax"), ("rocm", None)])
def test_decoder_chosen_by_platform(monkeypatch, platform, decoder):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(viterbi_cuda, "viterbi_decode_cuda",
                        lambda soft, nbits: "cuda")
    monkeypatch.setattr(viterbi, "viterbi_decode_jax",
                        lambda soft, nbits: "jax")
    if decoder is None:
        with pytest.raises(NotImplementedError, match="rocm"):
            viterbi.viterbi_decode(None, 768)
    else:
        assert viterbi.viterbi_decode(None, 768) == decoder


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("nbits,shape,scale", [
    (768, (384,), 80),        # every FIC codeword of a 96-frame batch
    (2304, (16, 16), 60),     # 256 MSC codewords, 96 kbps
    (2304, (33,), None),      # pure integer noise: ties and step padding
])
def test_cuda_kernel_matches_numpy(gpu, nbits, shape, scale):
    rng = np.random.default_rng(nbits + len(shape))
    if scale is None:
        soft = rng.integers(-127, 128, shape + (4 * (nbits + 6),)).astype(
            np.float32)
    else:
        _, soft = _noisy(rng, shape, nbits, scale)
    got = viterbi_cuda.viterbi_decode_cuda(jnp.asarray(soft), nbits)
    np.testing.assert_array_equal(np.asarray(got),
                                  viterbi_decode_np(soft, nbits))


@pytest.mark.gpu
def test_gpu_decoder_is_the_kernel(gpu, monkeypatch):
    calls = []
    real = viterbi_cuda.viterbi_decode_cuda
    monkeypatch.setattr(viterbi_cuda, "viterbi_decode_cuda",
                        lambda soft, nbits: calls.append(1) or real(soft,
                                                                     nbits))
    _, soft = _noisy(np.random.default_rng(3), (8,), 768, 40)
    got = viterbi.viterbi_decode(jnp.asarray(soft), 768)
    assert calls
    np.testing.assert_array_equal(np.asarray(got),
                                  viterbi_decode_np(soft, 768))
