"""CUDA Viterbi decoder (``viterbi_k7.cu``) called through ``jax.ffi``.

One warp decodes one codeword: the whole add-compare-select recursion and
the traceback run in a single launch, path metrics stay in registers as
exact int32, soft bits stream in as int8 and each step's 64 decisions
leave as two packed 32-bit words (see the kernel source for the layout).

The shared library is built from the source next to this module on first
use, for ``sm_90a`` (Hopper), into ``<checkout>/build`` — named by the
source's hash, so an edited kernel is rebuilt.  ``nvcc`` is taken from
``PATH`` or ``$CUDA_HOME/bin``.

Bit-exact with :func:`dabjax.fec.viterbi.viterbi_decode_np` on
integer-valued soft bits; inputs are clipped to [-127, 127] (the int8
soft-bit contract, ofdm-decoder.cpp:188-189).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from dabjax.fec import conv

__all__ = ["viterbi_decode_cuda"]

_TARGET = "dabjax_viterbi_k7"
_SOURCE = Path(__file__).with_name("viterbi_k7.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_CHUNK = 32            # steps per decision chunk (one warp's lanes)
# the four generator polynomials packed one per byte (kernel attribute)
_POLYS = sum(p << (8 * k) for k, p in enumerate(conv.POLYS))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def _build_library() -> Path:
    """Compile the kernel (once per source hash) and return the library."""
    tag = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    lib = _BUILD_DIR / f"libviterbi_k7-{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)          # atomic: concurrent builders agree
    return lib


@functools.lru_cache(maxsize=None)
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(_build_library()))
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.DabjaxViterbiK7), platform="CUDA")


def _kernel(soft_i8, steps: int):
    """int8 soft bits [B, Tp, 4] (Tp = steps rounded up to 32) -> decoded
    bits packed 32 steps per word [B, Tp // 32] uint32 (bit j of word c is
    step 32c + j)."""
    _register()
    B, Tp, _ = soft_i8.shape
    bits, _ = jax.ffi.ffi_call(_TARGET, (
        jax.ShapeDtypeStruct((B, Tp // _CHUNK), jnp.uint32),
        jax.ShapeDtypeStruct((B, Tp, 2), jnp.uint32),    # decision words
    ))(soft_i8, steps=np.int32(steps), polys=np.int32(_POLYS))
    return bits


def viterbi_decode_cuda(soft, nbits: int):
    """``soft`` (..., 4*(nbits+6)) -> (..., nbits) int32 decoded bits."""
    T = nbits + conv.K - 1
    lead = soft.shape[:-1]
    B = int(np.prod(lead))
    Tp = -(-T // _CHUNK) * _CHUNK
    s = jnp.clip(soft.reshape(B, T, 4), -127, 127).astype(jnp.int8)
    s = jnp.pad(s, ((0, 0), (0, Tp - T), (0, 0)))
    words = _kernel(s, T)
    shifts = jnp.arange(_CHUNK, dtype=jnp.uint32)
    bits = (words[:, :, None] >> shifts) & 1
    bits = bits.reshape(B, Tp)[:, :nbits].astype(jnp.int32)
    return bits.reshape(lead + (nbits,))
