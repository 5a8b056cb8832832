"""FIC channel decoder: OFDM soft bits -> CRC-gated FIB bits.

Device-side, batched equivalent of the reference's FIC thread
(``fic-handler.cpp:143-321``): codeword regrouping, PI_16/PI_15/PI_X
depuncturing, rate-1/4 Viterbi, energy dispersal and the CRC16 gate are all
vectorized over [frames, codewords]; only the FIG *parsing* of CRC-passed
FIBs stays on the host (it is control plane — see dabjax.fic.fib).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dabjax.constants import DabParams
from dabjax.fec import prbs, puncture, viterbi
from dabjax.fec.crc import check_crc16_bits

__all__ = ["fic_codewords_per_frame", "decode_fic"]


def fic_codewords_per_frame(p: DabParams) -> int:
    # Mode I: 3 symbols * 3072 bits = 4 codewords of 2304; Mode IV: 2;
    # Mode II: 1 (fic-handler.cpp:131-141).  Mode III: one 3072-bit
    # codeword of 4 FIBs per frame (EN 300 401 §11.2; beyond the
    # reference, which rejects Mode III).
    return {1: 4, 2: 1, 3: 1, 4: 2}[p.mode]


def fic_profile(p: DabParams) -> Tuple[list, int, int]:
    """(depuncture profile blocks, payload bits, FIBs per codeword).

    Modes I/II/IV: 2304-bit codewords of 3 FIBs, 21xPI_16 + 3xPI_15.
    Mode III: 3072-bit codewords of 4 FIBs, 29xPI_16 + 3xPI_15
    (EN 300 401 §11.2: (1024+6)*4 = 4120 mother bits -> 2784+276+12)."""
    if p.mode == 3:
        return [29, 3], 1024, 4
    return [21, 3], 768, 3


@functools.lru_cache(maxsize=None)
def _fic_mask_indices() -> np.ndarray:
    mask = puncture.puncture_mask([21, 3], [16, 15])
    return mask


def decode_fic(fic_soft: jnp.ndarray, p: DabParams
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Decode FIC soft bits for a batch of frames.

    ``fic_soft``: [F, fic_symbols, 2K] float soft bits (symbols 1..3).
    Returns ``(fib_bits, crc_ok)``:
      fib_bits: [F, n_fibs, 256] int32 (post energy-dispersal, incl. CRC16)
      crc_ok:   [F, n_fibs] bool
    where n_fibs = 3 * codewords_per_frame.
    """
    F = fic_soft.shape[0]
    n_cw = fic_codewords_per_frame(p)
    blocks, nbits, fibs_per_cw = fic_profile(p)
    cw = fic_soft.reshape(F, n_cw, -1)
    full = puncture.depuncture_profile(cw, blocks, [16, 15])
    bits = viterbi.viterbi_decode(full, nbits)         # [F, n_cw, nbits]
    bits = prbs.disperse(bits)                         # energy dispersal
    fibs = bits.reshape(F, n_cw * fibs_per_cw, 256)
    ok = check_crc16_bits(fibs, inverted=True)
    # int32 rather than bool (ROADMAP Design 3 queues the plain bool)
    return fibs, ok.astype(jnp.int32)
