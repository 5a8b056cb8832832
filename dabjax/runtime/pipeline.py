"""Jit-compiled receiver pipelines — the flagship compute graphs.

Pure functions of frame-aligned IQ with static mode/geometry parameters;
used by the runtime, the benchmark, and the multi-chip sharded step.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from dabjax.constants import DabParams
from dabjax.fic.fic_decoder import decode_fic
from dabjax.iq import pack_iq, unpack_iq
from dabjax.msc.cif import cifs_from_soft
from dabjax.msc.subchannel import SubchGeometry, decode_subchannel
from dabjax.ofdm import demod

__all__ = ["frame_pipeline", "full_ensemble_pipeline", "pipeline_stages",
           "example_rows"]


def frame_pipeline(p: DabParams):
    """Frame demod + FIC decode: rows [F, need, 2] float32 IQ pairs ->
    (soft, fib_bits, crc_ok, snr).  The single-chip forward step
    (BASELINE config 1)."""

    def fn(rows):
        rows = unpack_iq(rows)
        fine = demod.fine_cfo_estimate(rows, p)
        soft, spec0 = demod.demodulate_frames_cfo(rows, fine, p)
        snr = demod.snr_estimate(spec0, p)
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        return soft, fibs, ok, snr

    return fn


def full_ensemble_pipeline(p: DabParams, geoms: Tuple[SubchGeometry, ...]):
    """Full-ensemble decode: rows [F, need, 2] float32 IQ pairs -> FIC +
    every subchannel.

    All subchannels must share a geometry shape (callers bucket first, as
    EnsembleDecoder does); returns (fib_crc_ok, subch_bits[n_subch, T-15,
    24*bitrate]).  This is BASELINE config 4 as one jittable graph.
    """
    starts = np.array([g.start_addr * 64 for g in geoms])
    n_bits = geoms[0].length_cus * 64
    proto = geoms[0]

    def fn(rows):
        rows = unpack_iq(rows)
        fine = demod.fine_cfo_estimate(rows, p)
        soft, _ = demod.demodulate_frames_cfo(rows, fine, p)
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        cifs = cifs_from_soft(soft, p)
        idx = starts[:, None] + np.arange(n_bits)[None, :]
        slices = cifs[:, idx].transpose(1, 0, 2)       # [n_subch, T, bits]
        bits = decode_subchannel(slices, proto)
        return ok, bits

    return fn


def pipeline_stages(p: DabParams, geoms: Tuple[SubchGeometry, ...]):
    """Cumulative sub-pipelines of :func:`full_ensemble_pipeline` for the
    bench's per-stage breakdown (BASELINE.md "Kernel metric" row).

    Returns an ordered dict of name -> fn(rows) -> f32 scalar; each fn is a
    strict prefix of the full pipeline and folds EVERY computed output into
    the scalar (unconsumed outputs get dead-code-eliminated — CLAUDE.md
    timing discipline).  Stage cost = difference of adjacent prefix times:
    demod | fic | deint_depunct | viterbi_dispersal.
    """
    from dabjax.fec import puncture
    from dabjax.msc.deinterleave import time_deinterleave

    starts = np.array([g.start_addr * 64 for g in geoms])
    n_bits = geoms[0].length_cus * 64
    proto = geoms[0]
    if proto.protection == "UEP":
        lengths, pis = puncture.uep_profile(proto.bitrate, proto.prot_level)
    else:
        lengths, pis = puncture.eep_profile(proto.bitrate, proto.prot_level,
                                            proto.protection[-1])

    def _front(rows):
        rows = unpack_iq(rows)
        fine = demod.fine_cfo_estimate(rows, p)
        soft, _ = demod.demodulate_frames_cfo(rows, fine, p)
        return soft

    def _fic(soft):
        fibs, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        return (jnp.sum(fibs).astype(jnp.float32)
                + jnp.sum(ok).astype(jnp.float32))

    def _prep(soft):
        cifs = cifs_from_soft(soft, p)
        idx = starts[:, None] + np.arange(n_bits)[None, :]
        slices = cifs[:, idx].transpose(1, 0, 2)
        deint = time_deinterleave(slices)
        return puncture.depuncture_profile(deint, lengths, pis)

    def s_demod(rows):
        return jnp.sum(_front(rows))

    def s_fic(rows):
        soft = _front(rows)
        return jnp.sum(soft) + _fic(soft)

    def s_prep(rows):
        soft = _front(rows)
        return jnp.sum(soft) + _fic(soft) + jnp.sum(_prep(soft))

    full_fn = full_ensemble_pipeline(p, geoms)

    def s_full(rows):
        ok, bits = full_fn(rows)
        return (jnp.sum(ok).astype(jnp.float32)
                + jnp.sum(bits).astype(jnp.float32))

    return {"demod": s_demod, "fic": s_fic, "deint_depunct": s_prep,
            "full": s_full}


def example_rows(p: DabParams, n_frames: int = 2, seed: int = 0):
    """Synthetic frame-aligned rows (float IQ pairs) for compile checks."""
    rng = np.random.default_rng(seed)
    need = demod.min_frame_samples(p)
    x = (rng.standard_normal((n_frames, need))
         + 1j * rng.standard_normal((n_frames, need))) / np.sqrt(2)
    return jnp.asarray(pack_iq(x))
