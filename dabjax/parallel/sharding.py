"""Sharded full-ensemble decode step (pjit/shard_map over a device mesh).

The single-chip pipeline (dabjax.runtime.pipeline) is re-expressed as an
SPMD program over axes ('time', 'subch'):

* frame rows are sharded along ``time``; demod/FIC are embarrassingly
  parallel per time shard
* the MSC time de-interleaver needs the previous 15 CIFs — an
  overlap-save halo pulled from the left time-neighbor with
  ``jax.lax.ppermute`` (the collective replacement for the reference's
  ring-buffer handoff, SURVEY.md §2.5)
* subchannels are sharded along ``subch``; each rank Viterbi-decodes its
  slice of services in one batched kernel call, so the whole CIF is decoded concurrently
* FIC CRC pass-rate is psum-reduced over the mesh as the step's scalar
  quality signal

Shapes are uniform across ranks (subchannels bucketed to one geometry), so
the program is a single SPMD computation; XLA hands the collectives to
NCCL.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dabjax.constants import CU_BITS, DabParams
from dabjax.fic.fic_decoder import decode_fic
from dabjax.iq import pack_iq, unpack_iq
from dabjax.msc.cif import cifs_from_soft
from dabjax.msc.deinterleave import HISTORY
from dabjax.msc.subchannel import SubchGeometry, decode_subchannel
from dabjax.ofdm import demod

__all__ = ["sharded_ensemble_step", "make_sharded_inputs"]


def sharded_ensemble_step(mesh: Mesh, p: DabParams, proto: SubchGeometry):
    """Build the jitted SPMD step.

    Returns ``fn(rows, starts) -> (fic_ratio, subch_bits)`` where
      rows:   [F, need] complex64, F divisible by mesh 'time' size
      starts: [n_subch] int32 CU start addresses, divisible by 'subch' size
      fic_ratio: scalar fraction of FIBs passing CRC (psum over mesh)
      subch_bits: [n_subch, T_total - 15*n_time, 24*bitrate] decoded bits
        (each time shard contributes its CIFs minus the 15-CIF warm-up,
        which the halo fills for every shard except the first).
    """
    n_time = mesh.shape["time"]
    n_bits = proto.length_cus * CU_BITS

    def step(rows_loc, starts_loc):
        # rows_loc: [F_loc, need, 2] float IQ pairs; starts_loc: [S_loc]
        rows_loc = unpack_iq(rows_loc)
        fine = demod.fine_cfo_estimate(rows_loc, p)
        soft, _ = demod.demodulate_frames_cfo(rows_loc, fine, p)
        _, ok = decode_fic(soft[:, : p.fic_symbols, :], p)
        fic_ratio = jax.lax.psum(jnp.sum(ok.astype(jnp.float32)), "time")
        fic_total = jax.lax.psum(
            jnp.float32(ok.size), "time")
        fic_ratio = fic_ratio / fic_total

        cifs = cifs_from_soft(soft, p)              # [T_loc, 55296]
        if cifs.shape[0] < HISTORY:
            raise ValueError(
                f"time shard carries {cifs.shape[0]} CIFs < {HISTORY}-CIF "
                f"de-interleaver halo; use more frames per shard")
        # overlap-save halo: last 15 CIFs travel to the right time-neighbor
        halo = jax.lax.ppermute(
            cifs[-HISTORY:], "time",
            perm=[(i, i + 1) for i in range(n_time - 1)])
        block = jnp.concatenate([halo, cifs], axis=0)  # [T_loc+15, 55296]
        idx = (np.arange(n_bits)[None, :]
               + starts_loc[:, None] * CU_BITS)
        slices = jnp.take(block, idx, axis=1)       # [T_loc+15, S_loc, bits]
        slices = jnp.swapaxes(slices, 0, 1)          # [S_loc, T_loc+15, bits]
        bits = decode_subchannel(slices, proto)
        return fic_ratio, bits

    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("time", None, None), P("subch")),
        out_specs=(P(), P("subch", "time", None)),
        check_vma=False)
    return jax.jit(mapped)


def make_sharded_inputs(mesh: Mesh, rows: np.ndarray, starts: np.ndarray):
    """Device-put inputs with the step's shardings (complex rows are
    packed to float IQ pairs at the boundary)."""
    rows = jax.device_put(
        jnp.asarray(pack_iq(rows)), NamedSharding(mesh, P("time", None, None)))
    starts = jax.device_put(
        jnp.asarray(starts, jnp.int32), NamedSharding(mesh, P("subch")))
    return rows, starts
