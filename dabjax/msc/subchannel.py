"""Subchannel decode: CIF soft bits -> logical-frame bits, all services.

The reference decodes exactly ONE selected subchannel on a backend thread
(``msc-handler.cpp:183-192``, ``dab-concurrent.cpp:144-193``).  Here the
depuncture + Viterbi + energy-dispersal chain is a pure jitted function of
static subchannel geometry, and *every* active subchannel of the ensemble is
decoded concurrently by bucketing services with identical geometry shapes
(bitrate/protection) into a vmapped batch — the "expert-parallel-shaped"
axis of SURVEY.md §2.5.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dabjax.constants import CU_BITS, DabParams
from dabjax.fec import prbs, puncture, viterbi
from dabjax.msc.deinterleave import HISTORY, time_deinterleave

__all__ = ["SubchGeometry", "subch_puncture_mask", "decode_subchannel",
           "EnsembleDecoder"]


@dataclasses.dataclass(frozen=True)
class SubchGeometry:
    """Static decode geometry of one subchannel (hashable jit key)."""
    subch_id: int
    start_addr: int
    length_cus: int
    bitrate: int
    protection: str      # "UEP" | "EEP-A" | "EEP-B"
    prot_level: int

    @classmethod
    def from_db(cls, sc) -> "SubchGeometry":
        prot = ("UEP" if sc.uep_flag == 0
                else f"EEP-{sc.eep_profile}")
        return cls(subch_id=sc.subch_id, start_addr=sc.start_addr,
                   length_cus=sc.length, bitrate=sc.bitrate,
                   protection=prot, prot_level=sc.prot_level)

    @property
    def shape_key(self) -> Tuple:
        return (self.length_cus, self.bitrate, self.protection,
                self.prot_level)


@functools.lru_cache(maxsize=None)
def subch_puncture_mask(protection: str, bitrate: int, prot_level: int
                        ) -> np.ndarray:
    if protection == "UEP":
        lengths, pis = puncture.uep_profile(bitrate, prot_level)
    else:
        lengths, pis = puncture.eep_profile(bitrate, prot_level,
                                            protection[-1])
    return puncture.puncture_mask(lengths, pis)


def decode_subchannel(subch_soft: jnp.ndarray, g: SubchGeometry,
                      deinterleave: bool = True) -> jnp.ndarray:
    """Decode one subchannel's CIF slices.

    ``subch_soft``: [..., T, length_cus*64] soft bits for T consecutive
    CIFs (leading dims batch, e.g. over subchannels of one bucket).
    Returns [..., T - 15, 24*bitrate] decoded logical-frame bits (int32),
    after time de-interleave, depuncture, Viterbi and energy dispersal
    (dab-concurrent.cpp:144-193 semantics; output CIF index t+15
    corresponds to transmitted logical frame t).
    """
    if g.protection == "UEP":
        lengths, pis = puncture.uep_profile(g.bitrate, g.prot_level)
    else:
        lengths, pis = puncture.eep_profile(g.bitrate, g.prot_level,
                                            g.protection[-1])
    soft = time_deinterleave(subch_soft) if deinterleave else subch_soft
    full = puncture.depuncture_profile(soft, lengths, pis)
    bits = viterbi.viterbi_decode(full, 24 * g.bitrate)
    return prbs.disperse(bits)


@functools.lru_cache(maxsize=None)
def _bucket_fn_cached(key: Tuple, mesh=None, packed: bool = False):
    """One jitted bucket decoder per (shape, mesh, output form), shared
    process-wide: many receivers (channel scan, config-5 multi-channel)
    with same-shaped subchannels reuse one compiled program instead of
    recompiling per EnsembleDecoder instance.

    ``stacked`` [n_subch, T, length*64] -> bits [n_subch, T-15, 24*bitrate]
    or, with ``packed``, bytes [n_subch, T-15, 3*bitrate] (the product
    receiver moves decoded frames as bytes, 8x smaller, and the host audio
    plane consumes bytes anyway).  With a ``mesh`` the subchannel axis is
    split over every device by ``shard_map``, so each device runs the
    Viterbi kernel on its own subchannels."""
    length_cus, bitrate, protection, prot_level = key
    proto = SubchGeometry(-1, 0, length_cus, bitrate, protection,
                          prot_level)

    def run(stacked):
        bits = decode_subchannel(stacked, proto)
        return pack_bits_u8(bits) if packed else bits

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        spec = P(tuple(mesh.axis_names), None, None)
        run = jax.shard_map(run, mesh=mesh, in_specs=spec, out_specs=spec,
                            check_vma=False)
    return jax.jit(run)


def pack_bits_u8(bits: jnp.ndarray) -> jnp.ndarray:
    """Device-side np.packbits: (..., 8k) 0/1 -> (..., k) uint8, MSB first.

    Elementwise f32 weighted sum (values <= 255, exact in f32)."""
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.float32)
    x = bits.astype(jnp.float32).reshape(bits.shape[:-1] + (-1, 8))
    return (x * w).sum(axis=-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("shape_struct",))
def _fused_msc(hist, cifs, blob, starts, shape_struct):
    """One jitted program for the whole per-block MSC device chain:
    history concat -> per-bucket subchannel slicing -> decode -> bit-pack
    -> merge with the demod/FIC blob -> new history window.

    One cached jit call, shared process-wide, replaces the 5-8 eager
    concats/stacks per channel per block of an unfused path.  Only the
    bucket SHAPE structure is static (``shape_struct`` = ((shape_key,
    n_subch), ...)); the CU start addresses ride as the traced ``starts``
    vector, so every channel tuning same-shaped services shares one
    program regardless of where its subchannels sit in the CIF.
    """
    block = jnp.concatenate([hist, cifs], axis=0)
    T = block.shape[0]
    parts = [blob]
    off = 0
    for shape_key, n_subch in shape_struct:
        length_cus, bitrate, protection, prot_level = shape_key
        proto = SubchGeometry(-1, 0, length_cus, bitrate, protection,
                              prot_level)
        slices = jnp.stack([
            jax.lax.dynamic_slice(
                block, (0, starts[off + i] * CU_BITS),
                (T, length_cus * CU_BITS))
            for i in range(n_subch)])
        off += n_subch
        parts.append(pack_bits_u8(
            decode_subchannel(slices, proto)).ravel())
    merged = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return merged, block[-HISTORY:]


class EnsembleDecoder:
    """All-services MSC decoder over shape buckets.

    Groups subchannels with identical (size, bitrate, protection) and
    decodes each bucket as one vmapped Viterbi batch.  Returns per-subchannel
    logical-frame bits keyed by subch_id.

    With ``mesh`` set, each bucket's subchannel axis is padded to a multiple
    of the mesh size and split across every device (the expert-parallel
    axis of SURVEY.md §2.5) by ``shard_map``; per-subchannel math is
    unchanged, so outputs stay bit-identical to the single-device path.
    """

    def __init__(self, geometries: Sequence[SubchGeometry], p: DabParams,
                 mesh=None):
        self.p = p
        self.mesh = mesh
        self.geoms = list(geometries)
        self._buckets: Dict[Tuple, List[SubchGeometry]] = {}
        for g in self.geoms:
            self._buckets.setdefault(g.shape_key, []).append(g)

    def _sharded(self, slices: jnp.ndarray, n_geoms: int) -> jnp.ndarray:
        if self.mesh is None:
            return slices
        from jax.sharding import NamedSharding, PartitionSpec as P
        pad = (-n_geoms) % self.mesh.size
        if pad:        # pad-to-bucket: replicate subch 0, trimmed on read
            slices = jnp.concatenate(
                [slices, jnp.repeat(slices[:1], pad, axis=0)])
        return jax.device_put(slices, NamedSharding(
            self.mesh, P(tuple(self.mesh.axis_names), None, None)))

    def decode(self, cifs: jnp.ndarray) -> Dict[int, np.ndarray]:
        """``cifs``: [T, 55296] consecutive CIF soft bits (T > 15).

        Returns {subch_id: [T-15, 24*bitrate] bits}.
        """
        out: Dict[int, np.ndarray] = {}
        for key, geoms in self._buckets.items():
            slices = jnp.stack([
                cifs[:, g.start_addr * CU_BITS:
                     (g.start_addr + g.length_cus) * CU_BITS]
                for g in geoms])
            bits = _bucket_fn_cached(key, self.mesh)(
                self._sharded(slices, len(geoms)))
            bits_np = np.asarray(bits)    # one pull per bucket
            for i, g in enumerate(geoms):   # enumerate trims pad rows
                out[g.subch_id] = bits_np[i]
        return out

    def shape_struct(self) -> Tuple:
        """Static bucket SHAPE description for :func:`_fused_msc`."""
        return tuple((key, len(geoms))
                     for key, geoms in self._buckets.items())

    def fused(self, hist: jnp.ndarray, cifs: jnp.ndarray,
              blob: jnp.ndarray) -> Tuple:
        """Single-dispatch MSC chain (single-chip product path): returns
        ``(merged_u8, new_hist, bucket_meta)`` where bucket_meta lists
        (geoms, output_shape) in merge order for the host-side split."""
        if not hasattr(self, "_starts_dev"):
            self._starts_dev = jnp.asarray(np.array(
                [g.start_addr for geoms in self._buckets.values()
                 for g in geoms], np.int32))
        merged, new_hist = _fused_msc(hist, cifs, blob, self._starts_dev,
                                      self.shape_struct())
        n_out = int(hist.shape[0]) + int(cifs.shape[0]) - 15
        meta = [(geoms, (len(geoms), n_out, 3 * key[1]))
                for key, geoms in self._buckets.items()]
        return merged, new_hist, meta

    def dispatch(self, cifs: jnp.ndarray) -> List[Tuple]:
        """Mesh product path: dispatch every bucket WITHOUT syncing.

        Returns [(geoms, dev_bytes)] where dev_bytes is the un-pulled
        device array [n_subch(+pad), T-15, 3*bitrate] of bit-packed
        logical frames; the caller merges all buckets (and the demod/FIC
        taps) into ONE device->host pull per block."""
        out = []
        for key, geoms in self._buckets.items():
            slices = jnp.stack([
                cifs[:, g.start_addr * CU_BITS:
                     (g.start_addr + g.length_cus) * CU_BITS]
                for g in geoms])
            dev = _bucket_fn_cached(key, self.mesh, packed=True)(
                self._sharded(slices, len(geoms)))
            out.append((geoms, dev))
        return out
