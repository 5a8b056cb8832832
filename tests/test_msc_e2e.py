"""MSC end-to-end: modulated ensemble -> all-subchannel logical frames.

BASELINE.json configs 2 and 4 shapes (single-service full MSC decode and
all-services batched decode) on golden IQ, bit-exact against the
modulator's payload bits.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from dabjax.constants import get_mode
from dabjax.msc.cif import cifs_from_soft
from dabjax.msc.deinterleave import HISTORY
from dabjax.msc.subchannel import EnsembleDecoder, SubchGeometry
from dabjax.ofdm import acquisition, demod
from dabjax.tx.fig import ServiceSpec
from dabjax.tx.modulator import Modulator

SERVICES = [
    ServiceSpec(label="ALPHA", sid=0x5001, subch_id=3, start_addr=0,
                bitrate=128, protection="EEP-A", prot_level=3, kind="DAB+"),
    ServiceSpec(label="BRAVO", sid=0x5002, subch_id=7, start_addr=100,
                bitrate=96, protection="UEP", prot_level=3, kind="DAB"),
    ServiceSpec(label="CHARLIE", sid=0x5003, subch_id=9, start_addr=200,
                bitrate=64, protection="EEP-B", prot_level=2, kind="DAB+"),
]


@pytest.fixture(scope="module")
def decoded():
    p = get_mode(1)
    # need >15 CIFs of history + a few decodable logical frames:
    # 4 CIFs/frame -> 6 frames = 24 CIFs -> 9 decoded logical frames
    n_frames = 6
    mod = Modulator(mode=1, services=SERVICES)
    iq = mod.iq(n_frames, snr_db=25.0, sample_offset=333, seed=9)
    u0 = acquisition.acquire(iq, p)
    assert u0 is not None
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    soft, _ = demod.demodulate_frames(jnp.asarray(rows), p)
    cifs = cifs_from_soft(soft, p)
    geoms = [SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                           s.bitrate, s.protection, s.prot_level)
             for s in SERVICES]
    dec = EnsembleDecoder(geoms, p)
    return mod, dec.decode(cifs)


def test_all_subchannels_bit_exact(decoded):
    mod, out = decoded
    assert set(out) == {3, 7, 9}
    for s in SERVICES:
        bits = out[s.subch_id]
        n_lf = bits.shape[0]
        assert n_lf >= 5
        for t in range(n_lf):
            # decoded CIF index (t + 15) carries payload logical frame t
            want = mod.payload_bits(s.subch_id, t)
            np.testing.assert_array_equal(
                bits[t], want, err_msg=f"subch {s.subch_id} frame {t}")


@pytest.mark.parametrize("lvl,cus", [(5, 29), (4, 35), (3, 42), (2, 52)])
def test_56kbps_uep_closed_loop(lvl, cus):
    """56 kbit/s UEP (all four defined levels) decodes closed-loop — a
    capability the reference lacks entirely (deconvolve.cpp profileTable
    has no 56 entry).  Profile values are provisional; see
    fec/puncture.py::UEP_PROFILES."""
    p = get_mode(2)
    svc = [ServiceSpec(label="FIFTY6", sid=0x5601, subch_id=5, start_addr=0,
                       bitrate=56, protection="UEP", prot_level=lvl,
                       kind="DAB")]
    assert svc[0].length_cus == cus
    n_frames = 18                       # mode II: 1 CIF/frame
    mod = Modulator(mode=2, services=svc)
    iq = mod.iq(n_frames, snr_db=25.0, sample_offset=100, seed=56)
    u0 = acquisition.acquire(iq, p)
    assert u0 is not None
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    soft, _ = demod.demodulate_frames(jnp.asarray(rows), p)
    cifs = cifs_from_soft(soft, p)
    geom = SubchGeometry(5, 0, cus, 56, "UEP", lvl)
    out = EnsembleDecoder([geom], p).decode(cifs)[5]
    assert out.shape == (n_frames - HISTORY, 24 * 56)
    for t in range(out.shape[0]):
        np.testing.assert_array_equal(out[t], mod.payload_bits(5, t))


def test_unsupported_profile_is_skipped_not_fatal():
    """A subchannel signalling a profile this decoder lacks must be
    skipped (metric counted), never abort the whole-ensemble decode."""
    from dabjax.io.sources import NullSource
    from dabjax.runtime.config import ReceiverConfig
    from dabjax.runtime.receiver import Receiver

    r = Receiver(NullSource(), ReceiverConfig(mode=1))
    sc = r.db.subchannels.setdefault(11, type(
        "S", (), dict(subch_id=11, start_addr=0, length=40, uep_flag=0,
                      prot_level=1, eep_profile="", bitrate=56,
                      language=0, fec_scheme=0))())
    sc2 = r.db.subchannels.setdefault(12, type(
        "S", (), dict(subch_id=12, start_addr=40, length=42, uep_flag=0,
                      prot_level=3, eep_profile="", bitrate=56,
                      language=0, fec_scheme=0))())
    del sc, sc2
    geoms = r._geometries()
    # (56, UEP, 1) is undefined -> skipped; (56, UEP, 3) decodable
    assert [g.subch_id for g in geoms] == [12]
    assert r.metrics.unsupported_subch == 1


def test_single_service_matches_reference_semantics(decoded):
    """UEP service with padding bits decodes exactly (padding ignored)."""
    mod, out = decoded
    bravo = out[7]
    assert bravo.shape[1] == 24 * 96


def test_mode3_msc_bit_exact():
    """Mode III end to end: TFPR acquisition, 8-symbol FIC geometry and
    MSC payload decode at the 192-carrier mode.  The reference rejects
    Mode III outright (fic-handler.cpp:131-141) — this exceeds it; the
    recalled Table 46 PRS rows are round-trip-verified here."""
    p = get_mode(3)
    svc = [ServiceSpec(label="MODE3", sid=0x3301, subch_id=7, start_addr=0,
                       bitrate=64, protection="EEP-A", prot_level=2,
                       kind="DAB")]
    n_frames = 18                       # mode III: 1 CIF/frame
    mod = Modulator(mode=3, services=svc)
    iq = mod.iq(n_frames, snr_db=25.0, sample_offset=80, seed=33)
    u0 = acquisition.acquire(iq, p)
    assert u0 is not None
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    soft, _ = demod.demodulate_frames(jnp.asarray(rows), p)
    cifs = cifs_from_soft(soft, p)
    geom = SubchGeometry(7, 0, svc[0].length_cus, 64, "EEP-A", 2)
    out = EnsembleDecoder([geom], p).decode(cifs)[7]
    assert out.shape == (n_frames - HISTORY, 24 * 64)
    for t in range(out.shape[0]):
        np.testing.assert_array_equal(out[t], mod.payload_bits(7, t))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_fft_demod_matches_numpy(mode):
    """The jnp.fft demod (cuFFT on the GPU) against the float64 numpy
    reference with the carrier_bins gather, CFO rotation included.  Soft
    bits are rounded to integers, and float32 vs float64 can land on
    either side of a rounding boundary: |delta| <= 1 (one step)."""
    p = get_mode(mode)
    mod = Modulator(mode=mode, services=SERVICES[:1])
    n_frames = 2
    iq = mod.iq(n_frames, snr_db=20.0, seed=mode)
    u0 = p.T_null + p.T_g
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    cfo = np.array([37.5, -120.0][:n_frames], np.float32)
    got, _ = demod.demodulate_frames_cfo(jnp.asarray(rows),
                                         jnp.asarray(cfo), p)
    want = demod.demodulate_frames_np(rows, cfo, p)
    got = np.asarray(got)
    assert got.shape == want.shape == (n_frames, p.L - 1, 2 * p.K)
    assert np.max(np.abs(got - want)) <= 1.0
    assert np.mean(got == want) > 0.99
