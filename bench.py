#!/usr/bin/env python
"""Benchmark: full-ensemble DAB decode throughput on one GPU.

Measures the jitted OFDM demod + FIC + all-subchannel MSC Viterbi pipeline
(BASELINE.json config 4: every subchannel of the CIF decoded concurrently)
on synthesized Mode I IQ, and reports the real-time factor per device.

Baseline = the reference receiver's implicit 1.0x real-time decode of a
single subchannel at 2.048 Msps on a desktop CPU (BASELINE.md), so
vs_baseline == the measured real-time factor.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, with
the device's platform, kind and count and the card's name and power limit.
"""

import json
import sys

import numpy as np


def _timed_run(fn, rows) -> float:
    """Wall time of one dispatch of the in-graph timing loop (the scalar
    fetch forces completion)."""
    import time as _t
    t0 = _t.perf_counter()
    float(fn(rows))
    return _t.perf_counter() - t0


def _stage_breakdown(p, geoms, rows, iters):
    """Per-stage seconds via cumulative-prefix timing (each prefix is its
    own in-graph fori_loop program; stage cost = adjacent difference)."""
    import jax
    import jax.numpy as jnp
    from dabjax.runtime.pipeline import pipeline_stages

    prefix_t = {}
    for name, fn in pipeline_stages(p, geoms).items():
        @jax.jit
        def timed(rows, fn=fn):
            def body(_, acc):
                return acc + fn(rows + acc * 0.0) * 1e-9
            return jax.lax.fori_loop(0, iters, body, jnp.float32(0))
        float(jax.block_until_ready(timed(rows)))      # compile + warm
        prefix_t[name] = min(_timed_run(timed, rows) for _ in range(3)) / iters

    order = ["demod", "fic", "deint_depunct", "full"]
    out, prev = {}, 0.0
    for name in order:
        out[name if name != "full" else "viterbi_dispersal"] = \
            round(prefix_t[name] - prev, 6)
        prev = prefix_t[name]
    return out


class _LoopSource:
    """Pre-rendered IQ replayed cyclically: receiver benchmarks must not
    time the modulator.  The loop length is a whole number of frames so
    the PRS grid stays periodic; the deinterleaver/audio glitch at the
    seam is <2%% of frames and CRC-gated.

    Exposes ``read_u8`` (8-bit quantized, the native SDR front-end
    format) so the receiver takes its u8 device-upload fast path — what
    a real deployment would see."""

    sample_rate = 2_048_000

    def __init__(self, iq):
        self._iq = np.ascontiguousarray(iq)
        x = np.stack([iq.real, iq.imag], axis=-1)
        self._u8 = np.clip(np.round(x * 90.0 + 128.0), 0,
                           255).astype(np.uint8)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            take = min(n - got, self._iq.shape[0] - self._pos)
            out[got: got + take] = self._iq[self._pos: self._pos + take]
            got += take
            self._pos = (self._pos + take) % self._iq.shape[0]
        return out

    def read_u8(self, n: int) -> np.ndarray:
        out = np.empty((n, 2), np.uint8)
        got = 0
        while got < n:
            take = min(n - got, self._u8.shape[0] - self._pos)
            out[got: got + take] = self._u8[self._pos: self._pos + take]
            got += take
            self._pos = (self._pos + take) % self._u8.shape[0]
        return out


def _bench_services(kind):
    """Service sets for the BASELINE configs (fixture content from tx/)."""
    from dabjax.tx.fig import ServiceSpec
    if kind == "mp2":
        return [ServiceSpec(label="MP2SVC", sid=0x8201, subch_id=1,
                            start_addr=0, bitrate=96, protection="EEP-A",
                            prot_level=3, kind="MP2")]
    if kind == "dabplus":
        return [ServiceSpec(label="DAB+SVC", sid=0x8202, subch_id=2,
                            start_addr=0, bitrate=96, protection="EEP-A",
                            prot_level=3, kind="DAB+")]
    # mixed multi-service ensemble: DAB+, MP2 audio side by side
    return [
        ServiceSpec(label="DAB+SVC", sid=0x8202, subch_id=2, start_addr=0,
                    bitrate=96, protection="EEP-A", prot_level=3,
                    kind="DAB+"),
        ServiceSpec(label="MP2SVC", sid=0x8201, subch_id=1, start_addr=72,
                    bitrate=96, protection="EEP-A", prot_level=3,
                    kind="MP2"),
        ServiceSpec(label="DAB+SV2", sid=0x8203, subch_id=3, start_addr=144,
                    bitrate=96, protection="EEP-A", prot_level=3,
                    kind="DAB+"),
    ]


def _mp2_payload_gen(seed=0):
    """Real MP2 frames (880 Hz tone) cycled over the loop."""
    from dabjax.audio.mp2 import Mp2Encoder
    enc = Mp2Encoder(bitrate=96, mode=3)
    n = 40
    t = np.arange(1152 * n) / 48000
    sig = 0.4 * np.sin(2 * np.pi * (880 + 20 * seed) * t)
    frames = [np.unpackbits(np.frombuffer(
        enc.encode(sig[i * 1152:(i + 1) * 1152]), np.uint8))
        for i in range(n)]
    return lambda cif: frames[cif % n]


def _dabplus_payload_gen(bitrate=96, seed=0):
    """Real HE-AAC superframes (tone through the SBR fixture encoder)."""
    from dabjax.audio import mp4
    from dabjax.audio.sbr import SbrHeader
    from dabjax.tx.sbr_enc import HeAacEncoder, SbrWriter
    w = SbrWriter(SbrHeader(), 48000)
    nb = w.ft.n_low
    bits = w.sce_payload([np.full(nb, 52, int)],
                         [np.full(w.ft.n_q, 10, int)],
                         invf=[2] * w.ft.n_q)
    n_sf = 12
    t = np.arange(n_sf * 3 * 960) / 24000
    tone = 0.3 * np.sin(2 * np.pi * (2000 + 100 * seed) * t)
    aus = HeAacEncoder(6, 1, 960, lambda i: bits, max_q=400).encode(tone)
    frames = [mp4.build_superframe(bitrate, aus[3 * i: 3 * i + 3],
                                   dac_rate=1, sbr_flag=1,
                                   aac_channel_mode=0)
              for i in range(n_sf)]

    def payload(cif):
        sf, part = divmod(cif, 5)
        return np.unpackbits(frames[sf % n_sf][part])

    return payload


def _make_loop_iq(services, n_frames=64, seed=0):
    from dabjax.tx.modulator import Modulator
    payloads = {}
    for s in services:
        if s.kind == "MP2":
            payloads[s.subch_id] = _mp2_payload_gen(seed)
        else:
            payloads[s.subch_id] = _dabplus_payload_gen(s.bitrate, seed)
    mod = Modulator(mode=1, services=services, payloads=payloads)
    return mod.iq(n_frames, snr_db=None).astype(np.complex64)


def _receiver_bench(services, cfg_kwargs, warm_blocks=2, timed_blocks=4,
                    iq=None, gate=None, frames_per_block=64,
                    want_profile=False):
    """Wall-clock realtime factor of the product Receiver.run() —
    steady-state blocks after compile/warm-up; host parsing included.

    64-frame blocks (6.1 s of signal); the receiver performs exactly one
    device sync per block (ROADMAP Speed 6 queues a block-size sweep)."""
    import time as _t

    from dabjax.constants import get_mode
    from dabjax.runtime.config import ReceiverConfig
    from dabjax.runtime.receiver import Receiver

    if iq is None:
        iq = _make_loop_iq(services)
    cfg = ReceiverConfig(frames_per_block=frames_per_block, **cfg_kwargs)
    rx = Receiver(_LoopSource(iq), cfg)
    rx.run(warm_blocks)                      # compile + FIC lock + warm
    rx.profiler.stages.clear()
    for svc in rx.audio.values():
        svc.decode_seconds = 0.0
    t0 = _t.perf_counter()
    rx.run(timed_blocks)
    dt = _t.perf_counter() - t0
    p = get_mode(cfg.mode)
    samples = timed_blocks * cfg.frames_per_block * p.T_F
    sig_s = samples / 2_048_000
    rt = sig_s / dt
    m = rx.metrics
    ok = m.fic_crc_ok > 0
    if gate == "audio":
        ok = ok and (m.au_ok > 0 or m.mp2_frames_ok > 0)
    profile = None
    if want_profile:
        profile = {name: round(st.seconds / sig_s, 4)
                   for name, st in rx.profiler.stages.items()}
        profile["audio_decode"] = round(
            sum(s.decode_seconds for s in rx.audio.values()) / sig_s, 4)
        profile["unit"] = "host-seconds per signal-second (audio on " \
                          "worker threads, overlaps pull)"
    rx.close()
    return round(rt, 2), ok, m, profile


def _bench_configs():
    """BASELINE.json configs 1/2/3 on the product Receiver path."""
    out = {}
    mixed = _bench_services("mixed")
    iq_mixed = _make_loop_iq(mixed)
    rt, ok, _, _ = _receiver_bench(
        mixed, dict(decode_audio=False, decode_data=False),
        iq=iq_mixed)
    out["config1_fic_only"] = {"realtime_factor": rt, "fic_ok": bool(ok)}
    rt, ok, m, _ = _receiver_bench(
        _bench_services("mp2"),
        dict(service="MP2SVC", decode_data=False), gate="audio")
    out["config2_mp2_service"] = {"realtime_factor": rt,
                                  "decoded_ok": bool(ok),
                                  "mp2_frames_ok": int(m.mp2_frames_ok)}
    rt, ok, m, _ = _receiver_bench(
        _bench_services("dabplus"),
        dict(service="DAB+SVC", decode_data=False), gate="audio")
    out["config3_dabplus_service"] = {"realtime_factor": rt,
                                      "decoded_ok": bool(ok),
                                      "au_ok": int(m.au_ok)}
    rt, ok, m, prof = _receiver_bench(
        mixed, dict(decode_audio=True, decode_data=True),
        iq=iq_mixed, gate="audio", want_profile=True)
    out["receiver_realtime"] = {
        "realtime_factor": rt, "decoded_ok": bool(ok),
        "au_ok": int(m.au_ok), "mp2_frames_ok": int(m.mp2_frames_ok),
        "host_profile": prof,
        "note": "full Receiver.run(), audio+data handlers on, host "
                "parsing included (in-process audio threads, PCM kept)",
    }
    rt, ok, m, _ = _receiver_bench(
        mixed, dict(decode_audio=True, decode_data=True, audio_workers=2),
        iq=iq_mixed, gate="audio")
    out["receiver_realtime_workers"] = {
        "realtime_factor": rt, "decoded_ok": bool(ok),
        "au_ok": int(m.au_ok), "mp2_frames_ok": int(m.mp2_frames_ok),
        "note": "audio plane in 2 worker processes (the scan/monitor "
                "deployment shape; counters gated, PCM in workers)",
    }
    return out


def _run_bank(n_channels, n_blocks, cfgs, iqs, reps=4):
    """Best-of-``reps`` sustained wall measurement (each rep spans
    n_blocks full bank periods)."""
    import time as _t

    from dabjax.constants import get_mode
    from dabjax.parallel.multihost import MultiReceiver

    bank = MultiReceiver({f"ch{i:02d}": _LoopSource(iqs[i % len(iqs)])
                          for i in range(n_channels)}, cfgs)
    # warm THE BANK: 2 blocks compile every shared program including the
    # bank-width blob merge and the fused MSC chain (warming a 1-channel
    # bank left 8 s of compilation inside the timed region in r5's first
    # measurement), and let the FIC lock so MSC decode is active
    bank.run(2)
    dt = float("inf")
    for _ in range(reps):
        t0 = _t.perf_counter()
        metrics = bank.run(n_blocks)
        dt = min(dt, _t.perf_counter() - t0)
    bank.close()
    p = get_mode(1)
    fpb = next(iter(cfgs.values())).frames_per_block if isinstance(
        cfgs, dict) else cfgs.frames_per_block
    agg = n_channels * n_blocks * fpb * p.T_F / 2_048_000 / dt
    ok = sum(1 for m in metrics.values()
             if m.fic_crc_ok > 0 and (m.au_ok > 0 or m.mp2_frames_ok > 0))
    return agg, ok


def _bench_multichannel(n_channels=8, n_blocks=2):
    """BASELINE config 5 ("multi-channel band-III scan: 8+ ensembles ...
    sustained real-time"): n channels decoded concurrently on this host
    as one MultiReceiver bank (lock-step blocks, ONE merged device sync
    per period; audio in 2 worker processes).

    The gated workload tunes ONE audio service per ensemble — the
    reference's own receiver shape (it decodes exactly one selected
    service; its band scan decodes none, gui.cpp:561-638), so this
    already exceeds the reference's scan semantics.  The all-services
    variant (every subchannel of every ensemble decoded to audio, 24
    concurrent decoders — a workload the reference cannot express) is
    reported alongside.

    Four distinct ensembles rotate across the channels (distinct payload
    tones) so jit-cache sharing cannot flatter the number (r4 weak #6)."""
    from dabjax.runtime.config import ReceiverConfig

    mixed = _bench_services("mixed")
    iqs = [_make_loop_iq(mixed, seed=s) for s in range(4)]
    labels = [s.label for s in mixed]
    scan_cfgs = {
        f"ch{i:02d}": ReceiverConfig(
            frames_per_block=128, decode_audio=True, decode_data=False,
            service=labels[i % len(labels)], audio_workers=2)
        for i in range(n_channels)}
    agg, ok = _run_bank(n_channels, n_blocks, scan_cfgs, iqs)
    sustained = bool(agg / n_channels >= 1.0) and ok == n_channels
    out = {
        "channels": n_channels,
        "aggregate_realtime_factor": round(agg, 2),
        "per_channel_realtime_factor": round(agg / n_channels, 2),
        "channels_decoding_audio": ok,
        "distinct_ensembles": 4,
        "workload": "one tuned audio service per ensemble (the "
                    "reference receiver shape; its scan decodes none)",
        "sustained_realtime": sustained,
    }
    if not sustained:
        out["note"] = ("FAIL: BASELINE config 5 demands sustained "
                       ">=1.0x per channel with all channels decoding")
    all_cfg = ReceiverConfig(frames_per_block=128, decode_audio=True,
                             decode_data=False, audio_workers=2)
    agg2, ok2 = _run_bank(n_channels, n_blocks, all_cfg, iqs)
    out["all_services_variant"] = {
        "aggregate_realtime_factor": round(agg2, 2),
        "per_channel_realtime_factor": round(agg2 / n_channels, 2),
        "channels_decoding_audio": ok2,
        "note": "every subchannel of every ensemble decoded to audio "
                "(24 concurrent decoders)",
    }
    return out


def main():
    import jax
    import jax.numpy as jnp

    from dabjax.runtime.environment import (describe_device,
                                            enable_compile_cache)
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found "
                 f"{jax.devices()[0].platform}")

    from dabjax.constants import INPUT_RATE, get_mode
    from dabjax.ofdm import demod
    from dabjax.runtime.pipeline import full_ensemble_pipeline
    from dabjax.msc.subchannel import SubchGeometry
    from dabjax.tx.fig import ServiceSpec
    from dabjax.tx.modulator import Modulator

    p = get_mode(1)
    # 12 x 96 kbps EEP-A P3 services fill the CIF: 12 x 72 = 864 CUs
    services = [
        ServiceSpec(label=f"S{i:02d}", sid=0x8100 + i, subch_id=i,
                    start_addr=i * 72, bitrate=96, protection="EEP-A",
                    prot_level=3, kind="DAB+")
        for i in range(12)
    ]
    geoms = tuple(
        SubchGeometry(s.subch_id, s.start_addr, s.length_cus, s.bitrate,
                      s.protection, s.prot_level) for s in services)

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    mod = Modulator(mode=1, services=services)
    iq = mod.iq(n_frames, snr_db=None)
    u0 = p.T_null + p.T_g
    need = demod.min_frame_samples(p)
    from dabjax.iq import pack_iq
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    rows = jax.device_put(jnp.asarray(pack_iq(rows)))

    fn = jax.jit(full_ensemble_pipeline(p, geoms))
    # compile + correctness gate: all FIBs must pass CRC
    ok, bits = jax.block_until_ready(fn(rows))
    assert int(jnp.sum(ok)) == ok.size, "FIC CRC failed on clean golden IQ"
    # decode_subchannel output row t carries transmitted logical frame t
    # (the 15-CIF de-interleaver warm-up is consistent from stream start in
    # the modulator); gate on a post-warm-up span to be safe.
    bits_np = np.asarray(bits)
    for s in (0, 5, 11):
        for t in range(15, 20):
            want = mod.payload_bits(s, t)
            assert np.array_equal(bits_np[s, t], want), \
                f"MSC decode mismatch on golden IQ: subch {s} frame {t}"

    # Time `iters` pipeline executions inside ONE compiled program (a
    # fori_loop with a data dependency between iterations), so that
    # dispatch latency is not timed with the device work.
    pipe = full_ensemble_pipeline(p, geoms)

    @jax.jit
    def timed(rows):
        def body(_, acc):
            ok_i, bits_i = pipe(rows + acc * 0.0)
            # consume BOTH outputs or XLA dead-code-eliminates the MSC path
            return (acc + jnp.sum(ok_i).astype(jnp.float32)
                    + jnp.sum(bits_i).astype(jnp.float32) * 1e-9)
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

    float(jax.block_until_ready(timed(rows)))          # compile + warm
    dt = min(_timed_run(timed, rows) for _ in range(3)) / iters

    stages = _stage_breakdown(p, geoms, rows, max(4, iters // 2))

    samples = n_frames * p.T_F
    sps = samples / dt
    rt = sps / INPUT_RATE
    # coded Viterbi throughput: full CIF (2.304 Mbit per 24 ms) + FIC
    msc_coded_bits = n_frames * 4 * 864 * 64
    fic_coded_bits = n_frames * 4 * 2304
    viterbi_mbps = (msc_coded_bits + fic_coded_bits) / dt / 1e6

    result = {
        "metric": "full_ensemble_realtime_factor_per_chip",
        "value": round(rt, 2),
        "unit": "x realtime (2.048 Msps, all 12 subchannels + FIC)",
        "vs_baseline": round(rt, 2),
        "extra": {
            "samples_per_sec": int(sps),
            "viterbi_coded_mbit_per_sec": round(viterbi_mbps, 1),
            "frames_per_batch": n_frames,
            "seconds_per_batch": round(dt, 4),
            "device": describe_device(),
            "stage_seconds": stages,
            "configs": _bench_configs(),
            "multi_channel": _bench_multichannel(),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
