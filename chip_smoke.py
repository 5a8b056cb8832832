#!/usr/bin/env python
"""Smoke test of the DAB receiver on one NVIDIA GPU: the quickest proof
that the system still starts and decodes correctly on the card.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --devices 4  # four cards: the mesh path only

Phases on one card, in order:

1. Device check: JAX's default device must be a GPU.  Prints its kind,
   the device count and the card's name and power limit (nvidia-smi).
2. Kernel checks at real widths: the CUDA Viterbi kernel bit-exact against
   ``viterbi_decode_np`` on all 384 FIC codewords of a 96-frame Mode I
   batch, on 256 of its 2,304-bit MSC codewords and on pure integer noise;
   the cuFFT demod's soft bits against the numpy reference within one
   rounding step.
3. (a) Full-ensemble decode: 12 x 96 kbps EEP-A3 subchannels (all 864
   CUs) plus the FIC over 96 frames (9.2 s of signal) through
   ``full_ensemble_pipeline``; every FIB passes its CRC and every decoded
   logical frame equals the transmitted payload.
   (b) Product receiver: ``Receiver.run`` on the mixed MP2 + two DAB+
   ensemble with audio and data on, 64-frame blocks, 2 warm-up and 4 timed
   blocks; FIB CRCs, AU CRCs and MP2 frames must pass.
   (c) CLI: ``dabjax.cli.main(["decode", ...])`` in this process on a u8
   ``.raw`` file from the modulator; the MP2 service decodes to a WAV.
4. The tests marked ``gpu``, in this process.

``--devices 4`` runs only ``sharded_ensemble_step`` on a (2, 2)
('time', 'subch') mesh, so the de-interleaver halo crosses cards, and
``Receiver(mesh=)``, each compared bit for bit with a one-card decode.

Every failure exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

FRAMES = 96                      # (a): 96 Mode I frames = 9.2 s of signal
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "smoke")


def log(msg):
    print(msg, flush=True)


CARD = ""                        # nvidia-smi's "name, power.limit"


def log_time(what, seconds, extra=""):
    """Every time printed names the card and its power limit."""
    log(f"TIME {what}: {seconds:.6f} s{extra} [{CARD}]")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ ensembles

def full_ensemble(n_frames):
    """(a)'s ensemble: 12 x 96 kbps EEP-A3 services fill all 864 CUs."""
    from dabjax.constants import get_mode
    from dabjax.iq import pack_iq
    from dabjax.msc.subchannel import SubchGeometry
    from dabjax.ofdm import demod
    from dabjax.tx.fig import ServiceSpec
    from dabjax.tx.modulator import Modulator

    p = get_mode(1)
    services = [
        ServiceSpec(label=f"S{i:02d}", sid=0x8100 + i, subch_id=i,
                    start_addr=i * 72, bitrate=96, protection="EEP-A",
                    prot_level=3, kind="DAB+")
        for i in range(12)]
    geoms = tuple(SubchGeometry(s.subch_id, s.start_addr, s.length_cus,
                                s.bitrate, s.protection, s.prot_level)
                  for s in services)
    mod = Modulator(mode=1, services=services)
    iq = mod.iq(n_frames, snr_db=None)
    u0 = p.T_null + p.T_g
    need = demod.min_frame_samples(p)
    rows = np.stack([iq[u0 + f * p.T_F: u0 + f * p.T_F + need]
                     for f in range(n_frames)])
    return p, mod, geoms, rows, pack_iq(rows)


def check_payloads(mod, geoms, bits, first_row=0):
    """Every decoded row ``first_row + t`` equals logical frame t."""
    n = bits.shape[1] - first_row
    for i, g in enumerate(geoms):
        for t in range(n):
            if not np.array_equal(bits[i, first_row + t],
                                  mod.payload_bits(g.subch_id, t)):
                raise AssertionError(
                    f"subch {g.subch_id} logical frame {t} differs from "
                    "the transmitted payload")
    return len(geoms) * n


# ------------------------------------------------------- phase 2: kernels

def phase_kernels(p, geoms, rows, rows_pairs):
    import jax
    import jax.numpy as jnp

    from dabjax.fec import puncture
    from dabjax.fec.viterbi import viterbi_decode_np
    from dabjax.fec.viterbi_cuda import viterbi_decode_cuda
    from dabjax.iq import unpack_iq
    from dabjax.msc.cif import cifs_from_soft
    from dabjax.msc.deinterleave import time_deinterleave
    from dabjax.ofdm import demod

    @jax.jit
    def front(pairs):
        x = unpack_iq(pairs)
        fine = demod.fine_cfo_estimate(x, p)
        soft, _ = demod.demodulate_frames_cfo(x, fine, p)
        fic = puncture.depuncture_profile(
            soft[:, : p.fic_symbols, :].reshape(soft.shape[0], 4, -1),
            [21, 3], [16, 15])
        cifs = cifs_from_soft(soft, p)
        g = geoms[0]
        lengths, pis = puncture.eep_profile(g.bitrate, g.prot_level, "A")
        slices = jnp.stack([
            cifs[:, h.start_addr * 64: (h.start_addr + h.length_cus) * 64]
            for h in geoms])
        msc = puncture.depuncture_profile(time_deinterleave(slices),
                                          lengths, pis)
        return soft, fine, fic, msc

    soft, fine, fic, msc = jax.block_until_ready(front(rows_pairs))

    # demod: cuFFT float32 vs float64 numpy; soft bits are rounded, so
    # the two can fall either side of a rounding boundary: |d| <= 1
    want = demod.demodulate_frames_np(rows, np.asarray(fine), p)
    diff = np.abs(np.asarray(soft) - want)
    log(f"demod vs numpy: {want.size} soft bits, max |d| = {diff.max()}, "
        f"{int((diff > 0).sum())} differ by one step")
    check(diff.max() <= 1.0, "demod soft bits differ from numpy by > 1")

    # Viterbi: exact integer arithmetic, so bit-exact
    cases = {
        "FIC": (np.asarray(fic).reshape(-1, fic.shape[-1]), 768),
        "MSC": (np.asarray(msc).reshape(-1, msc.shape[-1])[::17][:256],
                24 * geoms[0].bitrate),
        "noise": (np.random.default_rng(0).integers(
            -127, 128, (64, 4 * (2304 + 6))).astype(np.float32), 2304),
    }
    for name, (x, nbits) in cases.items():
        got = np.asarray(viterbi_decode_cuda(jnp.asarray(x), nbits))
        ref = viterbi_decode_np(x, nbits)
        check(np.array_equal(got, ref),
              f"CUDA Viterbi differs from numpy on {name}: "
              f"{int((got != ref).sum())} bits")
        log(f"viterbi {name}: {x.shape[0]} codewords x {nbits} bits "
            "bit-exact vs viterbi_decode_np")


# ------------------------------------------------- phase 3a: full ensemble

def phase_full_ensemble(p, mod, geoms, rows_pairs):
    import jax
    import jax.numpy as jnp

    from dabjax.runtime.pipeline import full_ensemble_pipeline

    x = jax.device_put(jnp.asarray(rows_pairs))
    t0 = time.perf_counter()
    compiled = jax.jit(full_ensemble_pipeline(p, geoms)).lower(x).compile()
    log_time("(a) compile", time.perf_counter() - t0)
    log(f"(a) memory_analysis: {compiled.memory_analysis()}")
    ok, bits = jax.block_until_ready(compiled(x))
    ok = np.asarray(ok)
    check(int(ok.sum()) == ok.size, f"(a) FIC CRC: {int(ok.sum())}/{ok.size}")
    n = check_payloads(mod, geoms, np.asarray(bits))
    log(f"(a) {ok.size} FIBs pass CRC; {n} logical frames equal the payload")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(x))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    sig = rows_pairs.shape[0] * p.T_F / 2_048_000
    log_time("(a) batch (median of 5)", dt,
              f", {sig / dt:.1f}x realtime over {sig:.3f} s of signal")


# ----------------------------------------------- phase 3b: product receiver

def phase_receiver(frames_per_block=64, timed_blocks=4):
    import bench

    mixed = bench._bench_services("mixed")
    rt, _, m, _ = bench._receiver_bench(
        mixed, dict(decode_audio=True, decode_data=True), warm_blocks=2,
        timed_blocks=timed_blocks,
        iq=bench._make_loop_iq(mixed, n_frames=frames_per_block),
        frames_per_block=frames_per_block)
    log(f"(b) {m.dashboard()} au_ok={m.au_ok} au_bad={m.au_bad} "
        f"mp2_frames_ok={m.mp2_frames_ok} mp2_frames_bad={m.mp2_frames_bad}")
    check(m.fic_crc_ok > 0, "(b) no FIB passed its CRC")
    check(m.au_ok > 0, "(b) no DAB+ access unit passed its CRC")
    check(m.mp2_frames_ok > 0, "(b) no MP2 frame decoded")
    sig = timed_blocks * frames_per_block * 196608 / 2_048_000
    log_time(f"(b) {timed_blocks} blocks of {frames_per_block} frames",
              sig / rt, f", {rt}x realtime")


# ------------------------------------------------------------ phase 3c: CLI

def make_raw(path, n_frames=16):
    """u8 IQ of a one-service MP2 ensemble (as tests/test_cli.py does)."""
    from dabjax.audio.mp2 import Mp2Encoder
    from dabjax.tx.fig import ServiceSpec
    from dabjax.tx.modulator import Modulator

    enc = Mp2Encoder(bitrate=96, mode=3)
    t = np.arange(1152 * 40) / 48000
    sig = 0.4 * np.sin(2 * np.pi * 660 * t)
    frames = [np.unpackbits(np.frombuffer(
        enc.encode(sig[i * 1152:(i + 1) * 1152]), np.uint8))
        for i in range(40)]
    svc = [ServiceSpec(label="CLITEST", sid=0x3001, subch_id=3,
                       start_addr=0, bitrate=96, protection="EEP-A",
                       prot_level=3, kind="DAB")]
    mod = Modulator(mode=1, services=svc,
                    payloads={3: lambda ci: frames[ci % 40]}, amplitude=0.3)
    iq = mod.iq(n_frames, snr_db=40.0)
    u8 = np.empty(2 * iq.shape[0], np.uint8)
    u8[0::2] = np.clip(np.real(iq) * 128 + 128, 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.imag(iq) * 128 + 128, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(u8.tobytes())


def phase_cli(work_dir):
    import wave

    from dabjax.cli import main

    os.makedirs(work_dir, exist_ok=True)
    raw = os.path.join(work_dir, "ensemble.raw")
    wav = os.path.join(work_dir, "out.wav")
    make_raw(raw)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(["decode", raw, "--service", "CLITEST", "--out", wav,
                   "--blocks", "4", "--json"])
    log_time("(c) CLI decode of 16 frames", time.perf_counter() - t0)
    text = out.getvalue()
    log("(c) " + text.strip().replace("\n", "\n(c) "))
    check(rc == 0, f"(c) decode returned {rc}")
    metrics = json.loads(text.strip().splitlines()[-1])
    check(metrics["fic_crc_ok"] > 0, "(c) no FIB passed its CRC")
    check(metrics["mp2_frames_ok"] > 0, "(c) no MP2 frame decoded")
    with wave.open(wav) as w:
        check(w.getframerate() == 48000 and w.getnchannels() == 2,
              "(c) WAV is not 48 kHz stereo")
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    left = pcm[0::2].astype(np.float64)
    peak = np.argmax(np.abs(np.fft.rfft(left))) * 48000 / left.size
    log(f"(c) WAV: {left.size} frames, tone at {peak:.1f} Hz")
    check(left.size > 10000 and abs(peak - 660) < 5,
          "(c) decoded audio is not the transmitted 660 Hz tone")


# ------------------------------------------------------ phase 4: gpu tests

def phase_gpu_tests():
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      os.path.join(root, "tests")])
    check(rc == 0, f"tests marked gpu: pytest exit code {int(rc)}")


# ----------------------------------------------------------- four cards

def phase_mesh(n_devices, n_frames=FRAMES, blocks=3, frames_per_block=64):
    import jax

    import bench
    from dabjax.parallel.mesh import make_mesh
    from dabjax.parallel.sharding import (make_sharded_inputs,
                                          sharded_ensemble_step)
    from dabjax.runtime.config import ReceiverConfig
    from dabjax.runtime.pipeline import full_ensemble_pipeline
    from dabjax.runtime.receiver import Receiver

    check(n_devices == 4, "the mesh phase runs on four devices")
    mesh = make_mesh(4, (2, 2))
    p, mod, geoms, rows, pairs = full_ensemble(n_frames)

    # sharded step: frames over 'time' (the ppermute halo crosses
    # cards), subchannels over 'subch'
    step = sharded_ensemble_step(mesh, p, geoms[0])
    starts = np.array([g.start_addr for g in geoms], np.int32)
    rows_d, starts_d = make_sharded_inputs(mesh, rows, starts)
    fic_ratio, bits = jax.block_until_ready(step(rows_d, starts_d))
    check(float(fic_ratio) == 1.0, f"sharded FIC ratio {float(fic_ratio)}")
    bits = np.asarray(bits)
    # one-card decode of the same rows, on device 0
    ok1, bits1 = jax.jit(full_ensemble_pipeline(p, geoms))(
        jax.device_put(pairs, jax.devices()[0]))
    bits1 = np.asarray(bits1)
    check(int(np.asarray(ok1).sum()) == np.asarray(ok1).size,
          "one-card FIC CRC")
    # sharded row 15 + t is logical frame t (rank 0 has no halo)
    check(np.array_equal(bits[:, 15:], bits1),
          "sharded step differs from the one-card decode")
    n = check_payloads(mod, geoms, bits, first_row=15)
    log(f"mesh (2, 2) sharded_ensemble_step: {bits.shape} bit-identical to "
        f"one card; {n} logical frames equal the payload")

    # product receiver with mesh= against one card, logical frames
    # captured bit for bit
    mixed = bench._bench_services("mixed")
    iq = bench._make_loop_iq(mixed)

    def capture(store):
        class Cap:
            def __init__(self):
                self.frames = []

            def add_logical_frame(self, b):
                self.frames.append(np.asarray(b).copy())

        return lambda db, subch_id: store.setdefault(subch_id, Cap())

    cfg = ReceiverConfig(frames_per_block=frames_per_block,
                         decode_audio=False, decode_data=True)
    got = {}
    for name, m in (("one", None), ("mesh", mesh)):
        store = {}
        rx = Receiver(bench._LoopSource(iq), cfg,
                      data_handler_factory=capture(store), mesh=m)
        rx.run(blocks)
        rx.close()
        check(rx.metrics.fic_crc_ok > 0, f"{name}: no FIB passed its CRC")
        got[name] = store
    one, sharded = got["one"], got["mesh"]
    check(set(one) == set(sharded) and one, "receivers saw other subchannels")
    for k in one:
        check(np.array_equal(np.stack(one[k].frames),
                             np.stack(sharded[k].frames)),
              f"Receiver(mesh=) differs from one card on subch {k}")
    log(f"Receiver(mesh=(2, 2)): {len(one)} subchannels, "
        f"{sum(len(v.frames) for v in one.values())} logical frames "
        "bit-identical to one card")


# ------------------------------------------------------------------ main

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh path")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default device platform "
                 f"{devs[0].platform!r})")
    if len(devs) < args.devices:
        sys.exit(f"chip_smoke: {args.devices} GPUs asked, {len(devs)} found")

    from dabjax.runtime.environment import (card_name_and_power,
                                            enable_compile_cache)
    enable_compile_cache()
    global CARD
    card = card_name_and_power()
    CARD = card.splitlines()[0]
    log(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}")
    log(card)

    t_all = time.perf_counter()
    if args.devices == 4:
        phase_mesh(4)
    else:
        p, mod, geoms, rows, pairs = full_ensemble(FRAMES)
        phase_kernels(p, geoms, rows, pairs)
        phase_full_ensemble(p, mod, geoms, pairs)
        phase_receiver()
        phase_cli(os.path.join(OUT_DIR, "cli"))
        phase_gpu_tests()
    log_time("chip_smoke total", time.perf_counter() - t_all)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
