"""IQ input sources (L0 of SURVEY.md §1).

The reference's device zoo (dabstick/SDRplay/Airspy/UHD/rtl_tcp/ExtIO,
``src/input/*``) exists to fill a ring buffer with normalized complex
floats; in this framework the device plane is a small Source protocol that
yields numpy blocks which the runtime stages onto the GPU.  Implemented
here: the two file-replay sources that the reference also uses as its
deterministic test backends (``rawfiles.cpp``, ``wavfiles.cpp``), a
modulator-backed synthetic source, the null device, and an rtl_tcp network
client (see dabjax.io.rtl_tcp).  Real-time pacing is optional — the decode
plane is block-based and happily runs faster than real time.
"""

from __future__ import annotations

import struct
import time
from typing import Iterator, Optional, Protocol

import numpy as np

__all__ = ["Source", "RawFileSource", "WavFileSource", "NullSource",
           "SyntheticSource", "TunedSourceBank", "read_iq_file"]


class Source(Protocol):
    """Minimal device interface (virtual-input.h:51-70 equivalent)."""

    sample_rate: int

    def read(self, n: int) -> np.ndarray:
        """Return up to n complex64 samples ([] at end of stream)."""
        ...


class NullSource:
    """The reference's do-nothing fallback device (virtual-input.cpp)."""

    sample_rate = 2_048_000

    def read(self, n: int) -> np.ndarray:
        return np.zeros(n, np.complex64)


class RawFileSource:
    """8-bit unsigned IQ file replay (rawfiles.cpp:100-177).

    u8 pairs, value 128 = zero; optionally loops at EOF and paces to
    real time like the reference.
    """

    sample_rate = 2_048_000

    def __init__(self, path: str, loop: bool = True, pace: bool = False):
        self.path = path
        self.loop = loop
        self.pace = pace
        self._f = open(path, "rb")
        self._t0 = time.monotonic()
        self._delivered = 0

    def read_u8(self, n: int) -> np.ndarray:
        """Raw uint8 IQ pairs [m, 2] (value 128 = zero) — the receiver's
        fast upload path: the u8->float conversion happens on device,
        bit-identical to :meth:`read`'s host conversion but with 4x less
        host->device traffic."""
        raw = self._f.read(2 * n)
        if len(raw) < 2 * n and self.loop:
            self._f.seek(0)
            raw += self._f.read(2 * n - len(raw))
        buf = np.frombuffer(raw, np.uint8)
        out = buf[: (len(buf) // 2) * 2].reshape(-1, 2)
        if self.pace:
            self._delivered += out.shape[0]
            target = self._t0 + self._delivered / self.sample_rate
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        return out

    def read(self, n: int) -> np.ndarray:
        u8 = self.read_u8(n)
        x = (u8.astype(np.float32) - 128.0) / 128.0
        return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


class WavFileSource:
    """2-channel IQ WAV replay (.sdr files; wavfiles.cpp:45-180).

    Minimal RIFF reader supporting PCM16 and IEEE float32, the formats
    libsndfile writes for the reference's dumps.
    """

    def __init__(self, path: str, loop: bool = True):
        self.path = path
        self.loop = loop
        self._data = self._parse(path)
        self._pos = 0

    def _parse(self, path: str) -> np.ndarray:
        with open(path, "rb") as f:
            hdr = f.read(12)
            if hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
                raise ValueError(f"{path}: not a WAV file")
            fmt = None
            data = None
            while True:
                chunk = f.read(8)
                if len(chunk) < 8:
                    break
                cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
                payload = f.read(size + (size & 1))
                if cid == b"fmt ":
                    fmt = struct.unpack("<HHIIHH", payload[:16])
                elif cid == b"data":
                    data = payload[:size]
            if fmt is None or data is None:
                raise ValueError(f"{path}: missing fmt/data chunk")
            audio_fmt, channels, rate, _, _, bits = fmt
            self.sample_rate = rate
            if channels != 2:
                raise ValueError("IQ WAV must be 2-channel")
            if audio_fmt == 3 and bits == 32:
                x = np.frombuffer(data, np.float32)
            elif audio_fmt == 1 and bits == 16:
                x = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
            else:
                raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}")
            return (x[0::2] + 1j * x[1::2]).astype(np.complex64)

    def read(self, n: int) -> np.ndarray:
        out = self._data[self._pos: self._pos + n]
        self._pos += out.shape[0]
        if out.shape[0] < n and self.loop and self._data.shape[0]:
            self._pos = n - out.shape[0]
            out = np.concatenate([out, self._data[: self._pos]])
        return out


class SyntheticSource:
    """Modulator-backed source for tests/benchmarks (no file needed).

    Impairments model the RF/ADC chain: additive noise (snr_db), carrier
    frequency offset (cfo_hz) and a sample-clock offset in parts-per-million
    (ppm) — the tx/rx oscillator mismatch the reference's per-frame PRS
    resync absorbs (ofdm-processor.cpp:344-380).  ppm > 0 means the receiver
    clock runs slow, so the tx waveform is stretched: one tx frame occupies
    T_F * (1 + ppm*1e-6) rx samples.
    """

    sample_rate = 2_048_000

    def __init__(self, modulator, snr_db: Optional[float] = None,
                 cfo_hz: float = 0.0, lead_in: int = 0, ppm: float = 0.0):
        self.mod = modulator
        self.snr_db = snr_db
        self.cfo_hz = cfo_hz
        self.ppm = ppm
        self._ratio = 1.0 + ppm * 1e-6   # tx samples per rx sample is 1/ratio
        self._buf = (np.zeros(lead_in, np.complex64)
                     if lead_in else np.zeros(0, np.complex64))
        self._frame = 0
        # resampler state: tx-timebase stream + fractional read position
        self._tx = np.zeros(0, np.complex64)
        self._tx_base = 0       # absolute tx index of _tx[0]
        self._tx_pos = 0.0      # absolute tx index of the next rx sample

    def _gen_frame(self) -> np.ndarray:
        T_F = self.mod.p.T_F
        chunk = self.mod.frames(1, start_frame=self._frame)
        self._frame += 1
        if self.cfo_hz:
            t0 = (self._frame - 1) * T_F
            k = np.arange(t0, t0 + T_F)
            chunk = chunk * np.exp(
                2j * np.pi * self.cfo_hz * k / self.sample_rate
            ).astype(np.complex64)
        if self.snr_db is not None:
            rng = np.random.default_rng(self._frame)
            p = np.mean(np.abs(chunk) ** 2)
            sigma = np.sqrt(p / (10 ** (self.snr_db / 10)) / 2)
            chunk = chunk + sigma * (
                rng.standard_normal(T_F)
                + 1j * rng.standard_normal(T_F)).astype(np.complex64)
        return chunk

    def read(self, n: int) -> np.ndarray:
        if self.ppm == 0.0:
            while self._buf.shape[0] < n:
                self._buf = np.concatenate([self._buf, self._gen_frame()])
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        # rx sample i sits at tx index _tx_pos + i / ratio; linear interp
        while self._buf.shape[0] < n:
            m = n - self._buf.shape[0]
            need_tx = int(np.floor(self._tx_pos + (m - 1) / self._ratio)) + 2
            while self._tx_base + self._tx.shape[0] < need_tx:
                self._tx = np.concatenate([self._tx, self._gen_frame()])
            t = self._tx_pos - self._tx_base + np.arange(m) / self._ratio
            i0 = np.floor(t).astype(np.int64)
            frac = (t - i0).astype(np.float32)
            out = (self._tx[i0] * (1.0 - frac)
                   + self._tx[i0 + 1] * frac).astype(np.complex64)
            self._buf = np.concatenate([self._buf, out])
            self._tx_pos += m / self._ratio
            cut = int(np.floor(self._tx_pos)) - self._tx_base
            if cut > 0:
                self._tx = self._tx[cut:]
                self._tx_base += cut
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class TunedSourceBank:
    """A tuner model over per-channel sources.

    Maps DAB channel names to IQ sources (file replay in tests — one
    recorded ensemble per channel); ``set_frequency`` selects the stream,
    reading an unmapped or exhausted frequency yields receiver noise.
    Gives the band scan (``dabjax.runtime.scan``) exactly the control
    surface of the live SDR devices, the file-dict stand-in for the
    reference's tuner (gui.cpp:561-638 scanning loop)."""

    sample_rate = 2_048_000

    def __init__(self, by_channel: dict, noise_level: float = 0.005,
                 seed: int = 0):
        from dabjax.runtime.channels import frequency_khz
        self._by_hz = {}
        for chan, src in by_channel.items():
            khz = frequency_khz(chan)
            if khz is None:
                raise ValueError(f"unknown DAB channel {chan!r}")
            self._by_hz[khz * 1000] = src
        self._cur = None
        self._noise = noise_level
        self._rng = np.random.default_rng(seed)

    def set_frequency(self, hz: int) -> None:
        self._cur = self._by_hz.get(int(hz))

    def _noise_block(self, n: int) -> np.ndarray:
        return (self._noise * (self._rng.standard_normal(n)
                               + 1j * self._rng.standard_normal(n))
                ).astype(np.complex64)

    def read(self, n: int) -> np.ndarray:
        if self._cur is None:
            return self._noise_block(n)
        out = self._cur.read(n)
        if out.shape[0] < n:          # exhausted recording -> noise tail
            out = np.concatenate([out, self._noise_block(n - out.shape[0])])
        return out


def read_iq_file(path: str) -> np.ndarray:
    """Whole-file convenience loader (.raw u8 or .sdr/.wav)."""
    if path.endswith((".wav", ".sdr")):
        return WavFileSource(path, loop=False)._data
    return RawFileSource(path, loop=False).read(1 << 62)
