"""Audio output plane — the ``audioSink`` analog (SURVEY.md §2.4).

The reference renders PCM through PortAudio at a fixed 48 kHz stereo
(``audiosink.cpp:129-138``), low-pass-resampling 16/24/32 kHz codec output
with windowed-sinc FIR filters (``audiosink.cpp:71-73``,
``fir-filters.cpp:36-110``), and can dump audio to WAV via libsndfile.
Here the sink surface is files/arrays (a headless receiver): a WAV
writer, the same Blackman-windowed LowPassFIR, and a polyphase rational
resampler to 48 kHz.
"""

from __future__ import annotations

import struct
import wave
from math import gcd
from typing import Optional

import numpy as np

__all__ = ["low_pass_fir", "FirFilter", "resample_to_48k", "WavSink"]

OUTPUT_RATE = 48_000


def low_pass_fir(n_taps: int, f_cut: float, sample_rate: float
                 ) -> np.ndarray:
    """Blackman-windowed sinc low-pass (fir-filters.cpp:56-79)."""
    f = f_cut / sample_rate
    taps = np.empty(n_taps, np.float64)
    for i in range(n_taps):
        if i == (n_taps - 1) / 2:
            taps[i] = 2 * np.pi * f
        else:
            x = i - (n_taps - 1) / 2
            taps[i] = np.sin(2 * np.pi * f * x) / x
        # Blackman window
        taps[i] *= (0.42
                    - 0.5 * np.cos(2 * np.pi * i / (n_taps - 1))
                    + 0.08 * np.cos(4 * np.pi * i / (n_taps - 1)))
    return (taps / np.sum(taps)).astype(np.float32)


class FirFilter:
    """Streaming FIR with carried history (per-sample Pass() equivalent,
    vectorized per block)."""

    def __init__(self, taps: np.ndarray, channels: int = 2):
        self.taps = np.asarray(taps, np.float32)
        self._hist = np.zeros((self.taps.shape[0] - 1, channels), np.float32)

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [n, channels] -> filtered [n, channels]."""
        buf = np.concatenate([self._hist, x.astype(np.float32)], axis=0)
        self._hist = buf[-(self.taps.shape[0] - 1):]
        out = np.stack(
            [np.convolve(buf[:, c], self.taps, mode="valid")
             for c in range(x.shape[1])], axis=1)
        return out.astype(np.float32)


def resample_to_48k(pcm: np.ndarray, in_rate: int) -> np.ndarray:
    """Polyphase rational resample [n, ch] PCM to 48 kHz.

    Covers the reference's 16/24/32 kHz cases (audiosink.cpp:71-73) and is
    exact passthrough at 48 kHz.
    """
    if in_rate == OUTPUT_RATE:
        return pcm.astype(np.float32)
    g = gcd(OUTPUT_RATE, in_rate)
    up, down = OUTPUT_RATE // g, in_rate // g
    x = pcm.astype(np.float32)
    n, ch = x.shape
    # zero-stuff by `up`, low-pass at min(nyquist_in, nyquist_out), decimate
    ups = np.zeros((n * up, ch), np.float32)
    ups[::up] = x * up
    f_cut = 0.45 * min(in_rate, OUTPUT_RATE)
    taps = low_pass_fir(32 * up + 1, f_cut, in_rate * up)
    out = np.stack([np.convolve(ups[:, c], taps, mode="same")
                    for c in range(ch)], axis=1)
    return out[::down].astype(np.float32)


class WavSink:
    """48 kHz stereo WAV writer — the audioOut + dump path combined.

    Accepts PCM at any codec rate; resamples to 48 kHz like the reference
    sink.  int16 samples on disk (libsndfile SF_FORMAT_PCM_16 analog).
    """

    def __init__(self, path: str):
        self.path = path
        self._wf = wave.open(path, "wb")
        self._wf.setnchannels(2)
        self._wf.setsampwidth(2)
        self._wf.setframerate(OUTPUT_RATE)
        self.frames_written = 0

    def write(self, pcm: np.ndarray, rate: int = OUTPUT_RATE) -> None:
        """pcm: [n] mono or [n, ch]; float in [-1, 1] or int16."""
        x = np.asarray(pcm)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] == 1:
            x = np.repeat(x, 2, axis=1)      # mono -> stereo duplication
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = resample_to_48k(x[:, :2], rate)
        ints = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
        self._wf.writeframes(ints.tobytes())
        self.frames_written += ints.shape[0]

    def close(self) -> None:
        self._wf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PcmPipeSink:
    """Raw PCM to a byte stream — the live-playback analog of the
    reference's PortAudio callback (``audiosink.cpp:197-220``): pipe into
    ``aplay -f S16_LE -r 48000 -c 2`` (or any player) for live audio.

    Same resample-to-48 kHz stereo int16 contract as :class:`WavSink`.
    """

    def __init__(self, stream):
        self._stream = stream          # binary file object (e.g. stdout)
        self.frames_written = 0

    def write(self, pcm: np.ndarray, rate: int = OUTPUT_RATE) -> None:
        x = np.asarray(pcm)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] == 1:
            x = np.repeat(x, 2, axis=1)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = resample_to_48k(x[:, :2], rate)
        ints = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
        self._stream.write(ints.tobytes())
        try:
            self._stream.flush()
        except Exception:
            pass
        self.frames_written += ints.shape[0]

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
