"""Audio decode in worker PROCESSES — the config-5 GIL escape.

The audio plane (MP2 bit parsing, AAC/SBR/PS Huffman front ends) is
numpy-heavy Python: on worker *threads* it convoys on the GIL, so with
many concurrent channels x services the thread pile-up made the channel
bank slower than the sum of its parts.  This pool moves the per-service
decoder state into a few spawned worker processes: the main process
ships each block's bit-packed logical frames (~70 KB per service-block)
over a pipe via a feeder thread, workers decode independently on real
cores, and `drain()` collects the CRC-gated counters.

The reference's analog is its dedicated audio thread consuming the
backend ring buffer (mp4processor.cpp:272-277 runs the codec chain on
one thread); here the deployment shape is many channels per host, so
decode state is keyed by (channel, subchannel) and sharded over workers.

Workers decode on the host only.  They import ``dabjax.runtime.receiver``
and so JAX, pinned to the CPU first (``JAX_PLATFORMS=cpu``): a stray
device op in a worker must never open the card, where a second JAX
process would reserve most of its memory.  ``spawn`` start keeps them
clean of the parent's device state.
PCM stays in the worker (counters and decode-time are returned): this
path is for scan/monitor/bench workloads; interactive listening
(CLI decode --play) uses the in-process thread path where the PCM sinks
live.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["AudioWorkerPool", "COUNTER_FIELDS"]

COUNTER_FIELDS = ("au_ok", "au_bad", "superframes_ok", "superframes_bad",
                  "rs_corrected", "mp2_frames_ok", "mp2_frames_bad")


class _Counters:
    """Metrics stand-in inside the worker (duck-typed for AudioService)."""

    def __init__(self):
        for f in COUNTER_FIELDS:
            setattr(self, f, 0)


def _worker_main(conn):
    os.environ["JAX_PLATFORMS"] = "cpu"     # before JAX is imported
    services: Dict[Tuple, object] = {}
    from dabjax.runtime.receiver import AudioService
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        kind = msg[0]
        if kind == "rows":
            _, key, bitrate, is_plus, blob, row_len = msg
            svc = services.get(key)
            if svc is None:
                svc = AudioService(key[-1], bitrate, is_plus, _Counters())
                services[key] = svc
            rows = np.frombuffer(blob, np.uint8).reshape(-1, row_len)
            for r in rows:
                svc.add_frame_bytes(r)
            svc.pcm.clear()          # bound worker memory; counters remain
        elif kind == "drain":
            out = {}
            for key, svc in services.items():
                d = {f: int(getattr(svc.metrics, f))
                     for f in COUNTER_FIELDS}
                d["decode_seconds"] = float(svc.decode_seconds)
                out[key] = d
            conn.send(out)


class AudioWorkerPool:
    """N spawned decoder processes + per-worker feeder threads.

    ``submit_rows`` never blocks the caller on pipe backpressure: frames
    are queued to a feeder thread that owns the pipe write."""

    def __init__(self, n_workers: int = 2):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._procs: List = []
        self._conns: List = []
        self._queues: List[queue.Queue] = []
        self._feeders: List[threading.Thread] = []
        for _ in range(max(1, n_workers)):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main, args=(child,), daemon=True)
            p.start()
            child.close()
            q: queue.Queue = queue.Queue()
            t = threading.Thread(target=self._feed, args=(q, parent),
                                 daemon=True)
            t.start()
            self._procs.append(p)
            self._conns.append(parent)
            self._queues.append(q)
            self._feeders.append(t)

    @staticmethod
    def _feed(q: queue.Queue, conn):
        while True:
            msg = q.get()
            if msg is None:
                return
            conn.send(msg)

    def _worker_of(self, key: Tuple) -> int:
        return hash(key) % len(self._queues)

    def submit_rows(self, key: Tuple, bitrate: int, is_dab_plus: bool,
                    rows: np.ndarray) -> None:
        """``rows``: [n, row_bytes] uint8 logical frames for (channel,
        subch) ``key`` — decoded asynchronously in the key's worker."""
        rows = np.ascontiguousarray(rows, np.uint8)
        self._queues[self._worker_of(key)].put(
            ("rows", key, int(bitrate), bool(is_dab_plus),
             rows.tobytes(), rows.shape[1]))

    def drain(self) -> Dict[Tuple, Dict[str, float]]:
        """Flush every worker and return cumulative per-key counters."""
        for q in self._queues:
            q.put(("drain",))
        out: Dict[Tuple, Dict[str, float]] = {}
        for conn in self._conns:
            out.update(conn.recv())
        return out

    def close(self) -> None:
        for q in self._queues:
            q.put(None)
        for t in self._feeders:
            t.join(timeout=5)
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
