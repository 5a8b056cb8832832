"""Cross-host scaling: channels (ensembles) sharded over processes/DCN.

SURVEY.md §2.5's outermost axis: the reference tunes ONE channel at a
time and scans serially (``gui.cpp:561-638``); a multi-host deployment
decodes many Band III ensembles concurrently by assigning channels to
hosts.  Channels are embarrassingly parallel (independent RF), so the
right mapping is **independent per-host meshes over DCN-disjoint work**
— each process builds its local ``('time','subch')`` mesh over its own
chips and runs full receivers for its channel set; only metrics cross
host boundaries.  This is the deployment recipe behind BASELINE.md's
"two hosts >= 80% efficiency" target: zero inter-host communication in
the hot path makes scaling linear minus input-feed overheads.

Run one process per host:

    python -c "from dabjax.parallel.multihost import run_channels; ..."
    # proc 0:  run_channels({...}, coordinator='h0:1234', num_processes=2,
    #                        process_id=0)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["init_distributed", "assign_channels", "run_channels",
           "MultiReceiver"]


class MultiReceiver:
    """Channel bank: k full receivers driven in lock-step with exactly ONE
    device synchronization per block period for the whole bank.

    Channels are embarrassingly parallel, so every channel's staged
    device blob (demod+FIC taps, FIB payloads, bit-packed MSC frames) is
    concatenated on device and pulled in one transfer; host-side parsing and audio then run per channel (audio on
    each receiver's worker threads).  Device programs are shared across
    channels via the process-wide jit caches, so the bank compiles once.

    This is the one-host shape of BASELINE config 5 (8+ ensembles
    sustained); the reference scans channels serially (gui.cpp:561-638).
    """

    def __init__(self, sources: Dict[str, object], config=None,
                 data_handler_factory=None):
        """``config``: one ReceiverConfig for every channel, or a
        {channel: ReceiverConfig} dict (e.g. a scan bank tuning one
        service per ensemble)."""
        from dabjax.runtime.receiver import Receiver
        cfg_of = (config.get if isinstance(config, dict)
                  else (lambda name: config))
        self._pool = None
        workers = max((getattr(cfg_of(n), "audio_workers", 0) or 0)
                      for n in sources) if sources else 0
        if workers > 0:
            from dabjax.runtime.audio_pool import AudioWorkerPool
            self._pool = AudioWorkerPool(workers)
        self.rx: Dict[str, object] = {
            name: Receiver(src, cfg_of(name),
                           data_handler_factory=data_handler_factory,
                           audio_pool=self._pool)
            for name, src in sources.items()}

    def step(self) -> Dict[str, bool]:
        """Stage every live channel, pull the merged bank blob once, then
        consume per channel.  Returns {channel: progressed}."""
        import jax.numpy as jnp
        import numpy as np
        blks = {}
        for name, rx in self.rx.items():
            blk = rx.stage()
            if blk is not None:
                blks[name] = blk
        if not blks:
            return {name: False for name in self.rx}
        parts = [b.merged for b in blks.values()]
        bank = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        big = np.asarray(bank)               # the ONE sync for the bank
        off = 0
        for name, b in blks.items():
            n = int(b.merged.shape[0])
            self.rx[name].consume(b, big[off: off + n])
            off += n
        return {name: (name in blks) for name in self.rx}

    def run(self, n_blocks: int) -> Dict[str, object]:
        live = set(self.rx)
        for _ in range(n_blocks):
            if not live:
                break
            progressed = self.step()
            live = {n for n in live if progressed.get(n)}
        for rx in self.rx.values():
            rx._drain_audio()
        if self._pool is not None:
            counters = self._pool.drain()
            for rx in self.rx.values():
                rx.merge_pool_counters(counters)
        return {name: rx.metrics for name, rx in self.rx.items()}

    def close(self) -> None:
        for rx in self.rx.values():
            rx.close()
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0) -> None:
    """Initialize jax.distributed when running multi-process; no-op for a
    single process (the common one-host case)."""
    if num_processes <= 1 or coordinator is None:
        return
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def assign_channels(channels: Sequence[str], num_processes: int,
                    process_id: int) -> List[str]:
    """Round-robin channel -> process assignment (deterministic on every
    host, no coordination needed)."""
    return [c for i, c in enumerate(sorted(channels))
            if i % num_processes == process_id]


def run_channels(sources: Dict[str, Callable[[], object]],
                 n_blocks: int = 8,
                 coordinator: Optional[str] = None,
                 num_processes: int = 1, process_id: int = 0,
                 receiver_config=None,
                 concurrent: bool = True,
                 batched: bool = True) -> Dict[str, object]:
    """Decode this host's share of ``sources`` ({channel: source factory}).

    Returns {channel: Metrics} for the locally-owned channels.  Factories
    (not live sources) are passed so only owned channels open hardware.

    ``concurrent``: decode this host's channels concurrently (the
    one-host BASELINE config-5 shape).  With ``batched`` (default) the
    channels run as one :class:`MultiReceiver` bank — lock-step blocks,
    one merged device sync per period; ``batched=False`` falls back to a
    thread per channel.
    ``concurrent=False`` restores serial decode (deterministic ordering
    for debugging)."""
    from dabjax.runtime.receiver import Receiver

    init_distributed(coordinator, num_processes, process_id)
    mine = assign_channels(list(sources), num_processes, process_id)
    out = {}
    if not concurrent or len(mine) <= 1:
        for chan in mine:
            rx = Receiver(sources[chan](), receiver_config)
            out[chan] = rx.run(n_blocks)
            rx.close()
        return out

    if batched:
        bank = MultiReceiver({chan: sources[chan]() for chan in mine},
                             receiver_config)
        out = bank.run(n_blocks)
        bank.close()
        return out

    from concurrent.futures import ThreadPoolExecutor

    def one(chan):
        rx = Receiver(sources[chan](), receiver_config)
        m = rx.run(n_blocks)
        rx.close()
        return m

    with ThreadPoolExecutor(max_workers=len(mine)) as pool:
        futs = {chan: pool.submit(one, chan) for chan in mine}
        for chan, f in futs.items():
            out[chan] = f.result()
    return out
