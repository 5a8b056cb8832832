"""Tracing and performance counters (greenfield — SURVEY.md §5: the
reference has no profiling; its closest analog is the once-per-second GUI
refresh driven from the sample loop, ``ofdm-processor.cpp:169-181``).

Two layers:

* :class:`StageProfiler` — cheap wall-time + throughput counters per
  pipeline stage, suitable for always-on use; renders a text dashboard.
* :func:`device_trace` — context manager around ``jax.profiler`` for deep
  dives (XLA op-level timelines viewable in TensorBoard/Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

__all__ = ["StageProfiler", "device_trace"]


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0


@dataclass
class StageProfiler:
    """Accumulates per-stage wall time and item throughput.

    >>> prof = StageProfiler()
    >>> with prof.stage("demod", items=n_samples):
    ...     run_demod()
    >>> print(prof.report())
    """

    stages: Dict[str, _Stage] = field(default_factory=dict)
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st = self.stages.setdefault(name, _Stage())
            st.calls += 1
            st.seconds += time.perf_counter() - t0
            st.items += items

    def add(self, name: str, seconds: float, items: float = 0.0) -> None:
        st = self.stages.setdefault(name, _Stage())
        st.calls += 1
        st.seconds += seconds
        st.items += items

    def report(self, realtime_rate: float = 2_048_000.0) -> str:
        """Text dashboard; ``realtime_rate`` converts item counts that are
        IQ samples into a realtime factor."""
        lines = [f"{'stage':<16} {'calls':>6} {'total s':>9} "
                 f"{'ms/call':>8} {'items/s':>12} {'x RT':>7}"]
        for name, st in sorted(self.stages.items(),
                               key=lambda kv: -kv[1].seconds):
            per = st.seconds / st.calls * 1e3 if st.calls else 0.0
            rate = st.items / st.seconds if st.seconds > 0 else 0.0
            rt = rate / realtime_rate if realtime_rate else 0.0
            lines.append(f"{name:<16} {st.calls:>6} {st.seconds:>9.3f} "
                         f"{per:>8.2f} {rate:>12.0f} {rt:>7.1f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": v.calls, "seconds": v.seconds,
                    "items": v.items} for k, v in self.stages.items()}


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """XLA-level profiler trace (open with TensorBoard / xprof); a
    profiler that cannot start or stop raises."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
