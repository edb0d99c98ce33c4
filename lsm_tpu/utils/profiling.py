"""Tracing / profiling utilities (SURVEY.md section 5.1).

The reference has only tqdm progress bars; here every stage can be wrapped
in `jax.profiler` trace annotations and wall-clock timers that
block_until_ready around device work, producing the utterances/sec/chip
metrics the benchmarks report. Optional Perfetto trace dump via
jax.profiler.trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional

import jax


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float
    items: Optional[int] = None

    @property
    def rate(self) -> Optional[float]:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


class Profiler:
    """Collects named stage timings; optionally emits jax trace annotations."""

    def __init__(self) -> None:
        self.timings: Dict[str, StageTiming] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[int] = None) -> Iterator[None]:
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.timings[name] = StageTiming(name, dt, items)

    def report(self) -> str:
        lines = []
        for t in self.timings.values():
            rate = f" ({t.rate:.1f}/s)" if t.rate else ""
            lines.append(f"{t.name}: {t.seconds:.3f}s{rate}")
        return "\n".join(lines)


def _device_fence() -> None:
    """Wait for all previously-dispatched device work: enqueue a trivial
    op and block on it — XLA runs a device's programs in order on one
    stream, so the trivial op completes only after everything enqueued
    before it.
    (jax.effects_barrier only waits for SIDE-EFFECTING computations and
    lets pure async dispatches keep running — it is NOT a device sync.)"""
    (jax.device_put(0.0) + 0).block_until_ready()


@contextlib.contextmanager
def device_timer() -> Iterator[Dict[str, float]]:
    """Times a block, synchronizing the device before and after.

    The fence adds one small dispatch round-trip to the measurement."""
    out: Dict[str, float] = {}
    _device_fence()
    t0 = time.perf_counter()
    yield out
    _device_fence()
    out["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def perfetto_trace(log_dir: str) -> Iterator[None]:
    """Dump a Perfetto/TensorBoard trace of the enclosed block."""
    with jax.profiler.trace(log_dir):
        yield
