#!/usr/bin/env python
"""Corpus-scale streaming trainer benchmark: flat host memory at 100k.

Demonstrates VERDICT r3 item 6's done-criterion: a 100k-utterance sharded
spike corpus trains through pipeline.extract_and_train_streaming on this
host with flat RSS (the in-memory stage-2/3 path would hold ~0.8 GB of
feature matrices plus the spike corpus itself), while an RSS sampler
thread records the peak during each phase. Accuracy equivalence vs the
in-memory ridge is covered at test scale by tests/test_streaming_fit.py;
this tool's corpus is synthetic random spikes (reservoir cost is
content-independent), generated shard-by-shard from one permuted pool so
corpus creation is IO-bound, not RNG-bound.

  python tools/bench_stream_train.py \
      --n-utterances 100000 --root /tmp/stream100k

Re-running with an existing --root skips generation.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096 / 1e6


class RssSampler:
    """Background max-RSS tracker with per-phase marks."""

    def __init__(self, period: float = 0.25):
        self.period = period
        self.peak = 0.0
        self.marks: list[tuple[str, float]] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_mb())
            self._stop.wait(self.period)

    def mark(self, phase: str) -> float:
        self.peak = max(self.peak, rss_mb())
        self.marks.append((phase, self.peak))
        peak, self.peak = self.peak, rss_mb()
        return peak

    def stop(self) -> None:
        self._stop.set()
        self._t.join()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-utterances", type=int, default=100_000)
    parser.add_argument("--channels", type=int, default=128)
    parser.add_argument("--time-bins", type=int, default=400)
    parser.add_argument("--classes", type=int, default=12)
    parser.add_argument("--shard-size", type=int, default=8192)
    parser.add_argument("--spike-rate", type=float, default=0.05)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--root", type=str, default="/tmp/lsm_stream_train")
    parser.add_argument("--single-device", action="store_true")
    parser.add_argument("--cpu-devices", type=int, default=None)
    parser.add_argument("--readout", type=str, default="ridge",
                        choices=["ridge", "logistic"],
                        help="'logistic' = the reference readout at corpus "
                             "scale: streamed features live in device memory "
                             "(~0.8 GB per 100k at 2000-d); host RSS stays "
                             "flat either way.")
    args = parser.parse_args()

    from lsm_tpu.cli.common import (
        enable_compile_cache, setup_logging,
    )

    setup_logging()   # surface the trainer's INFO phase breakdown
    if args.cpu_devices:
        from lsm_tpu.cli.common import force_cpu_devices

        force_cpu_devices(args.cpu_devices)
    enable_compile_cache()

    import numpy as np

    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig
    from lsm_tpu.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter

    root = Path(args.root)
    sampler = RssSampler()
    if not (root / "manifest.json").exists():
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        pool = (
            rng.random((args.shard_size, args.channels, args.time_bins))
            < args.spike_rate
        ).astype(np.uint8)
        w = ShardedSpikeDatasetWriter(root, shard_size=args.shard_size,
                                      compress=False)
        written = 0
        while written < args.n_utterances:
            n = min(args.shard_size, args.n_utterances - written)
            # Per-shard variation without re-drawing 5 GB of RNG: permute
            # rows and roll the time axis by a shard-dependent offset.
            x = np.roll(
                pool[rng.permutation(args.shard_size)[:n]],
                shift=written % args.time_bins, axis=2,
            )
            y = rng.integers(0, args.classes, n).astype(np.int32)
            w.append(x, y, np.arange(written, written + n))
            written += n
        w.close()
        log(f"generated {written} utterances in "
            f"{time.perf_counter() - t0:.1f}s at {root}")
    peak = sampler.mark("generate")
    log(f"RSS peak after generation: {peak:.0f} MB")

    cfg = PipelineConfig(
        commands=tuple(f"w{i}" for i in range(args.classes)),
        batch_size=args.batch_size,
    )
    source = ShardedSpikeDataset(root)
    log(f"corpus: {source.num_samples} utterances, "
        f"{len(source.manifest['shards'])} shards")

    mesh = None if args.single_device else "auto"
    t0 = time.perf_counter()
    result = pipeline.extract_and_train_streaming(
        cfg, source, run_diagnostics=False, mesh=mesh, readout=args.readout
    )
    dt = time.perf_counter() - t0
    peak = sampler.mark("train+eval")
    sampler.stop()
    n = result.n_train + result.n_test
    log(f"streamed stage2+3: {n} utterances in {dt:.1f}s "
        f"({n / dt:,.0f} utt/s), accuracy {result.accuracy:.4f} "
        f"(random spikes -> chance ~{1 / args.classes:.3f})")
    log(f"RSS peak during train+eval: {peak:.0f} MB "
        f"(corpus on disk: "
        f"{sum(f.stat().st_size for f in root.glob('*.npz')) / 1e9:.2f} GB)")
    for phase, p in sampler.marks:
        log(f"  phase {phase:10s} peak RSS {p:.0f} MB")


if __name__ == "__main__":
    main()
