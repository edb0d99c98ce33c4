#!/usr/bin/env python
"""Serving-state operation costs at production stream counts.

Measures, on the flagship 1000-neuron continuous engine at N streams:
  - step() wall (the serving baseline the state ops must not disturb);
  - snapshot() + atomic write (the periodic-checkpoint cost);
  - load_serving_state into a fresh engine (restart-to-warm cost);
  - migrate_streams of k streams to a second engine (the row-level
    gather/scatter path — must NOT scale with N).

Timings are host wall-clock (each standalone dispatch includes its
round-trip); the numbers matter as ratios and totals, not as device
time.

  python tools/bench_state.py
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--streams", type=int, default=2048)
    parser.add_argument("--migrate-k", type=int, default=8)
    parser.add_argument("--chunk-ms", type=int, default=100)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--state-path", type=str, default="/tmp/state_bench.npz")
    args = parser.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
    from lsm_tpu.io.serving_state import (
        load_serving_state, migrate_streams, save_serving_state,
    )
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.readout import logistic, scaler

    fcfg = FrontendConfig()
    rcfg = ReservoirConfig()
    params = res.init_reservoir(rcfg, n_channels=fcfg.n_filters)
    d = len(FEATURE_SETS["original"]) * params.n_outputs
    rng = np.random.default_rng(0)
    ro = logistic.LogisticParams(
        w=np.asarray(rng.normal(0, 0.1, (d, 12)), np.float32),
        b=np.zeros((12,), np.float32),
    )
    sc = scaler.ScalerState(
        mean=np.zeros((d,), np.float32), scale=np.ones((d,), np.float32)
    )
    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000

    def mk(n):
        return ContinuousKWS(params, ro, sc, fcfg, "original", n,
                             chunk_len=chunk_len)

    n = args.streams
    kws = mk(n)
    chunk = (rng.standard_normal((n, chunk_len)) * 0.2).astype(np.float32)

    def timed(label, fn, reps=args.reps):
        fn()                      # warm (compile paths)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        med = sorted(ts)[len(ts) // 2]
        log(f"{label:>42s}: {med * 1e3:9.1f} ms (median of {reps})")
        return med

    log(f"continuous engine, {n} streams, {rcfg.num_neurons} neurons, "
        f"{args.chunk_ms} ms chunks")
    t_step = timed("step()", lambda: kws.step(chunk))

    snap = kws.snapshot()
    state_mb = sum(v.nbytes for v in snap.values()) / 1e6
    log(f"{'state size':>42s}: {state_mb:9.1f} MB "
        f"({len(snap)} leaves)")

    # jax.Array caches its host copy after the first materialization, so
    # time snapshot on FRESH state (step first, subtract the step wall) —
    # what a periodic checkpointer actually pays.
    def step_snap():
        kws.step(chunk)
        kws.snapshot()

    t_both = timed("step + snapshot (fresh state)", step_snap)
    log(f"{'snapshot() alone (minus step)':>42s}: "
        f"{(t_both - t_step) * 1e3:9.1f} ms")
    path = Path(args.state_path)
    t_save = timed("save_serving_state (compressed)",
                   lambda: save_serving_state(path, kws))
    t_save_u = timed("save_serving_state (compress=False)",
                     lambda: save_serving_state(path, kws, compress=False))
    log(f"{'uncompressed file size':>42s}: "
        f"{path.stat().st_size / 1e6:9.1f} MB")

    fresh = mk(n)
    t_load = timed("load_serving_state (fresh engine)",
                   lambda: load_serving_state(path, fresh))

    dst = mk(n)
    k = args.migrate_k
    src_idx = np.arange(k)
    t_mig = timed(f"migrate_streams (k={k} of {n})",
                  lambda: migrate_streams(kws, dst, src_idx, src_idx))
    t_ext = timed(f"extract_streams (k={k})",
                  lambda: kws.extract_streams(src_idx))

    # Sanity: serving continues after the state ops.
    out = kws.step(chunk)
    assert np.isfinite(out).all()
    path.unlink(missing_ok=True)

    print(
        f"streams={n} step_ms={t_step * 1e3:.1f} "
        f"state_mb={state_mb:.1f} snapshot_ms={(t_both - t_step) * 1e3:.1f} "
        f"save_ms={t_save * 1e3:.1f} save_raw_ms={t_save_u * 1e3:.1f} "
        f"load_ms={t_load * 1e3:.1f} "
        f"migrate{k}_ms={t_mig * 1e3:.1f} extract{k}_ms={t_ext * 1e3:.1f}"
    )


if __name__ == "__main__":
    sys.exit(main())
