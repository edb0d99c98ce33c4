#!/usr/bin/env python
"""Per-stage wall-clock breakdown on the current device.

Usage: python tools/profile_stages.py [--n 2400] [--filterbank gammatone]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2400)
    ap.add_argument("--filterbank", default="gammatone")
    ap.add_argument("--gammatone-method", default="iir")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--continuous", action="store_true",
                    help="Also profile the continuous-mode hop phases "
                         "(gtgram chunk scan, segment fold + features + "
                         "readout) at --n streams.")
    args = ap.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from lsm_tpu.config import FEATURE_SETS, FrontendConfig, ReservoirConfig
    from lsm_tpu.io.dataset import synthetic_audio_batch
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models.frontend import featurize_batch
    from lsm_tpu.readout import logistic, scaler

    fcfg = FrontendConfig(filterbank=args.filterbank,
                          gammatone_method=args.gammatone_method)
    rcfg = ReservoirConfig()
    keys = tuple(FEATURE_SETS["original"])

    audio_np, labels_np = synthetic_audio_batch(
        n_per_class=-(-args.n // 12), n_classes=12, seed=42
    )
    audio = jnp.asarray(audio_np[: args.n])
    labels = jnp.asarray(labels_np[: args.n])
    params = res.init_reservoir(rcfg, n_channels=fcfg.n_filters,
                                mean_weight=0.0118)

    def timed(name, fn, *a):
        # The timed program returns ONLY a fused scalar checksum pulled to
        # host, so the timing holds no device->host copy of the stage
        # output. The stage output for feeding the next stage is computed
        # once OUTSIDE the timing.
        @jax.jit
        def run_scalar(*a):
            leaves = jax.tree_util.tree_leaves(fn(*a))
            return sum(jnp.sum(l, dtype=jnp.float32) for l in leaves)

        float(run_scalar(*a))
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            float(run_scalar(*a))
            best = min(best, time.perf_counter() - t0)
        print(f"{name:24s} {best*1e3:9.1f} ms   {args.n/best:10.0f} utt/s",
              flush=True)
        return jax.jit(fn)(*a)

    # A trivial jitted scalar round-trip: the per-dispatch overhead each
    # stage number below includes.
    timed("(dispatch)", lambda a: jnp.float32(0.0) * a[0, 0], audio)

    spikes = timed("featurize", lambda a: featurize_batch(a, fcfg), audio)
    # The production dispatcher. params rides as a jit argument, never a
    # closure (CLAUDE.md).
    feats = timed(
        "reservoir+features",
        lambda p, s: res.extract_features(p, s, keys),
        params, spikes,
    )
    st = scaler.fit_scaler(feats)
    xs = scaler.transform(st, feats)
    readout = logistic.fit_ridge(xs, labels, num_classes=12, alpha=10.0)
    timed(
        "standardize+predict",
        lambda f: logistic.predict(readout, scaler.transform(st, f)),
        feats,
    )

    if args.continuous:
        # Continuous-mode hop phases at B = --n streams (each phase is a
        # separate dispatch here; the production step fuses them into ONE
        # dispatch).
        import numpy as np

        from lsm_tpu.ops import gammatone as gt

        B = args.n
        rng = np.random.default_rng(0)
        print(f"-- continuous hop phases at {B} streams --", flush=True)
        blocks = jnp.asarray(
            (rng.standard_normal((20, B, 80)) * 0.1).astype(np.float32)
        )
        gstate = jnp.zeros((B, 8, fcfg.n_filters), jnp.float32)
        timed(
            "gtgram chunk scan",
            lambda b, s: gt.gtgram_iir_scan(
                b, s, fcfg.sample_rate, fcfg.n_filters, fcfg.gt_f_min, 80
            ),
            blocks, gstate,
        )
        segs = {
            k: jnp.asarray(rng.random((10, B, 400)).astype(np.float32))
            for k in ("counts", "sum_t", "sum_t2", "first", "last",
                      "n_isi", "sum_isi", "sum_isi2", "bursts")
        }
        win = jnp.asarray(rng.random((B, 400, 10)).astype(np.float32))

        def fold(sg, w):
            stats = res.fold_segment_stats(sg, 40, rcfg.burst_isi_max)
            stats["win_counts"] = w
            f = res.features_from_stats(stats, keys)
            return logistic.predict(readout, scaler.transform(st, f))

        timed("fold+features+predict", fold, segs, win)


if __name__ == "__main__":
    main()
