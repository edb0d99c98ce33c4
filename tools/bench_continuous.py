#!/usr/bin/env python
"""Continuous-mode KWS accuracy delta + throughput vs the exact mode.

Protocol (the oracle for models/continuous.py's documented approximations):
train the flagship pipeline on the frozen hard benchmark (batch path, the
same features the exact streaming mode serves), then score the held-out
split three ways:

  1. exact batch predictions (== StreamingKWS on a full window);
  2. continuous mode, COLD: each test utterance streamed from reset in
     100 ms chunks, prediction read after its last chunk — isolates the
     featurizer-grid + causal-normalization deltas (membrane starts at 0
     both ways);
  3. continuous mode, CARRY-IN: a different utterance is streamed
     immediately before each test utterance with NO reset — adds the
     carried membrane/normalization state, the realistic always-on
     operating condition.

Also times continuous step() vs exact StreamingKWS.step() at equal stream
counts: the per-hop work ratio is the capacity multiplier the mode exists
for. Results recorded in docs/VALIDATION.md ("Continuous-mode KWS").

  python tools/bench_continuous.py
"""

from __future__ import annotations

import argparse
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-per-class", type=int, default=30)
    parser.add_argument("--chunk-ms", type=int, default=100)
    parser.add_argument("--bench-streams", type=int, nargs="+",
                        default=[128, 1024])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--skip-bench", action="store_true")
    parser.add_argument("--device-resident", action="store_true",
                        help="Pre-place bench chunks on device: measures "
                             "device compute, excluding the per-step H2D "
                             "chunk transfer (~26 MB/step at 4096 f32 "
                             "streams).")
    parser.add_argument("--cpu-devices", type=int, default=None)
    parser.add_argument("--filterbank", default="gammatone",
                        choices=["gammatone", "mel"],
                        help="Frontend for the whole protocol (mel runs "
                             "the per-hop STFT continuous frontend).")
    parser.add_argument("--n-filters", type=int, default=128)
    parser.add_argument("--norm-decay", type=float, default=0.1,
                        help="norm_decay_db_per_bin for the continuous "
                             "engines AND the matched calibration.")
    parser.add_argument("--sweep", action="store_true",
                        help="Matched-protocol sweep over norm-decay x "
                             "chunk-ms (markdown table for "
                             "docs/SENSITIVITY.md); trains the batch "
                             "model once and re-runs calibration + eval "
                             "per cell.")
    parser.add_argument("--sweep-decays", type=float, nargs="+",
                        default=[0.02, 0.05, 0.1, 0.2, 0.5])
    parser.add_argument("--sweep-chunks", type=int, nargs="+",
                        default=[100, 200, 400],
                        help="chunk sizes in ms for --sweep (must span "
                             "whole rate windows — 100 ms at the default "
                             "10-window grid; invalid combos print n/a).")
    args = parser.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    if args.cpu_devices:
        from lsm_tpu.cli.common import force_cpu_devices

        force_cpu_devices(args.cpu_devices)
    enable_compile_cache()

    import numpy as np

    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig
    from lsm_tpu.io import dataset
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.models.streaming import StreamingKWS

    from lsm_tpu.config import FrontendConfig

    cfg = PipelineConfig(
        frontend=FrontendConfig(filterbank=args.filterbank,
                                n_filters=args.n_filters),
        batch_size=64,
    )
    fs = cfg.frontend.sample_rate
    chunk_len = fs * args.chunk_ms // 1000
    n_chunks = cfg.frontend.num_samples // chunk_len

    # --- train the flagship model on the frozen hard benchmark ------------
    audio, labels = dataset.synthetic_audio_batch_hard(
        n_per_class=args.n_per_class, n_classes=12, seed=42
    )
    spikes = pipeline.featurize_audio_array(cfg, audio, mesh=None)
    from lsm_tpu.io.artifacts import SpikeDataset

    x_train, x_test, y_train, y_test = pipeline.stratified_split(
        audio, labels, cfg.test_size, cfg.split_seed
    )
    ds = SpikeDataset(x_spikes=spikes, y_labels=labels)
    ext = pipeline.extract_lsm_features(cfg, ds, run_diagnostics=False,
                                        mesh=None)
    result = pipeline.train_and_evaluate(cfg, ext.artifact, mesh=None)
    exact_acc = result.accuracy
    log(f"exact/batch accuracy: {exact_acc:.4f} "
        f"(mean_weight={ext.mean_weight:.6f})")

    # The batch split and the audio split use the same seed + stratify, so
    # x_test here is the raw audio of the same held-out utterances.
    n_test = len(y_test)
    # Exact predictions for the agreement metric: classify the test spikes
    # through the trained readout (identical to StreamingKWS on the window).
    import jax.numpy as jnp

    from lsm_tpu.config import FEATURE_SETS
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.readout import logistic, scaler as scaler_mod

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    test_spikes = pipeline.featurize_audio_array(cfg, x_test, mesh=None)
    feats = res.extract_features(ext.params, jnp.asarray(test_spikes), keys)
    exact_preds = np.asarray(
        logistic.predict(result.params,
                         scaler_mod.transform(ext.scaler, feats))
    )

    def stream_features(
        x: np.ndarray, carry_in: bool, cl: int, decay: float
    ) -> np.ndarray:
        """Stream utterances as parallel streams; return the continuous
        features at each utterance's last chunk (raw, unscaled)."""
        n = x.shape[0]
        nc = cfg.frontend.num_samples // cl
        kws = ContinuousKWS(
            ext.params, result.params, ext.scaler, cfg.frontend,
            cfg.feature_set, n_streams=n, chunk_len=cl,
            norm_decay_db_per_bin=decay,
        )
        if carry_in:
            # Stream a permuted copy first, no reset: every stream enters
            # its target utterance with carried state (the always-on
            # operating condition). A fixed-seed permutation, not a
            # roll-by-1: the split is class-correlated in index order, so
            # rolling would hand most streams a same-class predecessor and
            # flatter the carry-in accuracy (advisor r3).
            prev = x[np.random.default_rng(12345).permutation(x.shape[0])]
            for c in range(nc):
                kws.step(prev[:, c * cl:(c + 1) * cl])
        for c in range(nc):
            kws.step(x[:, c * cl:(c + 1) * cl])
        return kws.features()

    # --- MATCHED protocol: readout trained on continuous features ----------
    # Production deployments of continuous mode calibrate the readout on
    # continuous-mode features (same reservoir, same stats — different
    # operating distribution). This measures the mode's intrinsic
    # discriminability rather than its drift from the batch distribution.
    from lsm_tpu.models.continuous import fit_continuous_readout

    def matched_accuracy(cl: int, decay: float) -> float:
        p2, st2 = fit_continuous_readout(
            ext.params, cfg.frontend, x_train, y_train, num_classes=12,
            feature_set=cfg.feature_set, chunk_len=cl,
            norm_decay_db_per_bin=decay,
            l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter,
            tol=cfg.readout.tol,
        )
        test_f = stream_features(x_test, True, cl, decay)
        preds2 = np.asarray(
            logistic.predict(
                p2, scaler_mod.transform(st2, jnp.asarray(test_f))
            )
        )
        return float((preds2 == y_test).mean())

    se = float(np.sqrt(exact_acc * (1.0 - exact_acc) / max(n_test, 1)))

    if args.sweep:
        # One batch model, one table: every cell is the full matched
        # calibration + carry-in eval at that (decay, chunk) point.
        print(f"\nmatched-protocol sweep (n_test={n_test}, exact "
              f"{exact_acc:.4f}, 1 SE ~ {se:.4f}, "
              f"filterbank={args.filterbank}):\n", flush=True)
        header = "| norm_decay_db_per_bin | " + " | ".join(
            f"chunk {c} ms" for c in args.sweep_chunks
        ) + " |"
        print(header)
        print("|" + "---|" * (1 + len(args.sweep_chunks)))
        for decay in args.sweep_decays:
            row = [f"| {decay:g} "]
            for cms in args.sweep_chunks:
                cl = fs * cms // 1000
                try:
                    acc2 = matched_accuracy(cl, decay)
                except ValueError as e:
                    # e.g. chunk shorter than a rate window — structurally
                    # unsupported grid, not an accuracy data point.
                    row.append(f"| n/a ({e}) "
                               if "rate window" not in str(e) else "| n/a ")
                    continue
                row.append(f"| {acc2:.4f} ({acc2 - exact_acc:+.4f}) ")
            print("".join(row) + "|", flush=True)
        return

    for name, carry in (("cold", False), ("carry-in", True)):
        tf = stream_features(x_test, carry, chunk_len, args.norm_decay)
        preds = np.asarray(
            logistic.predict(result.params,
                             scaler_mod.transform(ext.scaler, jnp.asarray(tf)))
        )
        acc = float((preds == y_test).mean())
        agree = float((preds == exact_preds).mean())
        print(f"continuous {name:8s} (batch-trained readout): acc={acc:.4f} "
              f"(delta vs exact {acc - exact_acc:+.4f}), "
              f"agreement with exact predictions {agree:.4f}", flush=True)

    acc2 = matched_accuracy(chunk_len, args.norm_decay)
    print(f"continuous matched  (continuous-trained readout): acc={acc2:.4f} "
          f"(delta vs exact {acc2 - exact_acc:+.4f} +- {se:.4f} SE)",
          flush=True)

    if args.skip_bench:
        return

    # --- throughput: continuous vs exact step at equal streams ------------
    budget_ms = 1000.0 * chunk_len / fs
    rng = np.random.default_rng(0)
    for ns in args.bench_streams:
        chunk = (rng.standard_normal((ns, chunk_len)) * 0.1).astype(np.float32)
        if args.device_resident:
            chunk = jnp.asarray(chunk)
            chunk.block_until_ready()
        rows = {}
        for name, mk in (
            ("exact", lambda: StreamingKWS(
                ext.params, result.params, ext.scaler, cfg.frontend,
                cfg.feature_set, n_streams=ns)),
            ("continuous", lambda: ContinuousKWS(
                ext.params, result.params, ext.scaler, cfg.frontend,
                cfg.feature_set, n_streams=ns, chunk_len=chunk_len,
                norm_decay_db_per_bin=args.norm_decay)),
        ):
            kws = mk()
            kws.step(chunk)                       # compile + warmup
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                kws.step(chunk)
                times.append(time.perf_counter() - t0)
            med = sorted(times)[len(times) // 2]
            rows[name] = med
            print(f"streams={ns:5d} {name:10s}: median {med * 1e3:6.1f} ms "
                  f"-> {budget_ms / (med * 1e3):5.1f}x real-time, "
                  f"{ns / med:,.0f} stream-chunks/s", flush=True)
        print(f"streams={ns:5d} continuous speedup: "
              f"{rows['exact'] / rows['continuous']:.2f}x", flush=True)


if __name__ == "__main__":
    main()
