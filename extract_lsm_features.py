#!/usr/bin/env python
"""Stage 2 CLI: spike dataset -> standardized LSM features.

Drop-in equivalent of the reference's extract_lsm_features.py (same flags
--feature-set / --multiplier / --leak-variance-divisor, same input/output
artifacts), backed by the batched lax.scan reservoir instead of a per-sample
simulator loop. Extensions: --num-neurons, --batch-size, --input/--output.
"""

import argparse
import time
from pathlib import Path

from lsm_tpu.cli.common import (
    add_extension_flags,
    add_extract_flags,
    build_config,
    mesh_from_args,
    metrics_from_args,
    setup_logging,
)
from lsm_tpu.io import artifacts
from lsm_tpu.pipeline import extract_lsm_features, load_spike_dataset_any


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Extract features from a spike train dataset using an LSM."
    )
    add_extract_flags(parser)
    add_extension_flags(parser)
    parser.add_argument("--input", type=str,
                        default=artifacts.SPIKE_DATASET_FILENAME)
    parser.add_argument("--output", type=str, default=artifacts.FEATURES_FILENAME)
    parser.add_argument("--streaming-fit", action="store_true",
                        help="Constant-memory fused stage 2+3 over a SHARDED "
                             "spike dataset directory: shards stream from "
                             "disk, each train batch folds into on-device "
                             "ridge statistics, and the test rows stream "
                             "through the solved readout — host memory stays "
                             "flat at any corpus scale (100k+). Readout per "
                             "--readout; writes a deployable model bundle "
                             "via --save-model instead of a features "
                             "artifact.")
    parser.add_argument("--ridge-alpha", type=float, default=1.0,
                        help="L2 strength for the --streaming-fit ridge.")
    parser.add_argument("--readout", type=str, default="ridge",
                        choices=["ridge", "logistic"],
                        help="With --streaming-fit: 'ridge' is the "
                             "closed-form O(D^2)-state fit (no corpus "
                             "residency anywhere); 'logistic' is the "
                             "REFERENCE readout (multinomial LBFGS, "
                             "train_classifier.py:36-41) at corpus scale "
                             "— streamed features are held in device memory "
                             "(~0.8 GB per 100k utts at 2000-d, sharded "
                             "over the mesh data axis incl. multi-host), "
                             "host memory stays flat, and predictions "
                             "match the in-memory fit on the same split.")
    parser.add_argument("--l2-c", type=float, default=1.0,
                        help="With --readout logistic: inverse L2 strength "
                             "C (the reference LogisticRegression default "
                             "C=1.0).")
    parser.add_argument("--save-model", type=str, default=None,
                        help="With --streaming-fit: save the trained model "
                             "bundle (reservoir + scaler + readout) here.")
    args = parser.parse_args()
    setup_logging()
    cfg = build_config(args)

    if args.streaming_fit:
        _run_streaming_fit(args, cfg)
        return

    try:
        ds = load_spike_dataset_any(Path(args.input))
    except FileNotFoundError as e:
        print(f"Error: {e}")
        return
    print(f"Loaded {len(ds.x_spikes)} samples from '{args.input}'")

    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    result = extract_lsm_features(cfg, ds, output_path=Path(args.output),
                                  mesh=mesh_from_args(args))
    print(f"Extraction complete. Features saved to '{args.output}'")
    if metrics:
        dt = time.perf_counter() - t0
        n = len(ds.x_spikes)
        metrics.emit("stage2_wall_s", round(dt, 3), stage="extract_features",
                     utterances=n, utt_per_sec=round(n / max(dt, 1e-9), 1))
        metrics.emit("w_critico", result.w_critico, stage="extract_features")
        metrics.emit("mean_weight", result.mean_weight,
                     stage="extract_features", multiplier=cfg.multiplier)
        if result.diagnostics is not None:
            metrics.emit("regime", result.diagnostics.regime,
                         stage="extract_features",
                         avg_participation=round(
                             result.diagnostics.avg_participation, 2))
        metrics.close()


def _run_streaming_fit(args, cfg) -> None:
    from lsm_tpu.cli.common import resolve_commands
    from lsm_tpu.io.sharded import ShardedSpikeDataset
    from lsm_tpu.pipeline import extract_and_train_streaming

    root = Path(args.input)
    if not root.is_dir():
        raise SystemExit(
            "--streaming-fit requires a sharded spike dataset directory "
            f"(create_dataset.py --sharded-output ...); got '{root}'. A .npz "
            "artifact is already in memory — use the default path."
        )
    source = ShardedSpikeDataset(root)
    print(f"Streaming {source.num_samples} samples from '{root}'")
    # The corpus records its own vocabulary and featurization (sharded.py
    # writer meta): labels are indices into the vocabulary THE CORPUS was
    # built with, and the saved bundle must carry the frontend the spikes
    # were actually featurized with — this CLI has no frontend flags, so
    # without the metadata a mel/64-filter corpus would silently get a
    # default gammatone/128 bundle. Explicit --commands still wins (the
    # trainer then validates label range against it).
    frontend = cfg.frontend
    meta = source.meta
    if args.commands:
        names = resolve_commands(args)
    elif meta.get("class_names"):
        names = tuple(meta["class_names"])
        print(f"Vocabulary from corpus metadata: {len(names)} classes")
    else:
        names = resolve_commands(args)
    if meta.get("frontend"):
        from lsm_tpu.config import frontend_from_dict

        frontend = frontend_from_dict(meta["frontend"])
        if frontend != cfg.frontend:
            print(f"Frontend from corpus metadata: {frontend.filterbank}/"
                  f"{frontend.n_filters} filters")
    else:
        print("WARNING: corpus has no frontend metadata (written by an "
              "older create_dataset.py); the saved bundle will record the "
              f"default {frontend.filterbank}/{frontend.n_filters} frontend.")
    metrics = metrics_from_args(args)
    t0 = time.perf_counter()
    result = extract_and_train_streaming(
        cfg, source, class_names=names, alpha=args.ridge_alpha,
        mesh=mesh_from_args(args), readout=args.readout, l2_c=args.l2_c,
    )
    print("\n--- Final Results ---")
    print(f"Test Accuracy: {result.accuracy * 100:.2f}%\n")
    print("Classification Report:")
    print(result.report.render())
    if args.save_model:
        from lsm_tpu.io.model import save_model

        save_model(
            Path(args.save_model), result.params, result.readout,
            result.scaler, frontend, cfg.feature_set, names,
        )
        print(f"Model bundle saved to '{args.save_model}'")
    if metrics:
        dt = time.perf_counter() - t0
        n = result.n_train + result.n_test
        metrics.emit("streaming_fit_wall_s", round(dt, 3),
                     stage="extract_features", utterances=n,
                     utt_per_sec=round(n / max(dt, 1e-9), 1))
        metrics.emit("w_critico", result.w_critico, stage="extract_features")
        metrics.emit("test_accuracy", result.accuracy,
                     stage="extract_features", readout=args.readout,
                     ridge_alpha=args.ridge_alpha)
        metrics.close()


if __name__ == "__main__":
    main()
