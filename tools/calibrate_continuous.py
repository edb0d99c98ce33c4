#!/usr/bin/env python
"""Re-calibrate a trained model bundle for CONTINUOUS-mode serving.

Continuous streaming (models/continuous.py) evaluates a different feature
distribution than the batch pipeline (causal normalization, carried
membrane, native 100-bin grid): serving it with the batch-trained readout
loses ~0.3 accuracy, while a readout fit on continuous features is at
parity within noise (docs/VALIDATION.md "Continuous-mode KWS"). This tool
takes a `main.py --save-model` bundle plus training audio, streams the
audio through ContinuousKWS in the carried-state condition, refits the
scaler + multinomial logistic on those features
(continuous.fit_continuous_readout), and writes a new bundle tagged
feature_mode="continuous" — the input stream_kws.py --mode continuous
expects. The reservoir and frontend are reused unchanged, so batch/exact
serving from the original bundle stays valid.

  python tools/calibrate_continuous.py \
      --model lsm_model.npz --out lsm_model_continuous.npz \
      --data-dir speech_commands_v0.02
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        help="Input bundle (main.py --save-model).")
    parser.add_argument("--out", type=str, required=True,
                        help="Output bundle (feature_mode=continuous).")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="Speech Commands-style training WAV directory "
                             "(class subdirs must match the bundle's "
                             "class names).")
    parser.add_argument("--synthetic", action="store_true",
                        help="Calibrate on the synthetic corpus instead "
                             "(no dataset on disk needed).")
    parser.add_argument("--samples-per-class", type=int, default=200)
    parser.add_argument("--chunk-ms", type=int, default=100)
    parser.add_argument("--norm-decay-db-per-bin", type=float, default=0.1)
    args = parser.parse_args()

    from lsm_tpu.cli.common import setup_logging

    setup_logging()

    import numpy as np

    from lsm_tpu.io import dataset, model as model_io
    from lsm_tpu.io.wav import load_audio_batch
    from lsm_tpu.models.continuous import fit_continuous_readout

    bundle = model_io.load_model(Path(args.model))
    fcfg = bundle.frontend
    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000

    if args.synthetic:
        audio, labels = dataset.synthetic_audio_batch(
            n_per_class=args.samples_per_class,
            n_classes=len(bundle.class_names),
            seed=42,
            sample_rate=fcfg.sample_rate,
            duration=fcfg.duration,
        )
    elif args.data_dir is not None:
        idx = dataset.index_speech_commands(
            Path(args.data_dir), bundle.class_names, args.samples_per_class
        )
        for w in idx.warnings:
            print(w, file=sys.stderr)
        if not idx.files:
            print("Error: no audio files found.", file=sys.stderr)
            sys.exit(1)
        audio, kept, errors = load_audio_batch(
            idx.files, fcfg.sample_rate, fcfg.duration
        )
        for path, err in errors:
            print(f"Error loading {path}: {err}", file=sys.stderr)
        labels = idx.labels[kept]
    else:
        print("Error: provide --data-dir or --synthetic.", file=sys.stderr)
        sys.exit(1)

    print(f"Calibrating on {audio.shape[0]} utterances "
          f"({args.chunk_ms} ms chunks, carried-state protocol) ...")
    readout, scaler_state = fit_continuous_readout(
        bundle.reservoir, fcfg, audio, np.asarray(labels, np.int32),
        num_classes=len(bundle.class_names),
        feature_set=bundle.feature_set,
        chunk_len=chunk_len,
        norm_decay_db_per_bin=args.norm_decay_db_per_bin,
    )

    model_io.save_model(
        Path(args.out),
        reservoir=bundle.reservoir,
        readout=readout,
        scaler=scaler_state,
        frontend=fcfg,
        feature_set=bundle.feature_set,
        class_names=bundle.class_names,
        feature_mode="continuous",
        # Serving must reuse exactly these (stream_kws.py reads them).
        continuous_params={
            "chunk_len": chunk_len,
            "norm_decay_db_per_bin": args.norm_decay_db_per_bin,
        },
    )
    print(f"Continuous-calibrated bundle written to '{args.out}'")


if __name__ == "__main__":
    main()
