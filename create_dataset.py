#!/usr/bin/env python
"""Stage 1 CLI: audio -> spike-train dataset artifact.

Drop-in equivalent of the reference's create_dataset.py (same flags
--n-filters / --filterbank, same output artifact
speech_spike_dataset_pure_redundancy.npz, same directory-walk semantics),
backed by the batched on-device featurizer instead of a per-file Python
loop.
Extensions: --data-dir, --synthetic, --vocab, --batch-size.
"""

import argparse
import time
from pathlib import Path

import numpy as np

from lsm_tpu.cli.common import (
    add_extension_flags,
    add_frontend_flags,
    build_config,
    mesh_from_args,
    metrics_from_args,
    setup_logging,
)
from lsm_tpu.io import artifacts, dataset
from lsm_tpu.pipeline import create_spike_dataset, featurize_audio_array


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Create a spike train dataset from audio files."
    )
    add_frontend_flags(parser)
    add_extension_flags(parser)
    parser.add_argument("--output", type=str,
                        default=artifacts.SPIKE_DATASET_FILENAME)
    parser.add_argument("--sharded-output", type=str, default=None,
                        help="Write an incrementally-sharded dataset dir "
                             "instead of one .npz (for 100k+ utterances).")
    parser.add_argument("--shard-size", type=int, default=8192)
    parser.add_argument("--no-compress", action="store_true",
                        help="Write sharded output uncompressed (~190x the "
                             "disk, decompression-free streaming reads).")
    args = parser.parse_args()
    setup_logging()
    cfg = build_config(args)
    mesh = mesh_from_args(args)

    metrics = metrics_from_args(args)
    t0 = time.perf_counter()

    print(f"Creating dataset with filterbank: {cfg.frontend.filterbank}, "
          f"filters: {cfg.frontend.n_filters}")

    if args.synthetic:
        n_per = min(args.samples_per_class, 200)
        if n_per < args.samples_per_class:
            print(f"note: --synthetic caps --samples-per-class at 200 "
                  f"(requested {args.samples_per_class}) — the synthetic "
                  "corpus is a smoke/bench fixture, not a dataset.")
        audio, labels = dataset.synthetic_audio_batch(
            n_per_class=n_per,
            n_classes=len(cfg.commands),
        )
        spikes = featurize_audio_array(cfg, audio, mesh=mesh)
        ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
        if args.sharded_output:
            # Honor --sharded-output for synthetic corpora too (one-shot
            # write, no resume: there is no file list to fingerprint),
            # with the same frontend/vocabulary metadata the disk path
            # records — so --streaming-fit works on synthetic datasets.
            from lsm_tpu.config import corpus_meta
            from lsm_tpu.io.sharded import (
                ShardedSpikeDataset, ShardedSpikeDatasetWriter,
            )

            writer = ShardedSpikeDatasetWriter(
                Path(args.sharded_output), args.shard_size,
                compress=not args.no_compress,
                meta=corpus_meta(cfg),
            )
            writer.append(np.asarray(ds.x_spikes), np.asarray(ds.y_labels))
            writer.close()
            # The summary below reads journal stats off the handle, same
            # as the disk-corpus sharded path.
            ds = ShardedSpikeDataset(Path(args.sharded_output))
        else:
            artifacts.save_spike_dataset(Path(args.output), ds)
    else:
        ds = create_spike_dataset(
            cfg,
            Path(args.data_dir),
            None if args.sharded_output else Path(args.output),
            sharded_output=(
                Path(args.sharded_output) if args.sharded_output else None
            ),
            shard_size=args.shard_size,
            compress=not args.no_compress,
            mesh=mesh,
        )

    print("\nDataset created successfully.")
    if getattr(args, "sharded_output", None):
        # Journal stats, NOT ds.x_spikes: materializing the corpus for a
        # summary line defeats the sharded writer's constant-host-memory
        # contract at the 100k scale it exists for.
        n = ds.num_samples
        shape = (n,) + (ds.row_shape or ())
        spike_total = ds.total_spikes
        print(f"  Shape: {shape}")
    else:
        n = len(ds.x_spikes)
        shape = ds.x_spikes.shape
        spike_total = int(ds.x_spikes.sum())
        print(f"  Shape: {shape}")
    if spike_total is not None:
        print(f"  Avg spikes per sample: {spike_total / max(n, 1):.1f}")
    dest = args.sharded_output if getattr(args, "sharded_output", None) else args.output
    print(f"Saved to '{dest}'")
    if metrics:
        dt = time.perf_counter() - t0
        # Resumed sharded runs: n counts the whole corpus (incl. shards a
        # previous run wrote); the rate divides only what THIS invocation
        # featurized, or it would report a ~10x bogus speedup.
        n_run = getattr(ds, "featurized_this_run", n)
        metrics.emit("stage1_wall_s", round(dt, 3), stage="create_dataset",
                     utterances=n,
                     utt_per_sec=round(n_run / max(dt, 1e-9), 1),
                     filterbank=cfg.frontend.filterbank)
        if spike_total is not None:
            metrics.emit("avg_spikes_per_sample",
                         round(spike_total / max(n, 1), 2),
                         stage="create_dataset")
        metrics.close()


if __name__ == "__main__":
    main()
