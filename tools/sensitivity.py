#!/usr/bin/env python
"""Sensitivity analysis of the [inferred] snnpy semantics (VERDICT item 2).

The reference's reservoir simulator (`snn_reservoir_py`) is not on disk, so
several of its semantics were inferred (config.py: input projection,
weight_variance meaning, burst definition, spike_variances windowing). This
tool measures how much each inference choice moves accuracy on the frozen
HARD benchmark (lsm_tpu.io.dataset.synthetic_audio_batch_hard — confusable
temporal-cue pairs with a tunable Bayes floor, where the reference-default
config scores mid-band). A choice that moves accuracy is one the oracle
(tests/test_accuracy_band.py) can police; results are recorded in
docs/SENSITIVITY.md.

Run on the accelerator:
  python tools/sensitivity.py
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-per-class", type=int, default=100)
    parser.add_argument("--feature-set", default="all",
                        help="'all' covers every stat key incl. bursts")
    parser.add_argument("--markdown", action="store_true",
                        help="Emit a markdown table on stdout")
    args = parser.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from lsm_tpu.config import PipelineConfig, ReservoirConfig
    from lsm_tpu.io import dataset
    from lsm_tpu import pipeline

    audio, labels = dataset.synthetic_audio_batch_hard(
        n_per_class=args.n_per_class, n_classes=12, seed=42
    )

    def run(tag: str, rcfg_kw=None, pcfg_kw=None):
        rcfg = ReservoirConfig(**(rcfg_kw or {}))
        pcfg_kw_full = dict(
            reservoir=rcfg, feature_set=args.feature_set, batch_size=512
        )
        pcfg_kw_full.update(pcfg_kw or {})
        cfg = PipelineConfig(**pcfg_kw_full)
        t0 = time.time()
        res, ext = pipeline.run_pipeline_arrays(cfg, audio, labels)
        log(f"{tag:<42} acc={res.accuracy:.4f} "
            f"regime={ext.diagnostics.regime} "
            f"part={ext.diagnostics.avg_participation:.1f}% "
            f"({time.time() - t0:.0f}s)")
        return res.accuracy, ext.diagnostics.regime, ext.diagnostics.avg_participation

    rows = []

    def add(tag, **kw):
        acc, regime, part = run(tag, **kw)
        rows.append((tag, acc, regime, part))

    add("baseline (reference defaults)")
    # spike_variances windowing [inferred]
    add("n_rate_windows=2", rcfg_kw=dict(n_rate_windows=2))
    add("n_rate_windows=40", rcfg_kw=dict(n_rate_windows=40))
    # burst definition [inferred]
    add("burst_isi_max=1", rcfg_kw=dict(burst_isi_max=1))
    add("burst_isi_max=20", rcfg_kw=dict(burst_isi_max=20))
    # input projection [inferred]
    add("input_fanout=2", rcfg_kw=dict(input_fanout=2))
    add("input_fanout=32", rcfg_kw=dict(input_fanout=32))
    add("input_weight=0.5", rcfg_kw=dict(input_weight=0.5))
    add("input_weight=2.0", rcfg_kw=dict(input_weight=2.0))
    # weight_variance semantics [inferred]
    add("weight_variance=1", rcfg_kw=dict(weight_variance=1.0))
    add("weight_variance=30", rcfg_kw=dict(weight_variance=30.0))
    # regime knob (not inferred; shows the oracle tracks the regime map)
    add("multiplier=0.3 (sub-critical)", pcfg_kw=dict(multiplier=0.3))
    add("multiplier=1.0 (super-critical)", pcfg_kw=dict(multiplier=1.0))
    # heterogeneous leak path
    add("leak_variance_divisor=4", rcfg_kw=dict(leak_variance_divisor=4.0))

    base_acc = rows[0][1]
    print()
    header = f"{'perturbation':<34} {'acc':>7} {'delta':>7}  {'regime':<16} {'part%':>6}"
    print(header)
    print("-" * len(header))
    for tag, acc, regime, part in rows:
        print(f"{tag:<34} {acc:7.4f} {acc - base_acc:+7.4f}  {regime:<16} {part:6.1f}")

    if args.markdown:
        print()
        print("| perturbation | accuracy | delta vs baseline | regime | participation |")
        print("|---|---|---|---|---|")
        for tag, acc, regime, part in rows:
            print(f"| {tag} | {acc:.4f} | {acc - base_acc:+.4f} | {regime} | {part:.1f}% |")


if __name__ == "__main__":
    main()
