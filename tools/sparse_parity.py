#!/usr/bin/env python
"""Block-sparse vs dense-uniform reservoir ACCURACY parity (VERDICT r2 #3).

The block-sparse representation (models/sparse.py) deviates from the dense
generator in exactly one structural way: rewired edges land inside R random
partner blocks per 128-neuron source block instead of uniformly over all
neurons. Its kernel is bit-equal to its own XLA scan and its regime is
comparable to uniform rewiring (test_sparse_reservoir.py) — this tool
quantifies the remaining open question: the END-TO-END accuracy effect of
the topology change on the frozen hard benchmark, at an equal neuron count
where both representations run, with matched calibration (w_critico is
input-only, so both paths get the identical mean weight).

  python tools/sparse_parity.py \
      [--neurons 4096] [--n-per-class 30] [--repeats 3]

Results are recorded in docs/SENSITIVITY.md ("Block-sparse topology");
tests/test_sparse_reservoir.py asserts the parity at CPU scale.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--neurons", type=int, default=4096)
    parser.add_argument("--outputs", type=int, default=400)
    parser.add_argument("--n-per-class", type=int, default=30)
    parser.add_argument("--multiplier", type=float, default=0.6,
                        help="w_critico multiplier; at N=4096 the flagship "
                             "default 0.6 lands SUB-CRITICAL — compare in "
                             "the EDGE OF CHAOS regime the diagnostics "
                             "would tune toward.")
    parser.add_argument("--repeats", type=int, default=1,
                        help="Benchmark corpus seeds to average over.")
    args = parser.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig, ReservoirConfig
    from lsm_tpu.io import dataset

    n = args.neurons
    base = ReservoirConfig(
        num_neurons=n,
        num_output_neurons=args.outputs,
        small_world_k=int(0.10 * n * 2),
    )

    rows = []
    for r in range(args.repeats):
        corpus_seed = 42 + r
        audio, labels = dataset.synthetic_audio_batch_hard(
            n_per_class=args.n_per_class, n_classes=12, seed=corpus_seed
        )
        accs = {}
        for sparse in (False, True):
            cfg = PipelineConfig(
                reservoir=dataclasses.replace(base, sparse=sparse),
                batch_size=128,
                multiplier=args.multiplier,
            )
            res, ext = pipeline.run_pipeline_arrays(
                cfg, audio, labels, mesh=None
            )
            kind = "sparse" if sparse else "dense"
            accs[kind] = res.accuracy
            log(f"corpus_seed={corpus_seed} {kind:6s} N={n}: "
                f"acc={res.accuracy:.4f} regime={ext.diagnostics.regime} "
                f"participation={ext.diagnostics.avg_participation:.1f}% "
                f"(mean_weight={ext.mean_weight:.6f})")
        rows.append(accs)
        print(f"corpus_seed={corpus_seed}: dense={accs['dense']:.4f} "
              f"sparse={accs['sparse']:.4f} "
              f"delta={accs['sparse'] - accs['dense']:+.4f}", flush=True)

    if len(rows) > 1:
        import numpy as np

        d = np.asarray([r["dense"] for r in rows])
        s = np.asarray([r["sparse"] for r in rows])
        print(f"mean over {len(rows)} corpora: dense={d.mean():.4f} "
              f"sparse={s.mean():.4f} delta={(s - d).mean():+.4f} "
              f"(per-corpus spread dense±{d.std():.3f} sparse±{s.std():.3f})",
              flush=True)


if __name__ == "__main__":
    main()
