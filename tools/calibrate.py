#!/usr/bin/env python
"""Sweep reservoir parameterization to find edge-of-chaos defaults.

Usage: python tools/calibrate.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from lsm_tpu.config import FrontendConfig, ReservoirConfig
from lsm_tpu.io.dataset import synthetic_audio_batch
from lsm_tpu.models.frontend import featurize_batch
from lsm_tpu.models.sweep import sweep_regime


def main():
    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    audio, _ = synthetic_audio_batch(n_per_class=8, n_classes=12, seed=42)
    fcfg = FrontendConfig()
    spikes = np.asarray(featurize_batch(jnp.asarray(audio), fcfg))
    print(f"probe spikes: {spikes.shape} density={spikes.mean():.4f}")

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--fanout", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--w-in", type=float, nargs="+", default=[1.0])
    ap.add_argument("--wvar", type=float, nargs="+", default=[10.0])
    ap.add_argument("--multiplier", type=float, nargs="+", default=[0.3, 0.6, 1.0])
    ap.add_argument("--num-neurons", type=int, default=1000,
                    help="Reservoir size (e.g. 10000 for the scaled config).")
    args = ap.parse_args()

    n = args.num_neurons
    base_cfg = ReservoirConfig(
        num_neurons=n,
        num_output_neurons=max(1, int(0.4 * n)),
        small_world_k=int(0.10 * n * 2),
    )
    points = sweep_regime(
        spikes,
        base_cfg,
        input_fanouts=args.fanout,
        input_weights=args.w_in,
        weight_variances=args.wvar,
        multipliers=args.multiplier,
    )
    print(f"{'fo':>4} {'w_in':>6} {'wvar':>6} {'mult':>6} {'part%':>7} "
          f"{'spk/n':>8} regime", flush=True)
    for p in sorted(points, key=lambda p: abs(p.participation - 88)):
        print(f"{p.input_fanout:4d} {p.input_weight:6.2f} "
              f"{p.weight_variance:6.1f} {p.multiplier:6.2f} "
              f"{p.participation:7.1f} {p.spikes_per_neuron:8.2f} {p.regime}",
              flush=True)


if __name__ == "__main__":
    main()
