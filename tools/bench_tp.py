#!/usr/bin/env python
"""Benchmark the tensor-parallel (neuron-sharded) reservoir path.

BASELINE.json configs[3] coverage on real hardware: runs the 10k-neuron
reservoir through `extract_features_model_sharded` (the TP shard_map path,
one all_gather per timestep) on a mesh over all available devices — on a
single chip this measures the TP code path compiled for 1 device (the
all_gather lowers to a no-op copy), on several cards it measures true TP
scaling. Each timing is a jitted scalar reduction pulled to host.

  python tools/bench_tp.py [--sparse] [--n-model 4]
"""

from __future__ import annotations

import argparse
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-neurons", type=int, default=10_000)
    parser.add_argument("--num-outputs", type=int, default=400)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--t", type=int, default=400)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--n-model", type=int, default=0,
                        help="model-axis size (0 = all devices)")
    parser.add_argument("--sparse", action="store_true",
                        help="block-sparse reservoir (models/sparse.py)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 matmul operands (f32 accumulation)")
    args = parser.parse_args()

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.parallel import mesh as meshlib
    from lsm_tpu.parallel.sharded import (
        extract_features_model_sharded,
        extract_features_model_sharded_sparse,
    )

    n_dev = jax.device_count()
    n_model = args.n_model or n_dev
    n_data = n_dev // n_model
    mesh = meshlib.make_mesh(n_data=n_data, n_model=n_model)
    n = args.num_neurons
    if args.sparse:
        # The sparse TP path shards destination BLOCKS over the model
        # axis, so the block count must divide n_model: round neurons to
        # a multiple of 128 * n_model (10000 -> 10240 on 8 devices), not
        # just 128 (10112 = 79 blocks, prime, would reject any n_model>1).
        q = 128 * n_model
        if n % q:
            n = -(-n // q) * q
            log(f"--sparse: rounding neurons {args.num_neurons} -> {n} "
                f"(x{q})")
    mm = jnp.bfloat16 if args.bf16 else None
    log(f"devices={n_dev} mesh={n_data}x{n_model} neurons={n} "
        f"B={args.batch} T={args.t} sparse={args.sparse} "
        f"matmul={'bf16' if args.bf16 else 'f32'}")

    cfg = ReservoirConfig(
        num_neurons=n,
        num_output_neurons=args.num_outputs,
        small_world_k=int(0.10 * n * 2),
        mean_weight=0.002,
    )
    t0 = time.perf_counter()
    if args.sparse:
        from lsm_tpu.models.sparse import init_reservoir_sparse

        params = init_reservoir_sparse(cfg, n_channels=128)
    else:
        params = res.init_reservoir(cfg, n_channels=128)
    log(f"init (device draws, jit incl. compile): {time.perf_counter() - t0:.1f}s")

    keys = tuple(FEATURE_SETS["original"])
    rng = np.random.default_rng(0)
    spikes = jnp.asarray(
        (rng.random((args.batch, 128, args.t)) < 0.05).astype(np.uint8)
    )

    # params must be an ARGUMENT, not a closure: closed-over weight arrays
    # are embedded as HLO constants (a 10k-neuron W is 400 MB).
    @jax.jit
    def run_scalar(p, s):
        if args.sparse:
            feats = extract_features_model_sharded_sparse(
                p, s, keys, mesh, matmul_dtype=mm
            )
        else:
            feats = extract_features_model_sharded(
                p, s, keys, mesh, matmul_dtype=mm
            )
        return jnp.sum(feats)

    t0 = time.perf_counter()
    sval = float(run_scalar(params, spikes))
    log(f"compile+first run: {time.perf_counter() - t0:.1f}s (sum={sval:.3e})")

    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        float(run_scalar(params, spikes))
        times.append(time.perf_counter() - t0)
    best = min(times)
    rate = args.batch / best
    log(f"TP reservoir: {args.batch} utt in {best:.3f}s = {rate:.1f} utt/s "
        f"({rate / n_dev:.1f}/device on {n_dev} device(s)), "
        f"times={['%.3f' % t for t in times]}")
    print(f"{rate:.1f}")


if __name__ == "__main__":
    main()
