#!/usr/bin/env python
"""Streaming keyword-spotting latency/throughput (BASELINE configs[4]).

Drives models.streaming.StreamingKWS on real hardware: per-chunk
push + predict wall latency at several parallel-stream counts, against
the real-time budget (chunk_len / sample_rate). Each step's wall
includes its dispatch round-trip (bench.py reports the floor).

  python tools/bench_streaming.py
"""

from __future__ import annotations

import argparse
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunk-ms", type=int, default=100)
    parser.add_argument("--streams", type=int, nargs="+",
                        default=[1, 128, 1024])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--pcm16", action="store_true",
                        help="Feed raw int16 PCM chunks (half the ingest "
                             "bytes; device-side conversion, bit-equal).")
    parser.add_argument("--ulaw", action="store_true",
                        help="Feed uint8 G.711 mu-law chunks (quarter the "
                             "f32 ingest bytes; device-side decode, "
                             "ops/ulaw.py).")
    parser.add_argument("--compact", action="store_true",
                        help="step_compact(): top-1 class + f16 margin "
                             "packed to 4 bytes/stream on device — the "
                             "D2H egress is n_classes*f32 smaller than "
                             "full logits.")
    parser.add_argument("--mesh", action="store_true",
                        help="Shard the stream axis over all devices "
                             "(shard_map data-parallel scale-out; reports "
                             "per-chip AND total stream-chunk rates).")
    parser.add_argument("--cpu-devices", type=int, default=None,
                        help="Force CPU with N virtual devices (mesh "
                             "verification without a multi-chip slice).")
    parser.add_argument("--num-neurons", type=int, default=1000)
    parser.add_argument("--sparse", action="store_true",
                        help="Block-sparse reservoir (scaled configs; "
                             "requires --num-neurons % 128 == 0).")
    parser.add_argument("--continuous", action="store_true",
                        help="Bench ContinuousKWS (state-carrying mode) "
                             "instead of the exact sliding-window mode.")
    parser.add_argument("--device-resident", action="store_true",
                        help="Pre-place chunks on device: excludes the "
                             "per-step H2D chunk transfer.")
    parser.add_argument("--active-frac", type=float, default=None,
                        metavar="F",
                        help="Partial-activity ingest (step_active): "
                             "send only round(F * streams) active rows "
                             "per step; silent streams advance on "
                             "device-synthesized wire silence. Logits "
                             "bit-equal to the full wire with silent "
                             "rows (tests/test_step_active.py).")
    parser.add_argument("--pipelined", type=int, nargs="?", const=2,
                        default=None, metavar="DEPTH",
                        help="Serve host chunks through the pipelined "
                             "driver (kws.stream, default depth 2): H2D "
                             "of chunk k+1 and dispatch overlap step k's "
                             "compute. Logits bit-equal to serial step().")
    args = parser.parse_args()
    if args.active_frac is not None and args.pipelined is not None:
        raise SystemExit(
            "--active-frac does not combine with --pipelined (step_active "
            "is a single fused dispatch; pipeline the caller's loop instead)"
        )

    from lsm_tpu.cli.common import enable_compile_cache

    if args.cpu_devices:
        from lsm_tpu.cli.common import force_cpu_devices

        force_cpu_devices(args.cpu_devices)
    enable_compile_cache()

    import numpy as np

    from lsm_tpu.config import FrontendConfig, ReservoirConfig, FEATURE_SETS
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models.streaming import StreamingKWS
    from lsm_tpu.readout.logistic import LogisticParams
    from lsm_tpu.readout.scaler import ScalerState

    import jax.numpy as jnp

    fcfg = FrontendConfig()
    n = args.num_neurons
    rcfg = ReservoirConfig(
        num_neurons=n,
        small_world_k=int(0.10 * n * 2),
        mean_weight=0.0107 if n <= 1000 else 0.002,
        sparse=True if args.sparse else None,
    )
    if args.sparse:
        from lsm_tpu.models.sparse import init_reservoir_sparse

        params = init_reservoir_sparse(rcfg, n_channels=fcfg.n_filters)
    else:
        params = res.init_reservoir(rcfg, n_channels=fcfg.n_filters)
    d = len(FEATURE_SETS["original"]) * rcfg.num_output_neurons
    rng = np.random.default_rng(0)
    readout = LogisticParams(
        w=jnp.asarray(rng.normal(0, 0.01, (d, 12)).astype(np.float32)),
        b=jnp.zeros((12,), jnp.float32),
    )
    st = ScalerState(mean=jnp.zeros((d,), jnp.float32),
                     scale=jnp.ones((d,), jnp.float32))

    mesh = None
    n_chips = 1
    if args.mesh:
        import jax

        from lsm_tpu.parallel.mesh import make_mesh

        n_chips = jax.device_count()
        mesh = make_mesh(n_data=n_chips, n_model=1)
        log(f"mesh: {n_chips} device(s) on the data axis")

    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000
    budget_ms = 1000.0 * chunk_len / fcfg.sample_rate
    log(f"chunk={args.chunk_ms} ms ({chunk_len} samples), "
        f"real-time budget {budget_ms:.0f} ms/step")

    for ns in args.streams:
        if mesh is not None and ns % n_chips:
            log(f"streams={ns}: skipped (not divisible by {n_chips} chips)")
            continue
        if args.continuous:
            from lsm_tpu.models.continuous import ContinuousKWS

            kws = ContinuousKWS(params, readout, st, fcfg, n_streams=ns,
                                chunk_len=chunk_len, mesh=mesh)
        else:
            kws = StreamingKWS(params, readout, st, fcfg, n_streams=ns,
                               mesh=mesh)
        chunk = (rng.standard_normal((ns, chunk_len)) * 0.1).astype(np.float32)
        if args.pcm16:
            chunk = (chunk * 32768.0).astype(np.int16)
        elif args.ulaw:
            from lsm_tpu.ops.ulaw import encode_ulaw_f32

            chunk = encode_ulaw_f32(chunk)
        if args.device_resident:
            if mesh is not None:
                # Shard along streams: a single-device jnp.asarray would
                # make every timed step pay a device0 -> all-chips
                # redistribution inside the jit.
                from lsm_tpu.parallel.mesh import shard_batch

                chunk = shard_batch(chunk, mesh)
            else:
                chunk = jnp.asarray(chunk)
            chunk.block_until_ready()
        kws.step(chunk)                     # compile + warmup (fused path)
        if args.pipelined is not None:
            # Steady-state pipelined wall: the generator overlaps H2D and
            # dispatch across steps, so per-step wall is the LOOP time /
            # steps (individual yields are not independently meaningful).
            n_steps = args.steps
            list(kws.stream([chunk] * 2, depth=args.pipelined))  # warm
            t0 = time.perf_counter()
            for out in kws.stream([chunk] * n_steps, depth=args.pipelined):
                out.argmax(-1)
            wall = time.perf_counter() - t0
            med = best = wall / n_steps
            tag = f" [pipelined depth={args.pipelined}]"
        elif args.active_frac is not None:
            k = max(1, round(args.active_frac * ns))
            idx = np.linspace(0, ns - 1, k).astype(np.int64)
            rows = np.ascontiguousarray(np.asarray(chunk)[idx])
            cp = args.compact
            kws.step_active(rows, idx, compact=cp)   # compile + warmup
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                out = kws.step_active(rows, idx, compact=cp)
                (out[0] if cp else out.argmax(-1))
                times.append(time.perf_counter() - t0)
            best, med = min(times), sorted(times)[len(times) // 2]
            tag = f" [active {k}/{ns}{' compact' if cp else ''}]"
        elif args.compact:
            kws.step_compact(chunk)          # compile + warmup
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                kws.step_compact(chunk)
                times.append(time.perf_counter() - t0)
            best, med = min(times), sorted(times)[len(times) // 2]
            tag = " [compact]"
        else:
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                kws.step(chunk).argmax(-1)
                times.append(time.perf_counter() - t0)
            best, med = min(times), sorted(times)[len(times) // 2]
            tag = ""
        rtf = budget_ms / (med * 1e3)       # real-time factor per stream
        per_chip = ns / med / n_chips
        print(f"streams={ns:5d}: per-step best {best*1e3:6.1f} ms "
              f"median {med*1e3:6.1f} ms -> {rtf:6.1f}x real-time, "
              f"{ns / med:,.0f} stream-chunks/s"
              f" ({per_chip:,.0f}/chip x {n_chips}){tag}", flush=True)


if __name__ == "__main__":
    main()
