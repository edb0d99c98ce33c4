#!/usr/bin/env python
"""Streaming keyword-spotting CLI: serve WAVs as parallel real-time streams.

EXTENSION beyond the reference (which has no streaming or serving mode at
all; BASELINE configs[4]): load a trained bundle and drive the streaming
engines the way a deployment would — every input WAV becomes one parallel
stream, audio is fed in fixed chunks (default 100 ms), and each chunk is
ONE fused device dispatch over all streams.

Two engines:
  --mode exact       sliding-window recompute (models/streaming.py):
                     every hop's prediction is bit-identical to the batch
                     pipeline on the same trailing window; works with any
                     `main.py --save-model` bundle.
  --mode continuous  state-carrying mode (models/continuous.py): ~2x the
                     per-chip stream capacity; REQUIRES a bundle
                     calibrated on continuous features
                     (tools/calibrate_continuous.py) — enforced, because
                     a batch-calibrated readout loses ~0.3 accuracy in
                     this mode (docs/VALIDATION.md).

With >1 device the stream axis shards over the mesh data axis
(per-chip capacity x N chips; `--single-device` opts out).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from lsm_tpu.cli.common import metrics_from_args, setup_logging
from lsm_tpu.io import model as model_io


def _to_wire(chunk: np.ndarray, wire: str) -> np.ndarray:
    """Encode an f32 chunk into the requested ingest wire format (the
    demo stands in for a network producer; decode happens on device)."""
    if wire == "pcm16":
        from lsm_tpu.io.wav import to_pcm16_wire

        return to_pcm16_wire(chunk)
    if wire == "ulaw":
        from lsm_tpu.ops.ulaw import encode_ulaw_f32

        return encode_ulaw_f32(chunk)
    return chunk


def _serve_pool(args, pool, files, fcfg, chunk_len, n_chunks, names,
                metrics, checkpoint):
    """Session-churn serving loop over a StreamPool: WAV i is session i,
    admitted FIFO when a slot frees, fed its own chunks at its own pace,
    finished (slot recycled) after its last chunk. Audio loads LAZILY at
    admit time and is dropped at finish, so host memory is O(slot
    capacity), not O(corpus) — an always-on fleet never holds the whole
    data dir resident; a decode failure skips that session (served=False),
    mirroring static mode's skip-on-error. Only the connected sessions'
    rows cross H2D each hop (step_active under the hood); decisions come
    from the compact egress. Returns (preds, margins,
    checkpointed-on-final-hop, served-mask) with one decision per served
    session — in exact mode bit-equal to the static one-slot-per-file
    run (per-slot state depends only on that session's own audio since
    its admit reset; pinned in tests/test_stream_cli.py). Multi-host:
    every process runs this identical loop (the file walk and decode are
    deterministic, so the SPMD admit/skip decisions agree); process 0
    prints."""
    from collections import deque

    import jax as _jax

    from lsm_tpu.io.wav import load_audio_batch

    pid0 = _jax.process_index() == 0
    n_sessions = len(files)
    queue = deque(range(n_sessions))
    active: dict = {}  # session id -> next chunk index to feed
    cache: dict = {}   # session id -> its decoded (window,) f32 audio
    served = np.zeros(n_sessions, bool)
    preds = np.full(n_sessions, -1, np.int32)
    margins = np.zeros(n_sessions, np.float32)
    hop = 0
    ckpt_hop = -1
    while queue or active:
        while queue and pool.n_active < pool.capacity:
            sid = queue.popleft()
            row, kept, errors = load_audio_batch(
                [files[sid]], fcfg.sample_rate, fcfg.duration
            )
            if not kept:
                for path, err in errors:
                    print(f"Error loading {path}: {err}", file=sys.stderr)
                continue
            cache[sid] = row[0]
            served[sid] = True
            pool.admit(sid)
            active[sid] = 0
            if args.per_chunk and pid0:
                print(f"  hop {hop + 1:4d}: admit session {sid} -> "
                      f"slot {pool.slot_of(sid)}")
        sids = sorted(active)
        if not sids:
            continue    # every queued session failed to decode this round
        rows = _to_wire(np.stack([
            cache[s][active[s] * chunk_len:(active[s] + 1) * chunk_len]
            for s in sids
        ]), args.wire)
        res = pool.step(dict(zip(sids, rows)))
        hop += 1
        if args.check:
            m = np.asarray([res[s][1] for s in sids], np.float32)
            if not (np.isfinite(m).all() and (m >= 0).all()):
                raise SystemExit(
                    f"--check: non-finite or negative decision margin at "
                    f"hop {hop} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
        for s in sids:
            active[s] += 1
            if active[s] == n_chunks:
                preds[s], margins[s] = res[s]
                pool.finish(s)
                del active[s]
                del cache[s]    # O(slot-capacity) residency: drop at finish
                if args.per_chunk and pid0:
                    print(f"  hop {hop:4d}: finish session {s} -> "
                          f"{names[preds[s]]}")
        if args.save_state_every and hop % args.save_state_every == 0:
            checkpoint()
            ckpt_hop = hop
        if (args.diagnostics_every and pool.n_active
                and hop % args.diagnostics_every == 0):
            rep, _ = pool.diagnostics()    # collective: every process
            if pid0:
                print(rep.render())
            if metrics:
                # Same record key as the static path (chunk=) so
                # --metrics-out consumers see one schema for both modes.
                metrics.emit("serving_participation_pct",
                             round(rep.avg_participation, 2),
                             regime=rep.regime, scope=rep.scope, chunk=hop)
    if metrics:
        metrics.emit("serving_pool_sessions", int(served.sum()),
                     slots=pool.capacity, hops=hop)
    return preds, margins, ckpt_hop == hop, served


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Serve WAVs as parallel keyword-spotting streams."
    )
    parser.add_argument("--model", type=str, default=model_io.MODEL_FILENAME)
    parser.add_argument("--data-dir", type=str, required=True,
                        help="Directory of WAVs (recursed); each file is "
                             "one stream. Class-named parent dirs provide "
                             "labels for the accuracy line.")
    parser.add_argument("--mode", type=str, default=None,
                        choices=["exact", "continuous"],
                        help="Default: the bundle's feature_mode.")
    parser.add_argument("--chunk-ms", type=int, default=100)
    parser.add_argument("--max-streams", type=int, default=1024)
    parser.add_argument("--output", type=str, default="stream_predictions.npz")
    parser.add_argument("--wire", type=str, default="f32",
                        choices=["f32", "pcm16", "ulaw"],
                        help="Wire format fed to step(): f32 samples, "
                             "int16 PCM (2x fewer ingest bytes), or uint8 "
                             "G.711 mu-law (4x fewer; the production "
                             "always-on format — decoded on device, zero "
                             "measured accuracy cost, ops/ulaw.py).")
    parser.add_argument("--per-chunk", action="store_true",
                        help="Print the running prediction after every "
                             "chunk (default: final prediction per stream).")
    parser.add_argument("--compact", action="store_true",
                        help="Use the compact decision egress "
                             "(step_compact): the device returns packed "
                             "[top-1 class, f16 top-1/top-2 margin] — 4 "
                             "bytes/stream off the chip instead of "
                             "n_classes x 4. Predictions are bit-equal to "
                             "argmax of the full logits; margins are "
                             "written to the output file.")
    parser.add_argument("--pool", action="store_true",
                        help="Session-churn serving (StreamPool, "
                             "models/pool.py): every WAV is one SESSION, "
                             "--max-streams is the SLOT capacity, and "
                             "sessions are admitted FIFO as slots free up "
                             "— the always-on admit/step/finish lifecycle "
                             "instead of the static one-file-per-slot "
                             "replay. Decisions come from the compact "
                             "egress at each session's last chunk; in "
                             "exact mode they are bit-equal to the static "
                             "run's. Continuous-mode sessions start COLD "
                             "(~1 s warmup by design — real deployments "
                             "keep sessions long-lived). Sessions decode "
                             "lazily at admit and are dropped at finish, "
                             "so host memory is O(--max-streams), not "
                             "O(corpus) — any size data dir serves on a "
                             "low-RAM host.")
    parser.add_argument("--single-device", action="store_true")
    parser.add_argument("--save-state", type=str, default=None,
                        help="After serving, snapshot ALL cross-chunk "
                             "stream state to this .npz "
                             "(io/serving_state.py): a server restart "
                             "restores it with --restore-state and every "
                             "stream continues bit-exactly, warmup "
                             "included.")
    parser.add_argument("--state-no-compress", action="store_true",
                        help="Write state snapshots uncompressed: ~14x "
                             "faster checkpoint writes for big engines "
                             "on a slow host (zlib measured ~14 s for a "
                             "365 MB / 2048-stream state) at ~the state "
                             "size in disk.")
    parser.add_argument("--save-state-every", type=int, default=0,
                        metavar="N",
                        help="With --save-state: ALSO checkpoint every N "
                             "chunks during serving (atomic temp+rename "
                             "write, so a kill mid-checkpoint keeps the "
                             "previous snapshot) — the always-on "
                             "periodic-checkpoint pattern.")
    parser.add_argument("--check", action="store_true",
                        help="Debug sanitizer for serving (the stage "
                             "CLIs' --check, serving edition): validate "
                             "every hop's decisions are finite and, in "
                             "compact and pool modes (which decide via "
                             "the compact egress), margins non-negative "
                             "— a NaN reservoir/readout fails loudly at "
                             "the hop that produced it instead of "
                             "shipping garbage decisions.")
    parser.add_argument("--metrics-out", type=str, default=None,
                        help="Append structured JSONL metric records "
                             "(serving rate, wire format, diagnostics "
                             "regime, accuracy) to this file — the same "
                             "MetricLogger schema as the stage CLIs.")
    parser.add_argument("--diagnostics-every", type=int, default=0,
                        metavar="N",
                        help="Every N chunks, print the live reservoir "
                             "health report (participation / regime with "
                             "the reference's run_network_diagnostics "
                             "thresholds) over the served streams — how "
                             "an always-on deployment checks its "
                             "--multiplier still holds on real audio.")
    parser.add_argument("--restore-state", type=str, default=None,
                        help="Before serving, restore a --save-state "
                             "snapshot (validated against this bundle's "
                             "weights and the engine geometry). Replaces "
                             "the continuous-mode demo pre-roll: restored "
                             "streams are already warm.")
    args = parser.parse_args()
    if args.save_state_every and not args.save_state:
        # Pure-argparse check: fail before the bundle load / engine
        # compile / pre-roll.
        print("Error: --save-state-every needs --save-state <path>.",
              file=sys.stderr)
        sys.exit(1)
    if args.max_streams < 1:
        # Pure-argparse check: a 0-capacity pool would never admit a
        # session (the serve loop dies in np.stack([]) with an opaque
        # error) and a 0-stream static engine fails in the engine build.
        print("Error: --max-streams must be >= 1.", file=sys.stderr)
        sys.exit(1)
    setup_logging()

    try:
        bundle = model_io.load_model(Path(args.model))
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)

    mode = args.mode or (
        "continuous" if bundle.feature_mode == "continuous" else "exact"
    )
    if mode == "continuous" and bundle.feature_mode != "continuous":
        print(
            "Error: --mode continuous needs a continuous-calibrated bundle "
            "(this one is feature_mode='batch' — its readout loses ~0.3 "
            "accuracy on continuous features). Re-calibrate with "
            "tools/calibrate_continuous.py.",
            file=sys.stderr,
        )
        sys.exit(1)
    if mode == "exact" and bundle.feature_mode == "continuous":
        print(
            "Error: this bundle is calibrated for continuous-mode features; "
            "use --mode continuous (or an exact/batch bundle).",
            file=sys.stderr,
        )
        sys.exit(1)

    from lsm_tpu.io.wav import load_audio_batch
    from lsm_tpu.parallel import mesh as meshlib

    fcfg = bundle.frontend
    # Pool mode serves EVERY file as a session over --max-streams slots;
    # static mode serves at most --max-streams files, one slot each.
    all_files = sorted(Path(args.data_dir).rglob("*.wav"))
    files = all_files if args.pool else all_files[: args.max_streams]
    if not files:
        print(f"Error: no WAVs under '{args.data_dir}'.", file=sys.stderr)
        sys.exit(1)
    if args.pool:
        # Sessions decode LAZILY at admit time inside _serve_pool (host
        # memory O(slot capacity), not O(corpus)); decode failures skip
        # that session there, mirroring the skip-on-error below.
        audio = None
        n_streams = len(files)
    else:
        audio, kept, errors = load_audio_batch(
            files, fcfg.sample_rate, fcfg.duration
        )
        for path, err in errors:
            print(f"Error loading {path}: {err}", file=sys.stderr)
        files = [files[i] for i in kept]
        n_streams = audio.shape[0]

    mesh = None if args.single_device else meshlib.auto_mesh()
    import jax

    # Process 0 owns every informational print (errors still fail loudly
    # on all processes); the SPMD serve loops gate theirs the same way.
    pid0 = jax.process_index() == 0
    if args.pool:
        # Multi-host pool serving is SPMD: every process runs the SAME
        # admit/step/finish sequence (the file walk is deterministic and
        # every process loads the same WAVs), and the pool's device calls
        # — step_active with GLOBAL replicated rows/idx, masked resets,
        # migration, snapshot — are the engines' multi-host collectives.
        # Process 0 owns printing, metrics, and the output file, same as
        # static mode (pinned in test_multihost.py).
        if args.restore_state:
            print("Error: --pool replays files as fresh sessions; a "
                  "restored session table has no files to resume. Use "
                  "StreamPool.restore from the library for real "
                  "failover.", file=sys.stderr)
            sys.exit(1)
        # Engine width = slot capacity (mesh-padded), independent of the
        # session count.
        n_real = n_streams  # sessions
        n_streams = args.max_streams
        if mesh is not None:
            n_data = mesh.shape[meshlib.DATA_AXIS]
            n_streams = -(-n_streams // n_data) * n_data
    elif mesh is not None:
        n_data = mesh.shape[meshlib.DATA_AXIS]
        audio, n_real = meshlib.pad_to_multiple(audio, n_data)
        n_streams = audio.shape[0]
    else:
        n_real = n_streams

    chunk_len = fcfg.sample_rate * args.chunk_ms // 1000
    if mode == "continuous":
        # The calibration's distribution-shaping knobs ride in the bundle
        # and OVERRIDE the CLI: serving at a different chunk length or
        # normalization decay than the readout was calibrated on silently
        # re-introduces the ~0.3 accuracy mismatch the feature_mode tag
        # exists to prevent.
        cp = bundle.continuous_params or {}
        if cp.get("chunk_len") and cp["chunk_len"] != chunk_len:
            if pid0:
                print(
                    f"note: using the bundle's calibrated chunk length "
                    f"({cp['chunk_len']} samples) instead of --chunk-ms."
                )
            chunk_len = int(cp["chunk_len"])
    # Analysis window per session: load_audio_batch pads/truncates every
    # file to exactly this many samples (the lazy pool loads do too).
    window = int(fcfg.sample_rate * fcfg.duration)
    n_chunks = window // chunk_len
    if n_chunks == 0:
        print(
            f"Error: chunk length {chunk_len} samples exceeds the "
            f"{window}-sample analysis window.", file=sys.stderr,
        )
        sys.exit(1)
    dropped = window - n_chunks * chunk_len
    if dropped and pid0:
        print(
            f"note: chunk length {chunk_len} does not divide the "
            f"{window}-sample window — the last {dropped} samples "
            "of every file are not served (pick a dividing --chunk-ms to "
            "cover the full utterance)."
        )

    if mode == "continuous":
        from lsm_tpu.models.continuous import ContinuousKWS

        kws = ContinuousKWS(
            bundle.reservoir, bundle.readout, bundle.scaler, fcfg,
            bundle.feature_set, n_streams=n_streams,
            chunk_len=chunk_len,
            norm_decay_db_per_bin=float(
                (bundle.continuous_params or {}).get(
                    "norm_decay_db_per_bin", 0.1
                )
            ),
            mesh=mesh,
        )
    else:
        from lsm_tpu.models.streaming import StreamingKWS

        kws = StreamingKWS(
            bundle.reservoir, bundle.readout, bundle.scaler, fcfg,
            bundle.feature_set, n_streams=n_streams, mesh=mesh,
        )

    names = list(bundle.class_names)
    served_ms = 1000 * chunk_len // fcfg.sample_rate
    # Multi-host ingest contract: each process feeds its PROCESS-LOCAL
    # stream rows (process-major partition, mesh.local_stream_rows — the
    # same contract tests/test_multihost.py pins for the engines). Every
    # process loads the same WAV list, so the local rows are a slice of
    # the global batch; single-host this is the whole batch.
    _n_local = meshlib.local_stream_rows(n_streams, mesh)
    _lo = jax.process_index() * _n_local
    _hi = _lo + _n_local
    if pid0 and args.pool:
        print(f"Serving {n_real} sessions over {n_streams} pool slots "
              f"in {mode} mode ({served_ms} ms chunks, {n_chunks} chunks "
              f"per session"
              f"{', mesh x' + str(mesh.shape[meshlib.DATA_AXIS]) if mesh else ''})")
    elif pid0:
        print(f"Serving {n_real} streams in {mode} mode "
              f"({served_ms} ms chunks, {n_chunks} chunks"
              f"{', mesh x' + str(mesh.shape[meshlib.DATA_AXIS]) if mesh else ''})")
    if args.restore_state:
        from lsm_tpu.io.serving_state import load_serving_state

        try:
            load_serving_state(Path(args.restore_state), kws)
        except (FileNotFoundError, ValueError) as e:
            print(f"Error restoring state: {e}", file=sys.stderr)
            sys.exit(1)
        if pid0:
            print(f"Stream state restored from '{args.restore_state}'")
    if mode == "continuous" and not args.restore_state and not args.pool:
        # Continuous mode is calibrated for ALWAYS-ON streams (carried
        # state); a file-per-stream demo starts cold, so pre-roll each
        # stream with another utterance's audio — the same carried-state
        # protocol fit_continuous_readout trains on. A fixed-seed
        # PERMUTATION, not a roll-by-1: the file walk is class-dir-major,
        # so rolling would hand most streams a same-class predecessor and
        # flatter the accuracy line (the calibration and its bench use
        # the same class-independent protocol, models/continuous.py). A
        # real deployment simply keeps feeding the live stream and needs
        # no pre-roll (only the stream's very first second is warmup).
        preroll = audio[np.random.default_rng(12345).permutation(n_streams)]
        preroll = preroll[_lo:_hi]
        for c in range(n_chunks):
            kws.step(_to_wire(preroll[:, c * chunk_len:(c + 1) * chunk_len],
                              args.wire))
    pool = None
    if args.pool:
        from lsm_tpu.models.pool import StreamPool

        pool = StreamPool(kws, chunk_len=chunk_len)

    def _checkpoint() -> None:
        import jax

        from lsm_tpu.io.serving_state import save_serving_state, write_snapshot

        # Multi-host: snapshot() runs an all-gather COLLECTIVE, so every
        # process must take it; only process 0 writes (one writer, no
        # N-processes-one-path race). The write is atomic (temp+rename).
        compress = not args.state_no_compress
        if pool is not None:
            # Pool checkpoints carry the session table too (StreamPool.
            # save): a restart resumes slot ownership, not just state.
            pool.save(Path(args.save_state), compress=compress)
        elif jax.process_count() > 1:
            snap = kws.snapshot()
            if jax.process_index() == 0:
                write_snapshot(Path(args.save_state), kws, snap,
                               compress=compress)
        else:
            save_serving_state(Path(args.save_state), kws,
                               compress=compress)

    import time as _time

    import jax as _jax

    metrics = metrics_from_args(args) if _jax.process_index() == 0 else None
    t_serve = _time.perf_counter()
    preds = margins = logits = None
    last_ckpt_chunk = -1
    if args.pool:
        preds, margins, ckpt_on_last, served = _serve_pool(
            args, pool, files, fcfg, chunk_len, n_chunks, names,
            metrics, _checkpoint,
        )
        # Output rows cover only the served (decodable) sessions — the
        # same contract as static mode's upfront skip-on-error filter.
        files = [f for f, ok in zip(files, served) if ok]
        preds = preds[served]
        margins = margins[served]
        n_real = len(files)
        # Reuse the static path's skip-duplicate-final-checkpoint logic.
        last_ckpt_chunk = n_chunks - 1 if ckpt_on_last else -1
    for c in range(0 if args.pool else n_chunks):
        wire_chunk = _to_wire(
            audio[_lo:_hi, c * chunk_len:(c + 1) * chunk_len], args.wire
        )
        if args.compact:
            preds_all, margins = kws.step_compact(wire_chunk)
            preds = preds_all[:n_real]
            if args.check and not (
                np.isfinite(margins[:n_real]).all()
                and (margins[:n_real] >= 0).all()
            ):
                raise SystemExit(
                    f"--check: non-finite or negative decision margin at "
                    f"chunk {c + 1} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
        else:
            logits = kws.step(wire_chunk)
            if args.check and not np.isfinite(logits[:n_real]).all():
                bad = int((~np.isfinite(logits[:n_real])).any(axis=-1).sum())
                raise SystemExit(
                    f"--check: non-finite logits for {bad} stream(s) at "
                    f"chunk {c + 1} — the reservoir or readout produced "
                    "NaN/Inf on this hop"
                )
            preds = np.argmax(logits[:n_real], axis=-1)
        if args.per_chunk and pid0:
            head = " ".join(names[p] for p in preds[:8])
            print(f"  chunk {c + 1:3d}/{n_chunks}: {head}"
                  f"{' ...' if n_real > 8 else ''}")
        if args.save_state_every and (c + 1) % args.save_state_every == 0:
            _checkpoint()
            last_ckpt_chunk = c
        if args.diagnostics_every and (c + 1) % args.diagnostics_every == 0:
            import jax

            # SPMD: diagnostics is a collective on a multi-host mesh —
            # every process computes, process 0 prints. Restrict to the
            # real streams (mesh padding rows are silence and would
            # read sub-critical).
            rep = kws.diagnostics(stream_idx=np.arange(n_real))
            if jax.process_index() == 0:
                print(rep.render())
                if metrics:
                    metrics.emit(
                        "serving_participation_pct",
                        round(rep.avg_participation, 2),
                        regime=rep.regime, scope=rep.scope, chunk=c + 1,
                    )

    if metrics:
        wall = _time.perf_counter() - t_serve
        metrics.emit(
            "serving_stream_chunks_per_sec",
            round(n_chunks * n_real / wall, 2),
            mode=mode, streams=n_real, chunks=n_chunks,
            chunk_ms=served_ms, wire=args.wire, wall_s=round(wall, 3),
        )

    if args.save_state:
        import jax

        # State is unchanged since a periodic checkpoint on the very
        # last chunk — skip the duplicate full-state D2H + write.
        if last_ckpt_chunk != n_chunks - 1:
            _checkpoint()
        if jax.process_index() == 0:
            print(f"Stream state snapshot -> '{args.save_state}'")

    import jax

    if jax.process_index() != 0:
        # Multi-host: every process holds the full predictions
        # (materialize_stream_output all-gathers); one writer for the
        # output file and the report, same as the state checkpoints.
        return

    # Labels from class-named parent directories, where they match.
    class_idx = {c: i for i, c in enumerate(names)}
    labels = np.asarray(
        [class_idx.get(f.parent.name, -1) for f in files], np.int32
    )
    out = dict(
        predictions=preds.astype(np.int32),
        labels=labels,
        files=np.asarray([str(f) for f in files]),
        class_names=np.asarray(names),
    )
    if margins is not None:
        out["margins"] = np.asarray(margins[:n_real], np.float32)
    np.savez_compressed(Path(args.output), **out)
    print(f"Final predictions for {n_real} streams -> '{args.output}'")
    counts = np.bincount(preds, minlength=len(names))
    for name, cnt in zip(names, counts):
        if cnt:
            print(f"  {name:>10s}: {cnt}")
    known = labels >= 0
    if known.any():
        acc = float((preds[known] == labels[known]).mean())
        print(f"Accuracy vs directory labels ({int(known.sum())} streams): "
              f"{acc * 100:.2f}%")
        if metrics:
            metrics.emit("serving_accuracy", round(acc, 4),
                         streams=int(known.sum()), mode=mode)
    if metrics:
        metrics.close()


if __name__ == "__main__":
    main()
