"""Streaming keyword spotting (BASELINE.json configs[4]).

Real-time KWS evaluates a trailing 1 s analysis window every `hop_chunks`
audio chunks. The stream state is an on-device audio ring buffer per
stream; each evaluation runs the SAME jitted end-to-end function as the
batch path (featurize -> reservoir -> features -> readout), so streaming
predictions are bit-identical to offline predictions on the same window —
there is no approximate "streaming feature" variant to validate separately.

Scale-out (the second half of configs[4]): streams are independent, so the
stream axis shards over the mesh data axis exactly like utterances in
`parallel.sharded.extract_features_dp` — pass `mesh=` and the ring buffer,
the fused step, and the evaluation all run per-shard under shard_map with
ZERO collectives; capacity is per-device capacity x n_devices. Reference
counterpart: none (the reference is a batch pipeline with no streaming;
SURVEY.md section 5.7 mandates this mode).

Latency budget: one window evaluation is dominated by the 400-step LIF
scan and must fit inside the 10-100 ms hop. The sequence axis stays on
the device via lax.scan (SURVEY.md section 5.7): longer audio just means
more scan steps, O(1) state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsm_tpu.config import FEATURE_SETS, FrontendConfig
from lsm_tpu.models import reservoir as res
from lsm_tpu.models.frontend import featurize_batch
from lsm_tpu.parallel import mesh as meshlib
from lsm_tpu.parallel.mesh import DATA_AXIS
from lsm_tpu.readout import logistic, scaler


@functools.partial(jax.jit, donate_argnums=(0,))
def _push_chunk(buffer: jax.Array, chunk: jax.Array) -> jax.Array:
    n = chunk.shape[-1]
    return jnp.concatenate([buffer[:, n:], chunk], axis=-1)


def normalize_ingest_chunk(
    chunk: np.ndarray, n_streams: int, max_len: int, fixed_len: bool
) -> np.ndarray:
    """The SHARED ingest policy of both streaming engines (shape + dtype).

    float inputs are cast to f32 ([-1, 1] samples); int16 stays int16
    (the jitted step converts with the decoders' exact /32768 on device);
    uint8 is G.711 mu-law PCM and stays uint8 (decoded on device,
    ops/ulaw.py — one byte per sample, the ingest-bound serving format);
    other integer dtypes are rejected rather than silently cast unscaled.
    Exact mode rejects chunks LONGER than the analysis window (they would
    silently grow the buffer and recompile everything); continuous mode
    (fixed_len) requires exactly its configured chunk length. One
    function so the contract cannot drift between the engines.
    """
    chunk = np.asarray(chunk)
    if chunk.ndim == 1:
        chunk = chunk[None, :]
    if chunk.shape[0] != n_streams:
        raise ValueError(
            f"expected {n_streams} streams, got {chunk.shape[0]}"
        )
    if fixed_len:
        if chunk.shape[-1] != max_len:
            raise ValueError(
                f"continuous mode ingests fixed {max_len}-sample chunks, "
                f"got {chunk.shape[-1]}"
            )
    elif chunk.shape[-1] > max_len:
        raise ValueError(
            f"chunk length {chunk.shape[-1]} exceeds the analysis "
            f"window ({max_len} samples)"
        )
    if chunk.dtype == np.int16 or chunk.dtype == np.uint8:
        return chunk
    if np.issubdtype(chunk.dtype, np.integer):
        raise TypeError(
            "integer PCM chunks must be int16 (linear) or uint8 (mu-law), "
            f"got {chunk.dtype}"
        )
    return chunk.astype(np.float32)


def materialize_stream_output(out: jax.Array, mesh: Optional[Mesh]) -> np.ndarray:
    """Pull a per-step output (logits / packed decisions) to host.

    Single-host: plain np.asarray. On a multi-host mesh the output is
    sharded across processes (not fully addressable), so it first
    all-gathers to replicated — a CACHED jitted identity with replicated
    output sharding (mesh.host_local; a fresh lambda here would re-trace
    on every serving step), XLA lowers it to one all-gather over the data
    axis (across hosts) — and every process returns the FULL
    (n_streams, ...) array. Callers that only need local rows can slice
    their process's partition."""
    del mesh  # host_local reads the sharding off the array itself
    return np.asarray(meshlib.host_local(out))


def compact_output_device(logits: jnp.ndarray) -> jnp.ndarray:
    """(B, K) logits -> (B, 2) uint16 packed [pred, margin] (device side).

    Always-on serving at high stream counts reads a decision every hop;
    shipping full logits is 4K bytes/stream (K classes x f32) where the
    decision needs 4: the top-1 class index (uint16) and the top-1/top-2
    logit margin (f16, bitcast to uint16) as the confidence signal. One
    packed buffer, ONE small D2H transfer per hop. Fused
    into the step program (lax.top_k over the replicated class axis, so
    it shards trivially over streams). Host-side inverse:
    `unpack_compact_output`.
    """
    top2, idx = jax.lax.top_k(logits, 2)
    preds = idx[:, 0].astype(jnp.uint16)
    margin = jax.lax.bitcast_convert_type(
        (top2[:, 0] - top2[:, 1]).astype(jnp.float16), jnp.uint16
    )
    return jnp.stack([preds, margin], axis=-1)


def unpack_compact_output(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 2) uint16 packed [pred, margin] -> (preds int32, margin f32)."""
    packed = np.asarray(packed)
    preds = packed[:, 0].astype(np.int32)
    margin = packed[:, 1].copy().view(np.float16).astype(np.float32)
    return preds, margin


def wire_silence(dtype) -> int | float:
    """The byte a silent stream's producer would have sent, per wire
    format: 0.0 (f32), 0 (int16 PCM), 0xFF (G.711 mu-law encodes 0 as
    0xFF — ops/ulaw.py, also the sharded-decoder padding byte). The
    partial-activity ingest (step_active) synthesizes silent rows from
    this ON DEVICE, so skipping a silent stream's wire bytes is
    BIT-equal to sending them."""
    dt = jnp.dtype(dtype)
    if dt == jnp.uint8:
        return 0xFF
    if dt in (jnp.int16, jnp.float32):
        return 0
    raise ValueError(f"not an ingest wire dtype: {dt}")


def expand_active_rows(rows: jnp.ndarray, idx: jnp.ndarray,
                       n_streams: int) -> jnp.ndarray:
    """(k, L) active rows + (k,) slot indices -> (n_streams, L) full wire
    chunk with silence everywhere else (device-side scatter; traced into
    the engines' fused step_active programs so the whole partial-activity
    step stays one dispatch)."""
    full = jnp.full((n_streams, rows.shape[-1]), wire_silence(rows.dtype),
                    rows.dtype)
    return full.at[idx].set(rows)


def swap_readout_on(kws, readout, scaler_state=None) -> None:
    """Hot readout cutover shared by both serving engines (their
    `swap_readout` methods): install a new readout (and optionally new
    scaler moments) on a LIVE engine without touching stream state.

    The jitted steps take the readout/scaler leaves as ARGUMENTS, so the
    swap costs nothing — no recompile (shapes unchanged), and the next
    step uses the new weights. This is the hot-recalibration path:
    fit_ridge / fit_continuous_readout produce a new readout while the
    streams keep serving, then one swap cuts over mid-stream.

    Shapes/dtypes must match the live readout — a different feature set
    or class count is a different program; build a new engine and
    migrate_streams into it instead. The serving-state identity cache is
    invalidated: snapshots taken after the swap digest the NEW weights,
    and a pre-swap snapshot no longer validates against this engine (by
    design — it could not continue bit-exactly under different weights).
    Multi-host: every process must swap identical values (SPMD, like
    reset)."""
    for name, new, cur in (
        ("w", readout.w, kws.readout.w),
        ("b", readout.b, kws.readout.b),
    ) + (
        () if scaler_state is None else (
            ("mean", scaler_state.mean, kws.scaler_state.mean),
            ("scale", scaler_state.scale, kws.scaler_state.scale),
        )
    ):
        if tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
            raise ValueError(
                f"swap_readout {name}: {new.dtype}{tuple(new.shape)} does "
                f"not match the live engine's "
                f"{cur.dtype}{tuple(cur.shape)} — a different feature set "
                "or class count needs a new engine (+ migrate_streams)"
            )
    if kws.mesh is not None:
        from lsm_tpu.parallel.mesh import replicate_to_mesh

        readout = replicate_to_mesh(readout, kws.mesh)
        if scaler_state is not None:
            scaler_state = replicate_to_mesh(scaler_state, kws.mesh)
    kws.readout = readout
    if scaler_state is not None:
        kws.scaler_state = scaler_state
    # Serving-state identity: the weights CRC is cached per engine
    # lifetime (serving_state._weights_crc) — drop it so the next
    # snapshot/migrate digests the swapped weights.
    if hasattr(kws, "_serving_weights_crc"):
        del kws._serving_weights_crc


def validate_stream_idx(stream_idx, n_streams: int, what: str,
                        unique: bool = False) -> np.ndarray:
    """Host-side validation for row-addressed engine entry points
    (extract_streams / install_streams): XLA's take/scatter CLAMP
    out-of-range indices, so an off-by-one from a session table would
    silently move the WRONG stream's state bit-exactly — fail loudly on
    the host instead (the step_active convention)."""
    idx = np.atleast_1d(np.asarray(stream_idx))
    if idx.ndim != 1 or idx.size == 0:
        raise ValueError(f"{what} needs a non-empty 1-D stream index list, "
                         f"got shape {idx.shape}")
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"{what} stream indices must be integers, "
                         f"got {idx.dtype}")
    if idx.min() < 0 or idx.max() >= n_streams:
        raise ValueError(
            f"{what} stream index out of range for {n_streams} streams: "
            f"{idx[(idx < 0) | (idx >= n_streams)][:4].tolist()}"
        )
    if unique and len(set(idx.tolist())) != idx.shape[0]:
        raise ValueError(f"{what} has duplicate stream indices")
    return idx


def _validate_active(rows: "np.ndarray", idx: "np.ndarray",
                     n_streams: int, chunk_len: "int | None",
                     max_len: "int | None" = None) -> None:
    if idx.ndim != 1 or rows.ndim != 2 or rows.shape[0] != idx.shape[0]:
        raise ValueError(
            f"step_active needs rows (k, chunk_len) + idx (k,); got "
            f"rows {rows.shape}, idx {idx.shape}"
        )
    if idx.size and not np.issubdtype(idx.dtype, np.integer):
        # A float index array would silently TRUNCATE to the wrong slots
        # (someone else's stream ingests the audio) — same loud-failure
        # convention as validate_stream_idx. (An EMPTY idx list arrives
        # as float64 from np.asarray([]) and is harmless.)
        raise ValueError(
            f"active idx must be integers, got {idx.dtype}"
        )
    if chunk_len is not None and rows.shape[1] != chunk_len:
        raise ValueError(
            f"active rows are {rows.shape[1]} samples; this engine steps "
            f"in {chunk_len}-sample chunks"
        )
    if max_len is not None and not (0 < rows.shape[1] <= max_len):
        # Same guard step()'s normalize path enforces: an over-window
        # chunk would silently GROW the ring buffer (buffer[:, L:] is
        # empty) and change the engine's window length forever after.
        raise ValueError(
            f"active rows are {rows.shape[1]} samples; chunks must be "
            f"1..{max_len} (the analysis window)"
        )
    if idx.size and (idx.min() < 0 or idx.max() >= n_streams):
        raise ValueError(f"active idx out of range for {n_streams} streams")
    if len(set(idx.tolist())) != idx.shape[0]:
        raise ValueError("active idx has duplicate slots")


def prepare_active_rows(rows, idx, n_streams: int,
                        chunk_len: "int | None" = None,
                        max_len: "int | None" = None,
                        mesh=None):
    """Host-side front half of step_active, shared by both engines:
    validate, BUCKET k to the next power of two (padding with
    wire-silence rows scattered into currently-inactive slots — bit-equal
    by the feature's own construction, since explicit silence == the
    silence the device would synthesize), and place on device. Bucketing
    caps the jit cache at log2(n_streams) programs per wire format — a
    fleet whose active count fluctuates every step would otherwise
    retrace/recompile for every distinct k. Multi-host: replicated placement via
    shard_host_array (plain device_put cannot reach non-addressable
    devices)."""
    rows = np.asarray(rows)
    idx = np.asarray(idx)            # dtype validated BEFORE any cast:
    _validate_active(rows, idx, n_streams, chunk_len, max_len)
    idx = idx.astype(np.int64)
    k = idx.shape[0]
    bucket = 1
    while bucket < max(k, 1):
        bucket <<= 1
    bucket = min(bucket, n_streams)
    if bucket > k:
        free = np.setdiff1d(np.arange(n_streams), idx)[: bucket - k]
        rows = np.concatenate(
            [rows, np.full((bucket - k, rows.shape[1]),
                           wire_silence(rows.dtype), rows.dtype)], axis=0
        )
        idx = np.concatenate([idx, free])
    idx32 = idx.astype(np.int32)
    if mesh is not None and jax.process_count() > 1:
        from lsm_tpu.parallel.mesh import shard_host_array
        from jax.sharding import PartitionSpec

        return (shard_host_array(rows, mesh, PartitionSpec()),
                shard_host_array(idx32, mesh, PartitionSpec()))
    return jnp.asarray(rows), jnp.asarray(idx32)


def decode_pcm_device(chunk: jnp.ndarray) -> jnp.ndarray:
    """On-device ingest decode shared by both engines' jitted steps.

    f32 passes through; int16 is linear PCM (the decoders' exact /32768,
    io/wav.py:59); uint8 is G.711 mu-law (ops/ulaw.py). Trace-time dtype
    dispatch — each wire format compiles its own step program once.
    """
    if chunk.dtype == jnp.int16:
        return chunk.astype(jnp.float32) / 32768.0
    if chunk.dtype == jnp.uint8:
        from lsm_tpu.ops.ulaw import decode_ulaw_device

        return decode_ulaw_device(chunk)
    return chunk


def stream_pipelined(kws, chunks, depth: int = 2):
    """Pipelined serving driver shared by both streaming engines.

    Yields one (n_streams, n_classes) logits array per chunk, bit-equal to
    calling `kws.step(chunk)` serially — same jitted program, same order —
    but with up to `depth` steps in flight: chunk k+1's H2D transfer and
    step k+1's dispatch are enqueued BEFORE the host blocks on step k's
    logits, so on hosts with real async transfer engines (direct PCIe)
    the next transfer rides under the device compute. Whether it beats
    serial step() on a given host is for a measurement to decide.

    JAX makes this safe without explicit futures: device_put and jitted
    dispatch are asynchronous, and only `np.asarray(logits)` blocks. Each
    in-flight step holds one staged chunk + one logits buffer on device
    (a few hundred KB at 4096 streams), so `depth` is a host-lookahead
    knob, not a memory risk; compute stays serialized by the stream-state
    dependency either way.

    `chunks` is any iterable of host chunks (f32 or int16 PCM, the shared
    `normalize_ingest_chunk` contract) or already device-resident
    jax.Arrays (trusted, zero-copy). Do not call reset()/step() on `kws`
    while the generator is live — state advances as chunks are dispatched,
    `depth - 1` steps ahead of what has been yielded.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    from collections import deque

    pending: "deque[jax.Array]" = deque()
    for chunk in chunks:
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = kws._place_chunk(kws._normalize_chunk(chunk))
        pending.append(kws._step_device(dev))
        if len(pending) >= depth:
            yield materialize_stream_output(pending.popleft(), kws.mesh)
    while pending:
        yield materialize_stream_output(pending.popleft(), kws.mesh)


class StreamingKWS:
    """Stateful sliding-window keyword spotter over B parallel streams.

    With `mesh=None` (default) everything runs single-device. With a mesh,
    the stream axis shards along the mesh data axis: `n_streams` must be
    divisible by the data-axis size, and every step runs the full
    featurize -> reservoir -> readout chain per shard (the production
    `extract_features` dispatcher, on each device's local streams).
    """

    def __init__(
        self,
        params,
        readout: logistic.LogisticParams,
        scaler_state: scaler.ScalerState,
        fcfg: FrontendConfig,
        feature_set: str = "original",
        n_streams: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        self.params = params
        self.readout = readout
        self.scaler_state = scaler_state
        self.fcfg = fcfg
        self.keys = tuple(FEATURE_SETS[feature_set])
        self.n_streams = n_streams
        self.mesh = mesh
        self.buffer = jnp.zeros((n_streams, fcfg.num_samples), jnp.float32)

        keys = self.keys

        if mesh is None:
            self._buf_sharding = None

            # params rides as a jit ARGUMENT (it is a registered-pytree
            # dataclass), never a closure: closed-over weights become HLO
            # literal constants, which bloat (and for a large reservoir
            # break) compilation.
            def _eval_inner(p, buffer, w, b, mean, scale):
                spikes = featurize_batch(buffer, fcfg)
                feats = res.extract_features(p, spikes, keys)
                feats = (feats - mean) / scale
                return feats @ w + b

        else:
            n_data = mesh.shape[DATA_AXIS]
            if n_streams % n_data:
                raise ValueError(
                    f"n_streams={n_streams} must be divisible by the mesh "
                    f"data axis ({n_data}) so stream shards are equal"
                )
            self._buf_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
            from lsm_tpu.parallel.mesh import (
                replicate_to_mesh, shard_host_array,
            )

            # Process-aware placement (a multihost_mesh spans processes,
            # where plain device_put to non-addressable devices fails):
            # every state/weight leaf is a full value identical on every
            # process, so shard_host_array/replicate_to_mesh materialize
            # just the addressable shards. Single-host this is device_put.
            self.buffer = shard_host_array(
                np.zeros((n_streams, fcfg.num_samples), np.float32),
                mesh, P(DATA_AXIS, None),
            )
            self.params = params = replicate_to_mesh(params, mesh)
            self.readout = readout = replicate_to_mesh(readout, mesh)
            self.scaler_state = scaler_state = replicate_to_mesh(
                scaler_state, mesh
            )

            # Weight arrays enter shard_map replicated, by name, and the
            # static params metadata rides via dataclasses.replace — the
            # same pattern as parallel.sharded.extract_features_dp, which
            # also covers block-sparse reservoirs.
            if isinstance(params, res.ReservoirParams):
                names = ("w_rec", "w_in", "leak")
            else:  # models.sparse.SparseReservoirParams
                names = ("w_blocks", "src_idx", "w_in", "leak")

            def _eval_local(buffer_local, w, b, mean, scale, *weights):
                p = dataclasses.replace(params, **dict(zip(names, weights)))
                spikes = featurize_batch(buffer_local, fcfg)
                feats = res.extract_features(p, spikes, keys)
                feats = (feats - mean) / scale
                return feats @ w + b

            _eval_sm = shard_map(
                _eval_local,
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None),) + (P(),) * (4 + len(names)),
                out_specs=P(DATA_AXIS, None),
                check_vma=False,
            )

            def _eval_inner(p, buffer, w, b, mean, scale):
                weights = [getattr(p, nm) for nm in names]
                return _eval_sm(buffer, w, b, mean, scale, *weights)

        self._evaluate = jax.jit(_eval_inner)

        def _step_body(p, buffer, chunk, w, b, mean, scale, compact):
            # THE step semantics — the single definition all three jitted
            # entry points (_step, _step_compact, _step_active) trace, so
            # their bit-equality contracts cannot drift apart.
            # Compressed-wire ingest (int16 linear / uint8 mu-law)
            # converts on device — the H2D transfer moves 2x/4x fewer
            # bytes than f32 and the serving wall is ingest-bound.
            chunk = decode_pcm_device(chunk)
            n = chunk.shape[-1]
            buffer = jnp.concatenate([buffer[:, n:], chunk], axis=-1)
            out = _eval_inner(p, buffer, w, b, mean, scale)
            return buffer, (compact_output_device(out) if compact else out)

        @functools.partial(jax.jit, donate_argnums=(1,))
        def _step(p, buffer, chunk, w, b, mean, scale):
            return _step_body(p, buffer, chunk, w, b, mean, scale, False)

        self._step = _step

        @functools.partial(jax.jit, donate_argnums=(1,))
        def _step_compact(p, buffer, chunk, w, b, mean, scale):
            return _step_body(p, buffer, chunk, w, b, mean, scale, True)

        self._step_compact = _step_compact

        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(8,))
        def _step_active(p, buffer, rows, idx, w, b, mean, scale, compact):
            # Partial-activity ingest: scatter the k active rows into a
            # silence-filled full chunk ON DEVICE (wire_silence per
            # format), then the shared step body — one fused dispatch,
            # H2D carries only the active rows.
            chunk = expand_active_rows(rows, idx, n_streams)
            return _step_body(p, buffer, chunk, w, b, mean, scale, compact)

        self._step_active = _step_active

        # k fused steps in ONE dispatch (the amortized-timing probe —
        # see steps_fused). The buffer evolves across iterations, so XLA
        # cannot hoist the loop body even though the chunk repeats.
        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(7,))
        def _steps_fused(p, buffer, chunk, w, b, mean, scale, k):
            def body(buf, _):
                buf, out = _step_body(p, buf, chunk, w, b, mean, scale,
                                      False)
                return buf, jnp.sum(out, dtype=jnp.float32)

            buffer, sums = jax.lax.scan(body, buffer, None, length=k)
            return buffer, sums[-1]

        self._steps_fused = _steps_fused

        # Live-traffic diagnostics program (compiled on first
        # diagnostics() call): re-simulate the current trailing windows
        # and reduce FULL-reservoir spike counts to per-stream
        # (active, total) scalars — a tiny D2H, and exactly the batch
        # diagnostics' semantics (extract_lsm_features.py:92-152) applied
        # to the live window.
        if isinstance(params, res.ReservoirParams):
            _sim = res.simulate_batch
        else:
            from lsm_tpu.models.sparse import simulate_batch_sparse as _sim

        def _diag_body(p, buffer):
            spikes = featurize_batch(buffer, fcfg)
            counts = _sim(p, spikes)["all_counts"]
            return (jnp.sum(counts > 0, axis=1).astype(jnp.int32),
                    jnp.sum(counts, axis=1))

        if mesh is None:
            self._diag = jax.jit(_diag_body)
        else:
            _diag_sm = shard_map(
                lambda buffer_local, *weights: _diag_body(
                    dataclasses.replace(params, **dict(zip(names, weights))),
                    buffer_local,
                ),
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None),) + (P(),) * len(names),
                out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                check_vma=False,
            )

            def _diag_fn(p, buffer):
                return _diag_sm(buffer, *[getattr(p, nm) for nm in names])

            self._diag = jax.jit(_diag_fn)

    def diagnostics(self, stream_idx=None):
        """Reservoir health on LIVE serving traffic: re-simulates each
        stream's current trailing window and reports full-reservoir
        participation / dead neurons / mean rate per stream plus the
        regime verdict, with the reference's thresholds and advice
        (extract_lsm_features.py:92-152) — how a deployed server checks
        its reservoir is still at the edge of chaos on real audio
        statistics. `stream_idx` selects the streams the verdict averages
        over (None = all; silent slots read sub-critical by nature, so
        pools pass their connected sessions). On-demand cost: one full
        window simulation per call — run it at health-check cadence, not
        per hop."""
        from lsm_tpu.models.diagnostics import serving_report

        act, tot = self._diag(self.params, self.buffer)
        return serving_report(
            materialize_stream_output(act, self.mesh),
            materialize_stream_output(tot, self.mesh),
            self.params.n_neurons, "full", stream_idx,
        )

    def swap_readout(self, readout, scaler_state=None) -> None:
        """Hot readout cutover on the live engine (see swap_readout_on)."""
        swap_readout_on(self, readout, scaler_state)

    def step_active(self, rows, active_idx, compact: bool = False):
        """step() with only the ACTIVE streams' audio on the wire: `rows`
        is (k, chunk_len) in any ingest wire format, `active_idx` the k
        stream slots it belongs to. Silent streams advance on
        device-synthesized wire silence, so the logits are BIT-equal to
        step() on the full chunk with silence in the inactive rows — at
        k/n_streams of the H2D bytes, the first-order serving wall. For
        an always-on fleet at activity factor f the ingest wire shrinks
        1/f with zero semantic change (silence is what those producers
        would have sent). Multi-host: SPMD — every process passes the
        same global rows/idx.

        compact=True also packs the decision egress (see step_compact):
        returns (preds int32 (B,), margin f32 (B,)) at 4 bytes/stream
        D2H — both wire directions shrink.

        The active count buckets to the next power of two internally
        (prepare_active_rows), so fluctuating fleet activity compiles at
        most log2(n_streams) programs per wire format."""
        rows_d, idx_d = prepare_active_rows(
            rows, active_idx, self.n_streams,
            max_len=self.fcfg.num_samples, mesh=self.mesh,
        )
        self.buffer, out = self._step_active(
            self.params, self.buffer, rows_d, idx_d,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale,
            compact,
        )
        out = materialize_stream_output(out, self.mesh)
        return unpack_compact_output(out) if compact else out

    def _place_chunk(self, chunk: np.ndarray) -> jax.Array:
        """Host chunk -> device, stream-sharded on a mesh; multi-host each
        process passes its PROCESS-LOCAL rows (mesh.place_stream_chunk,
        the contract shared with ContinuousKWS)."""
        return meshlib.place_stream_chunk(chunk, self._buf_sharding)

    def _local_streams(self) -> int:
        """Rows each process feeds per chunk (mesh.local_stream_rows)."""
        return meshlib.local_stream_rows(self.n_streams, self.mesh)

    def _normalize_chunk(self, chunk: np.ndarray) -> np.ndarray:
        return normalize_ingest_chunk(
            chunk, self._local_streams(), self.fcfg.num_samples,
            fixed_len=False,
        )

    def push(self, chunk: np.ndarray) -> None:
        """Append a (n_streams, chunk_len) audio chunk to the ring buffer.

        Same ingest contract as step(): f32 samples, int16 PCM, or uint8
        mu-law (decoded with the exact device conventions on the host
        here)."""
        chunk = self._normalize_chunk(chunk)
        if chunk.dtype == np.int16:
            chunk = chunk.astype(np.float32) / 32768.0
        elif chunk.dtype == np.uint8:
            from lsm_tpu.ops.ulaw import decode_ulaw_reference

            chunk = decode_ulaw_reference(chunk).astype(np.float32) / 32768.0
        self.buffer = _push_chunk(self.buffer, self._place_chunk(chunk))

    def logits(self) -> np.ndarray:
        """Evaluate the current trailing window. (n_streams, n_classes)."""
        out = self._evaluate(
            self.params,
            self.buffer,
            self.readout.w,
            self.readout.b,
            self.scaler_state.mean,
            self.scaler_state.scale,
        )
        return materialize_stream_output(out, self.mesh)

    def predict(self) -> np.ndarray:
        return np.argmax(self.logits(), axis=-1)

    def step(self, chunk: np.ndarray) -> np.ndarray:
        """push + logits fused into ONE dispatch: (n_streams, n_classes).

        Semantically identical to push(chunk) then logits(), but the
        buffer roll and the window evaluation compile into a single
        program — one device dispatch per chunk instead of two.

        Accepts float32 samples in [-1, 1] or raw int16 PCM; PCM chunks
        transfer half the bytes and convert on device with the exact
        decoder scaling (pcm / 32768), so the two forms are bit-equal. A
        jax.Array chunk is trusted as already device-resident (and, under
        a mesh, already stream-sharded) — the zero-copy ingest path."""
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        return materialize_stream_output(self._step_device(dev), self.mesh)

    def _step_device(self, dev: jax.Array) -> jax.Array:
        """Dispatch one step on a device-resident chunk; returns the logits
        as an UNMATERIALIZED jax.Array (nothing blocks). The building block
        of the pipelined driver."""
        self.buffer, out = self._step(
            self.params,
            self.buffer,
            dev,
            self.readout.w,
            self.readout.b,
            self.scaler_state.mean,
            self.scaler_state.scale,
        )
        return out

    def step_compact(self, chunk) -> Tuple[np.ndarray, np.ndarray]:
        """step() with the compact decision output: (preds int32 (B,),
        margin f32 (B,)) — top-1 class + top-1/top-2 logit margin, packed
        on device into one (B, 2) uint16 buffer so the D2H transfer is 4
        bytes/stream instead of 4K (see compact_output_device). Same
        ingest contract and state advance as step(); preds are bit-equal
        to step(chunk).argmax(-1)."""
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        self.buffer, packed = self._step_compact(
            self.params, self.buffer, dev,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale,
        )
        return unpack_compact_output(
            materialize_stream_output(packed, self.mesh)
        )

    def stream(self, chunks, depth: int = 2):
        """Pipelined serving loop: yields per-chunk logits, bit-equal to
        serial step() calls but with H2D/dispatch of up to `depth` steps
        in flight (see stream_pipelined)."""
        return stream_pipelined(self, chunks, depth=depth)

    def steps_fused(self, chunk, k: int) -> float:
        """Run k consecutive step() calls on the SAME ingest chunk as ONE
        jitted dispatch (a lax.scan over the step body) and return the
        LAST hop's logit checksum — the scalar D2H barrier.

        This is the amortized-timing probe bench.py uses for its
        device-only rows: k steps in one dispatch pay the per-dispatch
        overhead once. State advances exactly as k step() calls on that chunk (pinned
        bit-level in tests/test_streaming.py); the per-hop logits are
        not returned (use step() for decisions)."""
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        self.buffer, s = self._steps_fused(
            self.params, self.buffer, dev,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale, int(k),
        )
        return float(s)

    def reset(self, stream_idx: Optional[int] = None) -> None:
        if stream_idx is None:
            if self._buf_sharding is not None:
                from lsm_tpu.parallel.mesh import shard_host_array

                self.buffer = shard_host_array(
                    np.zeros(self.buffer.shape, self.buffer.dtype),
                    self.mesh, P(DATA_AXIS, None),
                )
            else:
                self.buffer = jnp.zeros(self.buffer.shape, self.buffer.dtype)
        else:
            # Loud validation: XLA's scatter silently DROPS out-of-bounds
            # updates, so an off-by-one reset would be a no-op and the
            # recycled slot would keep the previous tenant's trailing
            # audio (ContinuousKWS.reset raises via its NumPy mask; the
            # two engines' contracts must match).
            idx = validate_stream_idx(stream_idx, self.n_streams, "reset")
            self.buffer = self.buffer.at[jnp.asarray(idx, jnp.int32)].set(0.0)

    def snapshot(self) -> dict:
        """Host copy of ALL cross-chunk stream state (here: the sample
        ring buffer). Restoring it into a fresh engine with the same
        weights continues the stream bit-exactly (io/serving_state.py is
        the on-disk format + compatibility validation). Multi-host, the
        state all-gathers so every process holds the full snapshot."""
        return {"buffer": np.asarray(meshlib.host_local(self.buffer))}

    def restore(self, snap: dict) -> None:
        """Inverse of snapshot(): install a saved state. `snap` carries
        FULL (n_streams, ...) arrays, identical on every process; under a
        mesh each process materializes its addressable shards."""
        if "buffer" not in snap:
            raise ValueError(
                "snapshot is missing state leaf 'buffer' — not a "
                "StreamingKWS snapshot"
            )
        buf = np.asarray(snap["buffer"])
        want = (self.n_streams, self.fcfg.num_samples)
        if buf.shape != want or buf.dtype != np.float32:
            raise ValueError(
                f"snapshot buffer is {buf.dtype}{buf.shape}; this engine "
                f"needs float32{want} — the snapshot was taken with a "
                "different n_streams or frontend"
            )
        if self._buf_sharding is not None:
            from lsm_tpu.parallel.mesh import shard_host_array

            self.buffer = shard_host_array(buf, self.mesh, P(DATA_AXIS, None))
        else:
            self.buffer = jnp.asarray(buf)

    def extract_streams(self, stream_idx) -> dict:
        """snapshot() restricted to the named stream slot(s): the gather
        runs on device, so only the selected rows cross D2H. The unit
        serving_state.migrate_streams moves. Multi-host: a collective —
        call on every process with identical indices (SPMD)."""
        idx = jnp.asarray(
            validate_stream_idx(stream_idx, self.n_streams,
                                "extract_streams"),
            jnp.int32,
        )
        return {
            "buffer": np.asarray(
                meshlib.host_local(jnp.take(self.buffer, idx, axis=0))
            )
        }

    def install_streams(self, stream_idx, rows: dict) -> None:
        """Inverse of extract_streams: scatter donor rows into the named
        slots, other slots untouched. Multi-host: SPMD."""
        idx = validate_stream_idx(stream_idx, self.n_streams,
                                  "install_streams", unique=True)
        if "buffer" not in rows:
            raise ValueError("donor rows are missing state leaf 'buffer'")
        r = np.asarray(rows["buffer"])
        want = (idx.shape[0], self.fcfg.num_samples)
        if r.shape != want or r.dtype != np.float32:
            raise ValueError(
                f"donor leaf 'buffer' is {r.dtype}{r.shape}; this engine "
                f"needs float32{want} — the donor engine has a different "
                "geometry"
            )
        self.buffer = self.buffer.at[jnp.asarray(idx, jnp.int32)].set(r)
