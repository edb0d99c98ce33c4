"""Serving-state checkpoints for the always-on streaming engines.

The reference has stage-granular checkpointing only (its two .npz
artifacts let a stage re-run; create_dataset.py:175-176). An always-on
server needs more: the streaming engines carry per-stream state across
chunks (StreamingKWS: the sample ring buffer; ContinuousKWS: IIR
cascade, hysteresis triggers, normalization peak/floor, membrane,
segment/rate-window rings — ~1 s of warmup to rebuild from cold), so a
restart without a snapshot costs every connected stream its context.

This module is the on-disk format: one .npz holding the engine's
snapshot() leaves plus a JSON identity header. Restore validates the
header against the live engine — stream count, frontend, feature set,
chunk geometry, and a weight checksum (CRC32 over per-leaf value
digests; see _leaf_fingerprint) — so a snapshot can only be
installed into an engine that will continue it BIT-EXACTLY; anything
else fails loudly. Multi-host: snapshot() all-gathers state so every
process holds the full value — save on process 0; load takes the same
file on every process and restore() materializes only the addressable
shards.

Contract test: run k chunks, save, rebuild the engine fresh, load, run
more chunks — logits bit-equal to the uninterrupted run
(tests/test_serving_state.py, both engines, single-device and mesh).

migrate_streams builds on the same primitives: move individual live
streams between engines (any stream counts, single-device or mesh) for
serving-fleet rebalancing — the moved streams continue bit-exactly in
their new slots.
"""

from __future__ import annotations

import json
import zipfile
import zlib
from pathlib import Path

import numpy as np

from lsm_tpu.config import frontend_from_dict, frontend_to_dict

# v2: weight digest became position-weighted (order-dependent) and
# representation-independent; identity gained gtgram_two_phase. v1 files
# would fail the CRC check with a misleading "different model weights" —
# the format bump turns that into a clear versioned-format error.
# v3: the continuous engine has one gammatone implementation, so the
# gtgram_two_phase identity row is gone; v2 files are refused by version.
_FORMAT = "lsm_tpu.serving_state.v3"


# Above this many elements a leaf is fingerprinted ON DEVICE (exact
# integer sum over the bit patterns, one 8-byte D2H) instead of hashed on
# host: a 10k-neuron w_rec is ~400 MB, which is not worth pulling to the
# host just to CRC it.
_DEVICE_HASH_THRESHOLD = 1 << 20


# Knuth's golden-ratio multiplier: position-weights the modular digest so
# permuted weight matrices do not collide (a plain sum is order-blind).
_DIGEST_MULT = 0x9E3779B1


def _leaf_fingerprint(a) -> bytes:
    """Digest of a leaf's VALUES — identical whether the leaf lives as a
    jax.Array or a host np.ndarray (an engine built from host arrays and
    one built from the same bundle on device must agree, or migration
    between them falsely reports different weights).

    Large leaves (>= _DEVICE_HASH_THRESHOLD elements) use a
    position-weighted modular sum over the raw bit patterns: digest =
    sum_i (i*MULT + 1) * bits_i mod 2^32. Modular integer arithmetic
    never rounds, so the digest is deterministic across backends and
    shardings; the position weights make it order-DEPENDENT (two weight
    matrices that are permutations of each other must not validate as
    identical). On device this is one fused reduction + an 8-byte D2H
    instead of pulling a 400 MB w_rec to the host; on host the same
    formula runs chunked in NumPy.
    Small leaves hash their exact bytes either way."""
    import jax
    import jax.numpy as jnp

    if isinstance(a, jax.Array) and a.size >= _DEVICE_HASH_THRESHOLD:
        bits = jax.lax.bitcast_convert_type(
            a.reshape(-1),
            jnp.uint32 if a.dtype.itemsize == 4 else jnp.uint8,
        ).reshape(-1).astype(jnp.uint32)
        w = (jnp.arange(bits.size, dtype=jnp.uint32)
             * jnp.uint32(_DIGEST_MULT) + jnp.uint32(1))
        total = jnp.sum(bits * w, dtype=jnp.uint32)
        return int(total).to_bytes(8, "little") + str(a.shape).encode()
    arr = np.asarray(a)
    if arr.size >= _DEVICE_HASH_THRESHOLD:
        flat = np.ascontiguousarray(arr).reshape(-1)
        # Same bit-pattern flattening as the device path: 4-byte dtypes
        # digest as uint32 words, everything else as little-endian bytes
        # (= jax bitcast's minor-dim byte order on LE hosts — pinned
        # against the device path in tests/test_serving_state.py).
        bits = flat.view(np.uint32) if flat.dtype.itemsize == 4 \
            else flat.view(np.uint8)
        total = 0
        step = 1 << 22
        for off in range(0, bits.size, step):
            chunk = bits[off:off + step].astype(np.uint32)
            w = (np.arange(off, off + chunk.size, dtype=np.uint32)
                 * np.uint32(_DIGEST_MULT) + np.uint32(1))
            total = (total + int(np.sum(chunk * w, dtype=np.uint32)))
        total &= 0xFFFFFFFF
        return total.to_bytes(8, "little") + str(arr.shape).encode()
    return np.ascontiguousarray(arr).tobytes()


def _weights_crc(kws) -> int:
    """CRC32 identity over EVERYTHING the continued trajectory depends
    on: every array leaf of the reservoir params (recurrent + input
    weights, per-neuron leak), the readout, and the scaler moments, plus
    the params pytree treedef — which carries the static dynamics fields
    (threshold, refractory, burst_isi_max, n_rate_windows) and the
    dense/sparse structure. A snapshot restored under ANY difference here
    would be shape-valid yet silently diverge from the run it recorded.

    Cached on the engine (its weights are immutable after construction),
    so save/load/migrate pay the device fingerprint pass once per engine
    lifetime."""
    cached = getattr(kws, "_serving_weights_crc", None)
    if cached is not None:
        return cached
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(
        (kws.params, kws.readout, kws.scaler_state)
    )
    crc = zlib.crc32(str(treedef).encode())
    for a in leaves:
        crc = zlib.crc32(_leaf_fingerprint(a), crc)
    kws._serving_weights_crc = crc
    return crc


def _engine_meta(kws) -> dict:
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.models.streaming import StreamingKWS

    if isinstance(kws, ContinuousKWS):
        engine = "continuous"
        geometry = {
            "chunk_len": int(kws.chunk_len),
            "norm_decay_db_per_bin": float(kws.norm_decay_db_per_bin),
        }
    elif isinstance(kws, StreamingKWS):
        engine = "exact"
        geometry = {}
    else:
        raise TypeError(f"not a streaming engine: {type(kws).__name__}")
    return {
        "format": _FORMAT,
        "engine": engine,
        "n_streams": int(kws.n_streams),
        "frontend": frontend_to_dict(kws.fcfg),
        "feature_keys": list(kws.keys),
        "weights_crc": _weights_crc(kws),
        **geometry,
    }


def write_snapshot(path: Path, kws, snap: dict, compress: bool = True,
                   extra_meta: dict | None = None) -> None:
    """Write an already-taken snapshot() to `path` (.npz). Split from
    save_serving_state for multi-host callers: snapshot() is an
    all-gather COLLECTIVE every process must run, while the file write
    belongs on exactly one process (jax.process_index() == 0).

    The write is ATOMIC (temp file + rename in the same directory): a
    server killed mid-checkpoint leaves the previous snapshot intact
    instead of a truncated file — the property a periodic checkpointer
    depends on.

    `compress=False` for PERIODIC checkpoints of big engines: zlib on one
    host core costs seconds for a several-hundred-MB state (2048
    streams) — the checkpoint interval budget, not disk, is usually the
    binding constraint. The reader auto-detects either."""
    import os

    # npz member names can't contain ':' on some zip tooling paths; map
    # the 'seg:<stat>' snapshot keys to 'seg__<stat>' members.
    arrays = {k.replace("seg:", "seg__"): v for k, v in snap.items()}
    meta = _engine_meta(kws)
    if extra_meta:
        # Namespaced extension rows (e.g. StreamPool's session table).
        # load_serving_state validates only the engine-identity keys and
        # returns the full meta, so extensions ride along untouched.
        meta.update(extra_meta)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    writer = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:   # file handle: numpy can't append '.npz'
        writer(f, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def save_serving_state(path: Path, kws, compress: bool = True) -> None:
    """Snapshot `kws`'s cross-chunk stream state to `path` (.npz).

    Single-host convenience. Multi-host: take kws.snapshot() on EVERY
    process (it is a collective), then write_snapshot on process 0 only.
    """
    write_snapshot(path, kws, kws.snapshot(), compress=compress)


def read_snapshot_meta(path: Path) -> dict:
    """Read and format-check a snapshot's meta header WITHOUT touching
    any engine: the snapshot-inspection primitive (operators listing
    checkpoints; StreamPool validating its session table before it lets
    load_serving_state mutate device state). Raises the same ValueError
    contract as load_serving_state for unreadable/foreign files."""
    try:
        with np.load(Path(path), allow_pickle=False) as data:
            if "meta" not in data.files:
                raise ValueError(f"'{path}' is not a serving-state snapshot")
            meta = json.loads(str(data["meta"]))
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"'{path}' is corrupt or truncated (not a readable "
            f"serving-state snapshot): {e}"
        ) from e
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"'{path}' has format {meta.get('format')!r} "
            f"(this build reads: {_FORMAT})"
        )
    return meta


def load_serving_state(path: Path, kws) -> dict:
    """Validate `path` against `kws`'s identity and install the state.

    Raises ValueError on any mismatch: engine kind, stream count,
    frontend, feature set, chunk geometry, or weights. After it returns,
    `kws` continues the saved streams bit-exactly. Returns the snapshot's
    meta dict (engine identity plus any extension rows such as
    StreamPool's session table) for callers that persist state of their
    own alongside the engine's.
    """
    meta = read_snapshot_meta(path)
    try:
        with np.load(Path(path), allow_pickle=False) as data:
            arrays = {
                k.replace("seg__", "seg:"): data[k]
                for k in data.files
                if k != "meta"
            }
    except (zipfile.BadZipFile, OSError) as e:
        # A server killed mid --save-state leaves a truncated .npz;
        # surface it as the same ValueError contract as every other
        # invalid-snapshot condition instead of a raw zipfile traceback.
        raise ValueError(
            f"'{path}' is corrupt or truncated (not a readable "
            f"serving-state snapshot): {e}"
        ) from e
    want = _engine_meta(kws)
    for key, label in (
        ("engine", "engine mode"),
        ("n_streams", "stream count"),
        ("feature_keys", "feature set"),
        ("chunk_len", "chunk length"),
        ("norm_decay_db_per_bin", "normalization decay"),
    ):
        if meta.get(key) != want.get(key):
            raise ValueError(
                f"snapshot {label} mismatch: saved "
                f"{meta.get(key)!r}, engine has {want.get(key)!r}"
            )
    if frontend_from_dict(meta["frontend"]) != kws.fcfg:
        raise ValueError(
            "snapshot frontend configuration does not match this engine's"
        )
    if meta["weights_crc"] != want["weights_crc"]:
        raise ValueError(
            "snapshot was taken under different model weights — restoring "
            "it would not continue the streams the snapshot recorded"
        )
    kws.restore(arrays)
    return meta


def _stream_axis(key: str) -> int:
    """Axis of a snapshot leaf that indexes streams. ContinuousState is
    batch-major except `tail` and the segment rings (ring/scan-major,
    stream axis second); StreamingKWS's `buffer` is batch-major."""
    return 1 if key == "tail" or key.startswith("seg:") else 0


def migrate_streams(src, dst, src_idx, dst_idx) -> None:
    """Move live stream state between engines: dst slot `dst_idx[i]`
    continues src stream `src_idx[i]` BIT-EXACTLY, other dst slots
    untouched. The serving-fleet rebalancing / session-handoff primitive:
    an always-on pool can drain slots off one engine (host) onto another
    without costing the moved streams their warm context.

    The engines must be identical up to stream count — same kind,
    frontend, feature set, chunk geometry, and weights (validated exactly
    like load_serving_state) — because the moved state only means
    anything under the same program. Source slots keep their state; call
    src.reset(src_idx) after a successful migration to recycle them.

    Only the moved rows travel: the source gathers them on device
    (extract_streams) and the destination scatters them on device
    (install_streams) — kilobytes per stream, never the engines' full
    state. Multi-host: the extract is a collective — invoke on every
    process with identical indices (SPMD), like reset().
    """
    a, b = _engine_meta(src), _engine_meta(dst)
    for key, label in (
        ("engine", "engine mode"),
        ("feature_keys", "feature set"),
        ("chunk_len", "chunk length"),
        ("norm_decay_db_per_bin", "normalization decay"),
        ("frontend", "frontend configuration"),
        ("weights_crc", "model weights"),
    ):
        if a.get(key) != b.get(key):
            raise ValueError(
                f"cannot migrate streams between engines with different "
                f"{label}"
            )
    src_idx = np.atleast_1d(np.asarray(src_idx, np.int64))
    dst_idx = np.atleast_1d(np.asarray(dst_idx, np.int64))
    if src_idx.shape != dst_idx.shape:
        raise ValueError(
            f"src_idx has {src_idx.shape[0]} streams, dst_idx "
            f"{dst_idx.shape[0]} — must pair up one-to-one"
        )
    if (src_idx < 0).any() or (src_idx >= src.n_streams).any():
        raise ValueError(f"src_idx out of range for {src.n_streams} streams")
    if (dst_idx < 0).any() or (dst_idx >= dst.n_streams).any():
        raise ValueError(f"dst_idx out of range for {dst.n_streams} streams")
    if len(set(dst_idx.tolist())) != dst_idx.shape[0]:
        raise ValueError("dst_idx has duplicate slots")

    dst.install_streams(dst_idx, src.extract_streams(src_idx))
