"""The three pipeline stages as library functions + the fused end-to-end path.

The reference chains three scripts via `os.system` and .npz files
(main.py:19-27). Here each stage is a plain function over arrays; the CLI
scripts are thin façades that preserve the reference's flags and artifact
filenames, and the whole pipeline can also run fused in one process with no
intermediate host round-trips.

Every stage is data-parallel over the device mesh by default (SURVEY.md
section 2.4a): with more than one device, `mesh="auto"` shards each compute
batch along the mesh data axis — featurization and reservoir simulation are
per-utterance independent (zero collectives), while the readout fit reduces
its gradients across shards. On one device the single-chip jit path is used
unchanged. The reference has no parallelism at all (serial per-sample loop,
extract_lsm_features.py:78).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from lsm_tpu.config import FEATURE_SETS, PipelineConfig
from lsm_tpu.io import artifacts, dataset
from lsm_tpu.io.wav import load_audio_batch
from lsm_tpu.models import reservoir as res
from lsm_tpu.models.calibration import calibrate_weight
from lsm_tpu.models.diagnostics import DiagnosticsReport, run_network_diagnostics
from lsm_tpu.models.frontend import featurize_batch
from lsm_tpu.parallel import mesh as meshlib
from lsm_tpu.readout import logistic, metrics, scaler

log = logging.getLogger("lsm_tpu")

# `mesh` parameter convention for the stage functions below:
#   "auto" (default) -> all devices on the data axis when >1 device;
#   None             -> force the single-device path;
#   a Mesh           -> use it as given.
MeshArg = Union[str, None, Mesh]


def _resolve_mesh(mesh: MeshArg) -> Optional[Mesh]:
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"unknown mesh spec: {mesh!r}")
        return meshlib.auto_mesh()
    return mesh


def _effective_batch(batch_size: int, mesh: Optional[Mesh]) -> int:
    """Round the compute batch up to a shard multiple of the data axis."""
    if mesh is None:
        return batch_size
    n = mesh.shape[meshlib.DATA_AXIS]
    return -(-batch_size // n) * n


def _batched(n: int, batch_size: int):
    for start in range(0, n, batch_size):
        yield start, min(start + batch_size, n)


def _pad_batch(x: np.ndarray, size: int) -> Tuple[np.ndarray, int]:
    """Pad the batch axis up to `size` so every jit call has one shape."""
    n = x.shape[0]
    if n == size:
        return x, n
    pad = [(0, size - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad), n


def _place_batch(x: np.ndarray, mesh: Optional[Mesh]) -> jax.Array:
    """Host batch -> device(s): sharded along the data axis under a mesh."""
    if mesh is None:
        return jnp.asarray(x)
    return meshlib.shard_batch(np.asarray(x), mesh)


def _featurize(
    audio_dev: jax.Array, fcfg, mesh: Optional[Mesh], check: bool = False
) -> jax.Array:
    """Featurize on one device or via shard_map over the mesh (mirroring
    extract_features_dp: each device featurizes its local batch shard).

    check=True (the --check debug mode): the single-device path runs under
    checkify float checks, so a NaN/Inf produced ANYWHERE inside the
    featurizer chain raises a located error instead of silently encoding
    garbage. The mesh path cannot checkify (it does not compose with
    shard_map), so it guards the INPUT with one device-side finiteness
    reduction here and relies on the callers' host-side output validation
    for the rest — NaNs born inside the mesh computation surface at the
    feature validator, one stage later than checkify would locate them."""
    if mesh is None:
        if check:
            from lsm_tpu.utils import checks

            return checks.checked(lambda a: featurize_batch(a, fcfg))(audio_dev)
        return featurize_batch(audio_dev, fcfg)
    from lsm_tpu.parallel.sharded import featurize_dp

    if check and not bool(_all_finite(audio_dev)):
        raise RuntimeError(
            "--check failed in featurize (mesh path): non-finite audio "
            "input (the mesh path cannot run checkify, so the input is "
            "validated with a device-side reduction instead)"
        )
    return featurize_dp(audio_dev, fcfg, mesh)


@jax.jit
def _all_finite(x: jax.Array) -> jax.Array:
    return jnp.isfinite(x).all() if jnp.issubdtype(x.dtype, jnp.floating) \
        else jnp.asarray(True)


def _check_spikes_host(spikes: np.ndarray, context: str) -> None:
    """--check invariant: spike trains are strictly 0/1 (the contract the
    bit-packed D2H transfer and the reservoir drive both assume).

    Callers MUST pass the raw device featurizer output, BEFORE
    _spikes_to_host: the pack/unpackbits round-trip can only produce 0/1,
    so validating after it would be vacuous — a featurizer bug emitting a
    2 would be aliased into wrong bit patterns instead of caught."""
    bad = (spikes != 0) & (spikes != 1)
    if bad.any():
        raise RuntimeError(
            f"--check failed in {context}: {int(bad.sum())} spike values "
            "outside {0, 1}"
        )


def _check_features_host(features: np.ndarray, context: str) -> None:
    """--check validation of extracted features (utils.checks)."""
    from lsm_tpu.utils.checks import validate_features_host

    ok, msg = validate_features_host(features)
    if not ok:
        raise RuntimeError(f"--check failed in {context}: {msg}")


@jax.jit
def _pack_spike_bits(spikes: jax.Array) -> jax.Array:
    """(B, C, T) 0/1 uint8 -> (B, C, T//8) uint8, little bit order."""
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    b, c, t = spikes.shape
    packed = jnp.sum(
        spikes.astype(jnp.int32).reshape(b, c, t // 8, 8) * w, axis=-1
    )
    return packed.astype(jnp.uint8)


@jax.jit
def _unpack_spike_bits_dev(packed: jax.Array) -> jax.Array:
    """(B, C, T//8) uint8 little-endian bit-packed -> (B, C, T) 0/1 uint8.

    Device-side inverse of np.packbits(..., bitorder='little'): the
    HOST->DEVICE twin of _pack_spike_bits/_spikes_to_host. The corpus-scale
    streaming paths (extract_and_train_streaming, classify_spikes_
    streaming) move ~26 MB per 512-row spike batch host-to-device;
    packing on host with np.packbits and unpacking here cuts the transfer
    8x. Jitted standalone and jit-composable
    (classify_spikes_streaming inlines it into its per-batch program).
    """
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(packed.shape[0], packed.shape[1], -1)


def _pack_batch_host(padded: np.ndarray) -> np.ndarray:
    """Host-side bit-pack of a (B, C, T) 0/1 uint8 batch (T % 8 == 0)."""
    return np.packbits(padded, axis=-1, bitorder="little")


def _spikes_to_host(spikes_dev: jax.Array, n_real: int) -> np.ndarray:
    """Device spikes -> host (B, C, T) uint8, bit-packed for the transfer.

    Spike trains are 0/1, so packing 8 steps per byte on device cuts the
    device->host bytes 8x. Exact: hysteresis
    spikes are 0/1 by invariant (utils.checks.assert_spike_invariants);
    np.unpackbits(bitorder='little') inverts the device dot exactly.
    Falls back to the direct transfer when T % 8 != 0.
    """
    t = spikes_dev.shape[-1]
    if t % 8:
        return np.asarray(spikes_dev[:n_real])
    # Pack the full padded batch (one static shape -> one compile) and
    # slice the packed array; slicing before the jit would re-trace per
    # distinct kept-count.
    packed = np.asarray(_pack_spike_bits(spikes_dev)[:n_real])
    return np.unpackbits(packed, axis=-1, bitorder="little")


# ---------------------------------------------------------------------------
# Stage 1: audio files -> spike dataset
# ---------------------------------------------------------------------------

def create_spike_dataset(
    cfg: PipelineConfig,
    base_path: Path,
    output_path: Optional[Path] = None,
    sharded_output: Optional[Path] = None,
    shard_size: int = 8192,
    compress: bool = True,
    mesh: MeshArg = "auto",
):
    """Featurize a Speech Commands-style directory tree into spike trains.

    Equivalent of create_dataset.py:107-177, but batched: files are decoded
    in large chunks and featurized with one jitted call per chunk, sharded
    over the device mesh. With `sharded_output`, shards are written
    incrementally (constant host memory) for 100k-utterance-scale corpora
    (SURVEY.md section 5.4), and an interrupted run resumes from the last
    complete shard.

    Returns artifacts.SpikeDataset (in-memory path) or a LAZY
    io.sharded.ShardedSpikeDataset handle (sharded path) — same
    .x_spikes/.y_labels surface, materialized on first access only.
    """
    mesh = _resolve_mesh(mesh)
    idx = dataset.index_speech_commands(
        base_path, cfg.commands, cfg.max_samples_per_class
    )
    for w in idx.warnings:
        log.warning(w)
    if not idx.files:
        raise RuntimeError("No audio files were successfully processed.")

    writer = None
    first_file = 0
    if sharded_output is not None:
        import hashlib

        from lsm_tpu.io.sharded import ShardedSpikeDatasetWriter

        # Resume is only valid if the shards on disk were produced from the
        # SAME featurization config and the SAME input file sequence —
        # file indices anchor the resume, so an inserted/removed file (or a
        # changed filterbank) must force a fresh run, not a silent mix.
        h = hashlib.sha256()
        h.update(repr(cfg.frontend).encode())
        # audio_wire lives on PipelineConfig, not FrontendConfig, but it
        # IS part of the featurization identity: int16 is bit-exact,
        # mu-law is lossy (~38 dB SNR) — a resume across a wire switch
        # would silently mix the two in one dataset.
        h.update(f"audio_wire={cfg.audio_wire}".encode())
        for p in idx.files:
            h.update(str(p).encode())
            h.update(b"\0")
        fingerprint = h.hexdigest()

        from lsm_tpu.config import corpus_meta

        writer = ShardedSpikeDatasetWriter(
            sharded_output, shard_size, resume=True, compress=compress,
            fingerprint=fingerprint,
            # Recorded so corpus consumers (extract_lsm_features.py
            # --streaming-fit --save-model) can recover the TRUE
            # featurization + vocabulary instead of assuming defaults.
            meta=corpus_meta(cfg),
        )
        first_file = writer.resume_file_index + 1
        if first_file:
            log.info(
                "Resuming featurization at file %d/%d (%d shards complete)",
                first_file, len(idx.files), len(writer.completed_shards()),
            )

    fcfg = cfg.frontend
    bs = _effective_batch(cfg.batch_size, mesh)
    spikes_out, labels_out = [], []
    n_total = 0
    t0 = time.perf_counter()

    # One-ahead decode prefetch: the native WAV decoder (a ctypes call)
    # and zlib both release the GIL, so chunk k+1 decodes on a worker
    # thread while the main thread waits on the device for chunk k.
    # Results are consumed strictly in order — artifacts are byte-
    # identical to the serial loop.
    from concurrent.futures import ThreadPoolExecutor

    chunks = [
        (start + first_file, stop + first_file)
        for start, stop in _batched(len(idx.files) - first_file, bs)
    ]

    def _decode(start: int, stop: int):
        # Audio device wire (cfg.audio_wire). Default int16 PCM: BIT-EQUAL
        # spikes for PCM16-sourced files (all of Speech Commands) at half
        # the H2D bytes of f32; the native decoder
        # memcpys PCM16-at-rate files without any float round-trip.
        # Float/24-bit/resampled sources quantize at the 16-bit step
        # (~3e-5 — the precision the reference's own 16-bit corpus
        # carries). "ulaw" halves the wire again (uint8 G.711, decoded on
        # device): lossy, measured accuracy-neutral — opt in where
        # host-to-device bandwidth is the wall.
        return load_audio_batch(
            idx.files[start:stop], fcfg.sample_rate, fcfg.duration,
            dtype=cfg.audio_wire,
        )

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_decode, *chunks[0]) if chunks else None
        for i, (start, stop) in enumerate(chunks):
            audio, kept, errors = fut.result()
            if i + 1 < len(chunks):
                fut = pool.submit(_decode, *chunks[i + 1])
            for path, err in errors:
                log.warning("Error loading %s: %s", path, err)
            if audio.shape[0] == 0:
                continue
            padded, n_real = _pad_batch(audio, bs)
            spikes_dev = _featurize(
                _place_batch(padded, mesh), fcfg, mesh, check=cfg.check
            )
            if cfg.check:
                _check_spikes_host(
                    np.asarray(spikes_dev[:n_real]), "create_spike_dataset"
                )
            spikes = _spikes_to_host(spikes_dev, n_real)
            labels = idx.labels[start:stop][kept]
            n_total += n_real
            if writer is not None:
                writer.append(spikes, labels, np.arange(start, stop)[kept])
            else:
                spikes_out.append(spikes)
                labels_out.append(labels)

    if writer is not None:
        manifest = writer.close()
        dt = time.perf_counter() - t0
        log.info("Sharded dataset: %d samples in %d shards (%.1f utt/s)",
                 manifest["num_samples"], len(manifest["shards"]),
                 n_total / max(dt, 1e-9))
        from lsm_tpu.io.sharded import ShardedSpikeDataset

        # A LAZY handle: .x_spikes/.y_labels materialize on first access
        # (fine at reference scale), while corpus-scale callers read the
        # journal stats (num_samples/total_spikes/row_shape) and stream
        # via iter_batches — the whole point of the sharded writer is that
        # 100k utterances never sit in host RAM at once.
        handle = ShardedSpikeDataset(sharded_output)
        # On a RESUMED run num_samples counts previous runs' shards too;
        # rate metrics must divide only what THIS invocation featurized.
        handle.featurized_this_run = n_total
        return handle

    if not spikes_out:
        raise RuntimeError("No audio files were successfully processed.")

    x = np.concatenate(spikes_out, axis=0)
    y = np.concatenate(labels_out, axis=0)
    dt = time.perf_counter() - t0
    log.info(
        "Dataset created: shape=%s avg spikes/sample=%.1f (%.1f utt/s)",
        x.shape, x.sum() / len(x), len(x) / max(dt, 1e-9),
    )
    ds = artifacts.SpikeDataset(x_spikes=x, y_labels=y)
    if output_path is not None:
        artifacts.save_spike_dataset(output_path, ds)
    return ds


def load_spike_dataset_any(path: Path) -> artifacts.SpikeDataset:
    """Load either a classic .npz artifact or a sharded dataset directory."""
    path = Path(path)
    if path.is_dir():
        from lsm_tpu.io.sharded import ShardedSpikeDataset

        return ShardedSpikeDataset(path).load_all()
    return artifacts.load_spike_dataset(path)


def featurize_audio_array(
    cfg: PipelineConfig, audio: np.ndarray, mesh: MeshArg = "auto"
) -> np.ndarray:
    """(N, T_samples) float32 -> (N, C, T) uint8 spikes, batched jit calls
    sharded data-parallel over the mesh."""
    mesh = _resolve_mesh(mesh)
    bs = _effective_batch(cfg.batch_size, mesh)
    out = []
    for start, stop in _batched(audio.shape[0], bs):
        padded, n_real = _pad_batch(audio[start:stop], bs)
        spikes_dev = _featurize(
            _place_batch(padded, mesh), cfg.frontend, mesh, check=cfg.check
        )
        if cfg.check:
            _check_spikes_host(
                np.asarray(spikes_dev[:n_real]), "featurize_audio_array"
            )
        out.append(_spikes_to_host(spikes_dev, n_real))
    return np.concatenate(out, axis=0)


# ---------------------------------------------------------------------------
# Stage 2: spike dataset -> standardized LSM features
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExtractionResult:
    artifact: artifacts.FeatureArtifact
    w_critico: float
    mean_weight: float
    diagnostics: DiagnosticsReport
    params: res.ReservoirParams
    scaler: Optional[scaler.ScalerState] = None


def _approximate_mode(
    class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState
) -> np.ndarray:
    """Per-class draw counts summing to n_draws: floor of the proportional
    share, the remainder handed out by descending fractional part with
    ties broken by `rng` (sklearn.utils.extmath._approximate_mode)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(
    x: np.ndarray, y: np.ndarray, test_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratified train/test split, bit-compatible with the reference.

    The reference uses sklearn.train_test_split(..., random_state=42,
    stratify=y) (extract_lsm_features.py:160-162). This is the same
    algorithm (sklearn's StratifiedShuffleSplit, first split) in NumPy
    with the same RandomState draw order, so the split is identical
    whether or not sklearn is installed (tests/test_pipeline.py compares
    it with sklearn where sklearn is present).
    """
    y = np.asarray(y)
    n = y.shape[0]
    n_test = int(math.ceil(test_size * n))
    n_train = n - n_test
    classes, y_idx, class_counts = np.unique(
        y, return_inverse=True, return_counts=True
    )
    if class_counts.min() < 2:
        raise ValueError(
            f"classes {classes[class_counts < 2].tolist()} have fewer than "
            "2 members; a stratified split needs at least 2 per class"
        )
    if min(n_train, n_test) < classes.shape[0]:
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each be at "
            f"least the number of classes ({classes.shape[0]})"
        )
    class_indices = np.split(
        np.argsort(y_idx, kind="stable"), np.cumsum(class_counts)[:-1]
    )
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(classes.shape[0]):
        perm = class_indices[i].take(rng.permutation(class_counts[i]))
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    tr = rng.permutation(train)
    te = rng.permutation(test)
    return x[tr], x[te], y[tr], y[te]


def _init_reservoir_params(cfg: PipelineConfig, n_channels: int, mean_weight: float):
    """Reservoir init shared by the in-memory and streaming stage-2 paths."""
    if cfg.reservoir.use_sparse():
        # Scaled reservoirs (>=4096 neurons, N % 128 == 0): block-sparse
        # weights (~10% density). extract_features and the DP shard_map
        # path dispatch on the params type.
        from lsm_tpu.models.sparse import init_reservoir_sparse

        log.info(
            "Using block-sparse reservoir (%d neurons)", cfg.reservoir.num_neurons
        )
        return init_reservoir_sparse(
            cfg.reservoir, n_channels, mean_weight=mean_weight
        )
    return res.init_reservoir(cfg.reservoir, n_channels, mean_weight=mean_weight)


def extract_lsm_features(
    cfg: PipelineConfig,
    ds: artifacts.SpikeDataset,
    output_path: Optional[Path] = None,
    run_diagnostics: bool = True,
    mesh: MeshArg = "auto",
) -> ExtractionResult:
    """Equivalent of extract_lsm_features.py:155-214, batched and jitted.

    Under a mesh, the reservoir simulation shards data-parallel over
    devices (each chip runs the fused LIF path on its batch shard; no
    collectives — utterances are independent)."""
    mesh = _resolve_mesh(mesh)
    x_train, x_test, y_train, y_test = stratified_split(
        ds.x_spikes, ds.y_labels, cfg.test_size, cfg.split_seed
    )

    # The calibration reduction (one global spike sum over <=500 samples,
    # extract_lsm_features.py:40-44) runs on the sharded batch; XLA lowers
    # the sum to per-shard partials + an all-reduce. No batch padding here:
    # avg_I divides by the element count, so padded zeros would dilute it —
    # a non-divisible calibration subset just runs single-device (it is one
    # cheap sum).
    calib = x_train[: min(500, len(x_train))]
    calib_mesh = mesh
    if mesh is not None and len(calib) % mesh.shape[meshlib.DATA_AXIS] != 0:
        calib_mesh = None
    wc, mean_weight = calibrate_weight(
        cfg.reservoir, _place_batch(calib, calib_mesh), cfg.multiplier
    )
    log.info("Theoretical w_critico: %.8f", wc)
    log.info("Using weight: %.8f (multiplier: %.2f)", mean_weight, cfg.multiplier)
    if cfg.reservoir.leak_variance_divisor:
        log.info(
            "Using Heterogeneous Leak. Divisor: %s",
            cfg.reservoir.leak_variance_divisor,
        )

    params = _init_reservoir_params(cfg, ds.x_spikes.shape[1], mean_weight)

    report = None
    if run_diagnostics:
        report = run_network_diagnostics(params, x_train)
        log.info("\n%s", report.render())

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    log.info("Extracting feature set: '%s'", cfg.feature_set)

    bs = _effective_batch(cfg.batch_size, mesh)
    if mesh is not None:
        from lsm_tpu.parallel.sharded import extract_features_dp

        params = meshlib.replicate_to_mesh(params, mesh)

    if cfg.check and mesh is None:
        # --check debug mode: the checkify-instrumented XLA scan paths —
        # a NaN/Inf anywhere in the simulation raises a located error.
        from lsm_tpu.utils import checks

        if isinstance(params, res.ReservoirParams):
            _checked_extract = checks.checked(
                lambda p, s: res.extract_features_batch(p, s, keys)
            )
        else:
            from lsm_tpu.models.sparse import simulate_batch_sparse

            def _checked_extract(p, s):
                stats = checks.checked(simulate_batch_sparse)(p, s)
                stats.pop("all_counts", None)
                return res.features_from_stats(stats, keys)

    def extract(split: np.ndarray, desc: str) -> np.ndarray:
        out, n_reals = [], []
        t0 = time.perf_counter()
        for start, stop in _batched(split.shape[0], bs):
            padded, n_real = _pad_batch(split[start:stop], bs)
            if mesh is None:
                if cfg.check:
                    feats = _checked_extract(params, jnp.asarray(padded))
                else:
                    feats = res.extract_features(
                        params, jnp.asarray(padded), keys
                    )
            else:
                feats = extract_features_dp(
                    params, _place_batch(padded, mesh), keys, mesh
                )
            # Keep results on device until the loop ends: host batch prep
            # overlaps device compute (async dispatch), no per-batch sync.
            out.append(feats)
            n_reals.append(n_real)
        # host_local: multi-process meshes shard the DP output across
        # non-addressable devices; one all-gather makes it readable.
        host = [
            np.asarray(meshlib.host_local(f))[:n]
            for f, n in zip(out, n_reals)
        ]
        dt = time.perf_counter() - t0
        log.info("%s: %d samples in %.2fs (%.1f utt/s)",
                 desc, split.shape[0], dt, split.shape[0] / max(dt, 1e-9))
        return np.concatenate(host, axis=0)

    train_feat = extract(x_train, "Training")
    test_feat = extract(x_test, "Testing")
    if cfg.check:
        _check_features_host(train_feat, "extract_lsm_features (train)")
        _check_features_host(test_feat, "extract_lsm_features (test)")

    st = scaler.fit_scaler(jnp.asarray(train_feat))
    train_scaled = np.asarray(scaler.transform(st, jnp.asarray(train_feat)))
    test_scaled = np.asarray(scaler.transform(st, jnp.asarray(test_feat)))

    artifact = artifacts.FeatureArtifact(
        x_train=train_scaled,
        y_train=y_train,
        x_test=test_scaled,
        y_test=y_test,
        feature_set=cfg.feature_set,
        leak_variance_divisor=cfg.reservoir.leak_variance_divisor,
    )
    if output_path is not None:
        artifacts.save_features(output_path, artifact)
    return ExtractionResult(
        artifact=artifact,
        w_critico=wc,
        mean_weight=mean_weight,
        diagnostics=report,
        params=params,
        scaler=st,
    )


# ---------------------------------------------------------------------------
# Stage 3: features -> trained readout + evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    accuracy: float
    report: metrics.ClassificationReport
    params: logistic.LogisticParams
    n_iters: int


def train_and_evaluate(
    cfg: PipelineConfig,
    artifact: artifacts.FeatureArtifact,
    class_names: Optional[Sequence[str]] = None,
    mesh: MeshArg = "auto",
) -> TrainResult:
    """Equivalent of train_classifier.py:7-53 with an on-device LBFGS fit.

    Under a mesh the fit is data-parallel: the example axis shards over
    devices and the loss/gradient reductions become psums (SURVEY 2.4b)."""
    mesh = _resolve_mesh(mesh)
    names = list(class_names or cfg.commands)
    num_classes = len(names)

    if mesh is not None:
        params, iters = logistic.fit_logistic_dp(
            artifact.x_train, artifact.y_train, num_classes=num_classes,
            mesh=mesh, l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter,
            tol=cfg.readout.tol,
        )
        xt, n_real = meshlib.pad_to_multiple(
            np.asarray(artifact.x_test, np.float32),
            mesh.shape[meshlib.DATA_AXIS],
        )
        y_pred = np.asarray(meshlib.host_local(
            logistic.predict(params, meshlib.shard_batch(xt, mesh))
        ))[:n_real]
        rep = metrics.classification_report(artifact.y_test, y_pred, names)
        log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
        return TrainResult(
            accuracy=rep.accuracy, report=rep, params=params, n_iters=int(iters)
        )
    else:
        x_train = jnp.asarray(artifact.x_train, jnp.float32)
        y_train = jnp.asarray(artifact.y_train, jnp.int32)
        x_test = jnp.asarray(artifact.x_test, jnp.float32)
        params, iters = logistic.fit_logistic(
            x_train, y_train, num_classes=num_classes,
            l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter,
            tol=cfg.readout.tol,
        )
    y_pred = np.asarray(logistic.predict(params, x_test))
    rep = metrics.classification_report(artifact.y_test, y_pred, names)
    log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
    return TrainResult(
        accuracy=rep.accuracy, report=rep, params=params, n_iters=int(iters)
    )


# ---------------------------------------------------------------------------
# Batched offline inference at corpus scale (BASELINE.json configs[4])
# ---------------------------------------------------------------------------

def classify_spikes_streaming(
    cfg: PipelineConfig,
    source,
    params: res.ReservoirParams,
    readout: logistic.LogisticParams,
    scaler_state,
    mesh: MeshArg = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Classify an entire (possibly 100k-utterance) spike corpus, streaming.

    `source` is a ShardedSpikeDataset (or any object with
    `iter_batches(batch_size)` yielding SpikeDataset chunks): shards stream
    from disk into fixed-shape device batches — host memory stays constant
    at one batch — each batch shards over the mesh data axis, runs the
    reservoir + readout, and only the int32 predictions return to host.
    Returns (predictions, labels), both (N,) int32 in storage order.

    This is the production shape of BASELINE configs[4]'s "batched offline
    inference ... sharded DP": the reference has no inference
    mode at all (its stage 3 both trains and evaluates).
    """
    mesh = _resolve_mesh(mesh)
    keys = tuple(FEATURE_SETS[cfg.feature_set])
    bs = _effective_batch(cfg.batch_size, mesh)
    if mesh is not None:
        from lsm_tpu.parallel.sharded import extract_features_dp

        params = meshlib.replicate_to_mesh(params, mesh)

    # ONE jitted program per batch (no per-op dispatches), and predictions
    # stay on device until the end so host-side shard decompression of
    # batch k+1 overlaps the device compute of batch k (JAX async
    # dispatch). Single-device batches travel bit-packed (8x less H2D) and
    # unpack inside the jitted program.
    @jax.jit
    def _classify(p, spikes_dev):
        if mesh is None:
            if packed_h2d:           # trace-time constant (set before call 1)
                spikes_dev = _unpack_spike_bits_dev(spikes_dev)
            feats = res.extract_features(p, spikes_dev, keys)
        else:
            feats = extract_features_dp(p, spikes_dev, keys, mesh)
        return logistic.predict(
            readout, scaler.transform(scaler_state, feats)
        )

    preds_dev, n_reals, labels_out = [], [], []
    n_total = 0
    packed_h2d = None
    t0 = time.perf_counter()
    for chunk in source.iter_batches(bs):
        padded, n_real = _pad_batch(chunk.x_spikes, bs)
        if packed_h2d is None:
            packed_h2d = mesh is None and padded.shape[-1] % 8 == 0
        batch = _pack_batch_host(padded) if packed_h2d else padded
        preds_dev.append(_classify(params, _place_batch(batch, mesh)))
        n_reals.append(n_real)
        labels_out.append(chunk.y_labels[:n_real])
        n_total += n_real
        if len(preds_dev) % 8 == 0:
            # Backpressure: bound the async in-flight queue (see
            # extract_and_train_streaming) — without it the host stages
            # every remaining batch's H2D buffer at corpus scale.
            preds_dev[-1].block_until_ready()
    # host_local: the DP predictions are data-axis sharded — on a
    # multi-process mesh np.asarray on non-addressable shards raises.
    preds_out = [
        np.asarray(meshlib.host_local(p))[:n]
        for p, n in zip(preds_dev, n_reals)
    ]
    dt = time.perf_counter() - t0
    log.info("Classified %d utterances in %.2fs (%.1f utt/s)",
             n_total, dt, n_total / max(dt, 1e-9))
    return np.concatenate(preds_out), np.concatenate(labels_out)


# ---------------------------------------------------------------------------
# Constant-memory training at corpus scale (streamed stage 2+3)
# ---------------------------------------------------------------------------

def _iter_masked_batches(source, mask: np.ndarray, batch_size: int):
    """Stream only mask-selected rows of a sharded corpus as fixed-size
    (x, y) batches (last may be short), compacting across shard edges.

    Rows come out in storage order; each shard is loaded once. This is what
    lets the streaming trainer featurize every row exactly once (pass 1
    walks the train rows, pass 2 the test rows) instead of masking mixed
    batches and paying the reservoir simulation twice. Thin (x, y) adapter:
    ShardedSpikeDataset.iter_batches(mask=...) owns the re-chunking."""
    for b in source.iter_batches(batch_size, mask=mask):
        yield b.x_spikes, b.y_labels


@dataclasses.dataclass
class StreamingTrainResult:
    accuracy: float
    report: metrics.ClassificationReport
    readout: logistic.LogisticParams
    scaler: "scaler.ScalerState"
    params: res.ReservoirParams
    w_critico: float
    mean_weight: float
    n_train: int
    n_test: int
    diagnostics: Optional[DiagnosticsReport]


def extract_and_train_streaming(
    cfg: PipelineConfig,
    source,
    class_names: Optional[Sequence[str]] = None,
    alpha: float = 1.0,
    run_diagnostics: bool = True,
    mesh: MeshArg = "auto",
    readout: str = "ridge",
    l2_c: float = 1.0,
    max_iter: int = 1000,
) -> StreamingTrainResult:
    """Fused stage 2+3 over a sharded spike corpus with flat host memory.

    The in-memory path (extract_lsm_features + train_and_evaluate) holds
    both split feature matrices on host and hands the full matrix to the
    LBFGS fit — ~0.8 GB at the 100k-utterance BASELINE configs[4] scale.
    This path never materializes the corpus anywhere: shards stream from
    disk (`source` is a ShardedSpikeDataset or anything with iter_batches/
    labels/gather_rows), pass 1 folds each train batch's reservoir features
    into O(D^2) device-side ridge statistics
    (readout.streaming_fit.RidgeAccumState), and pass 2 streams the test
    rows through the solved readout. Each row is featurized exactly once.

    Semantics vs the in-memory path: identical split (stratified_split on
    indices — train_test_split selects by (y, seed) only), identical
    calibration subset (the first <=500 train rows in split order,
    extract_lsm_features.py:40-44 / here pipeline.extract_lsm_features),
    identical scaler (moments over train rows), and a readout that matches
    fit_ridge on the scaled in-memory matrix to float tolerance
    (tests/test_streaming_fit.py).

    readout="ridge" (default): the closed-form shifted-Gram solve — truly
    O(D^2) state, no corpus residency anywhere. readout="logistic": the
    REFERENCE readout (multinomial LBFGS, train_classifier.py:36-41) at
    corpus scale — the streamed feature rows are written into a
    device-resident (n_train, D) buffer as they are extracted (host RSS
    stays flat; at 100k x 2000-d features the buffer is 0.8 GB of device
    memory, so an 80 GB card holds tens of millions of rows) and the
    exact fit_logistic runs on it — predictions match the in-memory path
    on the same split (tests/test_streaming_fit.py). l2_c/max_iter mirror
    fit_logistic; alpha is the ridge L2.

    Under a mesh, feature batches shard over the data axis and the
    accumulator updates reduce into replicated state via XLA all-reduces
    (the streaming analogue of fit_ridge_dp's psums); the logistic buffer
    shards over the data axis too. Multi-process meshes follow the
    SPMD batch-pipeline contract — every process iterates the same shards
    and issues the same device calls; the buffer writes and the LBFGS fit
    are collective programs over the global buffer, and only each
    process's addressable shard lives in its device memory (pinned against a
    single-process oracle in tests/test_multihost.py)."""
    mesh = _resolve_mesh(mesh)
    if readout not in ("ridge", "logistic"):
        raise ValueError(f"readout must be 'ridge' or 'logistic', got "
                         f"{readout!r}")
    names = list(class_names or cfg.commands)
    k = len(names)
    labels_all = np.asarray(source.labels())
    # one_hot silently zeroes out-of-range labels, which would corrupt the
    # ridge statistics (rows counted in the Gram but absent from X^T Y)
    # instead of failing — so a vocab/corpus mismatch must raise here.
    if labels_all.size and (labels_all.min() < 0 or labels_all.max() >= k):
        raise ValueError(
            f"corpus labels span [{labels_all.min()}, {labels_all.max()}] "
            f"but the class vocabulary has {k} entries ({names[:4]}...) — "
            "the sharded dataset was built with a different --vocab/"
            "--commands than this fit was given"
        )
    n = labels_all.shape[0]
    idx_tr, idx_te, _, _ = stratified_split(
        np.arange(n), labels_all, cfg.test_size, cfg.split_seed
    )
    train_mask = np.zeros(n, bool)
    train_mask[np.asarray(idx_tr)] = True

    calib = source.gather_rows(np.asarray(idx_tr)[: min(500, len(idx_tr))])
    calib_mesh = mesh
    if mesh is not None and len(calib) % mesh.shape[meshlib.DATA_AXIS] != 0:
        calib_mesh = None
    wc, mean_weight = calibrate_weight(
        cfg.reservoir, _place_batch(calib, calib_mesh), cfg.multiplier
    )
    log.info("Theoretical w_critico: %.8f", wc)
    log.info("Using weight: %.8f (multiplier: %.2f)", mean_weight, cfg.multiplier)
    params = _init_reservoir_params(cfg, calib.shape[1], mean_weight)

    report = None
    if run_diagnostics:
        report = run_network_diagnostics(params, calib)
        log.info("\n%s", report.render())

    keys = tuple(FEATURE_SETS[cfg.feature_set])
    bs = _effective_batch(cfg.batch_size, mesh)
    if mesh is not None:
        from lsm_tpu.parallel.sharded import extract_features_dp

        params = meshlib.replicate_to_mesh(params, mesh)

    pack_h2d: Optional[bool] = None

    @jax.jit
    def _extract_jit(p, batch_dev):
        if mesh is None:
            if pack_h2d:             # trace-time constant (set before call 1)
                batch_dev = _unpack_spike_bits_dev(batch_dev)
            return res.extract_features(p, batch_dev, keys)
        return extract_features_dp(p, batch_dev, keys, mesh)

    def extract(padded: np.ndarray) -> jax.Array:
        nonlocal pack_h2d
        if pack_h2d is None:
            pack_h2d = mesh is None and padded.shape[-1] % 8 == 0
        if pack_h2d:
            # 8x smaller H2D: bit-pack on host, unpack inside the jitted
            # program (~26 MB per raw 512-row batch vs ~3.3 MB packed).
            batch = _pack_batch_host(padded)
        else:
            batch = padded
        feats = _extract_jit(params, _place_batch(batch, mesh))
        if cfg.check:
            # --check debug mode: host-side validation per batch (costs a
            # D2H sync; the checkify-instrumented path needs the full
            # matrix and does not apply to the streaming accumulator).
            # host_local: the DP output is data-axis sharded — on a
            # multi-process mesh np.asarray on non-addressable shards
            # raises; one all-gather makes it materializable everywhere.
            _check_features_host(
                np.asarray(meshlib.host_local(feats)),
                "extract_and_train_streaming",
            )
        return feats

    from lsm_tpu.readout.streaming_fit import (
        finalize_ridge, init_ridge_accum, update_ridge_accum,
    )

    # readout="logistic": the streamed feature rows also land in a
    # device-resident (n_slots, D) buffer (dynamic_update_slice with the
    # buffer donated, so it updates in place — no reallocation per batch).
    # Host RSS stays flat; the scaler still comes from the streaming
    # moments (finalize_ridge), exactly as in ridge mode.
    n_slots = -(-len(idx_tr) // bs) * bs
    feat_buf = None
    y_all = np.zeros(n_slots, np.int32)
    w_all = np.zeros(n_slots, np.float32)
    buf_sharding = (
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(meshlib.DATA_AXIS, None)
        )
        if mesh is not None else None
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def _write_rows(buf, rows, off):
        return jax.lax.dynamic_update_slice(
            buf, rows.astype(jnp.float32), (off, 0)
        )

    state = None
    n_train = 0
    n_batches = 0
    # Phase accounting (host shard iteration vs pack+H2D+dispatch vs
    # device sync): the attribution that tells corpus-scale users whether
    # the wall is this host's single core or the device/link, without a
    # profiler run.
    t_iter = t_disp = t_sync = 0.0
    t0 = time.perf_counter()
    it = iter(_iter_masked_batches(source, train_mask, bs))
    while True:
        tp = time.perf_counter()
        nxt = next(it, None)
        t_iter += time.perf_counter() - tp
        if nxt is None:
            break
        xb, yb = nxt
        tp = time.perf_counter()
        padded, n_real = _pad_batch(xb, bs)
        ypad, _ = _pad_batch(np.asarray(yb, np.int32), bs)
        wts = np.zeros(bs, np.float32)
        wts[:n_real] = 1.0
        feats = extract(padded)
        if state is None:
            w_dev = jnp.asarray(wts)
            shift = jnp.sum(
                feats * w_dev[:, None], axis=0
            ) / jnp.sum(w_dev)
            state = init_ridge_accum(shift, k)
        state = update_ridge_accum(
            state, feats, jnp.asarray(ypad), jnp.asarray(wts)
        )
        if readout == "logistic":
            if feat_buf is None:
                d_feat = int(feats.shape[1])
                mk = jax.jit(
                    lambda: jnp.zeros((n_slots, d_feat), jnp.float32),
                    out_shardings=buf_sharding,
                )
                feat_buf = mk()
            off = n_batches * bs
            feat_buf = _write_rows(feat_buf, feats, jnp.int32(off))
            y_all[off:off + bs] = ypad
            w_all[off:off + bs] = wts
        n_train += n_real
        n_batches += 1
        t_disp += time.perf_counter() - tp
        if n_batches % 8 == 0:
            # Backpressure: without a periodic sync, async dispatch lets the
            # host run arbitrarily far ahead of the device,
            # holding EVERY in-flight H2D spike buffer alive — measured
            # multi-GB RSS growth at 100k scale. One sync per 8 batches
            # bounds the queue at ~8 staged batches while still overlapping
            # host shard prep with device compute.
            tp = time.perf_counter()
            state.n.block_until_ready()
            t_sync += time.perf_counter() - tp
    if state is None:
        raise ValueError("streaming fit: no training rows in corpus")
    readout_params, scaler_state = finalize_ridge(state, alpha=alpha)
    dt = time.perf_counter() - t0
    log.info("Streaming %s fit pass: %d train rows in %.2fs (%.1f utt/s); "
             "phases: shard-iter %.1fs, pack+H2D+dispatch %.1fs, "
             "device-sync %.1fs",
             readout, n_train, dt, n_train / max(dt, 1e-9),
             t_iter, t_disp, t_sync)
    if readout == "logistic":
        # The reference readout (train_classifier.py:36-41) on the
        # device-resident buffer: standardize in place (buffer donated)
        # and run the exact LBFGS fit_logistic — the same program the
        # in-memory path uses, so predictions match it on the same split.
        t0 = time.perf_counter()

        @functools.partial(jax.jit, donate_argnums=(0,))
        def _standardize(x, mean, scale_):
            return (x - mean) / scale_

        z = _standardize(feat_buf, scaler_state.mean, scaler_state.scale)
        feat_buf = None
        if mesh is None:
            y_dev = jnp.asarray(y_all)
            w_dev = jnp.asarray(w_all)
        else:
            y_dev = meshlib.shard_host_array(y_all, mesh)
            w_dev = meshlib.shard_host_array(w_all, mesh)
        readout_params, iters = logistic.fit_logistic(
            z, y_dev, k, l2_c=l2_c, max_iter=max_iter, weights=w_dev
        )
        del z
        log.info("Streaming logistic solve: %d LBFGS iters in %.2fs",
                 int(iters), time.perf_counter() - t0)

    preds_dev, n_reals, y_true = [], [], []
    t0 = time.perf_counter()
    for xb, yb in _iter_masked_batches(source, ~train_mask, bs):
        padded, n_real = _pad_batch(xb, bs)
        feats = extract(padded)
        preds_dev.append(
            logistic.predict(
                readout_params, scaler.transform(scaler_state, feats)
            )
        )
        n_reals.append(n_real)
        y_true.append(np.asarray(yb))
        if len(preds_dev) % 8 == 0:      # same backpressure as the fit pass
            preds_dev[-1].block_until_ready()
    # host_local: predict() inherits the data-axis sharding from the DP
    # features — on a multi-process mesh each (bs,) prediction vector
    # spans non-addressable devices until gathered.
    preds = np.concatenate(
        [np.asarray(meshlib.host_local(p))[:nr]
         for p, nr in zip(preds_dev, n_reals)]
    )
    y_test = np.concatenate(y_true)
    dt = time.perf_counter() - t0
    log.info("Streaming eval: %d test rows in %.2fs (%.1f utt/s)",
             len(y_test), dt, len(y_test) / max(dt, 1e-9))
    rep = metrics.classification_report(y_test, preds, names)
    log.info("Test Accuracy: %.2f%%", rep.accuracy * 100)
    return StreamingTrainResult(
        accuracy=rep.accuracy,
        report=rep,
        readout=readout_params,
        scaler=scaler_state,
        params=params,
        w_critico=wc,
        mean_weight=mean_weight,
        n_train=n_train,
        n_test=int(len(y_test)),
        diagnostics=report,
    )


# ---------------------------------------------------------------------------
# Fused end-to-end (no intermediate artifacts)
# ---------------------------------------------------------------------------

def run_pipeline_arrays(
    cfg: PipelineConfig,
    audio: np.ndarray,
    labels: np.ndarray,
    mesh: MeshArg = "auto",
) -> Tuple[TrainResult, ExtractionResult]:
    """Audio arrays in, trained+evaluated readout out — single process."""
    mesh = _resolve_mesh(mesh)
    spikes = featurize_audio_array(cfg, audio, mesh=mesh)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)
    ext = extract_lsm_features(cfg, ds, mesh=mesh)
    result = train_and_evaluate(cfg, ext.artifact, mesh=mesh)
    return result, ext
