"""Sharded execution paths: data-parallel stages and the model-parallel
(neuron-sharded) reservoir for scaled configurations.

Data parallelism: utterance batches shard along the mesh 'data' axis; the
featurizer and reservoir are element-wise in the batch, so XLA partitions
them with zero communication. Global reductions (calibration spike sums,
scaler moments, readout gradients) become psums over the data axis.

Model parallelism (for 10k+ neuron reservoirs, BASELINE.json configs[3]):
the recurrent matrix W (N, N) is sharded column-wise over the 'model' axis —
each shard owns the update of its neuron slice. Per scan step each shard
computes (B_local, N) x (N, N/m) locally and all_gathers the new spike slice
along 'model' so the next step sees the full spike vector. This is the
standard tensor-parallel RNN decomposition: compute scales 1/m per card,
communication is one (B_local, N/m) all-gather per step over the
card-to-card interconnect.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from lsm_tpu.models import reservoir as res
from lsm_tpu.models.reservoir import ReservoirParams, features_from_stats
from lsm_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def data_parallel_extract(
    params: ReservoirParams,
    spikes: jax.Array,
    feature_keys: Tuple[str, ...],
    mesh: Mesh,
) -> jax.Array:
    """Pure-DP feature extraction: shard batch, replicate weights."""
    from lsm_tpu.models.reservoir import extract_features_batch

    spikes = jax.device_put(spikes, NamedSharding(mesh, P(DATA_AXIS)))
    params = jax.device_put(params, NamedSharding(mesh, P()))
    return extract_features_batch(params, spikes, feature_keys)


def featurize_dp(audio: jax.Array, fcfg, mesh: Mesh) -> jax.Array:
    """Data-parallel featurization via shard_map.

    shard_map runs the full single-device featurizer on each device's
    local shard. Zero collectives (per-utterance independent).
    Requires the global batch divisible by the data-axis size.
    """
    from lsm_tpu.models.frontend import featurize_batch

    def local_fn(audio_local):
        return featurize_batch(audio_local, fcfg)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(DATA_AXIS, None),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )
    return fn(audio)


def extract_features_dp(
    params: ReservoirParams,
    spikes: jax.Array,
    feature_keys: Tuple[str, ...],
    mesh: Mesh,
) -> jax.Array:
    """The PRODUCTION data-parallel extractor: shard_map over the data axis.

    Unlike `data_parallel_extract` (which relies on jit auto-partitioning
    of the XLA scan), this routes each device's local shard through the
    representation-dispatching `extract_features` (dense or block-sparse).
    No collectives are needed — the reservoir is independent per
    utterance; weights are replicated. Requires the global batch divisible
    by the data-axis size.
    """
    from lsm_tpu.models.reservoir import extract_features

    if isinstance(params, ReservoirParams):
        arrs = dict(w_rec=params.w_rec, w_in=params.w_in, leak=params.leak)
    else:                                             # block-sparse reservoir
        arrs = dict(
            w_blocks=params.w_blocks,
            src_idx=params.src_idx,
            w_in=params.w_in,
            leak=params.leak,
        )
    names = tuple(arrs)

    def local_fn(spikes_local, *weights):
        p = dataclasses.replace(params, **dict(zip(names, weights)))
        return extract_features(p, spikes_local, feature_keys)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),) + (P(),) * len(names),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    return fn(spikes, *arrs.values())


def _simulate_model_sharded_local(
    w_rec_shard: jax.Array,   # (N, N/m) — columns owned by this shard
    w_in_shard: jax.Array,    # (C, N/m)
    leak_shard: jax.Array,    # (N/m,)
    spikes_in: jax.Array,     # (B_local, C, T)
    threshold: float,
    refractory: int,
    burst_isi_max: int,
    n_rate_windows: int,
    n_outputs: int,
    matmul_dtype=None,
) -> Dict[str, jax.Array]:
    """Per-shard LIF scan.

    The membrane/refractory update covers this shard's neuron slice; the
    per-step all_gather (the TP RNN's one collective) assembles the full
    spike vector for the next step's recurrent matmul — and since every
    shard then HOLDS the full vector, the feature statistics accumulate
    REPLICATED on the gathered output-neuron slice s_full[:, :n_outputs]
    (O(B * n_outputs) per step) instead of per-shard over all local
    neurons (O(B * N/m) — 25x more state at the 10k/400 scale, measured
    ~40% slower end-to-end). Only `counts` also accumulates per-shard over
    local neurons, for the full-reservoir participation diagnostics.

    Returned stats are replicated across the model axis except
    `local_counts` (sharded, (B, N/m)).
    """
    B, C, T = spikes_in.shape
    n_local = w_rec_shard.shape[1]
    no = n_outputs
    n_win = n_rate_windows
    win_len = max(1, T // n_win)

    xs_t = jnp.moveaxis(spikes_in.astype(jnp.float32), -1, 0)
    leak_keep = 1.0 - leak_shard
    mm = matmul_dtype or jnp.float32
    w_rec_mm = w_rec_shard.astype(mm)
    w_in_mm = w_in_shard.astype(mm)

    def step(carry, inp):
        x_t, t = inp
        v, refrac, s_prev_full, st = carry
        # s_prev_full: (B, N) — gathered full spike vector from last step.
        drive = (
            jnp.dot(s_prev_full.astype(mm), w_rec_mm,
                    preferred_element_type=jnp.float32)
            + jnp.dot(x_t.astype(mm), w_in_mm,
                      preferred_element_type=jnp.float32)
        )
        v_new, refrac_new, spike = res.lif_update(
            v, refrac, drive, leak_keep, threshold, refractory
        )
        s_local = spike.astype(jnp.float32)                    # (B, N/m)
        # The one collective per step: assemble the full spike vector.
        s_full = jax.lax.all_gather(s_local, MODEL_AXIS, axis=1, tiled=True)

        so = s_full[:, :no] > 0.0                              # output neurons
        new_st = res.update_output_stats(
            st, so, t, win_len, n_win, burst_isi_max
        )
        new_st["local_counts"] = st["local_counts"] + s_local
        return (v_new, refrac_new, s_full, new_st), None

    z_loc = jnp.zeros((B, n_local), jnp.float32)
    init_stats = res.init_output_stats(B, no, n_win)
    init_stats["local_counts"] = z_loc
    n_full = w_rec_shard.shape[0]
    init = (z_loc, jnp.zeros((B, n_local), jnp.int32),
            jnp.zeros((B, n_full), jnp.float32), init_stats)
    ts = jnp.arange(T, dtype=jnp.int32)
    (_, _, _, st), _ = jax.lax.scan(step, init, (xs_t, ts))
    st = dict(st)
    st.pop("prev_t")
    return st


def extract_features_model_sharded_sparse(
    params,                        # models.sparse.SparseReservoirParams
    spikes: jax.Array,
    feature_keys: Tuple[str, ...],
    mesh: Mesh,
    matmul_dtype=None,
) -> jax.Array:
    """DP x TP BLOCK-SPARSE reservoir extraction (scaled configs).

    Destination blocks shard along 'model': each shard owns nb/m rows of
    (w_blocks, src_idx) and updates its neuron slice; `sparse_drive` reads
    the GATHERED full spike vector, so src_idx's global block indices are
    valid per shard unchanged. Same one all_gather per step as the dense
    TP path, but the per-shard matmul and weight traffic scale with the
    true ~10% density instead of N*N/m.

    matmul_dtype: operand dtype for the block matmuls (None = f32 exact;
    bfloat16 for production — same statistical-contract argument as the
    dense path, models/reservoir.py simulate_batch docstring).
    """
    from lsm_tpu.models.sparse import BLOCK, sparse_drive

    n = params.n_neurons
    no = params.n_outputs
    nb = n // BLOCK
    m = mesh.shape[MODEL_AXIS]
    if nb % m:
        raise ValueError(f"{nb} dst blocks not divisible by model axis {m}")
    c_pad = params.w_in.shape[0]
    if spikes.shape[1] != c_pad:
        spikes = jnp.pad(spikes, ((0, 0), (0, c_pad - spikes.shape[1]), (0, 0)))
    mm = matmul_dtype or jnp.float32

    def local_fn(w_blocks, src_idx, w_in, leak, spikes_local):
        B, C, T = spikes_local.shape
        n_local = w_blocks.shape[0] * BLOCK
        n_win = params.n_rate_windows
        win_len = max(1, T // n_win)
        xs_t = jnp.moveaxis(spikes_local.astype(jnp.float32), -1, 0)
        leak_keep = 1.0 - leak
        wb = w_blocks.astype(mm)
        w_in_mm = w_in.astype(mm)

        def step(carry, inp):
            x_t, t = inp
            v, refrac, s_prev_full, st = carry
            drive = sparse_drive(s_prev_full, wb, src_idx, mm) + jnp.dot(
                x_t.astype(mm), w_in_mm, preferred_element_type=jnp.float32
            )
            v_new, refrac_new, spike = res.lif_update(
                v, refrac, drive, leak_keep, params.threshold, params.refractory
            )
            s_local = spike.astype(jnp.float32)
            s_full = jax.lax.all_gather(s_local, MODEL_AXIS, axis=1, tiled=True)
            so = s_full[:, :no] > 0.0
            new_st = res.update_output_stats(
                st, so, t, win_len, n_win, params.burst_isi_max
            )
            new_st["local_counts"] = st["local_counts"] + s_local
            return (v_new, refrac_new, s_full, new_st), None

        init_stats = res.init_output_stats(B, no, n_win)
        init_stats["local_counts"] = jnp.zeros((B, n_local), jnp.float32)
        init = (
            jnp.zeros((B, n_local), jnp.float32),
            jnp.zeros((B, n_local), jnp.int32),
            jnp.zeros((B, n), jnp.float32),
            init_stats,
        )
        ts = jnp.arange(T, dtype=jnp.int32)
        (_, _, _, st), _ = jax.lax.scan(step, init, (xs_t, ts))
        st = dict(st)
        st.pop("prev_t")
        local_counts = st.pop("local_counts")
        st["all_counts"] = jax.lax.all_gather(
            local_counts, MODEL_AXIS, axis=1, tiled=True
        )[:, :n]
        return features_from_stats(st, feature_keys)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(MODEL_AXIS),           # w_blocks: (nb/m, S, BLOCK, BLOCK)
            P(MODEL_AXIS),           # src_idx:  (nb/m, S)
            P(None, MODEL_AXIS),     # w_in:     (C, N/m)
            P(MODEL_AXIS),           # leak:     (N/m,)
            P(DATA_AXIS, None, None),
        ),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    return fn(params.w_blocks, params.src_idx, params.w_in, params.leak, spikes)


def extract_features_model_sharded(
    params: ReservoirParams,
    spikes: jax.Array,
    feature_keys: Tuple[str, ...],
    mesh: Mesh,
    matmul_dtype=None,
) -> jax.Array:
    """DP x TP reservoir feature extraction under shard_map.

    Batch shards along 'data'; W_rec columns (target neurons) shard along
    'model'. Returns (B, len(keys) * n_outputs) with the batch axis sharded
    along 'data' and features replicated along 'model'.
    """
    n_pad = params.w_rec.shape[0]
    no = params.n_outputs
    c_pad = params.w_in.shape[0]
    if spikes.shape[1] != c_pad:
        spikes = jnp.pad(
            spikes, ((0, 0), (0, c_pad - spikes.shape[1]), (0, 0))
        )

    def local_fn(w_rec, w_in, leak, spikes_local):
        st = _simulate_model_sharded_local(
            w_rec, w_in, leak, spikes_local,
            params.threshold, params.refractory,
            params.burst_isi_max, params.n_rate_windows,
            n_outputs=no, matmul_dtype=matmul_dtype,
        )
        # Output-neuron stats are already replicated across the model axis;
        # only the full-reservoir counts (diagnostics) need re-assembly.
        local_counts = st.pop("local_counts")
        st["all_counts"] = jax.lax.all_gather(
            local_counts, MODEL_AXIS, axis=1, tiled=True
        )[:, : params.n_neurons]
        return features_from_stats(st, feature_keys)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(None, MODEL_AXIS),   # w_rec: (N, N/m)
            P(None, MODEL_AXIS),   # w_in:  (C, N/m)
            P(MODEL_AXIS),         # leak:  (N/m,)
            P(DATA_AXIS, None, None),
        ),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    return fn(params.w_rec, params.w_in, params.leak, spikes)
