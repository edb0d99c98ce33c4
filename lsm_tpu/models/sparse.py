"""Block-sparse reservoir for scaled (4k+ neuron) configurations.

The recurrent matrix of the reference's reservoir is ~90% zeros: a directed
Watts-Strogatz graph has out-degree k/2 = 0.1*N (extract_lsm_features.py:
10-16 constants; SURVEY.md section 2.3 behavioral contract), so the dense
(N, N) formulation used by `models/reservoir.py` pays 10x the FLOPs and —
at 10k neurons, where W is 400 MB of f32 — 10x the device-memory traffic
of the information actually present. This module is the sparse
formulation the BASELINE.json north star asks for ("a lax.scan over a
fused sparse-recurrent-matmul + membrane-update ... kernel").

Design: 128x128 BLOCK sparsity, so every product is a dense matrix-unit
tile.

  - The WS ring band (edges i -> i+1..i+k/2) is already block-banded:
    dst block = src block + d for d in 0..n_band-1.
  - Uniform rewiring, however, sprinkles ~1% density over EVERY off-band
    block, which defeats block sparsity. So for sparse reservoirs the
    rewired edges (fraction small_world_p, exactly as before) land inside
    R random long-range PARTNER blocks of their source block (a fresh
    random permutation of blocks per r, so every block also RECEIVES
    exactly R partner blocks: the structure is uniform, shapes static).
    Out-degree stays exactly k/2 per neuron, weights keep the same
    N(mean_weight, (|mw|*sqrt(weight_variance))^2) distribution, and the
    random R-regular block digraph keeps the small-world short-path
    property (it is an expander). The reservoir contract is statistical
    (SURVEY.md section 2.3); acceptance = diagnostics regime + accuracy,
    like every other inferred reservoir choice (docs/SENSITIVITY.md).

Storage: w_blocks (nb, S, 128, 128) where S = n_band + R and
src_idx (nb, S) names the source block of each slot; per scan step the
drive for dst block j is sum_s s_prev[src_idx[j, s]] @ w_blocks[j, s].
Cost scales with S/nb (~6x fewer FLOPs and bytes at 10k neurons) instead
of N^2.

The flagship 1000-neuron reservoir stays on the dense host-NumPy path
(its draws are frozen by the accuracy-band test); sparse is for the
scaled configs (BASELINE.json configs[3]).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lsm_tpu.config import ReservoirConfig
from lsm_tpu.models import reservoir as res

BLOCK = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseReservoirParams:
    """Block-sparse reservoir instance.

    w_blocks[j, s] is the (BLOCK, BLOCK) weight block from source block
    src_idx[j, s] into destination block j; slots 0..n_band-1 are the ring
    band (distance d behind j), slots n_band.. are the R partner blocks.
    """

    w_blocks: jax.Array     # (nb, S, BLOCK, BLOCK) f32
    src_idx: jax.Array      # (nb, S) int32
    w_in: jax.Array         # (C_pad, N) f32
    leak: jax.Array         # (N,) f32
    n_neurons: int = dataclasses.field(metadata=dict(static=True))
    n_outputs: int = dataclasses.field(metadata=dict(static=True))
    n_channels: int = dataclasses.field(metadata=dict(static=True))
    threshold: float = dataclasses.field(metadata=dict(static=True))
    refractory: int = dataclasses.field(metadata=dict(static=True))
    burst_isi_max: int = dataclasses.field(metadata=dict(static=True))
    n_rate_windows: int = dataclasses.field(metadata=dict(static=True))
    n_band: int = dataclasses.field(metadata=dict(static=True))


def init_reservoir_sparse(
    cfg: ReservoirConfig,
    n_channels: int,
    mean_weight: Optional[float] = None,
) -> SparseReservoirParams:
    """Device-side block-sparse init (jitted; no (N, N) materialization).

    Requires num_neurons % 128 == 0 (pick 10240 rather than 10000 — at
    this scale the neuron count is a capacity knob, not a contract).
    """
    n = cfg.num_neurons
    if n % BLOCK:
        raise ValueError(
            f"block-sparse reservoir needs num_neurons % {BLOCK} == 0, got {n}"
        )
    R = cfg.sparse_partner_blocks
    if R < 1:
        raise ValueError("sparse_partner_blocks must be >= 1")
    nb = n // BLOCK
    half = cfg.small_world_k // 2
    if not 1 <= half < n:
        raise ValueError(f"small_world_k/2 must be in [1, N), got {half}")
    n_band = (BLOCK - 1 + half) // BLOCK + 1
    S = n_band + R
    c_pad = res._round_up(n_channels)
    mw = cfg.mean_weight if mean_weight is None else mean_weight
    std = abs(mw) * float(np.sqrt(cfg.weight_variance))
    fanout = min(cfg.input_fanout, n)
    p = cfg.small_world_p

    @jax.jit
    def build(seed):
        key = jax.random.PRNGKey(seed)
        k_perm, k_rw, k_r, k_off, k_w, k_in, k_leak = jax.random.split(key, 7)

        # R random block permutations: src block a rewires into perm[r, a];
        # block j receives partner slot r from inv_perm[r, j].
        perms = jnp.stack(
            [
                jax.random.permutation(k, nb)
                for k in jax.random.split(k_perm, R)
            ]
        ).astype(jnp.int32)                                   # (R, nb)
        inv_perms = jnp.argsort(perms, axis=1).astype(jnp.int32)

        # Per-edge arrays, shape (half, n): row = ring offset-1, col = src.
        src = jnp.arange(n, dtype=jnp.int32)[None, :]
        off = jnp.arange(1, half + 1, dtype=jnp.int32)[:, None]
        src_blk = src // BLOCK

        ring_dst = (src + off) % n
        rewire = jax.random.uniform(k_rw, (half, n)) < p
        r_choice = jax.random.randint(k_r, (half, n), 0, R, jnp.int32)
        part_blk = perms[r_choice, jnp.broadcast_to(src_blk, (half, n))]
        dst_off = jax.random.randint(k_off, (half, n), 0, BLOCK, jnp.int32)
        # Self-loop from rewiring: bump within the block (cannot re-collide).
        dst_off = jnp.where(
            part_blk * BLOCK + dst_off == src, (dst_off + 1) % BLOCK, dst_off
        )
        dst = jnp.where(rewire, part_blk * BLOCK + dst_off, ring_dst)

        dst_blk = dst // BLOCK
        slot = jnp.where(rewire, n_band + r_choice, (dst_blk - src_blk) % nb)

        flat = (
            (dst_blk * S + slot) * (BLOCK * BLOCK)
            + (src % BLOCK) * BLOCK
            + dst % BLOCK
        )
        wvals = jax.random.normal(k_w, (half, n), jnp.float32) * std + mw
        # Duplicate (src, dst) edges WITHIN a slot collapse to one value
        # (scatter-set), matching the dense generator's boolean-adjacency
        # semantics. Across slots they do not: a rewired edge that lands on
        # a (src, dst) pair also occupied by a ring-band edge (or by a
        # rewired edge in a different partner slot) occupies a different
        # slot and the two draws SUM in the simulation (densify() sums the
        # same way, so the densify() bit-equality oracle is consistent).
        # Consequence: a few edges carry ~2x-distributed weights and
        # per-neuron out-degree is exactly k/2 up to these rare collisions
        # (P ~ p*k/2N per edge) — a tiny statistical-contract deviation the
        # regime/accuracy oracles police, not a correctness bug.
        w_blocks = (
            jnp.zeros((nb * S * BLOCK * BLOCK,), jnp.float32)
            .at[flat.reshape(-1)]
            .set(wvals.reshape(-1))
            .reshape(nb, S, BLOCK, BLOCK)
        )

        j = jnp.arange(nb, dtype=jnp.int32)
        band_src = (j[:, None] - jnp.arange(n_band, dtype=jnp.int32)[None, :]) % nb
        src_idx = jnp.concatenate([band_src, inv_perms.T], axis=1)  # (nb, S)

        # Input projection + leak: the SAME shared helpers as the dense
        # device init (fresh keys) — the calibrated input statistics must
        # not fork between representations.
        w_in = res.device_input_projection(
            k_in, n_channels, n, c_pad, n, fanout, cfg.input_weight
        )
        leak = res.device_leak_draw(k_leak, cfg, n, n)
        return w_blocks, src_idx, w_in, leak

    w_blocks, src_idx, w_in, leak = build(cfg.seed)
    return SparseReservoirParams(
        w_blocks=w_blocks,
        src_idx=src_idx,
        w_in=w_in,
        leak=leak,
        n_neurons=n,
        n_outputs=cfg.num_output_neurons,
        n_channels=n_channels,
        threshold=cfg.membrane_threshold,
        refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max,
        n_rate_windows=cfg.n_rate_windows,
        n_band=n_band,
    )


def densify(params: SparseReservoirParams) -> res.ReservoirParams:
    """Expand to a dense ReservoirParams (oracle/debug path; host-side).

    Slots may reference the same (src, dst) block pair more than once
    (a partner permutation can coincide with a band block); the simulation
    SUMS slot contributions, so densification sums too.
    """
    wb = np.asarray(params.w_blocks)
    src_idx = np.asarray(params.src_idx)
    nb, S = src_idx.shape
    n = nb * BLOCK
    w = np.zeros((n, n), np.float32)
    for jblk in range(nb):
        for s in range(S):
            a = int(src_idx[jblk, s])
            w[a * BLOCK : (a + 1) * BLOCK, jblk * BLOCK : (jblk + 1) * BLOCK] += wb[
                jblk, s
            ]
    return res.ReservoirParams(
        w_rec=jnp.asarray(w),
        w_in=params.w_in,
        leak=params.leak,
        n_neurons=params.n_neurons,
        n_outputs=params.n_outputs,
        n_channels=params.n_channels,
        threshold=params.threshold,
        refractory=params.refractory,
        burst_isi_max=params.burst_isi_max,
        n_rate_windows=params.n_rate_windows,
    )


def sparse_drive(
    s_prev: jnp.ndarray,          # (B, N)
    w_blocks: jnp.ndarray,        # (nb, S, BLOCK, BLOCK), already in matmul dtype
    src_idx: jnp.ndarray,         # (nb, S)
    matmul_dtype: jnp.dtype,
) -> jnp.ndarray:
    """Block-sparse recurrent drive: one batched (gathered) matmul.

    For each dst block j: drive_j = sum_s s_prev[:, src_idx[j,s]] @ W[j,s],
    expressed as a single dot_general with batch dimension j so XLA emits
    one fused gather + batched matmul instead of nb*S small ones.
    """
    B = s_prev.shape[0]
    nb, S = src_idx.shape      # nb = DESTINATION blocks (local under TP)
    # Source blocks come from s_prev's own width: under tensor parallelism
    # s_prev is the gathered FULL spike vector while src_idx/w_blocks hold
    # only this shard's destination rows.
    sb = s_prev.reshape(B, -1, BLOCK).astype(matmul_dtype)
    g = jnp.take(sb, src_idx.reshape(-1), axis=1)         # (B, nb*S, BLOCK)
    g = g.reshape(B, nb, S * BLOCK)
    w = w_blocks.reshape(nb, S * BLOCK, BLOCK)
    out = jax.lax.dot_general(
        g,
        w,
        dimension_numbers=(((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.float32,
    )                                                     # (nb, B, BLOCK)
    return out.transpose(1, 0, 2).reshape(B, nb * BLOCK)


def simulate_batch_sparse(
    params: SparseReservoirParams,
    spikes_in: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
    matmul_dtype: Optional[jnp.dtype] = jnp.bfloat16,
) -> Dict[str, jnp.ndarray]:
    """Block-sparse twin of reservoir.simulate_batch (same stats contract)."""
    B, C, T = spikes_in.shape
    n = params.n_neurons
    no = params.n_outputs
    n_win = params.n_rate_windows
    win_len = max(1, T // n_win)

    x = spikes_in.astype(compute_dtype)
    if C != params.w_in.shape[0]:
        x = jnp.pad(x, ((0, 0), (0, params.w_in.shape[0] - C), (0, 0)))
    xs_t = jnp.moveaxis(x, -1, 0)

    mm = matmul_dtype or compute_dtype
    w_blocks = params.w_blocks.astype(mm)
    w_in = params.w_in.astype(mm)
    leak_keep = (1.0 - params.leak).astype(compute_dtype)

    def step(carry, inp):
        x_t, t = inp
        v, refrac, s_prev, st = carry
        drive = (
            sparse_drive(s_prev, w_blocks, params.src_idx, mm)
            + jnp.dot(x_t.astype(mm), w_in, preferred_element_type=jnp.float32)
        ).astype(compute_dtype)

        v_new, refrac_new, spike = res.lif_update(
            v, refrac, drive, leak_keep, params.threshold, params.refractory
        )
        so = spike[:, :no]
        new_st = res.update_output_stats(
            st, so, t, win_len, n_win, params.burst_isi_max
        )
        new_st["all_counts"] = st["all_counts"] + spike.astype(jnp.float32)
        return (v_new, refrac_new, spike.astype(compute_dtype), new_st), None

    init_stats = res.init_output_stats(B, no, n_win)
    init_stats["all_counts"] = jnp.zeros((B, n), jnp.float32)
    init = (
        jnp.zeros((B, n), compute_dtype),
        jnp.zeros((B, n), jnp.int32),
        jnp.zeros((B, n), compute_dtype),
        init_stats,
    )
    ts = jnp.arange(T, dtype=jnp.int32)
    (_, _, _, st), _ = jax.lax.scan(step, init, (xs_t, ts), unroll=4)
    st = dict(st)
    st.pop("prev_t")
    return st


@functools.partial(
    jax.jit, static_argnames=("feature_keys", "compute_dtype", "matmul_dtype")
)
def extract_features_sparse(
    params: SparseReservoirParams,
    spikes_in: jnp.ndarray,
    feature_keys: Tuple[str, ...],
    compute_dtype: jnp.dtype = jnp.float32,
    matmul_dtype: Optional[jnp.dtype] = jnp.bfloat16,
) -> jnp.ndarray:
    """spikes (B, C, T) -> features (B, len(keys) * n_outputs) through the
    XLA gather+einsum scan (simulate_batch_sparse)."""
    stats = simulate_batch_sparse(params, spikes_in, compute_dtype, matmul_dtype)
    return res.features_from_stats(stats, feature_keys)
