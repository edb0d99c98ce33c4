"""The LSM core: batched LIF reservoir simulation.

Replaces the reference's external `snnpy.snn.SNN` simulator (driven at
extract_lsm_features.py:76-89). The reference's per-sample Python loop
(reset / set_input_spike_times / simulate / extract_features_from_spikes)
becomes ONE jitted `lax.scan` over the 400 timesteps of a batched update:

    v_t = (1 - leak) * v_{t-1} + s_{t-1} @ W_rec + x_t @ W_in
    s_t = (v_t >= threshold) & not_refractory
    reset + refractory clamp

vmapped-by-construction over the utterance batch (the recurrent update is a
(B, N) x (N, N) matmul -> tensor-core work), and sharded data-parallel over the mesh.
Feature statistics (spike counts, spike-time moments, first/last spike, ISI
moments, bursts, windowed-rate variance) are accumulated STREAMING inside the
scan carry, so the (B, T, N) spike raster never materializes in device memory
(SURVEY.md section 7.3).

Behavioral contract vs. snnpy is statistical, not bitwise (SURVEY.md
section 2.3): topology is a Watts-Strogatz small-world graph (k=200, p=0.1
at reference defaults, extract_lsm_features.py:171-172), recurrent weights
~ Normal(mean_weight, (|mean_weight| * sqrt(weight_variance))^2), acceptance
is the diagnostics regime (edge of chaos) plus the end-to-end accuracy band.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lsm_tpu.config import ReservoirConfig

_ROUND = 128  # neuron-block alignment (the block-sparse topology's block size)


def _round_up(x: int, m: int = _ROUND) -> int:
    return -(-x // m) * m


def watts_strogatz_adjacency(n: int, k: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """DIRECTED Watts-Strogatz small-world adjacency (n, n) bool,
    adj[src, dst]; out-degree (and expected in-degree) = k/2.

    Ring of n nodes, each projecting to its k/2 clockwise neighbors, each
    edge rewired to a random target with probability p. The k/2 degree
    (not k) is what makes the reference's mean-field criticality formula
    consistent: `beta = small_world_graph_k / 2` is the branching fan-in in
    w_critico = (threshold - input_term) / beta
    (extract_lsm_features.py:50-57) — at mean_weight = w_critico the
    branching ratio beta * w / threshold is exactly 1. A symmetric degree-k
    graph doubles the fan-in and drives the network super-critical at every
    multiplier, contradicting the reference's observed regimes [inferred +
    validated empirically via tools/calibrate.py].
    """
    adj = np.zeros((n, n), dtype=bool)
    half = k // 2
    nodes = np.arange(n)
    for j in range(1, half + 1):
        targets = (nodes + j) % n
        rewire = rng.random(n) < p
        new_targets = rng.integers(0, n, size=n)
        targets = np.where(rewire, new_targets, targets)
        # Avoid self-loops from rewiring; redraw deterministically by offset.
        self_loop = targets == nodes
        targets = np.where(self_loop, (nodes + j + half) % n, targets)
        adj[nodes, targets] = True
    np.fill_diagonal(adj, False)
    return adj


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReservoirParams:
    """Device arrays for one reservoir instance (padded to lane multiples)."""

    w_rec: jax.Array        # (N_pad, N_pad) f32; row=source, col=target
    w_in: jax.Array         # (C_pad, N_pad) f32
    leak: jax.Array         # (N_pad,) f32
    # Static metadata
    n_neurons: int = dataclasses.field(metadata=dict(static=True))
    n_outputs: int = dataclasses.field(metadata=dict(static=True))
    n_channels: int = dataclasses.field(metadata=dict(static=True))
    threshold: float = dataclasses.field(metadata=dict(static=True))
    refractory: int = dataclasses.field(metadata=dict(static=True))
    burst_isi_max: int = dataclasses.field(metadata=dict(static=True))
    n_rate_windows: int = dataclasses.field(metadata=dict(static=True))


# Above this many neurons, init_reservoir draws weights ON DEVICE: the
# host path's (N, N) float draws + host-to-device transfer dominate
# startup at scale (a 10k reservoir's W is 400 MB of f32).
_DEVICE_INIT_THRESHOLD = 4096


def init_reservoir(
    cfg: ReservoirConfig,
    n_channels: int,
    mean_weight: Optional[float] = None,
    device_init: Optional[bool] = None,
) -> ReservoirParams:
    """Build topology + weights (deterministic in cfg.seed).

    Small reservoirs draw host-side with NumPy (the draws behind the
    calibrated defaults and the frozen accuracy band); large ones draw on
    device with jax.random (same distribution/topology contract, different
    RNG stream — the reservoir contract is statistical, SURVEY.md 2.3).
    `device_init` forces one path.
    """
    if device_init is None:
        device_init = cfg.num_neurons >= _DEVICE_INIT_THRESHOLD
    if device_init:
        return _init_reservoir_device(cfg, n_channels, mean_weight)
    rng = np.random.default_rng(cfg.seed)
    n, n_pad = cfg.num_neurons, _round_up(cfg.num_neurons)
    c_pad = _round_up(n_channels)
    mw = cfg.mean_weight if mean_weight is None else mean_weight

    adj = watts_strogatz_adjacency(n, cfg.small_world_k, cfg.small_world_p, rng)
    std = abs(mw) * np.sqrt(cfg.weight_variance)
    # float32 draws: at 10k neurons this is a 100M-element matrix and the
    # float64 path doubles both time and peak host memory for no benefit
    # (weights are consumed as f32/bf16 on device).
    weights = rng.standard_normal((n, n), dtype=np.float32) * np.float32(std)
    weights += np.float32(mw)
    weights *= adj
    w_rec = np.zeros((n_pad, n_pad), dtype=np.float32)
    w_rec[:n, :n] = weights

    # Input projection [inferred; see config.ReservoirConfig docstring]:
    # each channel -> `input_fanout` random neurons at `input_weight`.
    w_in = np.zeros((c_pad, n_pad), dtype=np.float32)
    fanout = min(cfg.input_fanout, n)
    for c in range(n_channels):
        targets = rng.choice(n, size=fanout, replace=False)
        w_in[c, targets] += cfg.input_weight

    if cfg.leak_variance_divisor:
        leak_n = rng.normal(
            cfg.leak_coefficient,
            cfg.leak_coefficient / cfg.leak_variance_divisor,
            size=n,
        ).clip(0.0, 1.0)
    else:
        leak_n = np.full(n, cfg.leak_coefficient)
    leak = np.zeros(n_pad, dtype=np.float32)
    leak[:n] = leak_n

    return ReservoirParams(
        w_rec=jnp.asarray(w_rec),
        w_in=jnp.asarray(w_in),
        leak=jnp.asarray(leak),
        n_neurons=n,
        n_outputs=cfg.num_output_neurons,
        n_channels=n_channels,
        threshold=cfg.membrane_threshold,
        refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max,
        n_rate_windows=cfg.n_rate_windows,
    )


def device_input_projection(
    key: jax.Array,
    n_channels: int,
    n: int,
    c_pad: int,
    width: int,
    fanout: int,
    weight: float,
) -> jnp.ndarray:
    """Device-side input projection: `fanout` distinct target neurons per
    channel at `weight`, drawn as the top of a per-channel random
    permutation (exactly rng.choice(n, fanout, replace=False) semantics).
    Shared by the dense and block-sparse device inits so the calibrated
    input statistics cannot fork between representations."""
    scores = jax.random.uniform(key, (n_channels, n))
    _, proj = jax.lax.top_k(scores, fanout)                  # (C, fanout)
    w_in = jnp.zeros((c_pad, width), jnp.float32)
    ch = jnp.broadcast_to(
        jnp.arange(n_channels, dtype=jnp.int32)[:, None], proj.shape
    )
    return w_in.at[ch.reshape(-1), proj.reshape(-1)].add(weight)


def device_leak_draw(
    key: jax.Array, cfg: ReservoirConfig, n: int, width: int
) -> jnp.ndarray:
    """Device-side per-neuron leak (optionally heterogeneous,
    extract_lsm_features.py:174,183 semantics), padded to `width`."""
    if cfg.leak_variance_divisor:
        leak_n = jnp.clip(
            cfg.leak_coefficient
            + jax.random.normal(key, (n,))
            * (cfg.leak_coefficient / cfg.leak_variance_divisor),
            0.0, 1.0,
        ).astype(jnp.float32)
    else:
        leak_n = jnp.full((n,), cfg.leak_coefficient, jnp.float32)
    return jnp.zeros((width,), jnp.float32).at[:n].set(leak_n)


def _init_reservoir_device(
    cfg: ReservoirConfig, n_channels: int, mean_weight: Optional[float]
) -> ReservoirParams:
    """Device-side reservoir init: directed-WS topology + weight draws as
    one jitted program — no (N, N) host materialization, no H2D."""
    n, n_pad = cfg.num_neurons, _round_up(cfg.num_neurons)
    c_pad = _round_up(n_channels)
    mw = cfg.mean_weight if mean_weight is None else mean_weight
    half = cfg.small_world_k // 2
    fanout = min(cfg.input_fanout, n)
    std = abs(mw) * float(np.sqrt(cfg.weight_variance))

    @functools.partial(jax.jit, static_argnames=())
    def build(seed):
        key = jax.random.PRNGKey(seed)
        k_w, k_rw, k_tgt, k_in, k_leak = jax.random.split(key, 5)

        rows = jnp.arange(n, dtype=jnp.int32)
        offsets = jnp.arange(1, half + 1, dtype=jnp.int32)
        ring = (rows[None, :] + offsets[:, None]) % n            # (half, n)
        rewire = jax.random.uniform(k_rw, (half, n)) < cfg.small_world_p
        new_t = jax.random.randint(k_tgt, (half, n), 0, n, jnp.int32)
        targets = jnp.where(rewire, new_t, ring)
        # Self-loops from rewiring: deterministic redraw by offset (same
        # rule as the host path).
        self_loop = targets == rows[None, :]
        targets = jnp.where(
            self_loop, (rows[None, :] + offsets[:, None] + half) % n, targets
        )

        mask = jnp.zeros((n_pad, n_pad), jnp.bool_)
        src = jnp.broadcast_to(rows[None, :], (half, n)).reshape(-1)
        mask = mask.at[src, targets.reshape(-1)].set(True)
        mask = mask.at[rows, rows].set(False)                    # no self-loops

        w = jax.random.normal(k_w, (n_pad, n_pad), jnp.float32) * std + mw
        w_rec = jnp.where(mask, w, 0.0)

        w_in = device_input_projection(
            k_in, n_channels, n, c_pad, n_pad, fanout, cfg.input_weight
        )
        leak = device_leak_draw(k_leak, cfg, n, n_pad)
        return w_rec, w_in, leak

    w_rec, w_in, leak = build(cfg.seed)
    return ReservoirParams(
        w_rec=w_rec,
        w_in=w_in,
        leak=leak,
        n_neurons=n,
        n_outputs=cfg.num_output_neurons,
        n_channels=n_channels,
        threshold=cfg.membrane_threshold,
        refractory=cfg.refractory_period,
        burst_isi_max=cfg.burst_isi_max,
        n_rate_windows=cfg.n_rate_windows,
    )


def init_output_stats(B: int, no: int, n_win: int) -> Dict[str, jnp.ndarray]:
    """Zero-state for the streaming output-neuron statistics carry.

    Shared by every simulation path (dense scan, block-sparse scan, the
    tensor-parallel shard_map scan) so the statistics semantics cannot
    drift between them. `all_counts` / `local_counts` (full-reservoir
    participation counts) are path-specific and owned by the caller.
    """
    z = jnp.zeros((B, no), jnp.float32)
    return dict(
        counts=z,
        sum_t=z,
        sum_t2=z,
        first=jnp.full((B, no), jnp.inf, jnp.float32),
        last=jnp.full((B, no), -1.0, jnp.float32),
        n_isi=z,
        sum_isi=z,
        sum_isi2=z,
        bursts=z,
        prev_t=jnp.full((B, no), -1.0, jnp.float32),
        win_counts=jnp.zeros((B, no, n_win), jnp.float32),
    )


def update_output_stats(
    st: Dict[str, jnp.ndarray],
    so: jnp.ndarray,          # (B, no) bool — output-neuron spikes this step
    t: jnp.ndarray,           # scalar int32 timestep
    win_len: int,
    n_win: int,
    burst_isi_max: int,
) -> Dict[str, jnp.ndarray]:
    """One streaming-stats update (the snnpy `extract_features_from_spikes`
    statistics recast as scan-carried accumulators; SURVEY.md section 7.3)."""
    sof = so.astype(jnp.float32)
    tf = t.astype(jnp.float32)

    prev_t = st["prev_t"]
    has_prev = prev_t >= 0.0
    isi = tf - prev_t
    isi_event = jnp.logical_and(so, has_prev)
    isi_f = jnp.where(isi_event, isi, 0.0)

    wi = t // win_len
    win_onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_win), 2)
        == jnp.minimum(wi, n_win - 1)
    ).astype(jnp.float32)

    return dict(
        counts=st["counts"] + sof,
        sum_t=st["sum_t"] + sof * tf,
        sum_t2=st["sum_t2"] + sof * tf * tf,
        first=jnp.minimum(st["first"], jnp.where(so, tf, jnp.inf)),
        last=jnp.maximum(st["last"], jnp.where(so, tf, -1.0)),
        n_isi=st["n_isi"] + isi_event.astype(jnp.float32),
        sum_isi=st["sum_isi"] + isi_f,
        sum_isi2=st["sum_isi2"] + isi_f * isi_f,
        bursts=st["bursts"]
        + jnp.logical_and(isi_event, isi <= burst_isi_max).astype(jnp.float32),
        prev_t=jnp.where(so, tf, prev_t),
        win_counts=st["win_counts"] + sof[:, :, None] * win_onehot,
    )


def stats_from_raster(
    raster: jnp.ndarray,          # (B, T, no) bool — output-neuron spikes
    n_win: int,
    burst_isi_max: int,
) -> Dict[str, jnp.ndarray]:
    """Window statistics straight from a spike raster, fully VECTORIZED.

    Produces EXACTLY the accumulator dict a T-step loop of
    update_output_stats over the raster would (bit-equal,
    tests/test_continuous.py) — but with no sequential scan: the only
    order-dependent quantity, each spike's previous-spike time, is an
    associative cummax of (t if spike else -1) shifted by one step; every
    other statistic is a weighted reduction over T. Used two ways: as
    segment_summary's engine over one SHORT chunk (T = ~40) on the
    continuous mode's chunk path, and as the exactness oracle for the fold
    (fold_segment_stats). It is
    deliberately NOT applied to a full trailing window per hop — that
    O(B*T_win*no) memory-bound pass measured slower than the exact mode it
    was meant to beat (models/continuous.py module docstring).
    """
    B, T, no = raster.shape
    sof = raster.astype(jnp.float32)                     # (B, T, no)
    tf = jnp.arange(T, dtype=jnp.float32)[None, :, None]

    counts = jnp.sum(sof, axis=1)
    sum_t = jnp.sum(sof * tf, axis=1)
    sum_t2 = jnp.sum(sof * tf * tf, axis=1)
    first = jnp.min(jnp.where(raster, tf, jnp.inf), axis=1)
    last = jnp.max(jnp.where(raster, tf, -1.0), axis=1)

    # prev_t[t] = time of the latest spike strictly before t (-1 if none):
    # inclusive cummax of (t if spike else -1), shifted right by one.
    m = jax.lax.cummax(jnp.where(raster, tf, -1.0), axis=1)
    prev_t = jnp.concatenate(
        [jnp.full((B, 1, no), -1.0), m[:, :-1, :]], axis=1
    )
    isi_event = jnp.logical_and(raster, prev_t >= 0.0)
    isi = jnp.where(isi_event, tf - prev_t, 0.0)
    n_isi = jnp.sum(isi_event.astype(jnp.float32), axis=1)
    sum_isi = jnp.sum(isi, axis=1)
    sum_isi2 = jnp.sum(isi * isi, axis=1)
    bursts = jnp.sum(
        jnp.logical_and(isi_event, isi <= burst_isi_max).astype(jnp.float32),
        axis=1,
    )

    # Windowed-rate counts with update_output_stats' exact clamping:
    # window index = min(t // win_len, n_win - 1).
    win_len = max(1, T // n_win)
    wi = np.minimum(np.arange(T) // win_len, n_win - 1)
    onehot = jnp.asarray(
        (wi[:, None] == np.arange(n_win)[None, :]).astype(np.float32)
    )                                                    # (T, n_win)
    win_counts = jnp.einsum(
        "btn,tw->bnw", sof, onehot, preferred_element_type=jnp.float32
    )

    return dict(
        counts=counts, sum_t=sum_t, sum_t2=sum_t2, first=first, last=last,
        n_isi=n_isi, sum_isi=sum_isi, sum_isi2=sum_isi2, bursts=bursts,
        win_counts=win_counts,
    )


def segment_summary(
    raster: jnp.ndarray,          # (B, T_c, no) bool — one segment's spikes
    burst_isi_max: int,
) -> Dict[str, jnp.ndarray]:
    """Per-segment statistics with SEGMENT-RELATIVE times — the monoid
    element of the sliding-window stats (see fold_segment_stats).

    Identical fields to stats_from_raster minus win_counts (rate windows
    are tracked in their own ring by the continuous-mode caller); ISI
    fields cover spike pairs INTERNAL to the segment only — cross-segment
    pairs are reconstructed exactly by the fold from (first, last,
    counts)."""
    st = stats_from_raster(raster, n_win=1, burst_isi_max=burst_isi_max)
    st.pop("win_counts")
    return st


def fold_segment_stats(
    segs: Dict[str, jnp.ndarray],  # each (n_ring, B, no); ring[0] = oldest
    seg_len: int,
    burst_isi_max: int,
) -> Dict[str, jnp.ndarray]:
    """Combine consecutive segment summaries into whole-window statistics
    (times relative to the window start = segment 0's start).

    Segment stats are associative under concatenation: sums shift by the
    segment offset (sum_t += offset*counts; sum_t2 += 2*offset*sum_t_rel +
    offset^2*counts — exact in f32 for offsets < 2^11 and t < 2^12);
    first/last are offset min/max; and the ISI chain crosses a segment
    boundary exactly once per non-empty segment — from the previous
    non-empty segment's last spike to this segment's first — so a single
    carried last-spike time reconstructs every cross-segment interval,
    including over empty segments. Matches stats_from_raster on the
    concatenated raster (bit-equal for the integer-valued fields,
    float-order tolerance on sum_t2/sum_isi2; tests/test_continuous.py).
    """
    n_ring = segs["counts"].shape[0]
    counts = jnp.sum(segs["counts"], axis=0)
    sum_t = counts * 0.0
    sum_t2 = counts * 0.0
    first = jnp.full_like(counts, jnp.inf)
    last = jnp.full_like(counts, -1.0)
    n_isi = jnp.sum(segs["n_isi"], axis=0)
    sum_isi = jnp.sum(segs["sum_isi"], axis=0)
    sum_isi2 = jnp.sum(segs["sum_isi2"], axis=0)
    bursts = jnp.sum(segs["bursts"], axis=0)

    carry_last = jnp.full_like(counts, -1.0)
    for k in range(n_ring):
        off = float(k * seg_len)
        ck = segs["counts"][k]
        has = ck > 0
        fk = segs["first"][k] + off            # inf stays inf when silent
        lk = segs["last"][k]
        sum_t = sum_t + segs["sum_t"][k] + off * ck
        sum_t2 = sum_t2 + segs["sum_t2"][k] + 2.0 * off * segs["sum_t"][k] \
            + off * off * ck
        first = jnp.minimum(first, jnp.where(has, fk, jnp.inf))
        last = jnp.maximum(last, jnp.where(has, lk + off, -1.0))
        # The one boundary-crossing interval ending in this segment.
        cross = jnp.logical_and(has, carry_last >= 0.0)
        isi = jnp.where(cross, fk - carry_last, 0.0)
        n_isi = n_isi + cross.astype(jnp.float32)
        sum_isi = sum_isi + isi
        sum_isi2 = sum_isi2 + isi * isi
        bursts = bursts + jnp.logical_and(
            cross, isi <= burst_isi_max
        ).astype(jnp.float32)
        carry_last = jnp.where(has, lk + off, carry_last)

    return dict(
        counts=counts, sum_t=sum_t, sum_t2=sum_t2, first=first, last=last,
        n_isi=n_isi, sum_isi=sum_isi, sum_isi2=sum_isi2, bursts=bursts,
    )


def lif_update(
    v: jnp.ndarray,
    refrac: jnp.ndarray,
    drive: jnp.ndarray,
    leak_keep: jnp.ndarray,
    threshold: float,
    refractory: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One LIF membrane step: leak + integrate, threshold, reset, refractory.
    Returns (v_new, refrac_new, spike_bool)."""
    active = refrac == 0
    v_new = jnp.where(active, v * leak_keep + drive, 0.0)
    spike = jnp.logical_and(v_new >= threshold, active)
    v_new = jnp.where(spike, 0.0, v_new)
    refrac_new = jnp.where(spike, refractory, jnp.maximum(refrac - 1, 0))
    return v_new, refrac_new, spike


def simulate_batch(
    params: ReservoirParams,
    spikes_in: jnp.ndarray,
    compute_dtype: jnp.dtype = jnp.float32,
    matmul_dtype: Optional[jnp.dtype] = jnp.bfloat16,
) -> Dict[str, jnp.ndarray]:
    """Run the reservoir over a spike-train batch with streaming statistics.

    Args:
      params: reservoir parameters.
      spikes_in: (B, C, T) uint8/bool input spike trains.
      compute_dtype: dtype of the membrane state (keep float32).
      matmul_dtype: operand dtype for the recurrent/input matmuls, with
        float32 accumulation. bfloat16 (default) runs the tensor cores at
        the full bf16 rate:
        spike vectors are exactly representable (0/1) and a 0.4% relative
        rounding of the random weights is statistically irrelevant to a
        random reservoir — validated by the regime diagnostics and
        end-to-end accuracy (tests/test_pipeline.py). Pass None/float32 for
        exact f32 (the NumPy-oracle tests use this).
    Returns:
      dict of raw accumulators, each (B, n_outputs) float32 unless noted:
        counts, sum_t, sum_t2, first (inf if silent), last (-1 if silent),
        n_isi, sum_isi, sum_isi2, bursts, win_counts (B, n_outputs, n_win),
        all_counts (B, n_neurons) — full-reservoir counts for diagnostics.
    """
    B, C, T = spikes_in.shape
    n_pad = params.w_rec.shape[0]
    no = params.n_outputs
    n_win = params.n_rate_windows
    win_len = max(1, T // n_win)

    x = spikes_in.astype(compute_dtype)
    if C != params.w_in.shape[0]:
        x = jnp.pad(x, ((0, 0), (0, params.w_in.shape[0] - C), (0, 0)))
    # Precompute nothing big: scan consumes (T, B, C_pad).
    xs_t = jnp.moveaxis(x, -1, 0)

    mm = matmul_dtype or compute_dtype
    w_rec = params.w_rec.astype(mm)
    w_in = params.w_in.astype(mm)
    leak_keep = (1.0 - params.leak).astype(compute_dtype)
    thr = params.threshold

    def step(carry, inp):
        x_t, t = inp
        v, refrac, s_prev, st = carry

        drive = (
            jnp.dot(s_prev.astype(mm), w_rec, preferred_element_type=jnp.float32)
            + jnp.dot(x_t.astype(mm), w_in, preferred_element_type=jnp.float32)
        ).astype(compute_dtype)

        v_new, refrac_new, spike = lif_update(
            v, refrac, drive, leak_keep, thr, params.refractory
        )
        s = spike.astype(compute_dtype)
        so = spike[:, :no]                                   # output-neuron spikes

        new_st = update_output_stats(
            st, so, t, win_len, n_win, params.burst_isi_max
        )
        new_st["all_counts"] = st["all_counts"] + spike.astype(jnp.float32)
        return (v_new, refrac_new, s, new_st), None

    init_stats = init_output_stats(B, no, n_win)
    init_stats["all_counts"] = jnp.zeros((B, n_pad), jnp.float32)
    init = (
        jnp.zeros((B, n_pad), compute_dtype),
        jnp.zeros((B, n_pad), jnp.int32),
        jnp.zeros((B, n_pad), compute_dtype),
        init_stats,
    )
    ts = jnp.arange(T, dtype=jnp.int32)
    # unroll: replaying a few steps per loop iteration lets XLA fuse the
    # elementwise LIF/stat updates across them instead of round-tripping
    # the (B, N) carry through device memory every step.
    (_, _, _, st), _ = jax.lax.scan(step, init, (xs_t, ts), unroll=4)
    st = dict(st)
    st.pop("prev_t")
    st["all_counts"] = st["all_counts"][:, : params.n_neurons]
    return st


def features_from_stats(
    stats: Dict[str, jnp.ndarray], feature_keys: Tuple[str, ...]
) -> jnp.ndarray:
    """Assemble the per-neuron feature vectors from streaming accumulators.

    Matches the reference's post-processing (extract_lsm_features.py:83-87):
    per-key vectors concatenated in feature-set order with NaN -> 0 for
    silent neurons (np.nan_to_num semantics).
    """
    counts = stats["counts"]
    fired = counts > 0
    n_isi = stats["n_isi"]
    has_isi = n_isi > 0

    safe_counts = jnp.maximum(counts, 1.0)
    safe_n_isi = jnp.maximum(n_isi, 1.0)
    mean_isi = stats["sum_isi"] / safe_n_isi
    win = stats["win_counts"]
    win_mean = jnp.mean(win, axis=-1)
    win_var = jnp.mean(win * win, axis=-1) - win_mean * win_mean

    derived = {
        "spike_counts": counts,
        # Variance of the per-window spike counts (rate variability)
        # [inferred definition; see config.ReservoirConfig].
        "spike_variances": jnp.where(fired, jnp.maximum(win_var, 0.0), 0.0),
        "mean_spike_times": jnp.where(fired, stats["sum_t"] / safe_counts, 0.0),
        "first_spike_times": jnp.where(fired, stats["first"], 0.0),
        "last_spike_times": jnp.where(fired, stats["last"], 0.0),
        "mean_isi": jnp.where(has_isi, mean_isi, 0.0),
        "isi_variances": jnp.where(
            has_isi,
            jnp.maximum(stats["sum_isi2"] / safe_n_isi - mean_isi * mean_isi, 0.0),
            0.0,
        ),
        "burst_counts": stats["bursts"],
    }
    return jnp.concatenate([derived[k] for k in feature_keys], axis=-1)


@functools.partial(jax.jit, static_argnames=("feature_keys",))
def extract_features(
    params,
    spikes_in: jnp.ndarray,
    feature_keys: Tuple[str, ...],
) -> jnp.ndarray:
    """REPRESENTATION-dispatching feature extraction.

    Dense ReservoirParams run the XLA scan (bf16 matmul operands, f32
    state); block-sparse SparseReservoirParams (scaled configs) run the
    sparse gather scan. Jitted as a whole so the stats->features epilogue
    fuses into one program instead of ~30 separate op dispatches."""
    if not isinstance(params, ReservoirParams):
        from lsm_tpu.models.sparse import extract_features_sparse

        return extract_features_sparse(params, spikes_in, feature_keys)
    return extract_features_batch(params, spikes_in, feature_keys)


@functools.partial(
    jax.jit, static_argnames=("feature_keys", "compute_dtype", "matmul_dtype")
)
def extract_features_batch(
    params: ReservoirParams,
    spikes_in: jnp.ndarray,
    feature_keys: Tuple[str, ...],
    compute_dtype: jnp.dtype = jnp.float32,
    matmul_dtype: Optional[jnp.dtype] = jnp.bfloat16,
) -> jnp.ndarray:
    """spikes (B, C, T) -> features (B, len(keys) * n_outputs)."""
    stats = simulate_batch(params, spikes_in, compute_dtype, matmul_dtype)
    return features_from_stats(stats, feature_keys)
