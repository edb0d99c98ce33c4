"""Continuous-mode streaming KWS: state carried across hops (SURVEY 5.7).

`StreamingKWS` (models/streaming.py) is the EXACT mode: every hop re-runs
the full trailing 1 s window — featurizer (16,000 samples) and the 400-step
LIF recurrence — so each prediction is bit-identical to the batch path, at
the cost of O(window / hop) redundant work per hop. This module is the
CONTINUOUS mode: every piece of sequential state persists across chunk
boundaries, so a hop of `h` bins costs only the NEW work:

  - gammatone cascade: the block-IIR scan continues from its carried
    (B, 8, C) state (bit-exact continuation — ops/gammatone.gtgram_iir_scan),
    plus a (w_per - h_per)-sub-block energy tail for windows straddling the
    chunk boundary. Chunk cost: L/80 block matmuls vs 200 for the window.
  - dB normalization: the batch path's per-window min-max (db.py) becomes a
    CAUSAL running peak/floor with linear-in-dB decay (peak-hold): bins are
    normalized once, at ingest, by the state known at that time — a later
    loud event cannot retroactively re-normalize already-encoded bins the
    way window recomputation does. This is the mode's main approximation.
  - hysteresis trigger state: carried exactly (closed-form prefix
    composition, ops/hysteresis.hysteresis_encode_step).
  - LIF reservoir: membrane/refractory/last-spike state carried; the scan
    runs 4*h steps per hop instead of 400. The carried membrane is the
    second semantic deviation: the exact mode resets v=0 at every window
    start, continuous mode lets state flow across window boundaries (the
    biologically natural choice, and what SURVEY 5.7 describes: "the same
    scan carries state across chunk boundaries").
  - window statistics: per hop, the NEW chunk's output spikes reduce to a
    segment summary (reservoir.segment_summary — O(B*T_chunk*no) work on
    just the new columns), which lands in a ring of window/hop summaries;
    evaluation folds the ring's tiny O(B*no) elements through the exact
    segment monoid (reservoir.fold_segment_stats — cross-segment ISIs
    reconstructed from first/last). A first implementation kept the raw
    400-column raster and re-derived stats from it each hop; that is
    O(B*T_win*no) of memory-bound elementwise traffic per hop (~47 GB at
    4096 streams) and measured SLOWER than the exact mode it was supposed
    to beat — the summary ring is what makes the mode actually win.

Net: per-hop compute drops ~window/hop (10x at 100 ms hops) in the
dominant reservoir term, multiplying per-chip stream capacity; the price
is a measured accuracy delta vs the exact mode (tools/bench_continuous.py,
docs/VALIDATION.md "Continuous-mode KWS") — policed by the same frozen
hard benchmark the accuracy band uses. Reference counterpart: none (the
reference has no streaming; BASELINE configs[4] / VERDICT r2 task 8).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lsm_tpu.config import FEATURE_SETS, FrontendConfig
from lsm_tpu.models import reservoir as res
from lsm_tpu.ops import gammatone as gt
from lsm_tpu.ops.hysteresis import hysteresis_encode_step
from lsm_tpu.parallel.mesh import DATA_AXIS
from lsm_tpu.readout import logistic, scaler

_LOG10 = 2.302585092994046


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ContinuousState:
    """All cross-chunk stream state. Batch axis first except `tail` and
    `segs` (ring/scan-major like what they cache)."""

    iir: jax.Array        # (B, 8, C) f32 — gammatone cascade state
                          #   (mel: (B, 0, C) — no IIR state)
    tail: jax.Array       # gammatone: (w_per - h_per, B, C) f32 straddling
                          #   energies; mel: (n_fft - hop, B, 1) raw audio
    hyst: jax.Array       # (B, n_thr, C) bool — Schmitt trigger state
    norm_hi: jax.Array    # (B,) f32 — running peak dB
    norm_lo: jax.Array    # (B,) f32 — running floor dB
    v: jax.Array          # (B, N_pad) f32 — membrane
    refrac: jax.Array     # (B, N_pad) i32
    s_prev: jax.Array     # (B, N_pad) f32 — last step's spike vector
    segs: dict            # stat name -> (n_ring, B, no) f32; ring[0] oldest
    win_ring: jax.Array   # (B, no, n_win) f32 — rate-window counts ring


@jax.jit
def _extract_rows_packed(leaves: dict, idx) -> jax.Array:
    """Gather stream rows `idx` from every state leaf AND pack the
    results into one uint8 buffer (keys in sorted order; f32/i32 leaves
    bitcast to little-endian bytes, bool widened to one byte), so the
    whole extraction is ONE dispatch + ONE D2H transfer instead of one
    per state leaf (18 leaves)."""
    from lsm_tpu.io.serving_state import _stream_axis

    parts = []
    for k in sorted(leaves):
        v = jnp.take(leaves[k], idx, axis=_stream_axis(k))
        if v.dtype == jnp.bool_:
            parts.append(v.astype(jnp.uint8).reshape(-1))
        else:
            # XLA bitcast-to-narrower appends a trailing byte axis, low
            # bits first (little-endian) — matches np .view on the host.
            parts.append(
                jax.lax.bitcast_convert_type(v, jnp.uint8).reshape(-1)
            )
    return jnp.concatenate(parts)


@functools.partial(jax.jit, donate_argnums=(0,))
def _install_rows(state: ContinuousState, idx, rows: dict) -> ContinuousState:
    """Scatter donor stream rows into slots `idx` of every state leaf
    (stream axis 0, except the ring-major tail/segs at axis 1). One fused
    dispatch; the rest of the state is passed through (donated)."""

    def put0(x, r):
        return x.at[idx].set(r)

    def put1(x, r):
        return x.at[:, idx].set(r)

    return ContinuousState(
        iir=put0(state.iir, rows["iir"]),
        tail=put1(state.tail, rows["tail"]),
        hyst=put0(state.hyst, rows["hyst"]),
        norm_hi=put0(state.norm_hi, rows["norm_hi"]),
        norm_lo=put0(state.norm_lo, rows["norm_lo"]),
        v=put0(state.v, rows["v"]),
        refrac=put0(state.refrac, rows["refrac"]),
        s_prev=put0(state.s_prev, rows["s_prev"]),
        segs={k: put1(state.segs[k], rows[f"seg:{k}"]) for k in state.segs},
        win_ring=put0(state.win_ring, rows["win_ring"]),
    )


class ContinuousKWS:
    """Stateful continuous keyword spotter over B parallel streams.

    Same constructor surface as StreamingKWS plus `chunk_len` (must be a
    multiple of the 160-sample featurizer hop) and `norm_decay_db_per_bin`
    (the causal normalization's peak/floor decay rate). The default
    0.1 dB/bin (10 dB/s) holds the peak across inter-word gaps, so in the
    always-on steady state — after the stream's first loud event — bins
    normalize against a peak close to the exact mode's window max. The
    trade-off is causal by nature: bins BEFORE the stream's first loud
    event normalize against a noise-level peak and over-fire (the exact
    mode re-normalizes them retroactively each window; this mode cannot) —
    so the first ~1 s of a cold stream is warmup, and the accuracy
    contract is measured in the carried-state condition
    (tools/bench_continuous.py). Both reference frontends are supported:
    gammatone continues its IIR-cascade state + straddling-window energy
    tail; mel computes one STFT frame per 160-sample hop from a carried
    (n_fft - hop)-sample raw-audio tail (same Hann/filterbank/dB math as
    the batch path; power_to_db's ref=max subtraction cancels in min-max
    normalization except the top_db floor, which the shared causal
    peak/floor normalization applies).

    Accepts dense ReservoirParams or block-sparse SparseReservoirParams
    (scaled reservoirs), each through an XLA chunk scan whose statistics
    are bit-equal to the batch scan's (tests/test_continuous.py; the sparse
    scan is additionally bit-equal to the densified dense path on dyadic
    weights).
    """

    def __init__(
        self,
        params,
        readout: logistic.LogisticParams,
        scaler_state: scaler.ScalerState,
        fcfg: FrontendConfig,
        feature_set: str = "original",
        n_streams: int = 1,
        chunk_len: int = 1600,
        norm_decay_db_per_bin: float = 0.1,
        mesh: Optional[Mesh] = None,
    ):
        if fcfg.filterbank not in ("gammatone", "mel"):
            raise ValueError(f"unknown filterbank {fcfg.filterbank!r}")
        is_mel = fcfg.filterbank == "mel"
        from lsm_tpu.models.sparse import SparseReservoirParams

        if not isinstance(params, (res.ReservoirParams, SparseReservoirParams)):
            raise TypeError(f"unsupported reservoir params: {type(params)}")
        is_sparse = isinstance(params, SparseReservoirParams)
        if is_mel:
            # One STFT frame per 160-sample hop (the batch path's hop,
            # create_dataset.py:43-45). The carried frontend state is the
            # last n_fft - hop raw samples: frames are n_fft wide, so a
            # frame ending inside this chunk starts up to n_fft - hop
            # samples before it. Frames end flush with the chunk (inherent
            # n_fft/2 = 64 ms analysis latency — the same centered-window
            # context the batch STFT sees, delivered causally).
            if fcfg.num_samples % fcfg.time_bins:
                raise ValueError(
                    f"num_samples {fcfg.num_samples} must be a multiple of "
                    f"time_bins {fcfg.time_bins}"
                )
            hop = fcfg.num_samples // fcfg.time_bins
            nwin = fcfg.n_fft
            if hop > nwin:
                # Mirrors the gammatone nwin < hop guard: with gaps
                # between STFT frames the carried (n_fft - hop)-sample
                # audio tail has negative length and no meaning.
                raise ValueError(
                    f"mel hop ({hop} samples) must be <= n_fft ({nwin}): "
                    "with gaps between frames the carried audio tail has "
                    "no meaning"
                )
            g = hop
        else:
            hop_time = fcfg.num_samples / (fcfg.sample_rate * fcfg.time_bins)
            nwin, hop, _ = gt.gtgram_strides(
                fcfg.sample_rate, fcfg.gt_window_time, hop_time,
                fcfg.num_samples
            )
            if nwin < hop:
                raise ValueError(
                    f"gammatone window ({nwin} samples) must be >= the hop "
                    f"({hop}): with gaps between windows the energy-tail "
                    "carry has no meaning"
                )
            g = math.gcd(hop, nwin)
        if chunk_len % hop:
            raise ValueError(
                f"chunk_len {chunk_len} must be a multiple of the "
                f"featurizer hop ({hop} samples)"
            )
        self.params = params
        self.readout = readout
        self.scaler_state = scaler_state
        self.fcfg = fcfg
        self.keys = tuple(FEATURE_SETS[feature_set])
        self.n_streams = n_streams
        self.chunk_len = chunk_len
        self.mesh = mesh
        self._is_mel = is_mel
        if mesh is not None:
            from lsm_tpu.parallel.mesh import replicate_to_mesh

            # Process-aware replication (multi-host meshes): weights are
            # identical on every process; single-host this is device_put.
            self.params = params = replicate_to_mesh(params, mesh)
            self.readout = readout = replicate_to_mesh(readout, mesh)
            self.scaler_state = scaler_state = replicate_to_mesh(
                scaler_state, mesh
            )
        self._g = g
        self._nwin = nwin
        self._w_per = nwin // g
        self._h_per = hop // g
        # Carried frontend-state shapes: gammatone keeps straddling
        # sub-block ENERGIES (w_per - h_per, B, C) + the (B, 8, C) IIR
        # cascade state; mel keeps raw AUDIO (n_fft - hop, B, 1) and no
        # IIR state.
        self._tail = (nwin - hop) if is_mel else (self._w_per - self._h_per)
        self._tail_ch = 1 if is_mel else fcfg.n_filters
        self._iir_n = 0 if is_mel else 8
        self._n_thr = fcfg.n_thresholds
        self._t_win = fcfg.time_bins * fcfg.n_thresholds
        self._decay = float(norm_decay_db_per_bin)

        self._seg_keys = (
            "counts", "sum_t", "sum_t2", "first", "last",
            "n_isi", "sum_isi", "sum_isi2", "bursts",
        )

        if mesh is not None:
            n_data = mesh.shape[DATA_AXIS]
            if n_streams % n_data:
                raise ValueError(
                    f"n_streams={n_streams} must be divisible by the mesh "
                    f"data axis ({n_data})"
                )

        fs = fcfg.sample_rate
        C = fcfg.n_filters
        f_min = fcfg.gt_f_min
        top_db = fcfg.power_top_db
        thresholds = fcfg.spike_thresholds
        gap = fcfg.hysteresis_gap
        keys = self.keys
        no = params.n_outputs
        # Carried-state width: the padded dense width, or the (already
        # 128-aligned) sparse neuron count.
        n_state = params.n_neurons if is_sparse else params.w_rec.shape[0]
        self._n_state = n_state
        c_pad = params.w_in.shape[0]
        n_cols = chunk_len // hop
        w_per, h_per, tail, d = self._w_per, self._h_per, self._tail, self._decay
        n_win = params.n_rate_windows
        burst_isi_max = params.burst_isi_max
        redundancy = fcfg.redundancy_factor

        t_c = n_cols * self._n_thr                 # spike steps per chunk
        t_win = self._t_win
        if t_win % t_c:
            raise ValueError(
                f"chunk spans {t_c} spike steps, which must divide the "
                f"{t_win}-step analysis window (chunk_len must divide "
                f"{fcfg.num_samples})"
            )
        if t_win % n_win:
            # The batch oracle (reservoir.stats_from_raster) clamps the
            # remainder into the LAST rate window; the ring of uniform
            # win_len windows cannot represent that, and silently covering
            # only n_win*win_len trailing steps would shift the win_counts
            # feature distribution. Fail loudly instead.
            raise ValueError(
                f"n_rate_windows={n_win} must divide the {t_win}-step "
                "analysis window for the continuous rate-window ring "
                "(the batch path folds the remainder into the last window)"
            )
        win_len = max(1, t_win // n_win)
        if t_c % win_len:
            raise ValueError(
                f"chunk ({t_c} steps) must span whole rate windows "
                f"({win_len} steps; n_rate_windows={n_win})"
            )
        self._t_c = t_c
        self._n_ring = t_win // t_c
        n_new_win = t_c // win_len

        def _normalize_encode(db, st: ContinuousState):
            """(n_cols, B, C) dB bins -> ((B, C', T_c) spikes, new trigger
            state, new peak/floor). The frontend-agnostic half of the
            featurizer: causal peak/floor normalization + hysteresis.

            Running peak/floor with linear-in-dB decay and CHUNK-level
            lookahead: every bin in the chunk normalizes against the
            whole chunk's extrema (a <= one-chunk decision latency —
            within-chunk decay at 0.1 dB/bin is negligible), merged with
            the carried pre-chunk value aged by the bin's distance.
            Pure-causal cummax was measured worse on the hard benchmark
            (matched 0.7917 -> 0.8056, carry-in 0.500 -> 0.528 with the
            lookahead): a word's first bins normalized against the
            pre-word noise peak over-fire (docs/VALIDATION.md)."""
            colmax = jnp.max(db, axis=-1)                 # (n_cols, B)
            colmin = jnp.min(db, axis=-1)
            jj = jnp.arange(n_cols, dtype=jnp.float32)[:, None]
            hi = jnp.maximum(
                jnp.max(colmax, axis=0, keepdims=True),
                st.norm_hi[None, :] - d * (jj + 1.0),
            )
            lo = jnp.minimum(
                jnp.min(colmin, axis=0, keepdims=True),
                st.norm_lo[None, :] + d * (jj + 1.0),
            )
            # Batch-path normalization semantics per bin (db.py): floor at
            # peak - top_db, min-max over [floor-clamped lo, hi], degenerate
            # range -> zeros.
            floor = hi - top_db
            lo_eff = jnp.maximum(lo, floor)
            rng = hi - lo_eff
            x = jnp.maximum(db, floor[..., None])
            norm = jnp.where(
                (rng < 1e-8)[..., None],
                0.0,
                (x - lo_eff[..., None]) / (rng + 1e-8)[..., None],
            )
            spec = jnp.clip(norm, 0.0, 1.0).transpose(1, 2, 0)  # (B, C, n_cols)
            spikes, hyst = hysteresis_encode_step(
                spec, st.hyst, thresholds, gap
            )
            if redundancy > 1:
                spikes = jnp.repeat(spikes, redundancy, axis=-2)
            return spikes, hyst, hi[-1], lo[-1]

        if is_mel:
            from lsm_tpu.ops import mel as melops
            from lsm_tpu.ops import stft as stftops

            fmax = (
                fcfg.mel_fmax if fcfg.mel_fmax is not None else fs / 2.0
            )
            mel_fb_t = jnp.asarray(
                melops.mel_filterbank(fs, fcfg.n_fft, C, fcfg.mel_fmin, fmax).T
            )                                             # (n_freqs, C)
            hann = jnp.asarray(stftops.hann_window(fcfg.n_fft))
            # Static frame gather: frame i covers concat[i*hop, i*hop+n_fft)
            # of [tail | chunk]; the last frame ends flush with the chunk.
            frame_idx = (
                np.arange(n_cols)[:, None] * hop
                + np.arange(fcfg.n_fft)[None, :]
            )
            tail_len = self._tail

            def _featurize_chunk(chunk, st: ContinuousState):
                """Per-hop mel bins from carried raw audio: same window/
                filterbank/dB math as the batch path (ops/stft.py, ops/
                mel.py, ops/db.py power_to_db) — power_to_db's ref=max
                subtraction cancels in min-max normalization except the
                top_db floor, which _normalize_encode applies against the
                RUNNING peak exactly like the gammatone path."""
                audio_tail = jnp.moveaxis(st.tail[:, :, 0], 0, 1)  # (B, tail)
                concat = jnp.concatenate([audio_tail, chunk], axis=-1)
                frames = concat[:, frame_idx]             # (B, n_cols, n_fft)
                spec = jnp.fft.rfft(frames * hann, axis=-1)
                power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
                melp = power @ mel_fb_t                   # (B, n_cols, C)
                db = 10.0 * jnp.log(jnp.maximum(melp, 1e-10)) / _LOG10
                db = jnp.moveaxis(db, 0, 1)               # (n_cols, B, C)
                spikes, hyst, hi_l, lo_l = _normalize_encode(db, st)
                new_tail = jnp.moveaxis(
                    concat[:, concat.shape[1] - tail_len:], 0, 1
                )[:, :, None]                             # (tail, B, 1)
                return spikes, st.iir, new_tail, hyst, hi_l, lo_l

        else:
            starts_np = np.arange(n_cols) * h_per
            win_idx = jnp.asarray(
                starts_np[:, None] + np.arange(w_per)[None, :]
            )                                             # (n_cols, w_per)

            def _featurize_chunk(chunk, st: ContinuousState):
                B = chunk.shape[0]
                n_sub = chunk.shape[1] // g
                blocks = chunk.reshape(B, n_sub, g).transpose(1, 0, 2)
                iir, sub_e = gt.gtgram_iir_scan(
                    blocks, st.iir, fs, C, f_min, g
                )
                all_e = jnp.concatenate([st.tail, sub_e], axis=0)
                win_e = jnp.sum(all_e[win_idx], axis=1)   # (n_cols, B, C)
                amp = jnp.sqrt(win_e / nwin)
                db = 20.0 * jnp.log(amp + 1e-9) / _LOG10  # (n_cols, B, C)
                spikes, hyst, hi_l, lo_l = _normalize_encode(db, st)
                # Explicit start index: `all_e[-tail:]` would return the
                # WHOLE buffer at tail == 0 (window == hop), growing the
                # carried state every step.
                new_tail = all_e[all_e.shape[0] - tail:]
                return spikes, iir, new_tail, hyst, hi_l, lo_l

        def _reservoir_chunk(p, spikes, st: ContinuousState):
            """(B, C, T_c) spikes + carried state -> (v, refrac, s_prev,
            segment-summary dict, win_counts (B, n_new_win, no)).

            An XLA chunk scan + reservoir.segment_summary (bit-equal to
            the batch scan's statistics, test_continuous.py)."""
            B, Cs, T_c = spikes.shape
            if Cs != c_pad:
                spikes = jnp.pad(spikes, ((0, 0), (0, c_pad - Cs), (0, 0)))

            x = spikes.astype(jnp.float32)
            xs_t = jnp.moveaxis(x, -1, 0)                 # (T_c, B, c_pad)
            w_in = p.w_in.astype(jnp.bfloat16)
            leak_keep = 1.0 - p.leak
            if is_sparse:
                from lsm_tpu.models.sparse import sparse_drive

                w_blocks = p.w_blocks.astype(jnp.bfloat16)

                def recur(s_prev):
                    return sparse_drive(
                        s_prev, w_blocks, p.src_idx, jnp.bfloat16
                    )
            else:
                w_rec = p.w_rec.astype(jnp.bfloat16)

                def recur(s_prev):
                    return jnp.dot(
                        s_prev.astype(jnp.bfloat16), w_rec,
                        preferred_element_type=jnp.float32,
                    )

            def step(carry, x_t):
                v, refrac, s_prev = carry
                drive = recur(s_prev) + jnp.dot(
                    x_t.astype(jnp.bfloat16), w_in,
                    preferred_element_type=jnp.float32,
                )
                v_new, refrac_new, spike = res.lif_update(
                    v, refrac, drive, leak_keep, p.threshold, p.refractory
                )
                return (v_new, refrac_new, spike.astype(jnp.float32)), \
                    spike[:, :no]

            (v, refrac, s_prev), out = jax.lax.scan(
                step, (st.v, st.refrac, st.s_prev), xs_t, unroll=4
            )                                             # out: (T_c, B, no)
            out = out.transpose(1, 0, 2)                  # (B, T_c, no)
            seg = res.segment_summary(out, burst_isi_max)
            win_new = (
                out.astype(jnp.float32)
                .reshape(B, n_new_win, win_len, no)
                .sum(axis=2)
            )                                             # (B, n_new_win, no)
            return v, refrac, s_prev, seg, win_new

        def _step_local(p, st: ContinuousState, chunk, w, b, mean, scale):
            from lsm_tpu.models.streaming import decode_pcm_device

            chunk = decode_pcm_device(chunk)  # f32 / int16 / uint8 mu-law
            spikes, iir, e_tail, hyst, norm_hi, norm_lo = _featurize_chunk(
                chunk, st
            )
            v, refrac, s_prev, new_seg, win_new = _reservoir_chunk(
                p, spikes, st
            )
            # Only the NEW columns were reduced; the trailing window's
            # stats come from folding the summary ring (O(B*no) per
            # slot) — a T_win-sized raster never exists.
            segs = {
                k: jnp.concatenate([st.segs[k][1:], new_seg[k][None]], axis=0)
                for k in st.segs
            }
            new_win = jnp.moveaxis(win_new, 1, 2)         # (B, no, n_new_win)
            win_ring = jnp.concatenate(
                [st.win_ring[..., n_new_win:], new_win], axis=-1
            )
            stats = res.fold_segment_stats(segs, t_c, burst_isi_max)
            stats["win_counts"] = win_ring
            feats = res.features_from_stats(stats, keys)
            logits = (feats - mean) / scale @ w + b
            new_st = ContinuousState(
                iir=iir, tail=e_tail, hyst=hyst,
                norm_hi=norm_hi, norm_lo=norm_lo,
                v=v, refrac=refrac, s_prev=s_prev,
                segs=segs, win_ring=win_ring,
            )
            return new_st, logits

        from lsm_tpu.models.streaming import compact_output_device

        def _step_local_compact(p, st, chunk, w, b, mean, scale):
            new_st, logits = _step_local(p, st, chunk, w, b, mean, scale)
            return new_st, compact_output_device(logits)

        if mesh is None:
            self._step = jax.jit(_step_local, donate_argnums=(1,))
            self._step_compact = jax.jit(
                _step_local_compact, donate_argnums=(1,)
            )
        else:
            names = (
                ("w_blocks", "src_idx", "w_in", "leak")
                if is_sparse else ("w_rec", "w_in", "leak")
            )
            state_specs = self._state_pspec()
            sm = shard_map(
                lambda p_arrs, st, chunk, w, b, mean, scale: _step_local(
                    dataclasses.replace(
                        params, **dict(zip(names, p_arrs))
                    ),
                    st, chunk, w, b, mean, scale,
                ),
                mesh=mesh,
                in_specs=(
                    (P(),) * len(names),
                    state_specs,
                    P(DATA_AXIS, None),
                    P(), P(), P(), P(),
                ),
                out_specs=(state_specs, P(DATA_AXIS, None)),
                check_vma=False,
            )

            def _mesh_step(p, st, chunk, w, b, mean, scale):
                return sm(tuple(getattr(p, nm) for nm in names),
                          st, chunk, w, b, mean, scale)

            self._step = jax.jit(_mesh_step, donate_argnums=(1,))

            sm_compact = shard_map(
                lambda p_arrs, st, chunk, w, b, mean, scale:
                    _step_local_compact(
                        dataclasses.replace(
                            params, **dict(zip(names, p_arrs))
                        ),
                        st, chunk, w, b, mean, scale,
                    ),
                mesh=mesh,
                in_specs=(
                    (P(),) * len(names),
                    state_specs,
                    P(DATA_AXIS, None),
                    P(), P(), P(), P(),
                ),
                out_specs=(state_specs, P(DATA_AXIS, None)),
                check_vma=False,
            )

            def _mesh_step_compact(p, st, chunk, w, b, mean, scale):
                return sm_compact(tuple(getattr(p, nm) for nm in names),
                                  st, chunk, w, b, mean, scale)

            self._step_compact = jax.jit(
                _mesh_step_compact, donate_argnums=(1,)
            )

        # Partial-activity ingest: scatter the k active rows into a
        # silence-filled full wire chunk ON DEVICE, then the normal step
        # body — one fused dispatch, H2D carries only the active rows.
        from lsm_tpu.models.streaming import expand_active_rows

        _step_full = _step_local if mesh is None else _mesh_step
        _step_full_c = (
            _step_local_compact if mesh is None else _mesh_step_compact
        )

        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(8,))
        def _step_active(p, st, rows, idx, w, b, mean, scale, compact):
            chunk = expand_active_rows(rows, idx, n_streams)
            fn = _step_full_c if compact else _step_full
            return fn(p, st, chunk, w, b, mean, scale)

        self._step_active = _step_active

        # k fused steps in ONE dispatch (the amortized-timing probe —
        # same contract as StreamingKWS.steps_fused). The carried state
        # evolves across iterations, so XLA cannot hoist the body even
        # though the chunk repeats.
        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(7,))
        def _steps_fused(p, st, chunk, w, b, mean, scale, k):
            def body(s_, _):
                s_, logits = _step_full(p, s_, chunk, w, b, mean, scale)
                return s_, jnp.sum(logits, dtype=jnp.float32)

            st, sums = jax.lax.scan(body, st, None, length=k)
            return st, sums[-1]

        self._steps_fused = _steps_fused

        # Frontend-only entry point (no state donation): used by the
        # bit-level featurizer oracles in tests/test_continuous.py.
        self._featurize = jax.jit(_featurize_chunk)

        def _features_fn(segs, win_ring):
            stats = res.fold_segment_stats(segs, t_c, burst_isi_max)
            stats["win_counts"] = win_ring
            return res.features_from_stats(stats, keys)

        # Elementwise over (B, no): plain jit partitions it under the mesh
        # without shard_map.
        self._features = jax.jit(_features_fn)

        def _diag_fn(segs):
            counts = jnp.sum(segs["counts"], axis=0)        # (B, no)
            return (jnp.sum(counts > 0, axis=1).astype(jnp.int32),
                    jnp.sum(counts, axis=1))

        # Per-stream reduction over (B, no): partitions under the mesh
        # like _features_fn; D2H is two (B,) scalar vectors.
        self._diag = jax.jit(_diag_fn)

        def _reset_streams_fn(st: ContinuousState, mask) -> ContinuousState:
            """Re-init every state leaf where mask (B,) is True. The init
            values are the _init_state constants; all leaves are batch-
            independent so a masked where is exactly 'this stream is
            fresh'."""

            def sel(cur, init_val, axis):
                shape = [1] * cur.ndim
                shape[axis] = mask.shape[0]
                return jnp.where(
                    mask.reshape(shape), jnp.asarray(init_val, cur.dtype), cur
                )

            seg_init = {"first": jnp.inf, "last": -1.0}
            return ContinuousState(
                iir=sel(st.iir, 0.0, 0),
                tail=sel(st.tail, 0.0, 1),
                hyst=sel(st.hyst, False, 0),
                norm_hi=sel(st.norm_hi, -1e30, 0),
                norm_lo=sel(st.norm_lo, 1e30, 0),
                v=sel(st.v, 0.0, 0),
                refrac=sel(st.refrac, 0, 0),
                s_prev=sel(st.s_prev, 0.0, 0),
                segs={
                    k: sel(st.segs[k], seg_init.get(k, 0.0), 1)
                    for k in st.segs
                },
                win_ring=sel(st.win_ring, 0.0, 0),
            )

        self._reset_streams = jax.jit(_reset_streams_fn, donate_argnums=(0,))

        self.state = self._init_state(n_streams)

    @property
    def norm_decay_db_per_bin(self) -> float:
        """The causal normalization decay this engine was built with (a
        serving-contract knob: bundles and state snapshots persist it)."""
        return self._decay

    def features(self) -> "np.ndarray":
        """Raw (unscaled) window features for the current trailing window —
        exactly the vector the last step() pushed through the readout.
        (B, len(keys) * n_outputs). Used to calibrate readouts on
        continuous-mode feature distributions (tools/bench_continuous.py
        'matched' protocol)."""
        from lsm_tpu.models.streaming import materialize_stream_output

        # materialize_stream_output: the jit output is data-axis sharded
        # on a mesh — on multi-process meshes np.asarray on
        # non-addressable shards raises (same route as diagnostics()).
        return materialize_stream_output(
            self._features(self.state.segs, self.state.win_ring), self.mesh
        )

    def diagnostics(self, stream_idx=None):
        """Reservoir health on LIVE serving traffic, from the
        per-output-neuron window spike counts this engine already carries
        (the segment-summary ring) — zero extra simulation. Reports
        participation / dead neurons / mean rate per stream plus the
        regime verdict with the reference's thresholds
        (extract_lsm_features.py:92-152). Scope is the OUTPUT-neuron
        subset: output neurons are an exchangeable random subset of the
        reservoir, so the participation percentage is an unbiased
        estimator of the full-reservoir figure the batch diagnostics
        report. `stream_idx` selects the streams the verdict averages
        over (None = all; silent and still-warming slots read
        sub-critical by nature — a cold stream needs one full window of
        audio before its ring covers the window)."""
        from lsm_tpu.models.diagnostics import serving_report
        from lsm_tpu.models.streaming import materialize_stream_output

        act, tot = self._diag(self.state.segs)
        return serving_report(
            materialize_stream_output(act, self.mesh),
            materialize_stream_output(tot, self.mesh),
            self.params.n_outputs, "output", stream_idx,
        )

    def swap_readout(self, readout, scaler_state=None) -> None:
        """Hot readout cutover on the live engine (the recalibration
        path: fit_continuous_readout on fresh data, then one swap
        mid-serving; see streaming.swap_readout_on)."""
        from lsm_tpu.models.streaming import swap_readout_on

        swap_readout_on(self, readout, scaler_state)

    def _state_pspec(self):
        """PartitionSpecs for ContinuousState: batch axis sharded along
        data — axis 0 everywhere except `tail`/`segs` (ring-major)."""
        return ContinuousState(
            iir=P(DATA_AXIS, None, None),
            tail=P(None, DATA_AXIS, None),
            hyst=P(DATA_AXIS, None, None),
            norm_hi=P(DATA_AXIS),
            norm_lo=P(DATA_AXIS),
            v=P(DATA_AXIS, None),
            refrac=P(DATA_AXIS, None),
            s_prev=P(DATA_AXIS, None),
            segs={k: P(None, DATA_AXIS, None) for k in self._seg_keys},
            win_ring=P(DATA_AXIS, None, None),
        )

    def _init_state(self, B: int) -> ContinuousState:
        C = self.fcfg.n_filters
        n_pad = self._n_state
        no = self.params.n_outputs
        st = ContinuousState(
            iir=jnp.zeros((B, self._iir_n, C), jnp.float32),
            tail=jnp.zeros((self._tail, B, self._tail_ch), jnp.float32),
            hyst=jnp.zeros((B, self._n_thr, C), jnp.bool_),
            # "No observation yet": +-1e30 sentinels lose every max/min
            # against real data, so the first chunk's normalization comes
            # entirely from observed bins. (Initializing at the digital-
            # silence dB of -180 instead poisons the running floor for
            # hundreds of bins — the drift only recovers d dB/bin — and
            # the inflated dynamic range saturates the spike encoder:
            # measured 27k spikes/utterance vs the batch path's ~1k.)
            norm_hi=jnp.full((B,), -1e30, jnp.float32),
            norm_lo=jnp.full((B,), 1e30, jnp.float32),
            v=jnp.zeros((B, n_pad), jnp.float32),
            refrac=jnp.zeros((B, n_pad), jnp.int32),
            s_prev=jnp.zeros((B, n_pad), jnp.float32),
            # Empty-segment summaries: zero counts/sums, first=+inf and
            # last=-1 (the silent sentinels fold_segment_stats expects).
            segs={
                k: jnp.full(
                    (self._n_ring, B, no),
                    jnp.inf if k == "first" else (-1.0 if k == "last" else 0.0),
                    jnp.float32,
                )
                for k in self._seg_keys
            },
            win_ring=jnp.zeros(
                (B, no, self.params.n_rate_windows), jnp.float32
            ),
        )
        return self._place_state(st)

    def _place_state(self, st: ContinuousState) -> ContinuousState:
        """Move a host-valued ContinuousState onto the device(s). Each
        leaf is a FULL (global-shape) value identical on every process;
        under a mesh shard_host_array materializes only the addressable
        shards (multihost_mesh spans processes, where plain device_put to
        non-addressable devices fails)."""
        if self.mesh is None:
            return jax.tree_util.tree_map(jnp.asarray, st)
        from lsm_tpu.parallel.mesh import shard_host_array

        specs = self._state_pspec()
        return jax.tree_util.tree_map(
            lambda x, s: shard_host_array(np.asarray(x), self.mesh, s),
            st, specs,
            is_leaf=lambda x: isinstance(x, P),
        )

    def _local_streams(self) -> int:
        """Rows each process feeds per chunk (mesh.local_stream_rows, the
        single definition shared with StreamingKWS)."""
        from lsm_tpu.parallel.mesh import local_stream_rows

        return local_stream_rows(self.n_streams, self.mesh)

    def _normalize_chunk(self, chunk: np.ndarray) -> np.ndarray:
        from lsm_tpu.models.streaming import normalize_ingest_chunk

        return normalize_ingest_chunk(
            chunk, self._local_streams(), self.chunk_len, fixed_len=True
        )

    def _place_chunk(self, chunk: np.ndarray) -> jax.Array:
        from lsm_tpu.parallel.mesh import place_stream_chunk

        sharding = None
        if self.mesh is not None:
            sharding = NamedSharding(self.mesh, P(DATA_AXIS, None))
        return place_stream_chunk(chunk, sharding)

    def step(self, chunk) -> np.ndarray:
        """Ingest one (n_streams, chunk_len) chunk and evaluate: ONE fused
        dispatch carrying all stream state on device. Accepts float32
        samples in [-1, 1], raw int16 PCM (exact /32768 on device), or
        uint8 G.711 mu-law (ops/ulaw.py — 1 byte/sample, the
        ingest-bound serving format). A
        jax.Array chunk is trusted as already device-resident (and, under
        a mesh, already stream-sharded) — the zero-copy ingest path for
        callers that pipeline their own H2D transfers."""
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        from lsm_tpu.models.streaming import materialize_stream_output

        return materialize_stream_output(self._step_device(dev), self.mesh)

    def _step_device(self, dev) -> "jax.Array":
        """Dispatch one step on a device-resident chunk; returns the logits
        as an UNMATERIALIZED jax.Array (nothing blocks). The building block
        of the pipelined driver (streaming.stream_pipelined)."""
        self.state, out = self._step(
            self.params,
            self.state,
            dev,
            self.readout.w,
            self.readout.b,
            self.scaler_state.mean,
            self.scaler_state.scale,
        )
        return out

    def stream(self, chunks, depth: int = 2):
        """Pipelined serving loop: yields per-chunk logits, bit-equal to
        serial step() calls but with H2D/dispatch of up to `depth` steps
        in flight (see streaming.stream_pipelined)."""
        from lsm_tpu.models.streaming import stream_pipelined

        return stream_pipelined(self, chunks, depth=depth)

    def steps_fused(self, chunk, k: int) -> float:
        """Run k consecutive step() calls on the SAME ingest chunk as ONE
        jitted dispatch (a lax.scan over the step body) and return the
        LAST hop's logit checksum — the amortized-timing probe; see
        StreamingKWS.steps_fused for the methodology. State advances
        exactly as k step() calls on that chunk (pinned bit-level in
        tests/test_continuous.py)."""
        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        self.state, s = self._steps_fused(
            self.params, self.state, dev,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale, int(k),
        )
        return float(s)

    def predict(self, chunk: np.ndarray) -> np.ndarray:
        return np.argmax(self.step(chunk), axis=-1)

    def step_active(self, rows, active_idx, compact: bool = False):
        """step() with only the ACTIVE streams' audio on the wire: `rows`
        is (k, chunk_len) in any ingest wire format, `active_idx` the k
        stream slots it belongs to. Silent streams advance on
        device-synthesized wire silence (streaming.wire_silence), so the
        logits — and every stream's carried state — are BIT-equal to
        step() on the full chunk with silence in the inactive rows, at
        k/n_streams of the H2D bytes (the first-order serving wall). For
        an always-on fleet at activity factor f the ingest wire shrinks
        1/f with zero semantic change. Multi-host: SPMD — every process
        passes the same global rows/idx.

        compact=True also packs the decision egress (see step_compact):
        returns (preds int32 (B,), margin f32 (B,)) at 4 bytes/stream
        D2H — both wire directions shrink.

        The active count buckets to the next power of two internally
        (streaming.prepare_active_rows), so fluctuating fleet activity
        compiles at most log2(n_streams) programs per wire format."""
        from lsm_tpu.models.streaming import (
            materialize_stream_output, prepare_active_rows,
            unpack_compact_output,
        )

        rows_d, idx_d = prepare_active_rows(
            rows, active_idx, self.n_streams, chunk_len=self.chunk_len,
            mesh=self.mesh,
        )
        self.state, out = self._step_active(
            self.params, self.state, rows_d, idx_d,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale,
            compact,
        )
        out = materialize_stream_output(out, self.mesh)
        return unpack_compact_output(out) if compact else out

    def step_compact(self, chunk):
        """step() with the compact decision output: (preds int32 (B,),
        margin f32 (B,)) — top-1 class + top-1/top-2 logit margin, packed
        on device into one (B, 2) uint16 buffer so the D2H is 4
        bytes/stream instead of n_classes x 4 (streaming.
        compact_output_device). Same ingest contract and state advance as
        step(); preds bit-equal to step(chunk).argmax(-1)."""
        from lsm_tpu.models.streaming import unpack_compact_output

        if isinstance(chunk, jax.Array):
            dev = chunk
        else:
            dev = self._place_chunk(self._normalize_chunk(chunk))
        self.state, packed = self._step_compact(
            self.params, self.state, dev,
            self.readout.w, self.readout.b,
            self.scaler_state.mean, self.scaler_state.scale,
        )
        from lsm_tpu.models.streaming import materialize_stream_output

        return unpack_compact_output(
            materialize_stream_output(packed, self.mesh)
        )

    def reset(self, stream_idx=None) -> None:
        """Re-initialize stream state (parity with StreamingKWS.reset).

        `stream_idx=None` resets ALL streams. Otherwise it names the
        stream(s) to recycle — an int, a sequence of ints, or a
        (n_streams,) bool mask — and EVERY ContinuousState leaf for just
        those slots (IIR cascade, energy tail, hysteresis triggers,
        normalization peak/floor sentinels, membrane/refractory/spike
        carry, segment-summary ring, rate-window ring) re-initializes
        in one fused masked update while the other streams' state is
        untouched: the serving recycle path for an always-on server
        whose stream slots turn over independently."""
        if stream_idx is None:
            self.state = self._init_state(self.n_streams)
            return
        mask = np.zeros((self.n_streams,), np.bool_)
        idx = np.asarray(stream_idx)
        if idx.dtype == np.bool_:
            if idx.shape != (self.n_streams,):
                raise ValueError(
                    f"bool mask must have shape ({self.n_streams},), "
                    f"got {idx.shape}"
                )
            mask = idx
        else:
            mask[idx] = True
        if self.mesh is None:
            m = jnp.asarray(mask)
        else:
            from lsm_tpu.parallel.mesh import shard_host_array

            # Full (global) mask, same value on every process (SPMD
            # callers invoke reset with identical arguments everywhere).
            m = shard_host_array(mask, self.mesh, P(DATA_AXIS))
        self.state = self._reset_streams(self.state, m)

    def _state_leaves(self) -> dict:
        """Flat name -> device-array view of ContinuousState (segment
        ring entries keyed 'seg:<stat>') — the snapshot/migration leaf
        map. Stream axis per leaf: serving_state._stream_axis."""
        st = self.state
        d = {
            k: getattr(st, k)
            for k in ("iir", "tail", "hyst", "norm_hi", "norm_lo",
                      "v", "refrac", "s_prev", "win_ring")
        }
        for k, v in st.segs.items():
            d[f"seg:{k}"] = v
        return d

    def snapshot(self) -> dict:
        """Host copy of ALL cross-chunk stream state — every
        ContinuousState leaf (IIR cascade, energy/audio tail, hysteresis
        triggers, normalization peak/floor, membrane/refractory/spike
        carry, segment-summary ring, rate-window ring) as a full
        (global-shape) array. Restoring it into a fresh engine with the
        same weights continues every stream bit-exactly, warmup included
        (io/serving_state.py is the on-disk format + validation).
        Multi-host, each leaf all-gathers so every process holds the full
        snapshot. Segment-ring entries are keyed 'seg:<stat>'."""
        from lsm_tpu.parallel.mesh import host_local

        return {
            k: np.asarray(host_local(v))
            for k, v in self._state_leaves().items()
        }

    def extract_streams(self, stream_idx) -> dict:
        """snapshot() restricted to the named stream slot(s): one fused
        jitted gather packs all 18 state leaves' rows into a single byte
        buffer on device, so the whole extraction is ONE dispatch + ONE
        D2H — only the selected rows ever leave the device (kilobytes per
        stream instead of the engine's full state), and only one
        device round-trip is paid instead of one per leaf. The unit
        serving_state.migrate_streams
        moves. Multi-host: a collective; call on every process with
        identical indices (SPMD, like reset)."""
        from lsm_tpu.io.serving_state import _stream_axis
        from lsm_tpu.models.streaming import validate_stream_idx
        from lsm_tpu.parallel.mesh import host_local

        idx_np = validate_stream_idx(stream_idx, self.n_streams,
                                     "extract_streams")
        nk = idx_np.shape[0]
        leaves = self._state_leaves()
        packed = np.asarray(host_local(_extract_rows_packed(
            leaves, jnp.asarray(idx_np, jnp.int32)
        )))
        out = {}
        off = 0
        for key in sorted(leaves):
            ref = leaves[key]
            ax = _stream_axis(key)
            shape = tuple(
                nk if d == ax else s for d, s in enumerate(ref.shape)
            )
            dt = np.dtype(ref.dtype)
            nbytes = int(np.prod(shape)) * (1 if dt == np.bool_ else dt.itemsize)
            seg = packed[off:off + nbytes]
            off += nbytes
            if dt == np.bool_:
                out[key] = (seg != 0).reshape(shape)
            else:
                out[key] = seg.view(dt).reshape(shape)
        return out

    def install_streams(self, stream_idx, rows: dict) -> None:
        """Inverse of extract_streams: scatter donor stream state into
        the named slots (device-side; other slots untouched). `rows`
        carries one row per index along each leaf's stream axis, same
        leaves/dtypes as extract_streams — validated before any state
        mutates. Multi-host: SPMD, identical arguments everywhere."""
        from lsm_tpu.io.serving_state import _stream_axis
        from lsm_tpu.models.streaming import validate_stream_idx

        idx = validate_stream_idx(stream_idx, self.n_streams,
                                  "install_streams", unique=True)
        ref = self._state_leaves()
        missing = set(ref) - set(rows)
        if missing:
            raise ValueError(
                f"donor rows are missing state leaves {sorted(missing)}"
            )
        clean = {}
        for k, leaf in ref.items():
            ax = _stream_axis(k)
            want = tuple(
                idx.shape[0] if d == ax else s
                for d, s in enumerate(leaf.shape)
            )
            r = np.asarray(rows[k])
            if r.shape != want or r.dtype != np.dtype(leaf.dtype):
                raise ValueError(
                    f"donor leaf {k!r} is {r.dtype}{r.shape}; this engine "
                    f"needs {np.dtype(leaf.dtype)}{want} — the donor engine "
                    "has a different geometry"
                )
            clean[k] = r
        self.state = _install_rows(
            self.state, jnp.asarray(idx, jnp.int32), clean
        )

    def restore(self, snap: dict) -> None:
        """Inverse of snapshot(): install a saved state. `snap` carries
        FULL (global-shape) arrays, identical on every process; under a
        mesh each process materializes its addressable shards. Every leaf
        is validated against this engine's state geometry, so a snapshot
        taken with different streams/frontend/reservoir/chunking fails
        loudly instead of desynchronizing the rings."""
        ref = self.state

        def pick(key: str, ref_leaf: jax.Array) -> np.ndarray:
            if key not in snap:
                raise ValueError(
                    f"snapshot is missing state leaf {key!r} — not a "
                    "ContinuousKWS snapshot, or one from an incompatible "
                    "build"
                )
            a = np.asarray(snap[key])
            want = (ref_leaf.shape, np.dtype(ref_leaf.dtype))
            if (a.shape, a.dtype) != want:
                raise ValueError(
                    f"snapshot leaf {key!r} is {a.dtype}{a.shape}; this "
                    f"engine needs {want[1]}{want[0]} — the snapshot was "
                    "taken with a different stream count, frontend, "
                    "reservoir, or chunk geometry"
                )
            return a

        extra = {
            k for k in snap
            if k.startswith("seg:") and k[4:] not in ref.segs
        }
        if extra:
            raise ValueError(
                f"snapshot has segment stats {sorted(extra)} this engine "
                "does not track (different feature set)"
            )
        st = ContinuousState(
            iir=pick("iir", ref.iir),
            tail=pick("tail", ref.tail),
            hyst=pick("hyst", ref.hyst),
            norm_hi=pick("norm_hi", ref.norm_hi),
            norm_lo=pick("norm_lo", ref.norm_lo),
            v=pick("v", ref.v),
            refrac=pick("refrac", ref.refrac),
            s_prev=pick("s_prev", ref.s_prev),
            segs={k: pick(f"seg:{k}", ref.segs[k]) for k in ref.segs},
            win_ring=pick("win_ring", ref.win_ring),
        )
        self.state = self._place_state(st)


def fit_continuous_readout(
    params,                       # ReservoirParams | SparseReservoirParams
    fcfg: FrontendConfig,
    audio: np.ndarray,            # (N, num_samples) f32 training utterances
    labels: np.ndarray,           # (N,) int32
    num_classes: int,
    feature_set: str = "original",
    chunk_len: int = 1600,
    norm_decay_db_per_bin: float = 0.1,
    mesh: Optional[Mesh] = None,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-4,
):
    """Calibrate a readout + scaler ON CONTINUOUS-MODE FEATURES.

    The production deployment recipe for ContinuousKWS: its feature
    distribution differs from the batch path (causal normalization,
    carried membrane, native 100-bin grid), so a batch-trained readout
    loses ~0.3 accuracy while a continuous-trained readout is at parity
    within noise (docs/VALIDATION.md "Continuous-mode KWS"). This streams
    the training utterances through ContinuousKWS in the carried-state
    condition (each utterance preceded by another, no reset — the
    always-on operating point), reads the window features at each
    utterance's last chunk, and fits the standard scaler + multinomial
    logistic on them. Returns (LogisticParams, ScalerState) ready to pass
    to ContinuousKWS.
    """
    n = audio.shape[0]
    n_chunks = fcfg.num_samples // chunk_len
    d = len(FEATURE_SETS[feature_set]) * params.n_outputs
    dummy_ro = logistic.LogisticParams(
        w=jnp.zeros((d, num_classes), jnp.float32),
        b=jnp.zeros((num_classes,), jnp.float32),
    )
    dummy_sc = scaler.ScalerState(
        mean=jnp.zeros((d,), jnp.float32), scale=jnp.ones((d,), jnp.float32)
    )
    # Forward every knob that shapes the feature distribution: calibrating
    # at one normalization decay and serving at another re-introduces the
    # distribution-shift loss the matched protocol exists to remove.
    kws = ContinuousKWS(
        params, dummy_ro, dummy_sc, fcfg, feature_set,
        n_streams=n, chunk_len=chunk_len,
        norm_decay_db_per_bin=norm_decay_db_per_bin, mesh=mesh,
    )
    # Carry-in pre-roll: a fixed-seed PERMUTATION, not np.roll — corpora
    # are typically class-blocked (index_speech_commands walks class dirs,
    # synthetic batches generate per class), so a roll-by-1 would give
    # nearly every stream a SAME-class predecessor and calibrate on a
    # context distribution deployment never sees (advisor r3).
    prev = audio[np.random.default_rng(12345).permutation(n)]

    def _advance(chunk):
        # State advance only: _step_device leaves the dummy-readout
        # logits unmaterialized, so calibration skips 2*n_chunks pointless
        # (n, K) D2H round-trips that kws.step() would pay just to discard.
        kws._step_device(kws._place_chunk(kws._normalize_chunk(chunk)))

    for c in range(n_chunks):
        _advance(prev[:, c * chunk_len:(c + 1) * chunk_len])
    for c in range(n_chunks):
        _advance(audio[:, c * chunk_len:(c + 1) * chunk_len])
    feats = jnp.asarray(kws.features())

    st = scaler.fit_scaler(feats)
    readout, _ = logistic.fit_logistic(
        scaler.transform(st, feats), jnp.asarray(labels, jnp.int32),
        num_classes=num_classes, l2_c=l2_c, max_iter=max_iter, tol=tol,
    )
    return readout, st
