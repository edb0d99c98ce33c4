"""Plain references the device paths are checked against.

Each oracle here is an independent, straightforward implementation of the
semantics a device path computes — sequential NumPy loops, float64 scipy
filters — shared by the test suite and `chip_smoke.py`, which runs the
same comparisons on the accelerator at full width.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from lsm_tpu.ops import gammatone as gt

# Dyadic weight grid: weights snapped to multiples of 1/DYADIC_GRID with
# |w| < 1 have at most 8 significant bits, so bf16 and TF32 operands hold
# them exactly and every f32 sum of them (with 0/1 spikes) is exact in
# any order — spike decisions cannot flip on summation order.
DYADIC_GRID = 256.0

# gtgram_iir vs the float64 oracle: sqrt(window energy) within
# atol + rtol * |ref| (f32 accumulation), on noise and on speech-like audio.
GTGRAM_RTOL = 2e-3
GTGRAM_ATOL = 1e-6

# The frozen hard accuracy benchmark (io/dataset.synthetic_audio_batch_hard)
# and the band the reference-default flagship config must land in with
# the EDGE OF CHAOS regime. Do not change without recalibrating
# (tools/sensitivity.py) and updating docs/SENSITIVITY.md.
HARD_N_PER_CLASS = 30
HARD_N_CLASSES = 12
HARD_SEED = 42
ACC_BAND = (0.76, 0.90)     # CPU defaults measured 0.8333 (2026-08-16)


def quantize_dyadic(params):
    """Snap a reservoir's weights to the dyadic grid and zero its leak, so
    all arithmetic in the oracle and in the device path is EXACT in f32.
    Works for dense ReservoirParams (w_rec) and block-sparse
    SparseReservoirParams (w_blocks)."""
    q = lambda a: jnp.round(jnp.asarray(a) * DYADIC_GRID) / DYADIC_GRID
    rec = "w_rec" if hasattr(params, "w_rec") else "w_blocks"
    return dataclasses.replace(
        params,
        **{rec: q(getattr(params, rec))},
        w_in=q(params.w_in),
        leak=jnp.zeros_like(params.leak),
    )


def lif_raster(params, spikes_in: np.ndarray) -> np.ndarray:
    """Sequential float32 LIF oracle for a dense reservoir.

    spikes_in: (C, T) 0/1 input spikes of one utterance. Returns the
    (T, N_pad) bool spike raster."""
    w_rec = np.asarray(params.w_rec, np.float32)
    w_in = np.asarray(params.w_in, np.float32)
    leak_keep = 1.0 - np.asarray(params.leak, np.float32)
    n_pad = w_rec.shape[0]
    C, T = spikes_in.shape
    x = np.zeros((w_in.shape[0], T), np.float32)
    x[:C] = spikes_in

    v = np.zeros(n_pad, np.float32)
    refrac = np.zeros(n_pad, np.int32)
    s_prev = np.zeros(n_pad, np.float32)
    raster = np.zeros((T, n_pad), bool)
    for t in range(T):
        drive = s_prev @ w_rec + x[:, t] @ w_in
        active = refrac == 0
        v_new = np.where(active, v * leak_keep + drive, 0.0).astype(np.float32)
        spike = (v_new >= params.threshold) & active
        v = np.where(spike, 0.0, v_new).astype(np.float32)
        refrac = np.where(spike, params.refractory, np.maximum(refrac - 1, 0))
        s_prev = spike.astype(np.float32)
        raster[t] = spike
    return raster


def gtgram_float64(
    wave: np.ndarray,
    fs: float,
    window_time: float,
    hop_time: float,
    channels: int,
    f_min: float,
) -> np.ndarray:
    """Float64 sequential gtgram of one waveform (the pip gtgram algorithm:
    scipy lfilter cascade, then sqrt of windowed mean energy).
    Returns (channels, n_cols)."""
    coeffs = gt.make_erb_coeffs(fs, channels, f_min)
    y = gt.erb_filterbank_np(wave.astype(np.float64), coeffs)
    xe = y**2
    nwin, hop, n_cols = gt.gtgram_strides(fs, window_time, hop_time, len(wave))
    out = np.zeros((channels, n_cols))
    for c in range(n_cols):
        out[:, c] = np.sqrt(xe[:, c * hop : c * hop + nwin].mean(axis=1))
    return out


def gtgram_error(ours: np.ndarray, ref: np.ndarray) -> dict:
    """Relative-error summary of gtgram output vs the float64 oracle, and
    whether it holds the GTGRAM_RTOL/ATOL contract everywhere."""
    ours = np.asarray(ours, np.float64)
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-30)
    ok = bool(np.all(np.abs(ours - ref) <= GTGRAM_ATOL + GTGRAM_RTOL * np.abs(ref)))
    return dict(
        median_rel=float(np.median(rel)),
        p99_rel=float(np.quantile(rel, 0.99)),
        max_rel=float(rel.max()),
        within_contract=ok,
    )
