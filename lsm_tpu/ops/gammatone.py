"""Gammatone (ERB) filterbank spectrogram — "gtgram".

Reproduces the behavior of `gammatone.gtgram.gtgram(wave, fs, window_time,
hop_time, channels, f_min)` as used by the reference (create_dataset.py:51-58):
ERB-spaced center frequencies from f_min to fs/2, Patterson-Holdsworth
4th-order gammatone filters realized as Slaney's cascade of four 2nd-order
IIR sections per channel (Slaney 1993, Apple TR #35 — public algorithm),
followed by sqrt(windowed mean energy) at the given window/hop. Channel 0 of
the output is the LOWEST frequency (the pip package flips the descending ERB
ordering before filtering).

Two implementations:

1. `gtgram_iir` (default, exact): coefficients are built in float64 NumPy at
   trace time; on device a `lax.scan` walks the waveform in sub-blocks of
   gcd(hop, window) samples, carrying only the (B, C, 4, 2) biquad state and
   emitting per-sub-block energy sums — the full-rate filtered signal is
   never materialized (O(B*C) working set instead of O(B*C*S)). Window
   energies are then 5-tap sums of sub-block energies. Exact up to f32
   accumulation, validated against a float64 NumPy oracle in tests.

2. `gtgram_fft` (fast approximation): STFT power spectrum weighted by the
   gammatone magnitude response — the same trick as the pip package's
   `fft_gtgram`. Downstream min-max normalization absorbs absolute gain
   differences (SURVEY.md section 7).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lsm_tpu.ops.stft import hann_window

_EAR_Q = 9.26449
_MIN_BW = 24.7


def erb_space(low_freq: float, high_freq: float, num: int) -> np.ndarray:
    """ERB-spaced center frequencies, DESCENDING (Slaney's ErbSpace)."""
    c = _EAR_Q * _MIN_BW
    return -c + np.exp(
        np.arange(1, num + 1)
        * (-np.log(high_freq + c) + np.log(low_freq + c))
        / num
    ) * (high_freq + c)


def centre_freqs(fs: float, num: int, f_min: float) -> np.ndarray:
    """Ascending center freqs (pip gtgram flips to low->high channel order)."""
    return erb_space(f_min, fs / 2.0, num)[::-1].copy()


class ErbCoeffs(NamedTuple):
    """Per-channel cascade coefficients, each shaped (C,).

    Biquad k (k=0..3) has numerator [a0_k, a1_k, 0] and denominator
    [1, b1, b2]; the first stage's numerator is divided by `gain`.
    """

    a0: np.ndarray          # = T (same all stages)
    a1: np.ndarray          # (4, C): A11..A14
    b1: np.ndarray
    b2: np.ndarray
    gain: np.ndarray


@functools.lru_cache(maxsize=None)
def make_erb_coeffs(fs: float, num_channels: int, f_min: float) -> ErbCoeffs:
    """Slaney's MakeERBFilters in float64 (public formulas, Apple TR #35)."""
    cf = centre_freqs(fs, num_channels, f_min).astype(np.float64)
    T = 1.0 / fs
    erb = ((cf / _EAR_Q) ** 1.0 + _MIN_BW**1.0) ** 1.0  # order = 1
    B = 1.019 * 2.0 * np.pi * erb

    arg = 2.0 * cf * np.pi * T
    vec = np.exp(2j * arg)

    A0 = T * np.ones_like(cf)
    B1 = -2.0 * np.cos(arg) / np.exp(B * T)
    B2 = np.exp(-2.0 * B * T)

    rt_pos = np.sqrt(3.0 + 2.0**1.5)
    rt_neg = np.sqrt(3.0 - 2.0**1.5)
    common = -T * np.exp(-(B * T))

    k11 = np.cos(arg) + rt_pos * np.sin(arg)
    k12 = np.cos(arg) - rt_pos * np.sin(arg)
    k13 = np.cos(arg) + rt_neg * np.sin(arg)
    k14 = np.cos(arg) - rt_neg * np.sin(arg)

    A11, A12, A13, A14 = (common * k for k in (k11, k12, k13, k14))

    gain_arg = np.exp(1j * arg - B * T)
    gain = np.abs(
        (vec - gain_arg * k11)
        * (vec - gain_arg * k12)
        * (vec - gain_arg * k13)
        * (vec - gain_arg * k14)
        * (T * np.exp(B * T) / (-1.0 / np.exp(B * T) + 1.0 + vec * (1.0 - np.exp(B * T))))
        ** 4
    )

    return ErbCoeffs(
        a0=A0,
        a1=np.stack([A11, A12, A13, A14]),
        b1=B1,
        b2=B2,
        gain=gain,
    )


def erb_filterbank_np(wave: np.ndarray, coeffs: ErbCoeffs) -> np.ndarray:
    """Float64 NumPy oracle: (S,) -> (C, S). Used for golden tests."""
    from scipy.signal import lfilter

    C = coeffs.b1.shape[0]
    out = np.zeros((C, wave.shape[0]))
    for c in range(C):
        den = [1.0, coeffs.b1[c], coeffs.b2[c]]
        y = lfilter(
            [coeffs.a0[c] / coeffs.gain[c], coeffs.a1[0, c] / coeffs.gain[c], 0.0],
            den, wave,
        )
        for k in range(1, 4):
            y = lfilter([coeffs.a0[c], coeffs.a1[k, c], 0.0], den, y)
        out[c] = y
    return out


def _round_half_away(x: float) -> int:
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


@functools.lru_cache(maxsize=None)
def gtgram_strides(fs: float, window_time: float, hop_time: float, n_samples: int):
    """Window/hop geometry exactly as the pip package computes it."""
    nwin = _round_half_away(window_time * fs)
    hop = _round_half_away(hop_time * fs)
    n_cols = int(math.floor((n_samples - nwin) / hop)) + 1
    return nwin, hop, n_cols


@functools.lru_cache(maxsize=None)
def _block_iir_matrices(fs: float, channels: int, f_min: float, L: int):
    """Exact block-form matrices for the 4-biquad cascade, per channel.

    The cascade is LTI with an 8-dim state (4 transposed-DF2 biquads x 2).
    Over a block of L samples the input/output relation is linear:

        y_block = x_block @ M_yx + s @ M_sy
        s'      = x_block @ M_xs + s @ M_ss

    The matrices are obtained numerically in float64 by running the exact
    sequential filter on basis vectors (L input impulses + 8 state units) —
    no algebra to get wrong, bit-exact vs. the scalar recurrence up to f32.
    This turns the 16000-step sample recurrence into S/L sequential steps of
    batched (B, L) x (L, L) matmuls per channel — matrix-unit work instead
    of a latency-bound scalar scan.

    Returns (M_yx (C,L,L), M_sy (C,8,L), M_xs (C,L,8), M_ss (C,8,8)) f32.
    """
    coeffs = make_erb_coeffs(fs, channels, f_min)
    C = channels
    # Distribute the 1/gain normalization evenly across the four stages
    # (gain is astronomically small for gammatone filters, ~1e-12; folding
    # it all into stage 0 makes that stage's internal TDF2 state reach 1e10,
    # which float32/bf16 matmuls cannot survive). The cascade output is
    # identical; only internal state scaling changes.
    g4 = coeffs.gain ** 0.25
    n0 = np.stack([coeffs.a0 / g4] * 4)
    n1 = np.stack([coeffs.a1[k] / g4 for k in range(4)])
    b1, b2 = coeffs.b1, coeffs.b2

    # Basis batch: L impulse inputs + 8 unit states => N = L + 8 runs.
    N = L + 8
    x_basis = np.zeros((N, L))
    x_basis[:L] = np.eye(L)
    state = np.zeros((C, N, 4, 2))
    for k in range(4):
        for j in range(2):
            state[:, L + 2 * k + j, k, j] = 1.0

    y_out = np.zeros((C, N, L))
    for t in range(L):
        x = np.broadcast_to(x_basis[:, t], (C, N)).copy()
        for k in range(4):
            s1 = state[:, :, k, 0]
            s2 = state[:, :, k, 1]
            y = n0[k][:, None] * x + s1
            state[:, :, k, 0] = n1[k][:, None] * x - b1[:, None] * y + s2
            state[:, :, k, 1] = -b2[:, None] * y
            x = y
        y_out[:, :, t] = x

    s_flat = state.reshape(C, N, 8)
    return (
        np.ascontiguousarray(y_out[:, :L]).astype(np.float32),       # (C, L, L)
        np.ascontiguousarray(y_out[:, L:]).astype(np.float32),       # (C, 8, L)
        np.ascontiguousarray(s_flat[:, :L]).astype(np.float32),      # (C, L, 8)
        np.ascontiguousarray(s_flat[:, L:]).astype(np.float32),      # (C, 8, 8)
    )


def gtgram_iir_scan(
    blocks: jnp.ndarray,          # (n_sub, B, g) scan-major waveform blocks
    init_state: jnp.ndarray,      # (B, 8, C) cascade state at blocks[0]
    fs: float,
    channels: int,
    f_min: float,
    g: int,
):
    """The exact block-IIR scan, with an EXPLICIT carried state.

    Factored out of gtgram_iir so streaming featurization can continue the
    cascade across chunk boundaries bit-exactly: feeding a signal in chunks
    (threading the returned state) performs the identical op sequence as
    one whole-signal call (tests/test_continuous.py). Returns
    (final_state (B, 8, C), sub_energy (n_sub, B, C)).
    """
    B = blocks.shape[1]
    C = channels
    m_yx, m_sy, m_xs, m_ss = _block_iir_matrices(fs, channels, f_min, g)

    # Flatten the per-channel block maps into single 2D matmuls so the
    # device sees one big (B, g) x (g, g*C) contraction per step instead of C small
    # batched ones (and XLA output-fuses the +state / square / reduce
    # epilogue instead of materializing per-channel intermediates):
    #   W_yx[l, m*C + c] = M_yx[c, l, m]  -> Y (B, g*C), minor dim = channel
    #   W_xs[l, s*C + c] = M_xs[c, l, s]  -> S (B, 8*C)
    w_yx = jnp.asarray(np.ascontiguousarray(m_yx.transpose(1, 2, 0)).reshape(g, g * C))
    w_xs = jnp.asarray(np.ascontiguousarray(m_xs.transpose(1, 2, 0)).reshape(g, 8 * C))
    m_sy_t = jnp.asarray(np.ascontiguousarray(m_sy.transpose(1, 2, 0)))  # (8, g, C)
    m_ss_t = jnp.asarray(np.ascontiguousarray(m_ss.transpose(1, 2, 0)))  # (8, 8, C)

    # Precision: the STATE path must be exact — single-pass reduced-precision
    # operands break near-unit-circle IIR state propagation over 200 block
    # steps — so x@W_xs runs at HIGHEST (true f32; on the GPU off the
    # tensor cores) and the M_ss/M_sy state terms run as exact f32
    # broadcast multiply-adds. Expressing the state terms as 8 broadcast
    # terms (instead of a batched einsum) also lets XLA fuse broadcasts +
    # add + square + reduce into one pass over the (B, g, C) block, so only
    # the y_x matmul output ever materializes in device memory. The
    # dominant x@W_yx path (~98% of flops) only feeds the windowed energy
    # (per-block errors do not accumulate), so it runs at DEFAULT
    # precision: single-pass TF32 on the GPU's tensor cores, f32 on the
    # CPU. TF32 holds the float64 oracle contract on noise but not in the
    # quiet bins of word audio (lsm_tpu/oracles.py; p99 rel err 1.9e-3,
    # max 6.1e-3 on an H100). 3-pass bf16 holds it there at ~9% more time,
    # but on the GPU it made data-parallel spikes differ from one device's
    # (194 of 123M), where TF32 kept them byte-identical.
    hi = jax.lax.Precision.HIGHEST

    def step(state, x_block):
        # state: (B, 8, C); x_block: (B, g).
        y = jnp.dot(x_block, w_yx,
                    preferred_element_type=jnp.float32).reshape(B, g, C)
        new_state = jnp.dot(x_block, w_xs, precision=hi,
                            preferred_element_type=jnp.float32).reshape(B, 8, C)
        for s in range(8):
            col = state[:, s, :][:, None, :]                   # (B, 1, C)
            y = y + col * m_sy_t[s][None, :, :]
            new_state = new_state + col * m_ss_t[s][None, :, :]
        energy = jnp.sum(y * y, axis=1)                        # (B, C)
        return new_state, energy

    return jax.lax.scan(step, init_state, blocks, unroll=2)


def gtgram_iir(
    wave: jnp.ndarray,
    fs: float,
    window_time: float,
    hop_time: float,
    channels: int,
    f_min: float,
) -> jnp.ndarray:
    """Exact gammatone spectrogram. wave: (B, S) -> (B, C, n_cols).

    Block-IIR formulation: a lax.scan over sub-blocks of g = gcd(hop, nwin)
    samples where each step applies the exact block-form cascade (see
    _block_iir_matrices) as batched matmuls and emits the sub-block energy
    sum per (batch, channel). Window energies are then exact contiguous
    sums of nwin/g sub-blocks. The full-rate filtered signal never
    materializes in device memory.
    """
    B, S = wave.shape
    nwin, hop, n_cols = gtgram_strides(fs, window_time, hop_time, S)
    g = math.gcd(hop, nwin)
    # Pad so S is a multiple of g (padding only affects windows past n_cols).
    n_sub = -(-S // g)
    pad = n_sub * g - S
    if pad:
        wave = jnp.pad(wave, ((0, 0), (0, pad)))

    # (n_sub, B, g): scan-major layout. The wave is shared across channels;
    # the channel axis appears through the per-channel block matrices.
    blocks = wave.reshape(B, n_sub, g).transpose(1, 0, 2)

    init = jnp.zeros((B, 8, channels), jnp.float32)
    _, sub_energy = gtgram_iir_scan(blocks, init, fs, channels, f_min, g)
    sub_energy = sub_energy.transpose(1, 2, 0)                 # (B, C, n_sub)

    # Window w covers sub-blocks [w*hop/g, w*hop/g + nwin/g).
    w_per = nwin // g
    h_per = hop // g
    starts = np.arange(n_cols) * h_per
    idx = starts[:, None] + np.arange(w_per)[None, :]          # (n_cols, w_per)
    win_energy = sub_energy[..., idx].sum(-1)                  # (B, C, n_cols)
    return jnp.sqrt(win_energy / nwin)


@functools.lru_cache(maxsize=None)
def _gammatone_fft_weights(
    fs: float, n_fft: int, channels: int, f_min: float
) -> np.ndarray:
    """(C, 1 + n_fft//2) squared-magnitude response of each gammatone channel."""
    coeffs = make_erb_coeffs(fs, channels, f_min)
    freqs = np.linspace(0.0, fs / 2.0, 1 + n_fft // 2)
    z = np.exp(2j * np.pi * freqs / fs)
    zinv = 1.0 / z
    den = 1.0 + coeffs.b1[:, None] * zinv + coeffs.b2[:, None] * zinv**2
    h = np.ones_like(den)
    for k in range(4):
        num = coeffs.a0[:, None] + coeffs.a1[k][:, None] * zinv
        h = h * (num / den)
    h = h / coeffs.gain[:, None]
    return (np.abs(h) ** 2).astype(np.float32)


def gtgram_fft(
    wave: jnp.ndarray,
    fs: float,
    window_time: float,
    hop_time: float,
    channels: int,
    f_min: float,
) -> jnp.ndarray:
    """FFT-weighted gammatone approximation. wave: (B, S) -> (B, C, n_cols).

    STFT with the gtgram window/hop geometry and a Hann window, band-energy
    weighted by each channel's |H(f)|^2 — the standard `fft_gtgram` trick.
    """
    B, S = wave.shape
    nwin, hop, n_cols = gtgram_strides(fs, window_time, hop_time, S)
    n_fft = 1 << (nwin - 1).bit_length()
    starts = (np.arange(n_cols) * hop)[:, None] + np.arange(nwin)[None, :]
    frames = wave[:, starts]                                   # (B, n_cols, nwin)
    win_np = hann_window(nwin)
    win = jnp.asarray(win_np)
    win_power = float(np.sum(win_np ** 2))
    spec = jnp.fft.rfft(frames * win, n=n_fft, axis=-1)
    power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) / win_power
    weights = jnp.asarray(_gammatone_fft_weights(fs, n_fft, channels, f_min))
    band = jnp.einsum("cf,btf->bct", weights, power, preferred_element_type=jnp.float32)
    # Normalize by the FFT bin count so scales roughly match the IIR path.
    return jnp.sqrt(band / n_fft)
