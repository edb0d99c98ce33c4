"""Batched STFT.

Semantics match `librosa.stft` defaults as used by
`librosa.feature.melspectrogram` in the reference (create_dataset.py:45-47):
n_fft=2048, hop_length=160, win_length=n_fft, periodic Hann window,
center=True with zero ('constant') padding, power=2 magnitude.

Design: framing is expressed as a strided gather with static indices so XLA
lowers it to a single efficient dynamic-slice/gather; the FFT runs batched
over (batch, frames) as one large 2D batch. Everything
is shape-static and jit/vmap/shard_map friendly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (matches scipy.signal.get_window('hann', n))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _frame_starts(num_samples: int, n_fft: int, hop: int) -> np.ndarray:
    # center=True: signal is padded by n_fft//2 on both sides; frame f covers
    # padded[f*hop : f*hop + n_fft]. librosa's frame count is
    # 1 + (padded_len - n_fft) // hop with padded_len = S + 2*(n_fft//2) —
    # equal to 1 + S//hop for even n_fft, but one less for odd n_fft
    # (total pad n_fft - 1), where the simpler form would gather one past
    # the padded end (JAX clamps silently, diverging from the oracle).
    n_frames = 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop
    return (np.arange(n_frames) * hop).astype(np.int32)


def frame_signal(audio: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """(..., num_samples) -> (..., n_frames, n_fft) with center zero-padding."""
    num_samples = audio.shape[-1]
    pad = n_fft // 2
    padded = jnp.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(pad, pad)])
    starts = _frame_starts(num_samples, n_fft, hop)
    # Static gather of frame windows: index matrix (n_frames, n_fft).
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    return padded[..., idx]


def stft_power(
    audio: jnp.ndarray,
    n_fft: int = 2048,
    hop_length: int = 160,
) -> jnp.ndarray:
    """Power spectrogram |STFT|^2.

    Args:
      audio: (..., num_samples) float32.
    Returns:
      (..., 1 + n_fft//2, n_frames) float32 — frequency-major like librosa.
    """
    frames = frame_signal(audio, n_fft, hop_length)
    win = jnp.asarray(hann_window(n_fft))
    spec = jnp.fft.rfft(frames * win, n=n_fft, axis=-1)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    # (.., frames, freqs) -> (.., freqs, frames)
    return jnp.swapaxes(power, -1, -2)
