"""Slaney-style mel filterbank, matching librosa.filters.mel defaults.

The reference calls `librosa.feature.melspectrogram` with default mel
parameters (create_dataset.py:45-47): Slaney mel scale (htk=False), Slaney
area normalization, fmin=0, fmax=sr/2.

The filterbank is built once in NumPy at trace time (it is a static
constant) and applied as a single (n_mels, n_freqs) x (n_freqs, frames)
matmul under jit.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

_F_SP = 200.0 / 3.0           # linear region: mels per Hz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32 Slaney-normalized triangular filters."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: scale each filter to constant energy per channel.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def apply_mel(power_spec: jnp.ndarray, fb: np.ndarray) -> jnp.ndarray:
    """(.., n_freqs, frames) -> (.., n_mels, frames) via batched matmul."""
    return jnp.einsum(
        "mf,...ft->...mt",
        jnp.asarray(fb),
        power_spec,
        preferred_element_type=jnp.float32,
    )
