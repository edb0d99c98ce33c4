"""Gammatone filterbank tests vs. a float64 scipy.signal.lfilter oracle."""

import math

import numpy as np
import jax.numpy as jnp

from lsm_tpu.ops import gammatone as gt
from lsm_tpu.oracles import GTGRAM_ATOL, GTGRAM_RTOL
from lsm_tpu.oracles import gtgram_float64 as _gtgram_oracle


def test_erb_space_descending_and_bounds():
    cfs = gt.erb_space(50.0, 8000.0, 64)
    assert cfs[0] > cfs[-1]
    assert cfs[0] <= 8000.0 + 1e-6
    assert cfs[-1] >= 50.0 - 1e-6
    asc = gt.centre_freqs(16000.0, 64, 50.0)
    assert np.all(np.diff(asc) > 0)


def test_gtgram_strides_reference_geometry():
    nwin, hop, n_cols = gt.gtgram_strides(16000.0, 0.025, 0.01, 16000)
    assert (nwin, hop, n_cols) == (400, 160, 98)


def test_gtgram_iir_matches_float64_oracle(rng):
    fs = 16000.0
    wave = rng.standard_normal(16000).astype(np.float32) * 0.1
    channels = 16
    ours = np.asarray(
        gt.gtgram_iir(jnp.asarray(wave[None]), fs, 0.025, 0.01, channels, 50.0)
    )[0]
    ref = _gtgram_oracle(wave, fs, 0.025, 0.01, channels, 50.0)
    assert ours.shape == ref.shape == (channels, 98)
    # f32 accumulation tolerance on sqrt(energy).
    np.testing.assert_allclose(ours, ref, rtol=GTGRAM_RTOL, atol=GTGRAM_ATOL)


def test_gtgram_iir_matches_float64_oracle_on_words():
    """Speech-like audio has quiet bins, where reduced matmul precision
    shows first; the contract holds there too."""
    from lsm_tpu.io.dataset import synthetic_audio_batch

    words, _ = synthetic_audio_batch(n_per_class=1, n_classes=3, seed=9)
    ours = np.asarray(
        gt.gtgram_iir(jnp.asarray(words), 16000.0, 0.025, 0.01, 16, 50.0)
    )
    for w, o in zip(words, ours):
        ref = _gtgram_oracle(w, 16000.0, 0.025, 0.01, 16, 50.0)
        np.testing.assert_allclose(o, ref, rtol=GTGRAM_RTOL, atol=GTGRAM_ATOL)


def test_gtgram_iir_tone_peaks_at_matching_channel():
    fs = 16000.0
    channels = 32
    cfs = gt.centre_freqs(fs, channels, 50.0)
    target = 12
    t = np.arange(16000) / fs
    wave = np.sin(2 * np.pi * cfs[target] * t).astype(np.float32)
    out = np.asarray(
        gt.gtgram_iir(jnp.asarray(wave[None]), fs, 0.025, 0.01, channels, 50.0)
    )[0]
    # Mid-utterance response should peak at (or adjacent to) the tone channel.
    peak = int(np.argmax(out[:, 50]))
    assert abs(peak - target) <= 1


def test_gtgram_fft_close_to_iir_after_normalization(rng):
    # The FFT approximation must agree with the exact IIR path up to the
    # downstream normalization (per-sample dB min-max), which is what the
    # pipeline actually consumes.
    fs = 16000.0
    t = np.arange(16000) / fs
    wave = (
        np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1870 * t)
    ).astype(np.float32)
    kwargs = dict(fs=fs, window_time=0.025, hop_time=0.01, channels=32, f_min=50.0)
    a = np.asarray(gt.gtgram_iir(jnp.asarray(wave[None]), **kwargs))[0]
    b = np.asarray(gt.gtgram_fft(jnp.asarray(wave[None]), **kwargs))[0]

    def norm_db(s):
        d = 20 * np.log10(s + 1e-9)
        d = np.maximum(d, d.max() - 80)
        return (d - d.min()) / (d.max() - d.min() + 1e-8)

    na, nb = norm_db(a), norm_db(b)
    # Loose agreement: same gross spectro-temporal structure.
    assert np.corrcoef(na.ravel(), nb.ravel())[0, 1] > 0.9
