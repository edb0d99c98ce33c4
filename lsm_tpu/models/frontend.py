"""Stage-1 featurizer: audio batch -> spike-train batch, fully jittable.

Reference pipeline (create_dataset.py:39-104):
  audio (16 kHz, 1 s)
    -> {mel | gammatone} spectrogram            (:43-58)
    -> dB (power_to_db ref=max | 20log10 + floor) (:48, :59-60)
    -> per-sample min-max normalize, degenerate -> zeros (:62-67)
    -> linear zoom of the time axis to TIME_BINS=100 (:69-78)
    -> 4-threshold hysteresis spike encoding, interleaved (:81-98)
    -> redundancy repeat along the filter axis (:101-104)

Here the whole chain is one jitted batched function (B, S) -> (B, F*R, 400)
that shards data-parallel over the mesh. No per-file Python loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lsm_tpu.config import FrontendConfig
from lsm_tpu.ops import db as db_ops
from lsm_tpu.ops import gammatone as gt
from lsm_tpu.ops import hysteresis, mel, resample, stft


def spectrogram_db(audio: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """(B, S) float32 -> (B, n_filters, T_frames) dB spectrogram."""
    if cfg.filterbank == "mel":
        hop = max(1, cfg.num_samples // cfg.time_bins)   # create_dataset.py:44
        power = stft.stft_power(audio, cfg.n_fft, hop)
        fb = mel.mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.n_filters, cfg.mel_fmin,
            cfg.mel_fmax if cfg.mel_fmax is not None else cfg.sample_rate / 2.0,
        )
        spec = mel.apply_mel(power, fb)
        return db_ops.power_to_db(spec, top_db=cfg.power_top_db)
    elif cfg.filterbank == "gammatone":
        # hop_time = len(audio) / (fs * TIME_BINS)  (create_dataset.py:50)
        hop_time = cfg.num_samples / (cfg.sample_rate * cfg.time_bins)
        fn = _dispatch_gtgram(cfg)
        spec = fn(
            audio, cfg.sample_rate, cfg.gt_window_time, hop_time,
            cfg.n_filters, cfg.gt_f_min,
        )
        return db_ops.amplitude_to_db_floor(spec, top_db=cfg.power_top_db)
    raise ValueError(f"unknown filterbank: {cfg.filterbank!r}")


def _dispatch_gtgram(cfg: FrontendConfig):
    """Pick the gtgram implementation: 'iir' the exact block-IIR scan,
    'fft' the STFT approximation."""
    if cfg.gammatone_method == "fft":
        return gt.gtgram_fft
    if cfg.gammatone_method != "iir":
        raise ValueError(f"unknown gammatone_method: {cfg.gammatone_method!r}")
    return gt.gtgram_iir


@functools.partial(jax.jit, static_argnames=("cfg",))
def featurize_batch(audio: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """Audio batch -> spike trains.

    Args:
      audio: (B, num_samples) float32 samples in [-1, 1], OR int16 linear
        PCM converted on device with the decoders' exact /32768
        (io/wav.py:59) — BIT-EQUAL for PCM16-sourced audio and half the
        host->device bytes of the cold (disk -> predictions) path — OR
        uint8 G.711 mu-law decoded on device
        (ops/ulaw.py:decode_ulaw_device): a QUARTER of the f32 bytes,
        lossy but measured accuracy-neutral (tests/test_ulaw.py) — the
        same three-format wire contract as the streaming engines'
        normalize_ingest_chunk. Already padded/truncated to 1 s either
        way.
    Returns:
      (B, n_filters * redundancy_factor, time_bins * n_thresholds) uint8.
    """
    if audio.dtype == jnp.uint8:
        from lsm_tpu.ops.ulaw import decode_ulaw_device

        audio = decode_ulaw_device(audio)
    elif audio.dtype == jnp.int16:
        audio = audio.astype(jnp.float32) / 32768.0
    elif not jnp.issubdtype(audio.dtype, jnp.floating):
        # The wire contract is exactly three formats. Any other integer
        # dtype (int32 PCM, bool, ...) would sail through the min-max
        # normalization at the wrong scale and produce plausible-looking
        # but wrong spikes with no signal — reject at the boundary.
        raise TypeError(
            f"featurize_batch audio dtype {audio.dtype} is not part of "
            "the wire contract (float samples, int16 PCM, or uint8 "
            "mu-law)"
        )
    spec_db = spectrogram_db(audio, cfg)
    spec_norm = db_ops.minmax_normalize(spec_db)
    spec_norm = resample.zoom_time_axis(spec_norm, cfg.time_bins)
    spikes = hysteresis.hysteresis_encode(
        spec_norm, cfg.spike_thresholds, cfg.hysteresis_gap
    )
    if cfg.redundancy_factor > 1:
        spikes = jnp.repeat(spikes, cfg.redundancy_factor, axis=-2)
    return spikes


def pad_or_truncate(audio: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """Right-pad with zeros or truncate (create_dataset.py:28-32)."""
    cur = audio.shape[-1]
    if cur < num_samples:
        pad = [(0, 0)] * (audio.ndim - 1) + [(0, num_samples - cur)]
        return jnp.pad(audio, pad)
    return audio[..., :num_samples]
