"""Edge-of-chaos weight calibration (mean-field w_critico).

Reproduces `calculate_theoretical_w_critico` (extract_lsm_features.py:33-60)
exactly: over the first <=500 training samples,
    avg_I = total_spikes / total_elements
    beta  = small_world_k / 2
    w_critico = (membrane_threshold - 2 * avg_I * refractory_period) / beta
with a 0.007 fallback for degenerate inputs. The spike reduction runs on
device (a single sum over the sharded spike batch — a psum under shard_map).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lsm_tpu.config import ReservoirConfig

_FALLBACK = 0.007
_CALIB_SAMPLES = 500


@functools.partial(jax.jit, static_argnames=("max_samples",))
def _calib_spike_sum(spikes: jnp.ndarray, max_samples: int) -> jnp.ndarray:
    # ONE fused program: eager slice + astype + sum would be three
    # dispatches, each compiled separately on a cold cache.
    return jnp.sum(spikes[:max_samples].astype(jnp.float32))


def average_input_rate(spikes: jnp.ndarray, max_samples: int = _CALIB_SAMPLES) -> float:
    """Mean spike density over the first <=max_samples spike trains."""
    n = min(int(spikes.shape[0]), max_samples)
    elements = int(np.prod((n,) + tuple(spikes.shape[1:])))
    if elements == 0:
        return float("nan")
    total = float(_calib_spike_sum(jnp.asarray(spikes), max_samples))
    return total / elements


def w_critico(cfg: ReservoirConfig, avg_input_rate: float) -> float:
    """Mean-field critical weight (extract_lsm_features.py:49-60)."""
    if not np.isfinite(avg_input_rate):
        return _FALLBACK
    beta = cfg.small_world_k / 2
    if beta == 0:
        return _FALLBACK
    numerator = cfg.membrane_threshold - 2.0 * avg_input_rate * cfg.refractory_period
    return numerator / beta


def calibrate_weight(
    cfg: ReservoirConfig, train_spikes: jnp.ndarray, multiplier: float
) -> tuple[float, float]:
    """Returns (w_critico, mean_weight = w_critico * multiplier)."""
    rate = average_input_rate(train_spikes)
    wc = w_critico(cfg, rate)
    return wc, wc * multiplier
