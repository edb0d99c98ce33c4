"""Multi-threshold hysteresis (Schmitt-trigger) spike encoder.

Reference semantics (create_dataset.py:81-98): for each threshold theta
(iterated in DESCENDING order; index t_idx counts from the highest), a
per-filter Schmitt trigger walks the 100 time bins carrying an `active`
state: it turns ON when value > theta, OFF when value < theta - gap, and
holds otherwise. While ON it emits a 1 every bin (level coding). Outputs are
interleaved: column `time_bin * n_thresholds + t_idx`, so 4 consecutive
columns per original bin ordered high->low threshold.

Parallel formulation: the recurrence
    active_t = rising_t OR (active_{t-1} AND holdable_t)
with rising_t = (x_t > theta) and holdable_t = (x_t >= theta - gap) is a
composition of boolean affine maps f_t(a) = b_t | (a & c_t), which compose
closed-form:  (b2, c2) o (b1, c1) = (b2 | (b1 & c2), c1 & c2).
That makes it an ASSOCIATIVE scan — O(log T) depth instead of a
100-step sequential loop, and it vectorizes over (batch, filters,
thresholds) simultaneously.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _compose(left, right):
    """Compose boolean affine maps a -> b | (a & c); right applied after left."""
    b1, c1 = left
    b2, c2 = right
    return jnp.logical_or(b2, jnp.logical_and(b1, c2)), jnp.logical_and(c1, c2)


def hysteresis_encode(
    spec: jnp.ndarray,
    thresholds: Sequence[float],
    gap: float,
) -> jnp.ndarray:
    """Encode normalized spectrograms into interleaved multi-threshold spikes.

    Args:
      spec: (..., n_filters, T) float in [0, 1].
      thresholds: spike thresholds; encoded in descending order (t_idx 0 is
        the highest threshold), matching create_dataset.py:87.
      gap: hysteresis gap (OFF level = threshold - gap).

    Returns:
      (..., n_filters, T * len(thresholds)) uint8, interleaved layout.
    """
    # The zero-state special case of hysteresis_encode_step: with
    # active_0 = False the extension term b | (a0 & c) reduces to b (and
    # XLA folds the AND-with-zeros away), so ONE scan body serves both
    # the batch and the streaming encoder — their pinned bit-equality
    # (tests/test_continuous.py) cannot drift.
    state = jnp.zeros(
        spec.shape[:-2] + (len(thresholds), spec.shape[-2]), bool
    )
    out, _ = hysteresis_encode_step(spec, state, thresholds, gap)
    return out


def hysteresis_encode_step(
    spec: jnp.ndarray,
    state: jnp.ndarray,
    thresholds: Sequence[float],
    gap: float,
):
    """Chunked encoder with an EXPLICIT carried trigger state.

    The boolean affine maps compose left-to-right, so a chunk's scanned
    prefix (b, c) extends an arbitrary initial state a0 in closed form:
    active_t = b_t | (a0 & c_t). Feeding a signal in chunks (threading the
    returned state) is bit-equal to one whole-signal hysteresis_encode
    (tests/test_continuous.py) — the streaming featurizer's encoder.

    Args:
      spec: (..., n_filters, T_chunk) float in [0, 1].
      state: (..., n_thr, n_filters) bool — trigger state after the
        previous chunk (all-False == stream start, matching
        hysteresis_encode's implicit initial state).
    Returns:
      (spikes (..., n_filters, T_chunk * n_thr) uint8 interleaved,
       new_state (..., n_thr, n_filters) bool).
    """
    if gap < 0:
        # The associative formulation's holdable_t = (x >= theta - gap)
        # assumes the OFF level sits AT or BELOW the ON threshold; with a
        # negative gap it would silently diverge from the sequential
        # Schmitt semantics (reference create_dataset.py:88-94).
        raise ValueError(f"hysteresis gap must be >= 0, got {gap}")
    thr = np.sort(np.asarray(thresholds, dtype=np.float32))[::-1]
    n_thr = len(thr)
    t_len = spec.shape[-1]

    xt = jnp.swapaxes(spec, -1, -2)                 # (..., T, F)
    x = xt[..., None, :, :]                         # (..., 1, T, F)
    thr_col = jnp.asarray(thr.copy()).reshape(
        (1,) * (spec.ndim - 2) + (n_thr, 1, 1)
    )
    rising = x > thr_col
    holdable = x >= (thr_col - gap)

    b, c = jax.lax.associative_scan(
        lambda l, r: _compose(l, r), (rising, holdable), axis=-2
    )
    active = jnp.logical_or(
        b, jnp.logical_and(state[..., :, None, :], c)
    )                                                # (..., n_thr, T, F)
    new_state = active[..., -1, :]

    out = jnp.moveaxis(jnp.moveaxis(active, -1, -3), (-2, -1), (-1, -2))
    out = out.reshape(out.shape[:-2] + (t_len * n_thr,))
    return out.astype(jnp.uint8), new_state


def hysteresis_encode_reference(
    spec: np.ndarray, thresholds: Sequence[float], gap: float
) -> np.ndarray:
    """Trivially-correct sequential NumPy implementation (test oracle).

    Mirrors create_dataset.py:81-98 exactly, for unit-test comparison.
    """
    n_filters, n_time = spec.shape
    n_thr = len(thresholds)
    spikes = np.zeros((n_filters, n_time * n_thr), dtype=np.uint8)
    for t_idx, threshold in enumerate(sorted(thresholds, reverse=True)):
        active = np.zeros(n_filters, dtype=bool)
        lower = threshold - gap
        for tb in range(n_time):
            rising = (spec[:, tb] > threshold) & ~active
            falling = (spec[:, tb] < lower) & active
            active[rising] = True
            active[falling] = False
            spikes[:, tb * n_thr + t_idx] = active.astype(np.uint8)
    return spikes
