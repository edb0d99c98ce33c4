"""Constant-memory ridge readout fit from streamed feature batches.

Stage 2+3 at corpus scale (BASELINE configs[4], 100k utterances) without
ever materializing the feature matrix: each streamed batch of reservoir
features updates O(D^2) sufficient statistics on device — a shifted Gram
block, a shifted feature-label cross term, the scaler moments and the
class counts — and one closed-form solve at the end reproduces
`fit_ridge(scaler.transform(X_train), y_train)` (logistic.py:123) to float
tolerance. Host memory stays flat regardless of corpus size; the per-batch
update is one (D, B) x (B, D) matmul fused with the moment reductions,
at the readout's matmul precision (logistic.READOUT_PRECISION).

Numerics: the Gram accumulates around a fixed shift c (the first batch's
mean) instead of raw second moments, so the final centering step
`G - n (mu - c)(mu - c)^T` subtracts a small correction rather than
cancelling two large numbers — the standard shifted-data trick, needed
because reservoir stat features have means far from zero. The scaler mean
IS the train mean, so scaled features are exactly centered and the scaled
Gram / cross term are diagonal rescalings of the centered raw ones.

The same statistics are mesh-ready: feature batches arriving batch-sharded
over a data axis reduce into the replicated accumulator state via XLA
all-reduces under jit (SURVEY.md section 2.4b), exactly like
`fit_ridge_dp`'s psums but spread over the streaming pass.

Reference semantics covered: extract_lsm_features.py:199-201 (scaler fit
on train only) and train_classifier.py:36-41's role as the readout
trainer — the closed-form ridge is the documented fast alternative to the
LBFGS logistic fit, which needs the full matrix and stays the default at
reference scale (pipeline.train_and_evaluate).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from lsm_tpu.readout.logistic import LogisticParams, _mm
from lsm_tpu.readout.scaler import ScalerState


class RidgeAccumState(NamedTuple):
    """Sufficient statistics for a scaled, centered ridge fit.

    shift: (D,) fixed centering point c (first batch's mean).
    gram:  (D, D) sum_i w_i (f_i - c)(f_i - c)^T
    xte:   (D, K) sum_i w_i (f_i - c) e_{y_i}^T
    s1:    (D,)   sum_i w_i (f_i - c)   — SHIFTED first moment
    s2:    (D,)   sum_i w_i (f_i - c)^2 — SHIFTED second moment (the raw
           E[f^2] - mu^2 form catastrophically cancels in f32 for the
           large-mean spike-time features; see scaler.fit_scaler)
    cnt:   (K,)   per-class weighted counts
    n:     ()     sum_i w_i
    """

    shift: jax.Array
    gram: jax.Array
    xte: jax.Array
    s1: jax.Array
    s2: jax.Array
    cnt: jax.Array
    n: jax.Array


def init_ridge_accum(shift: jnp.ndarray, num_classes: int) -> RidgeAccumState:
    d = shift.shape[0]
    f32 = jnp.float32
    return RidgeAccumState(
        shift=jnp.asarray(shift, f32),
        gram=jnp.zeros((d, d), f32),
        xte=jnp.zeros((d, num_classes), f32),
        s1=jnp.zeros((d,), f32),
        s2=jnp.zeros((d,), f32),
        cnt=jnp.zeros((num_classes,), f32),
        n=jnp.zeros((), f32),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def update_ridge_accum(
    state: RidgeAccumState,
    feats: jnp.ndarray,
    labels: jnp.ndarray,
    weights: jnp.ndarray,
) -> RidgeAccumState:
    """Fold one (B, D) feature batch into the accumulator.

    `weights` (0/1 float) masks padded rows; the state buffers are donated
    so the (D, D) Gram updates in place across the streaming pass.
    """
    f = feats.astype(jnp.float32)
    w = weights.astype(jnp.float32)
    k = state.xte.shape[1]
    y1 = jax.nn.one_hot(labels, k, dtype=jnp.float32)
    fc = f - state.shift[None, :]
    fcw = fc * w[:, None]
    return RidgeAccumState(
        shift=state.shift,
        gram=state.gram + _mm(fcw.T, fc),
        xte=state.xte + _mm(fcw.T, y1),
        s1=state.s1 + jnp.sum(fcw, axis=0),
        s2=state.s2 + jnp.sum(fc * fcw, axis=0),
        cnt=state.cnt + jnp.sum(y1 * w[:, None], axis=0),
        n=state.n + jnp.sum(w),
    )


@functools.partial(jax.jit, static_argnames=("alpha",))
def finalize_ridge(
    state: RidgeAccumState, alpha: float = 1.0
) -> Tuple[LogisticParams, ScalerState]:
    """Closed-form solve: (Z^T Z + alpha I) W = Z^T Yc on scaled features.

    With mu the train mean and s the train std (ddof=0, zero-var -> 1,
    matching scaler.fit_scaler), the scaled features z = (f - mu)/s are
    exactly centered, so fit_ridge's internal centering is the identity
    and its Gram / cross blocks are diagonal rescalings of the centered
    raw accumulators:

        Z^T Z  = D^{-1} (G - n dd^T) D^{-1},   d = mu - c, D = diag(s)
        Z^T Yc = D^{-1} (A - d cnt^T)
        b      = y_mean            (z_mean == 0 kills fit_ridge's x_mean term)
    """
    from lsm_tpu.readout.scaler import fit_scaler_from_moments

    sc = fit_scaler_from_moments(state.s1, state.s2, state.n,
                                 shift=state.shift)
    mu, scale = sc.mean, sc.scale
    delta = state.s1 / state.n            # mu - c, cancellation-free
    gram_c = state.gram - state.n * jnp.outer(delta, delta)
    xte_c = state.xte - jnp.outer(delta, state.cnt)
    d = mu.shape[0]
    inv_s = 1.0 / scale
    gram_z = gram_c * jnp.outer(inv_s, inv_s) + alpha * jnp.eye(
        d, dtype=jnp.float32
    )
    xte_z = xte_c * inv_s[:, None]
    y_mean = state.cnt / state.n
    w = jax.scipy.linalg.solve(gram_z, xte_z, assume_a="pos")
    return (
        LogisticParams(w=w, b=y_mean),
        ScalerState(mean=mu, scale=scale),
    )
