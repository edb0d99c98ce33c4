"""Multinomial logistic regression readout, trained on device with L-BFGS.

On-device replacement for the reference's
`sklearn.LogisticRegression(multi_class="multinomial", max_iter=1000)` fit
(train_classifier.py:36-41). sklearn's lbfgs solver minimizes

    0.5 * ||W||^2 + C * sum_i CE(softmax(x_i W + b), y_i)

with the intercept unpenalized; we minimize the same objective scaled by
1/(C*N) (same argmin) using `optax.lbfgs` with zoom line search, full-batch
gradients on device.

Data-parallel fits (SURVEY.md section 2.4b, reference
train_classifier.py:36-41 semantics): `fit_logistic_dp` runs the same LBFGS
loop on a batch-sharded feature matrix — the per-example CE terms live on
their shards and XLA lowers the loss/gradient batch reductions to psums
over the mesh 'data' axis; `fit_ridge_dp` is an explicit shard_map whose
Gram/XtY blocks are `jax.lax.psum`-reduced over the data axis before a
replicated solve. Both match their single-device counterparts to float
tolerance (tests/test_readout_dp.py).

Also provides a closed-form one-hot ridge readout (normal equations solved
on device) as a fast alternative.

Precision: every readout matmul runs at READOUT_PRECISION (HIGHEST, true
f32). The ridge Gram X^T X squares the features' condition number, and
at DEFAULT precision a GPU runs f32 matmuls as TF32 (~3 decimal digits);
the L-BFGS loss/gradient matmuls use the same setting so a fit on the
card agrees with the same fit on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


READOUT_PRECISION = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=READOUT_PRECISION)


class LogisticParams(NamedTuple):
    w: jax.Array   # (D, K)
    b: jax.Array   # (K,)


def _loss_fn(
    params: LogisticParams,
    x: jnp.ndarray,
    y: jnp.ndarray,
    l2: float,
    weights: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Weighted mean CE + L2/N. `weights` (0/1) masks padded rows so a
    batch padded up to the shard multiple optimizes the unpadded objective."""
    logits = _mm(x, params.w) + params.b
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    if weights is None:
        n_eff = jnp.float32(x.shape[0])
        ce_mean = ce.mean()
    else:
        n_eff = jnp.sum(weights)
        ce_mean = jnp.sum(ce * weights) / n_eff
    reg = 0.5 * l2 * jnp.sum(params.w * params.w) / n_eff
    return ce_mean + reg


@functools.partial(jax.jit, static_argnames=("num_classes", "max_iter"))
def fit_logistic(
    x: jnp.ndarray,
    y: jnp.ndarray,
    num_classes: int,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-5,
    weights: Optional[jnp.ndarray] = None,
) -> Tuple[LogisticParams, jnp.ndarray]:
    """Full-batch L-BFGS fit. x: (N, D) float32, y: (N,) int32.

    Returns (params, n_iters_used).
    """
    d = x.shape[1]
    # sklearn objective scaled by 1/(C*N): CE mean + (0.5/C) ||W||^2 / N.
    # _loss_fn divides the reg term by N, so pass l2 = 1/C.
    l2 = 1.0 / l2_c

    params = LogisticParams(
        w=jnp.zeros((d, num_classes), jnp.float32),
        b=jnp.zeros((num_classes,), jnp.float32),
    )
    loss = functools.partial(_loss_fn, x=x, y=y, l2=l2, weights=weights)

    opt = optax.lbfgs()
    state = opt.init(params)
    value_and_grad = optax.value_and_grad_from_state(loss)

    def cond(carry):
        params, state, it, gnorm = carry
        return jnp.logical_and(it < max_iter, gnorm > tol)

    def body(carry):
        params, state, it, _ = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(
            grad, state, params, value=value, grad=grad, value_fn=loss
        )
        params = optax.apply_updates(params, updates)
        gnorm = optax.global_norm(grad)
        return params, state, it + 1, gnorm

    params, state, iters, _ = jax.lax.while_loop(
        cond, body, (params, state, jnp.asarray(0), jnp.asarray(jnp.inf))
    )
    return params, iters


def predict_logits(params: LogisticParams, x: jnp.ndarray) -> jnp.ndarray:
    return _mm(x, params.w) + params.b


def predict(params: LogisticParams, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.argmax(predict_logits(params, x), axis=-1)


@functools.partial(jax.jit, static_argnames=("num_classes",))
def fit_ridge(
    x: jnp.ndarray, y: jnp.ndarray, num_classes: int, alpha: float = 1.0
) -> LogisticParams:
    """Closed-form one-hot ridge readout via normal equations.

    Solves (X^T X + alpha I) W = X^T Y_onehot with centered features; the
    Gram matrix is a single (D, N) x (N, D) matmul and, under
    shard_map, a psum over batch shards (SURVEY.md section 2.4b).
    """
    n, d = x.shape
    y1 = jax.nn.one_hot(y, num_classes, dtype=jnp.float32)
    x_mean = x.mean(axis=0, keepdims=True)
    y_mean = y1.mean(axis=0, keepdims=True)
    xc = x - x_mean
    yc = y1 - y_mean
    gram = _mm(xc.T, xc) + alpha * jnp.eye(d, dtype=jnp.float32)
    xty = _mm(xc.T, yc)
    w = jax.scipy.linalg.solve(gram, xty, assume_a="pos")
    b = (y_mean - _mm(x_mean, w))[0]
    return LogisticParams(w=w, b=b)


# ---------------------------------------------------------------------------
# Data-parallel fits over a device mesh (SURVEY.md section 2.4b)
# ---------------------------------------------------------------------------

def _pad_for_mesh(
    x: np.ndarray, y: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad the batch to a shard multiple; weight 0 marks padded rows."""
    from lsm_tpu.parallel.mesh import pad_to_multiple

    x, n = pad_to_multiple(x, n_shards)
    y, _ = pad_to_multiple(y, n_shards)
    w = np.zeros(x.shape[0], np.float32)
    w[:n] = 1.0
    return x, y, w


def fit_logistic_dp(
    x,
    y,
    num_classes: int,
    mesh: Mesh,
    l2_c: float = 1.0,
    max_iter: int = 1000,
    tol: float = 1e-5,
) -> Tuple[LogisticParams, jnp.ndarray]:
    """`fit_logistic` with the example axis sharded over the mesh data axis.

    The per-shard CE/gradient partial sums become XLA all-reduces (psums
    over the device interconnect) inside the compiled LBFGS loop; parameters and optimizer
    state stay replicated. Padded rows carry weight 0, so the optimized
    objective is exactly the single-device one.
    """
    from lsm_tpu.parallel.mesh import DATA_AXIS, shard_host_array

    n_data = mesh.shape[DATA_AXIS]
    xp, yp, wp = _pad_for_mesh(
        np.asarray(x, np.float32), np.asarray(y, np.int32), n_data
    )
    xs = shard_host_array(xp, mesh)
    ys = shard_host_array(yp, mesh)
    ws = shard_host_array(wp, mesh)
    return fit_logistic(
        xs, ys, num_classes, l2_c=l2_c, max_iter=max_iter, tol=tol, weights=ws
    )


def fit_ridge_dp(
    x,
    y,
    num_classes: int,
    mesh: Mesh,
    alpha: float = 1.0,
) -> LogisticParams:
    """Data-parallel closed-form ridge: explicit psum'd Gram/XtY blocks.

    Each shard computes its local centered Gram/XtY contribution; one
    `jax.lax.psum` per block reduces them over the data axis and every
    device solves the replicated (D, D) system. Matches `fit_ridge` on the
    same data to float tolerance.
    """
    from lsm_tpu.parallel.mesh import DATA_AXIS, shard_host_array

    n_data = mesh.shape[DATA_AXIS]
    xp, yp, wp = _pad_for_mesh(
        np.asarray(x, np.float32), np.asarray(y, np.int32), n_data
    )
    fn = _ridge_dp_program(mesh, num_classes, float(alpha))
    w, b = fn(
        shard_host_array(xp, mesh),
        shard_host_array(yp, mesh),
        shard_host_array(wp, mesh),
    )
    return LogisticParams(w=w, b=b)


@functools.lru_cache(maxsize=None)
def _ridge_dp_program(mesh: Mesh, num_classes: int, alpha: float):
    """The jitted shard_map ridge program, cached per (mesh, classes,
    alpha): rebuilding jax.jit(shard_map(...)) inside fit_ridge_dp would
    defeat the trace cache and re-trace (and recompile) on EVERY call —
    calibration sweeps and the tests call it repeatedly. jit's own shape cache handles varying (n, d)."""
    from lsm_tpu.parallel.mesh import DATA_AXIS

    def local_fit(x_l, y_l, w_l):
        y1 = jax.nn.one_hot(y_l, num_classes, dtype=jnp.float32)
        n = jax.lax.psum(jnp.sum(w_l), DATA_AXIS)
        x_mean = jax.lax.psum(
            jnp.sum(x_l * w_l[:, None], axis=0), DATA_AXIS
        )[None, :] / n
        y_mean = jax.lax.psum(
            jnp.sum(y1 * w_l[:, None], axis=0), DATA_AXIS
        )[None, :] / n
        xc = x_l - x_mean
        # Left factor weighted (w_i^2 == w_i), so padded rows contribute 0
        # even though centering makes them nonzero.
        xcw = xc * w_l[:, None]
        gram = jax.lax.psum(_mm(xcw.T, xc), DATA_AXIS)
        gram = gram + alpha * jnp.eye(x_l.shape[1], dtype=jnp.float32)
        xty = jax.lax.psum(_mm(xcw.T, y1 - y_mean), DATA_AXIS)
        w = jax.scipy.linalg.solve(gram, xty, assume_a="pos")
        b = (y_mean - _mm(x_mean, w))[0]
        return w, b

    return jax.jit(shard_map(
        local_fit,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    ))
