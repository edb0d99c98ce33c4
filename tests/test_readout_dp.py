"""Data-parallel readout fits match single-device fits (SURVEY.md 2.4b).

The reference fits one sklearn LogisticRegression on the host
(train_classifier.py:36-41); this build shards the example axis over the
mesh and reduces the loss/gradient (logistic) or Gram/XtY blocks (ridge)
across devices. These tests run on the 8-virtual-device CPU mesh and assert
the distributed fits reproduce the single-device ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsm_tpu.parallel.mesh import auto_mesh, make_mesh
from lsm_tpu.readout import logistic


def _toy_problem(n=257, d=24, k=5, seed=0):
    """Linearly-separable-ish classes; n deliberately NOT divisible by 8."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, (k, d)).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1.0, (n, d)).astype(np.float32)
    return x.astype(np.float32), y


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_data=jax.device_count(), n_model=1)


def test_auto_mesh_spans_all_devices():
    m = auto_mesh()
    assert m is not None
    assert m.shape["data"] == jax.device_count()
    assert m.shape["model"] == 1


def test_fit_logistic_dp_matches_single_device(mesh):
    x, y = _toy_problem()
    p_ref, it_ref = logistic.fit_logistic(
        jnp.asarray(x), jnp.asarray(y), num_classes=5, max_iter=200
    )
    p_dp, it_dp = logistic.fit_logistic_dp(
        x, y, num_classes=5, mesh=mesh, max_iter=200
    )
    # Same convex objective, same optimizer; the two runs stop within the
    # gradient-norm tolerance of the same optimum (reduction order differs),
    # and the predictions agree exactly.
    np.testing.assert_allclose(
        np.asarray(p_dp.w), np.asarray(p_ref.w), rtol=0, atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(p_dp.b), np.asarray(p_ref.b), rtol=0, atol=5e-3
    )
    pred_ref = np.asarray(logistic.predict(p_ref, jnp.asarray(x)))
    pred_dp = np.asarray(logistic.predict(p_dp, jnp.asarray(x)))
    assert (pred_ref == pred_dp).mean() == 1.0


def test_fit_logistic_weights_mask_padding():
    """Zero-weight rows must not affect the optimum."""
    x, y = _toy_problem(n=96)
    pad = np.random.default_rng(1).normal(0, 5, (32, x.shape[1])).astype(np.float32)
    xp = np.concatenate([x, pad])
    yp = np.concatenate([y, np.zeros(32, np.int32)])
    w = np.concatenate([np.ones(96, np.float32), np.zeros(32, np.float32)])
    p_ref, _ = logistic.fit_logistic(
        jnp.asarray(x), jnp.asarray(y), num_classes=5, max_iter=200
    )
    p_w, _ = logistic.fit_logistic(
        jnp.asarray(xp), jnp.asarray(yp), num_classes=5, max_iter=200,
        weights=jnp.asarray(w),
    )
    np.testing.assert_allclose(
        np.asarray(p_w.w), np.asarray(p_ref.w), rtol=0, atol=2e-3
    )


def test_fit_ridge_dp_matches_single_device(mesh):
    x, y = _toy_problem(n=320, d=32, k=4, seed=3)
    p_ref = logistic.fit_ridge(
        jnp.asarray(x), jnp.asarray(y), num_classes=4, alpha=2.0
    )
    p_dp = logistic.fit_ridge_dp(x, y, num_classes=4, mesh=mesh, alpha=2.0)
    np.testing.assert_allclose(
        np.asarray(p_dp.w), np.asarray(p_ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(p_dp.b), np.asarray(p_ref.b), rtol=1e-4, atol=1e-5
    )


def test_fit_ridge_dp_padding_path(mesh):
    """Non-divisible N exercises the weighted (masked) Gram blocks."""
    x, y = _toy_problem(n=101, d=16, k=3, seed=4)
    p_ref = logistic.fit_ridge(
        jnp.asarray(x), jnp.asarray(y), num_classes=3, alpha=1.0
    )
    p_dp = logistic.fit_ridge_dp(x, y, num_classes=3, mesh=mesh, alpha=1.0)
    np.testing.assert_allclose(
        np.asarray(p_dp.w), np.asarray(p_ref.w), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(p_dp.b), np.asarray(p_ref.b), rtol=1e-4, atol=1e-5
    )
