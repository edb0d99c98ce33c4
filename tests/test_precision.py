"""The matmul precision each numerically sensitive path states, read off
its jaxpr: a GPU runs f32 matmuls at DEFAULT precision as TF32, so the
paths that need true f32 must ask for it explicitly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lsm_tpu.ops import gammatone as gt
from lsm_tpu.readout import logistic, streaming_fit

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """[(precision, output shape)] of every dot_general, nested jaxprs
    (jit, scan, while) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params["precision"]
            if isinstance(prec, tuple):
                prec = prec[0]
            out.append((prec, tuple(eqn.outvars[0].aval.shape)))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else [v]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out.extend(_dots(getattr(inner, "jaxpr", inner)))
    return out


@pytest.mark.parametrize("fit", ["ridge", "logistic", "stream_accumulate"])
def test_readout_matmuls_run_at_highest(fit):
    x = jnp.asarray(np.random.default_rng(0).random((16, 6)), jnp.float32)
    y = jnp.asarray(np.arange(16) % 3, jnp.int32)
    if fit == "ridge":
        jx = jax.make_jaxpr(lambda a, b: logistic.fit_ridge(a, b, 3))(x, y)
    elif fit == "logistic":
        jx = jax.make_jaxpr(
            lambda a, b: logistic.fit_logistic(a, b, 3, max_iter=2))(x, y)
    else:
        st = streaming_fit.init_ridge_accum(x[0], 3)
        jx = jax.make_jaxpr(streaming_fit.update_ridge_accum)(
            st, x, y, jnp.ones(16))
    dots = _dots(jx.jaxpr)
    assert dots, "no matmul found"
    assert all(p == HIGHEST for p, _ in dots), dots


def test_gammatone_state_path_highest_input_path_default():
    """State propagation (x @ W_xs -> (B, 8C)) at HIGHEST; the energy-only
    input response (x @ W_yx -> (B, g*C)) at DEFAULT (TF32 on a GPU)."""
    B, C, g, n_sub = 2, 8, 80, 3
    blocks = jnp.zeros((n_sub, B, g), jnp.float32)
    init = jnp.zeros((B, 8, C), jnp.float32)
    jx = jax.make_jaxpr(
        lambda b, s: gt.gtgram_iir_scan(b, s, 16000.0, C, 50.0, g)
    )(blocks, init)
    by_shape = {shape: prec for prec, shape in _dots(jx.jaxpr)}
    assert by_shape[(B, 8 * C)] == HIGHEST
    assert by_shape[(B, g * C)] in (None, jax.lax.Precision.DEFAULT)
