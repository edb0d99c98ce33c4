"""Block-sparse reservoir (models/sparse.py) correctness.

The sparse path must be EXACTLY the dense LIF dynamics on the densified
weight matrix: we snap weights to a dyadic grid (all f32 sums then exact
regardless of summation order) and require bit-equal features between
`extract_features_sparse` and the dense `extract_features_batch` on
densify(params). Structure properties (out-degree, block count, band)
are checked directly on the generated blocks.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
from lsm_tpu.models import reservoir as res
from lsm_tpu.models import sparse
from lsm_tpu.oracles import quantize_dyadic as _quantize

KEYS = tuple(FEATURE_SETS["all"])


def _cfg(n=512, k=102, **kw):
    kw.setdefault("num_output_neurons", 128)
    kw.setdefault("mean_weight", 0.02)
    kw.setdefault("input_fanout", 6)
    return ReservoirConfig(
        num_neurons=n, small_world_k=k, **kw
    )


def test_rejects_non_multiple_of_block():
    with pytest.raises(ValueError):
        sparse.init_reservoir_sparse(_cfg(n=1000, k=200), n_channels=32)


def test_structure_out_degree_and_blocks():
    cfg = _cfg(n=512, k=102, sparse_partner_blocks=2, seed=7)
    params = sparse.init_reservoir_sparse(cfg, n_channels=32)
    nb = 512 // sparse.BLOCK
    half = cfg.small_world_k // 2
    assert params.n_band == (sparse.BLOCK - 1 + half) // sparse.BLOCK + 1
    S = params.n_band + cfg.sparse_partner_blocks
    assert params.w_blocks.shape == (nb, S, sparse.BLOCK, sparse.BLOCK)
    assert params.src_idx.shape == (nb, S)

    # Band slots reference ring-predecessor blocks.
    src_idx = np.asarray(params.src_idx)
    for d in range(params.n_band):
        np.testing.assert_array_equal(
            src_idx[:, d], (np.arange(nb) - d) % nb
        )
    # Partner slots are permutations: every block appears exactly once per r.
    for s in range(params.n_band, S):
        assert sorted(src_idx[:, s]) == list(range(nb))

    dense = sparse.densify(params)
    w = np.asarray(dense.w_rec)
    # No self-loops (abs: a negative-weight self-loop must also fail).
    assert np.abs(np.diagonal(w)).max() == 0.0
    # Out-degree: exactly k/2 out-edges per neuron up to rare collisions.
    out_deg = (w != 0).sum(axis=1)
    assert (out_deg <= half).all()
    assert out_deg.min() >= half - 5
    assert out_deg.mean() > half - 1
    # Weight distribution: mean/std follow the config (statistical contract).
    vals = w[w != 0]
    std = abs(cfg.mean_weight) * np.sqrt(cfg.weight_variance)
    assert abs(vals.mean() - cfg.mean_weight) < 3 * std / np.sqrt(len(vals)) * 5
    assert abs(vals.std() - std) / std < 0.05


def test_sparse_matches_densified_dense_bitwise(rng):
    """The block-sparse scan on W_sparse == the dense scan on densify(W):
    same spikes, same features, bit-for-bit (dyadic weights, f32)."""
    cfg = _cfg(n=384, k=76, sparse_partner_blocks=2, seed=3)
    params = _quantize(sparse.init_reservoir_sparse(cfg, n_channels=32))
    dense_params = sparse.densify(params)

    spikes = (rng.random((5, 32, 40)) < 0.15).astype(np.uint8)
    f_sparse = np.asarray(
        sparse.extract_features_sparse(
            params, jnp.asarray(spikes), KEYS, matmul_dtype=None
        )
    )
    f_dense = np.asarray(
        res.extract_features_batch(
            dense_params, jnp.asarray(spikes), KEYS, matmul_dtype=None
        )
    )
    np.testing.assert_array_equal(f_sparse, f_dense)
    assert f_sparse[:, : params.n_outputs].sum() > 0  # actually fired


def test_model_sharded_sparse_matches_single_device(rng):
    """TP block-sparse (2x4 CPU mesh) == single-device sparse, bit-equal
    under dyadic weights (same per-dst-block contraction, f32)."""
    from lsm_tpu.parallel import mesh as meshlib
    from lsm_tpu.parallel.sharded import extract_features_model_sharded_sparse

    cfg = _cfg(n=512, k=102, sparse_partner_blocks=2, seed=5)
    params = _quantize(sparse.init_reservoir_sparse(cfg, n_channels=32))
    spikes = (rng.random((8, 32, 40)) < 0.15).astype(np.uint8)

    single = np.asarray(
        sparse.extract_features_sparse(
            params, jnp.asarray(spikes), KEYS, matmul_dtype=None
        )
    )
    m = meshlib.make_mesh(n_data=2, n_model=4)
    tp = np.asarray(
        extract_features_model_sharded_sparse(
            params, jnp.asarray(spikes), KEYS, m, matmul_dtype=None
        )
    )
    # Spike dynamics must agree BIT-EXACTLY (dyadic weights): counts and
    # every time-derived feature are integers/exact sums. The two variance
    # features go through an x2-mean - mean^2 epilogue whose FMA
    # contraction differs between the two compiled programs -> 1e-6-level
    # float noise is expected there.
    no = params.n_outputs
    exact = [0, 2, 3, 4, 5, 7]  # counts, times, mean_isi, bursts
    for i in exact:
        np.testing.assert_array_equal(
            tp[:, i * no : (i + 1) * no], single[:, i * no : (i + 1) * no]
        )
    np.testing.assert_allclose(tp, single, rtol=1e-4, atol=1e-5)


def test_sparse_model_bundle_roundtrip(tmp_path, rng):
    """save_model/load_model must carry the block-sparse representation
    (a scaled-reservoir training run saves AFTER hours of work)."""
    from lsm_tpu.config import FrontendConfig
    from lsm_tpu.io import model as model_io
    from lsm_tpu.readout.logistic import LogisticParams
    from lsm_tpu.readout.scaler import ScalerState

    cfg = _cfg(n=512, k=102, sparse_partner_blocks=2, seed=5)
    params = sparse.init_reservoir_sparse(cfg, n_channels=32)
    d = 5 * params.n_outputs
    path = tmp_path / "m.npz"
    model_io.save_model(
        path,
        params,
        LogisticParams(w=jnp.zeros((d, 4)), b=jnp.zeros((4,))),
        ScalerState(mean=jnp.zeros((d,)), scale=jnp.ones((d,))),
        FrontendConfig(n_filters=32),
        "original",
        ("a", "b", "c", "d"),
    )
    bundle = model_io.load_model(path)
    assert isinstance(bundle.reservoir, sparse.SparseReservoirParams)
    assert bundle.reservoir.n_band == params.n_band
    np.testing.assert_array_equal(
        np.asarray(bundle.reservoir.w_blocks), np.asarray(params.w_blocks)
    )
    np.testing.assert_array_equal(
        np.asarray(bundle.reservoir.src_idx), np.asarray(params.src_idx)
    )

    # And the loaded params drive the extractor identically.
    spikes = (rng.random((3, 32, 40)) < 0.15).astype(np.uint8)
    a = np.asarray(
        sparse.extract_features_sparse(params, jnp.asarray(spikes), KEYS)
    )
    b = np.asarray(
        sparse.extract_features_sparse(
            bundle.reservoir, jnp.asarray(spikes), KEYS
        )
    )
    np.testing.assert_array_equal(a, b)


def test_pipeline_extract_dispatches_sparse(rng):
    """Stage-2 pipeline wiring: cfg.reservoir.use_sparse() routes init +
    extraction + diagnostics through the block-sparse path end-to-end."""
    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig, ReservoirConfig
    from lsm_tpu.io import artifacts

    rcfg = ReservoirConfig(
        num_neurons=512, num_output_neurons=128, small_world_k=102,
        sparse=True, input_fanout=6,
    )
    cfg = PipelineConfig(reservoir=rcfg, feature_set="original", batch_size=8)
    x = (rng.random((40, 32, 40)) < 0.15).astype(np.uint8)
    y = (np.arange(40) % 4).astype(np.int32)
    ds = artifacts.SpikeDataset(x_spikes=x, y_labels=y)

    ext = pipeline.extract_lsm_features(cfg, ds, mesh=None)
    art = ext.artifact
    assert art.x_train.shape == (32, 5 * 128)
    assert art.x_test.shape == (8, 5 * 128)
    assert np.isfinite(art.x_train).all() and np.isfinite(art.x_test).all()
    assert ext.diagnostics is not None       # diagnostics ran on sparse params
    from lsm_tpu.models.sparse import SparseReservoirParams

    assert isinstance(ext.params, SparseReservoirParams)


def test_extract_features_dp_sparse_matches_single(rng):
    """The production DP shard_map path accepts sparse params and equals
    the single-device sparse dispatcher."""
    from lsm_tpu.parallel import mesh as meshlib
    from lsm_tpu.parallel.sharded import extract_features_dp
    from lsm_tpu.models import reservoir as res_mod

    cfg = _cfg(n=512, k=102, sparse_partner_blocks=2, seed=13)
    params = sparse.init_reservoir_sparse(cfg, n_channels=32)
    spikes = (rng.random((16, 32, 40)) < 0.15).astype(np.uint8)

    single = np.asarray(
        res_mod.extract_features(params, jnp.asarray(spikes), KEYS)
    )
    m = meshlib.make_mesh(n_data=8, n_model=1)
    dp = np.asarray(
        extract_features_dp(params, jnp.asarray(spikes), KEYS, m)
    )
    np.testing.assert_allclose(dp, single, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sparse_accuracy_parity_with_dense_on_hard_benchmark():
    """The partner-block topology's END-TO-END accuracy must match the
    dense uniform-rewiring generator at equal N on the frozen hard
    benchmark with matched calibration (VERDICT r2 weak #7 — the one
    sparse-path deviation whose effect was unquantified). Measured
    2026-08-17 at N=1024: dense 0.8333, sparse 0.8333, both EDGE OF
    CHAOS (and at N=4096 — see docs/SENSITIVITY.md). The 0.15
    tolerance is ~2.3 SE of an accuracy difference at the 72-sample eval
    split."""
    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig
    from lsm_tpu.io import artifacts, dataset

    audio, labels = dataset.synthetic_audio_batch_hard(
        n_per_class=30, n_classes=12, seed=42
    )
    base = ReservoirConfig(
        num_neurons=1024, num_output_neurons=400, small_world_k=204
    )
    cfg0 = PipelineConfig(reservoir=base, batch_size=64)
    spikes = pipeline.featurize_audio_array(cfg0, audio, mesh=None)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)

    acc = {}
    for sparse_flag in (False, True):
        cfg = PipelineConfig(
            reservoir=dataclasses.replace(base, sparse=sparse_flag),
            batch_size=64,
        )
        ext = pipeline.extract_lsm_features(cfg, ds, mesh=None)
        assert ext.diagnostics.regime == "EDGE OF CHAOS", (
            sparse_flag, ext.diagnostics.regime
        )
        result = pipeline.train_and_evaluate(cfg, ext.artifact, mesh=None)
        acc[sparse_flag] = result.accuracy
        assert 0.66 <= result.accuracy <= 0.95, (sparse_flag, result.accuracy)
    assert abs(acc[True] - acc[False]) <= 0.15, acc


def test_sparse_regime_comparable_to_dense_uniform_rewiring():
    """Block-constrained rewiring must not change the dynamical regime:
    participation within a few points of the dense generator at the same
    config (the statistical acceptance contract, SURVEY.md 2.3)."""
    from lsm_tpu.models.diagnostics import run_network_diagnostics

    rng = np.random.default_rng(0)
    spikes = (rng.random((5, 32, 60)) < 0.12).astype(np.uint8)
    cfg = _cfg(n=512, k=102, mean_weight=0.015, seed=11)

    params_s = sparse.init_reservoir_sparse(cfg, n_channels=32)
    rep_s = run_network_diagnostics(sparse.densify(params_s), spikes)

    params_d = res.init_reservoir(cfg, n_channels=32, device_init=True)
    rep_d = run_network_diagnostics(params_d, spikes)

    assert abs(rep_s.avg_participation - rep_d.avg_participation) < 15.0


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_extract_features_is_the_xla_scan_on_every_backend(
    rng, monkeypatch, backend, kind
):
    """No backend gate: whatever backend JAX reports, extract_features
    (and the sparse extractor it dispatches to) traces the plain XLA
    scan — no custom kernel call — and returns the scan's features."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if kind == "dense":
        params = res.init_reservoir(
            _cfg(n=256, k=52, mean_weight=0.05), n_channels=16)
        direct = res.extract_features_batch
    else:
        params = sparse.init_reservoir_sparse(
            _cfg(n=256, k=52, sparse_partner_blocks=1), n_channels=16)
        direct = sparse.extract_features_sparse
    spikes = jnp.asarray((rng.random((3, 16, 40)) < 0.2).astype(np.uint8))
    jaxpr = str(jax.make_jaxpr(
        lambda p, s: res.extract_features.__wrapped__(p, s, KEYS)
    )(params, spikes))
    assert "scan" in jaxpr
    assert "pallas_call" not in jaxpr and "custom_call" not in jaxpr
    np.testing.assert_array_equal(
        np.asarray(res.extract_features(params, spikes, KEYS)),
        np.asarray(direct(params, spikes, KEYS)),
    )
