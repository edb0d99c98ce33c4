"""Reservoir tests: LIF dynamics vs. a sequential NumPy oracle, streaming
feature statistics vs. direct computation on the raster, topology checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from lsm_tpu.config import ReservoirConfig, FEATURE_SETS
from lsm_tpu.models import reservoir as res
from lsm_tpu.models.calibration import calibrate_weight, w_critico
from lsm_tpu.models.diagnostics import run_network_diagnostics
from lsm_tpu.oracles import lif_raster as _numpy_lif_raster
from lsm_tpu.oracles import quantize_dyadic as _quantize


def _small_params(seed=42, n=64, no=16, c=8):
    cfg = ReservoirConfig(
        num_neurons=n,
        num_output_neurons=no,
        small_world_k=16,
        mean_weight=0.05,
        weight_variance=10.0,
        input_fanout=4,
        input_weight=1.0,
        seed=seed,
    )
    return cfg, _quantize(res.init_reservoir(cfg, n_channels=c))


def test_watts_strogatz_degree_and_no_self_loops(rng):
    adj = res.watts_strogatz_adjacency(100, 20, 0.1, rng)
    assert adj.shape == (100, 100)
    assert not adj.diagonal().any()
    # Directed graph: out-degree = k/2 (up to rewiring collisions), and the
    # expected in-degree matches. beta = k/2 is the mean-field fan-in.
    out_deg = adj.sum(axis=1)
    in_deg = adj.sum(axis=0)
    assert 8 <= out_deg.mean() <= 10.0
    assert abs(in_deg.mean() - out_deg.mean()) < 1e-9
    # Rewiring makes it asymmetric (a symmetric draw is astronomically rare).
    assert not (adj == adj.T).all()


def test_simulate_matches_numpy_oracle():
    cfg, params = _small_params()
    rng = np.random.default_rng(0)
    spikes_in = (rng.random((3, 8, 40)) < 0.2).astype(np.uint8)

    stats = res.simulate_batch(params, jnp.asarray(spikes_in))
    for b in range(3):
        raster = _numpy_lif_raster(params, spikes_in[b])
        counts = raster.sum(axis=0)
        np.testing.assert_array_equal(
            np.asarray(stats["all_counts"])[b], counts[: params.n_neurons]
        )
        out = raster[:, : params.n_outputs]
        np.testing.assert_array_equal(
            np.asarray(stats["counts"])[b], out.sum(axis=0)
        )
        # Spike-time sums per output neuron.
        ts = np.arange(40)[:, None]
        np.testing.assert_allclose(
            np.asarray(stats["sum_t"])[b], (out * ts).sum(axis=0), rtol=1e-6
        )


def test_feature_stats_match_direct_computation():
    cfg, params = _small_params()
    rng = np.random.default_rng(1)
    spikes_in = (rng.random((2, 8, 40)) < 0.25).astype(np.uint8)
    stats = res.simulate_batch(params, jnp.asarray(spikes_in))
    feats = np.asarray(
        res.features_from_stats(stats, tuple(FEATURE_SETS["all"]))
    )
    no = params.n_outputs
    assert feats.shape == (2, 8 * no)

    for b in range(2):
        raster = _numpy_lif_raster(params, spikes_in[b])[:, :no]  # (T, no)
        for n in range(no):
            times = np.nonzero(raster[:, n])[0]
            got = {
                key: feats[b, i * no + n]
                for i, key in enumerate(FEATURE_SETS["all"])
            }
            assert got["spike_counts"] == len(times)
            if len(times) == 0:
                assert got["mean_spike_times"] == 0
                assert got["first_spike_times"] == 0
                assert got["last_spike_times"] == 0
                assert got["mean_isi"] == 0
                assert got["isi_variances"] == 0
                assert got["burst_counts"] == 0
                continue
            np.testing.assert_allclose(
                got["mean_spike_times"], times.mean(), rtol=1e-5
            )
            assert got["first_spike_times"] == times[0]
            assert got["last_spike_times"] == times[-1]
            isis = np.diff(times)
            if len(isis) == 0:
                assert got["mean_isi"] == 0
            else:
                np.testing.assert_allclose(got["mean_isi"], isis.mean(), rtol=1e-5)
                np.testing.assert_allclose(
                    got["isi_variances"], isis.var(), rtol=1e-4, atol=1e-4
                )
                assert got["burst_counts"] == int(
                    (isis <= params.burst_isi_max).sum()
                )
            # Windowed rate variance.
            win_len = 40 // params.n_rate_windows
            wcounts = raster[:, n].reshape(params.n_rate_windows, win_len).sum(1)
            np.testing.assert_allclose(
                got["spike_variances"], wcounts.var(), rtol=1e-5, atol=1e-6
            )


def test_refractory_period_enforced():
    # Single neuron net, huge input: must spike then stay silent for
    # exactly `refractory` steps.
    cfg = ReservoirConfig(
        num_neurons=1, num_output_neurons=1, small_world_k=0, mean_weight=0.0,
        input_fanout=1, input_weight=1.0, refractory_period=2,
        membrane_threshold=1.0,
    )
    params = res.init_reservoir(cfg, n_channels=1)
    # Constant strong input: w_in = 1.0, threshold 1.0 -> spikes at t=0 then
    # refractory 2 steps (t=1, 2), spike again t=3, ...
    spikes_in = np.ones((1, 1, 12), np.uint8)
    stats = res.simulate_batch(params, jnp.asarray(spikes_in))
    assert float(stats["counts"][0, 0]) == 4  # t = 0, 3, 6, 9


def test_w_critico_formula_matches_reference():
    cfg = ReservoirConfig()
    # avg rate 0.1: (2.0 - 2*0.1*2) / (200/2) = 1.6 / 100 = 0.016
    assert abs(w_critico(cfg, 0.1) - 0.016) < 1e-12
    # Degenerate beta.
    cfg0 = ReservoirConfig(small_world_k=0)
    assert w_critico(cfg0, 0.1) == 0.007


def test_calibrate_weight_on_synthetic():
    cfg = ReservoirConfig()
    rng = np.random.default_rng(3)
    spikes = (rng.random((20, 8, 40)) < 0.1).astype(np.uint8)
    wc, w = calibrate_weight(cfg, jnp.asarray(spikes), multiplier=0.6)
    rate = spikes.mean()
    expected = (2.0 - 2 * rate * 2) / 100.0
    np.testing.assert_allclose(wc, expected, rtol=1e-4)
    np.testing.assert_allclose(w, expected * 0.6, rtol=1e-4)


def test_diagnostics_regimes():
    cfg, params = _small_params()
    rng = np.random.default_rng(4)
    # Dense input -> plenty of activity.
    spikes = (rng.random((5, 8, 40)) < 0.5).astype(np.uint8)
    report = run_network_diagnostics(params, spikes)
    assert len(report.participation) == 5
    assert report.regime in ("SUB-CRITICAL", "SUPER-CRITICAL", "EDGE OF CHAOS")
    text = report.render()
    assert "DIAGNOSTIC" in text and "Participation" in text

    # Zero input -> fully dead -> sub-critical.
    silent = np.zeros((5, 8, 40), np.uint8)
    report2 = run_network_diagnostics(params, silent)
    assert report2.avg_participation == 0.0
    assert report2.regime == "SUB-CRITICAL"
