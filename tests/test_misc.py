"""Coverage for sharded artifacts, feature-set variants, heterogeneous leak,
profiling/logging/checkify utilities."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from lsm_tpu.config import FEATURE_SETS, ReservoirConfig, feature_dim
from lsm_tpu.io.sharded import ShardedSpikeDataset, ShardedSpikeDatasetWriter
from lsm_tpu.models import reservoir as res
from lsm_tpu.utils.checks import validate_features_host
from lsm_tpu.utils.logging import MetricLogger
from lsm_tpu.utils.profiling import Profiler


def test_sharded_dataset_roundtrip(tmp_path, rng):
    w = ShardedSpikeDatasetWriter(tmp_path / "ds", shard_size=16)
    all_x, all_y = [], []
    for i in range(5):
        x = (rng.random((10, 4, 8)) < 0.3).astype(np.uint8)
        y = rng.integers(0, 3, 10).astype(np.int32)
        w.append(x, y)
        all_x.append(x)
        all_y.append(y)
    manifest = w.close()
    assert manifest["num_samples"] == 50
    # 50 samples at shard_size 16 -> shards of 16,16,16,2.
    assert [s["num_samples"] for s in manifest["shards"]] == [16, 16, 16, 2]

    ds = ShardedSpikeDataset(tmp_path / "ds")
    assert ds.num_samples == 50
    full = ds.load_all()
    np.testing.assert_array_equal(full.x_spikes, np.concatenate(all_x))
    np.testing.assert_array_equal(full.y_labels, np.concatenate(all_y))

    # Re-chunked batches preserve order and content.
    batches = list(ds.iter_batches(12))
    assert [b.x_spikes.shape[0] for b in batches] == [12, 12, 12, 12, 2]
    np.testing.assert_array_equal(
        np.concatenate([b.x_spikes for b in batches]), full.x_spikes
    )


def test_all_feature_sets_dims(rng):
    cfg = ReservoirConfig(
        num_neurons=64, num_output_neurons=32, small_world_k=16,
        mean_weight=0.05, input_fanout=4,
    )
    params = res.init_reservoir(cfg, n_channels=8)
    spikes = jnp.asarray((rng.random((3, 8, 40)) < 0.2).astype(np.uint8))
    for name, keys in FEATURE_SETS.items():
        feats = res.extract_features_batch(params, spikes, tuple(keys))
        assert feats.shape == (3, feature_dim(name, 32)), name
        assert np.isfinite(np.asarray(feats)).all()


def test_heterogeneous_leak():
    cfg = ReservoirConfig(
        num_neurons=128, num_output_neurons=32, small_world_k=16,
        mean_weight=0.02, leak_variance_divisor=4.0,
    )
    params = res.init_reservoir(cfg, n_channels=8)
    leak = np.asarray(params.leak)[:128]
    assert leak.std() > 0  # heterogeneous
    assert np.all((leak >= 0) & (leak <= 1))
    # Mean close to the base coefficient.
    assert abs(leak.mean() - cfg.leak_coefficient) < cfg.leak_coefficient


def test_profiler_and_metric_logger(tmp_path):
    prof = Profiler()
    with prof.stage("demo", items=10):
        _ = sum(range(1000))
    rep = prof.report()
    assert "demo" in rep

    import io

    buf = io.StringIO()
    m = MetricLogger(stream=buf, path=str(tmp_path / "metrics.jsonl"))
    m.emit("accuracy", 0.5, split="test")
    m.close()
    rec = json.loads(buf.getvalue())
    assert rec["metric"] == "accuracy" and rec["split"] == "test"
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 1


def test_validate_features_host():
    ok, _ = validate_features_host(np.random.default_rng(0).random((4, 8)))
    assert ok
    bad = np.zeros((4, 8))
    ok, msg = validate_features_host(bad)
    assert not ok and "constant" in msg
    nan = np.full((2, 2), np.nan)
    ok, msg = validate_features_host(nan)
    assert not ok and "non-finite" in msg


def test_enable_compile_cache_configures_jax(tmp_path, monkeypatch):
    """enable_compile_cache honours JAX_COMPILATION_CACHE_DIR (and creates
    it); LSM_TPU_NO_CACHE=1 makes it a no-op."""
    import jax

    from lsm_tpu.cli.common import enable_compile_cache

    prev = jax.config.jax_compilation_cache_dir
    try:
        cache = tmp_path / "cc"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
        monkeypatch.delenv("LSM_TPU_NO_CACHE", raising=False)
        enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(cache)
        assert cache.is_dir()

        other = tmp_path / "other"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(other))
        monkeypatch.setenv("LSM_TPU_NO_CACHE", "1")
        enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(cache)  # unchanged
        assert not other.exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is <checkout>/.jax_cache
    — the same path in every process (the path is part of the cache key),
    and ignored by git. The retired LSM_TPU_CACHE_DIR has no effect."""
    import subprocess
    from pathlib import Path

    from lsm_tpu.cli.common import compile_cache_dir

    repo = Path(__file__).resolve().parents[1]
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("LSM_TPU_CACHE_DIR", "/nonexistent/elsewhere")
    assert compile_cache_dir() == str(repo / ".jax_cache")
    assert compile_cache_dir() == compile_cache_dir()
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", ".jax_cache/x"], cwd=repo
    ).returncode
    assert ignored in (0, 128)   # 128: not a git checkout (nothing to ignore)


def test_cli_subprocess_honors_jax_platforms(tmp_path):
    """A CLI-style subprocess with JAX_PLATFORMS=cpu lands on the CPU
    backend: the CLI process setup (setup_logging -> distributed join +
    compile cache) must not initialize or pin a backend of its own."""
    import os
    import subprocess
    import sys

    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    prev = env.get("PYTHONPATH")
    env["PYTHONPATH"] = repo + (os.pathsep + prev if prev else "")
    r = subprocess.run(
        [sys.executable, "-c",
         "from lsm_tpu.cli.common import setup_logging; setup_logging(); "
         "import jax; print('backend=' + jax.default_backend())"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend=cpu" in r.stdout


def test_sweep_regime_grid():
    """sweep_regime covers the (fanout, weight, variance, multiplier) grid
    and classifies regimes with the diagnostics thresholds; extreme
    multipliers must bracket the participation range."""
    from lsm_tpu.config import ReservoirConfig
    from lsm_tpu.models.sweep import sweep_regime

    rng = np.random.default_rng(0)
    spikes = (rng.random((8, 16, 40)) < 0.2).astype(np.uint8)
    cfg = ReservoirConfig(
        num_neurons=128, num_output_neurons=64, small_world_k=26,
        input_fanout=4,
    )
    pts = sweep_regime(
        spikes, cfg,
        input_fanouts=[4], input_weights=[1.0], weight_variances=[10.0],
        multipliers=[0.05, 3.0], n_probe=4,
    )
    assert len(pts) == 2
    lo, hi = pts
    assert lo.participation <= hi.participation
    assert all(
        p.regime in ("SUB-CRITICAL", "EDGE OF CHAOS", "SUPER-CRITICAL")
        for p in pts
    )
    assert hi.spikes_per_neuron > 0
