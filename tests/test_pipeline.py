"""End-to-end pipeline test on a small synthetic corpus (CPU).

The accuracy oracle here is statistical: a healthy frontend + reservoir +
readout must classify distinct synthetic words far above chance, and the
stage artifacts must round-trip through the reference .npz schemas.
"""

import numpy as np
import pytest

from lsm_tpu.config import FrontendConfig, PipelineConfig, ReservoirConfig
from lsm_tpu.io import artifacts, dataset
from lsm_tpu.pipeline import (
    extract_lsm_features,
    featurize_audio_array,
    run_pipeline_arrays,
    stratified_split,
    train_and_evaluate,
)


def _small_cfg(n_classes=4, filterbank="mel"):
    return PipelineConfig(
        frontend=FrontendConfig(n_filters=32, filterbank=filterbank,
                                gammatone_method="iir"),
        reservoir=ReservoirConfig(
            num_neurons=256,
            num_output_neurons=128,
            small_world_k=50,
            input_fanout=6,
        ),
        feature_set="original",
        commands=tuple(f"class{i}" for i in range(n_classes)),
        batch_size=64,
        test_size=0.25,
    )


def test_stratified_split_is_stratified_and_deterministic(rng):
    x = rng.random((120, 3)).astype(np.float32)
    y = np.repeat(np.arange(4), 30).astype(np.int32)
    x1, xt1, y1, yt1 = stratified_split(x, y, 0.2, 42)
    x2, xt2, y2, yt2 = stratified_split(x, y, 0.2, 42)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(xt1, xt2)
    assert len(yt1) == 24
    for c in range(4):
        assert (yt1 == c).sum() == 6


@pytest.mark.parametrize("counts,test_size,seed", [
    ((200,) * 12, 0.2, 42),          # the flagship synthetic corpus shape
    ((7, 13, 5, 9, 11), 0.2, 42),    # unbalanced: fractional-share ties
    ((3, 3, 4, 10), 0.25, 7),
])
def test_stratified_split_matches_sklearn(counts, test_size, seed):
    """The NumPy split is sklearn's train_test_split(stratify=y) draw for
    draw, so the split does not depend on what is installed."""
    sk = pytest.importorskip("sklearn.model_selection")
    y = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    y = y[np.random.default_rng(seed).permutation(len(y))]
    x = np.arange(len(y) * 2, dtype=np.float32).reshape(len(y), 2)
    got = stratified_split(x, y, test_size, seed)
    want = sk.train_test_split(
        x, y, test_size=test_size, random_state=seed, stratify=y
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.slow
def test_end_to_end_synthetic_accuracy():
    cfg = _small_cfg(n_classes=4)
    audio, labels = dataset.synthetic_audio_batch(
        n_per_class=40, n_classes=4, seed=123
    )
    result, ext = run_pipeline_arrays(cfg, audio, labels)
    # 4 distinct synthetic word classes: far above 25% chance.
    assert result.accuracy > 0.6, f"accuracy too low: {result.accuracy}"
    assert ext.artifact.x_train.shape[1] == 5 * cfg.reservoir.num_output_neurons
    # Standardization: train features ~zero-mean unit-var per dim (where seen).
    mu = ext.artifact.x_train.mean(axis=0)
    assert np.abs(mu).max() < 1e-3


@pytest.mark.slow
def test_stage_artifacts_roundtrip_through_files(tmp_path):
    cfg = _small_cfg(n_classes=3)
    audio, labels = dataset.synthetic_audio_batch(n_per_class=24, n_classes=3, seed=5)
    spikes = featurize_audio_array(cfg, audio)
    ds = artifacts.SpikeDataset(x_spikes=spikes, y_labels=labels)

    p1 = tmp_path / artifacts.SPIKE_DATASET_FILENAME
    artifacts.save_spike_dataset(p1, ds)
    ds2 = artifacts.load_spike_dataset(p1)

    p2 = tmp_path / artifacts.FEATURES_FILENAME
    ext = extract_lsm_features(cfg, ds2, output_path=p2, run_diagnostics=False)
    art = artifacts.load_features(p2)
    result = train_and_evaluate(cfg, art, class_names=cfg.commands)
    assert result.accuracy > 0.5
    assert art.feature_set == "original"


def test_featurize_shapes_and_dtype():
    cfg = _small_cfg()
    audio, labels = dataset.synthetic_audio_batch(n_per_class=3, n_classes=2, seed=9)
    spikes = featurize_audio_array(cfg, audio)
    assert spikes.shape == (6, 32, 400)
    assert spikes.dtype == np.uint8
    assert set(np.unique(spikes)) <= {0, 1}


def test_spikes_to_host_bitpack_roundtrip():
    """The bit-packed D2H path is exact for 0/1 uint8 spikes, including a
    trailing partial batch; T % 8 != 0 falls back to the direct copy."""
    import jax.numpy as jnp

    from lsm_tpu.pipeline import _spikes_to_host

    rng = np.random.default_rng(3)
    spikes = (rng.random((5, 8, 400)) < 0.3).astype(np.uint8)
    dev = jnp.asarray(spikes)
    np.testing.assert_array_equal(_spikes_to_host(dev, 5), spikes)
    np.testing.assert_array_equal(_spikes_to_host(dev, 3), spikes[:3])

    odd = (rng.random((4, 8, 45)) < 0.3).astype(np.uint8)  # 45 % 8 != 0
    np.testing.assert_array_equal(_spikes_to_host(jnp.asarray(odd), 4), odd)


def test_create_spike_dataset_ulaw_wire(tmp_path):
    """audio_wire='ulaw' (--audio-wire): the stage-1 loop ships uint8
    G.711 chunks and the featurizer decodes on device. The output must
    bit-equal featurizing the host-decoded wire (exact oracle), and the
    lossy wire must barely perturb the encoding vs the int16 default."""
    import dataclasses

    from lsm_tpu import pipeline
    from lsm_tpu.io.wav import load_audio_batch
    from lsm_tpu.ops.ulaw import decode_ulaw_reference

    corpus = tmp_path / "corpus"
    cfg = _small_cfg(n_classes=2)
    dataset.write_synthetic_corpus(corpus, cfg.commands, n_per_class=6,
                                   seed=0)
    ds_i = pipeline.create_spike_dataset(cfg, corpus, mesh=None)
    cfg_u = dataclasses.replace(cfg, audio_wire="ulaw")
    ds_u = pipeline.create_spike_dataset(cfg_u, corpus, mesh=None)
    np.testing.assert_array_equal(ds_u.y_labels, ds_i.y_labels)
    assert ds_u.x_spikes.shape == ds_i.x_spikes.shape

    idx = dataset.index_speech_commands(corpus, cfg.commands, 1000)
    wire, kept, _ = load_audio_batch(
        idx.files, cfg.frontend.sample_rate, cfg.frontend.duration,
        dtype="ulaw",
    )
    assert len(kept) == len(idx.files)
    f32 = decode_ulaw_reference(wire).astype(np.float32) / 32768.0
    expected = featurize_audio_array(cfg_u, f32, mesh=None)
    np.testing.assert_array_equal(ds_u.x_spikes, expected)

    frac_flipped = (ds_u.x_spikes != ds_i.x_spikes).mean()
    assert frac_flipped < 0.02, frac_flipped
