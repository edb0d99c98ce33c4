"""Multi-host runtime path: parallel/mesh.py init_distributed et al.

SURVEY.md sections 2.4/5.8 name collectives across hosts; the test stands
up a REAL 2-process JAX distributed runtime on CPU (2 local devices per
process, gloo collectives standing in for the network) and
runs the production DP extraction + psum'd ridge fit over the global
4-device mesh. Process 0's results must match a single-process reference
computed in this test process — the cross-process collectives reproduce
the unsharded math — and the workers join via the CLI env contract
(LSM_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from lsm_tpu.parallel.mesh import maybe_init_distributed_from_env
    assert maybe_init_distributed_from_env(), "env contract not honored"

    import jax.numpy as jnp
    import numpy as np
    from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.parallel import mesh as meshlib
    from lsm_tpu.parallel.sharded import extract_features_dp
    from lsm_tpu.readout import logistic

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()

    mesh = meshlib.multihost_mesh(n_model=1)
    assert mesh.shape == {"data": 4, "model": 1}
    # n_model=2 layout rule: each TP group stays within one process.
    mesh_tp = meshlib.multihost_mesh(n_model=2)
    for row in mesh_tp.devices:
        assert len({d.process_index for d in row}) == 1, (
            "TP group crosses a process boundary"
        )

    cfg = ReservoirConfig(
        num_neurons=128, num_output_neurons=64, small_world_k=26,
        mean_weight=0.03,
    )
    params = res.init_reservoir(cfg, n_channels=16)
    keys = tuple(FEATURE_SETS["original"])

    # Class-separable spikes (class c fires hot in channel block c): the
    # ridge solution is then well-determined and O(0.1)-scale, so the
    # cross-process comparison is meaningful rather than noise-level.
    rng = np.random.default_rng(7)
    labels_global = (np.arange(32) % 3).astype(np.int32)
    rates = np.full((32, 16, 100), 0.05)
    for i, c in enumerate(labels_global):
        rates[i, c * 5:(c + 1) * 5] = 0.3
    spikes_global = (rng.random((32, 16, 100)) < rates).astype(np.uint8)

    pid = jax.process_index()
    # shard_batch's contract: the FULL batch, identical on every process
    # (the batch-pipeline loaders are deterministic); each process
    # materializes only its addressable shards.
    spikes = meshlib.shard_batch(spikes_global, mesh)
    params_r = meshlib.replicate_to_mesh(params, mesh)
    feats = extract_features_dp(params_r, spikes, keys, mesh)

    # Materialize the full feature matrix on every host: host_local is a
    # cached jitted identity with replicated output sharding — XLA lowers
    # it to an all-gather across the (here cross-process) data axis.
    feats_full = np.asarray(meshlib.host_local(feats))

    ridge = logistic.fit_ridge_dp(
        feats_full, labels_global, num_classes=3, mesh=mesh
    )

    # --- Corpus-scale streaming fit across the 2 processes ---------------
    # extract_and_train_streaming follows the SPMD batch contract (every
    # process iterates the same shards); readout='logistic' additionally
    # holds the streamed feature rows in a GLOBAL data-axis-sharded device
    # buffer (each process stores only its addressable shard) and runs
    # the LBFGS fit as one collective program. Round 5: this lifted the
    # former single-process restriction — the oracle below pins the
    # 2-process fit against an unsharded single-process run.
    from lsm_tpu import pipeline as _pipeline
    from lsm_tpu.config import FrontendConfig, PipelineConfig
    from lsm_tpu.io.sharded import ShardedSpikeDataset

    sf_cfg = PipelineConfig(
        reservoir=ReservoirConfig(
            num_neurons=128, num_output_neurons=64, small_world_k=26,
            mean_weight=0.03,
        ),
        frontend=FrontendConfig(n_filters=16),
        commands=("a", "b", "c"),
        batch_size=16,
    )
    sf = _pipeline.extract_and_train_streaming(
        sf_cfg, ShardedSpikeDataset(sys.argv[2]),
        class_names=["a", "b", "c"], run_diagnostics=False, mesh=mesh,
        readout="logistic", l2_c=1.0, max_iter=60,
    )

    # --- Continuous streaming serving across the 2-process mesh ---------
    # Each process feeds its PROCESS-LOCAL stream rows (4 of 8); logits
    # all-gather back replicated. Round 4: the engines' state/weight
    # placement is process-aware, so an always-on server scales across
    # hosts exactly like the batch stages.
    from lsm_tpu.config import FrontendConfig
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.readout.scaler import ScalerState

    fcfg = FrontendConfig(n_filters=16)
    d = len(FEATURE_SETS["original"]) * params.n_outputs
    ro = logistic.LogisticParams(
        w=jnp.asarray(
            np.random.default_rng(3).normal(0, 0.1, (d, 4)).astype(np.float32)
        ),
        b=jnp.zeros((4,), jnp.float32),
    )
    sc = ScalerState(mean=jnp.zeros((d,), jnp.float32),
                     scale=jnp.ones((d,), jnp.float32))
    kws = ContinuousKWS(
        res.init_reservoir(ReservoirConfig(
            num_neurons=128, num_output_neurons=64, small_world_k=16,
            mean_weight=0.03,
        ), n_channels=16),
        ro, sc, fcfg, "original", n_streams=8, chunk_len=1600, mesh=mesh,
    )
    audio_global = (
        np.random.default_rng(11).standard_normal((8, 3200)) * 0.2
    ).astype(np.float32)
    local = audio_global[pid * 4:(pid + 1) * 4]
    for c in range(2):
        logits_stream = kws.step(local[:, c * 1600:(c + 1) * 1600])
    assert logits_stream.shape == (8, 4), logits_stream.shape

    # Serving-state snapshot: a COLLECTIVE (each leaf all-gathers across
    # the processes), taken on both; process 0 ships it for the oracle
    # to compare against the single-process engine's snapshot.
    snap = kws.snapshot()

    # Row-level extraction across the 2-process mesh: the packed gather
    # (one fused dispatch) pulls streams 5,6 — rows living on process
    # 1's shard — identically on BOTH processes (SPMD collective).
    rows = kws.extract_streams([5, 6])

    # ... and install them into slots 0,1 (process 0's shard): the full
    # cross-process migration path. One more step produces logits whose
    # slots 0,1 must match the oracle's streams 5,6 fed the same audio.
    kws.install_streams([0, 1], rows)
    swap_audio = audio_global.copy()
    swap_audio[[0, 1]] = audio_global[[5, 6]]
    local_swap = swap_audio[pid * 4:(pid + 1) * 4]
    logits_after_install = kws.step(local_swap[:, :1600])

    # Partial-activity ingest across processes: GLOBAL rows/idx identical
    # on every process (replicated placement via shard_host_array — plain
    # device_put cannot reach non-addressable devices). Slots 2 and 6
    # live on different processes' shards.
    act_idx = np.array([2, 6])
    act_rows = (
        np.random.default_rng(13).standard_normal((2, 1600)) * 0.2
    ).astype(np.float32)
    logits_active = kws.step_active(act_rows, act_idx)

    # Live serving diagnostics across processes: the per-stream window
    # count reduction runs on the sharded ring, host_local all-gathers
    # the (B,) results — every process must see the same report.
    diag = kws.diagnostics(stream_idx=np.array([2, 6]))

    # --- Multi-process StreamPool (the session layer is SPMD too) -------
    # Every process runs the SAME admit/step/drain/save/restore sequence;
    # the pool's device calls (step_active with global replicated
    # rows/idx, masked resets, migration, snapshot) are the engines'
    # multi-host collectives. Decisions must match a single-process pool
    # on the merged session set (oracle in the main test).
    from lsm_tpu.models.pool import StreamPool
    from lsm_tpu.models.streaming import StreamingKWS

    def _mk_eng():
        return StreamingKWS(
            res.init_reservoir(ReservoirConfig(
                num_neurons=128, num_output_neurons=64, small_world_k=16,
                mean_weight=0.03,
            ), n_channels=16),
            ro, sc, fcfg, "original", n_streams=4, mesh=mesh,
        )

    pool_a = StreamPool(_mk_eng(), chunk_len=1600)
    pool_b = StreamPool(_mk_eng(), chunk_len=1600)
    sess = ("s0", "s1", "s2")
    for s in sess:
        pool_a.admit(s)
    pool_audio = (
        np.random.default_rng(17).standard_normal((3, 3200)) * 0.2
    ).astype(np.float32)
    h0 = pool_a.step({s: pool_audio[i, :1600] for i, s in enumerate(sess)})
    pool_a.drain(["s1"], pool_b)        # cross-engine row migration
    h1a = pool_a.step({"s0": pool_audio[0, 1600:],
                       "s2": pool_audio[2, 1600:]})
    h1b = pool_b.step({"s1": pool_audio[1, 1600:]})
    # Checkpoint/restore the WHOLE serving unit across the 2 processes:
    # save() snapshots collectively and writes on process 0 only; the
    # barrier keeps process 1 from racing the atomic rename.
    from pathlib import Path as _Path

    ckpt = _Path(sys.argv[1] + ".pool.npz")
    pool_a.save(ckpt, compress=False)
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("pool-ckpt-written")
    pool_a2 = StreamPool.restore(ckpt, _mk_eng())
    assert pool_a2.slot_of("s0") == pool_a.slot_of("s0")
    assert pool_a2.slot_of("s2") == pool_a.slot_of("s2")
    h2 = pool_a2.step({"s0": pool_audio[0, :1600],
                       "s2": pool_audio[2, :1600]})

    def _pool_vec(d, ss):
        return (np.asarray([d[s][0] for s in ss], np.int32),
                np.asarray([d[s][1] for s in ss], np.float32))

    if pid == 0:
        np.savez(
            sys.argv[1],
            sf_acc=sf.accuracy,
            sf_w=np.asarray(sf.readout.w),
            sf_b=np.asarray(sf.readout.b),
            feats=feats_full,
            w=np.asarray(ridge.w), b=np.asarray(ridge.b),
            stream_logits=np.asarray(logits_stream),
            stream_audio=audio_global,
            **{"snap_" + k.replace("seg:", "seg__"): v
               for k, v in snap.items()},
            **{"rows_" + k.replace("seg:", "seg__"): v
               for k, v in rows.items()},
            logits_after_install=np.asarray(logits_after_install),
            logits_active=np.asarray(logits_active),
            diag_part=diag.participation,
            diag_rate=diag.spikes_per_neuron,
            pool_h0_p=_pool_vec(h0, sess)[0],
            pool_h0_m=_pool_vec(h0, sess)[1],
            pool_h1a_p=_pool_vec(h1a, ("s0", "s2"))[0],
            pool_h1a_m=_pool_vec(h1a, ("s0", "s2"))[1],
            pool_h1b_p=_pool_vec(h1b, ("s1",))[0],
            pool_h1b_m=_pool_vec(h1b, ("s1",))[1],
            pool_h2_p=_pool_vec(h2, ("s0", "s2"))[0],
            pool_h2_m=_pool_vec(h2, ("s0", "s2"))[1],
        )
    print(f"worker {pid} done", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_streamfit_corpus(root) -> np.ndarray:
    """Class-separable sharded spike corpus for the cross-process
    streaming-fit case (class c fires hot in channel block c). Returns
    the labels; the shards are deterministic, so the workers and the
    single-process oracle read identical bytes."""
    from lsm_tpu.io.sharded import ShardedSpikeDatasetWriter

    rng = np.random.default_rng(7)
    n = 96
    labels = (np.arange(n) % 3).astype(np.int32)
    rates = np.full((n, 16, 400), 0.03)
    for i, c in enumerate(labels):
        rates[i, c * 5:(c + 1) * 5] = 0.25
    spikes = (rng.random((n, 16, 400)) < rates).astype(np.uint8)
    w = ShardedSpikeDatasetWriter(root, shard_size=24, compress=False)
    w.append(spikes, labels, np.arange(n))
    w.close()
    return labels


def test_two_process_dp_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "proc0.npz"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    sf_corpus = tmp_path / "sf_shards"
    _write_streamfit_corpus(sf_corpus)

    env_base = {
        **os.environ,
        "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
        "LSM_TPU_COORDINATOR": f"localhost:{port}",
        "LSM_TPU_NUM_PROCESSES": "2",
        "LSM_TPU_NO_CACHE": "1",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(out), str(sf_corpus)],
            env={**env_base, "LSM_TPU_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
    assert out.exists(), logs[0]

    # Single-process reference (this test process, plain jit, no mesh).
    import jax.numpy as jnp

    from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.readout import logistic

    cfg = ReservoirConfig(
        num_neurons=128, num_output_neurons=64, small_world_k=26,
        mean_weight=0.03,
    )
    params = res.init_reservoir(cfg, n_channels=16)
    keys = tuple(FEATURE_SETS["original"])
    rng = np.random.default_rng(7)
    labels = (np.arange(32) % 3).astype(np.int32)
    rates = np.full((32, 16, 100), 0.05)
    for i, c in enumerate(labels):
        rates[i, c * 5:(c + 1) * 5] = 0.3
    spikes = (rng.random((32, 16, 100)) < rates).astype(np.uint8)
    feats_ref = np.asarray(
        res.extract_features(params, jnp.asarray(spikes), keys)
    )
    ridge_ref = logistic.fit_ridge(
        jnp.asarray(feats_ref), jnp.asarray(labels), num_classes=3
    )

    got = np.load(out)
    np.testing.assert_allclose(got["feats"], feats_ref, rtol=1e-4, atol=1e-4)
    # The Gram is ill-conditioned (reservoir stats are near-collinear), so
    # elementwise weight equality across different reduction orders is not
    # meaningful — the decision function is. Compare logits and argmax.
    logits_got = feats_ref @ got["w"] + got["b"]
    logits_ref = feats_ref @ np.asarray(ridge_ref.w) + np.asarray(ridge_ref.b)
    np.testing.assert_allclose(logits_got, logits_ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(
        logits_got.argmax(axis=1), logits_ref.argmax(axis=1)
    )
    # The separable construction must actually be learned (sanity that the
    # cross-process fit did real work, not just agreed on garbage).
    assert (logits_ref.argmax(axis=1) == labels).mean() == 1.0

    # Cross-process streamed logistic (feature buffer sharded over the
    # 2 processes, collective LBFGS) must match the unsharded
    # single-process fit on the same shards: same accuracy, same
    # decision function (weight tolerance covers reduction order).
    from lsm_tpu import pipeline as _pipeline
    from lsm_tpu.config import FrontendConfig as _FC, PipelineConfig
    from lsm_tpu.io.sharded import ShardedSpikeDataset

    sf_cfg = PipelineConfig(
        reservoir=ReservoirConfig(
            num_neurons=128, num_output_neurons=64, small_world_k=26,
            mean_weight=0.03,
        ),
        frontend=_FC(n_filters=16),
        commands=("a", "b", "c"),
        batch_size=16,
    )
    sf_ref = _pipeline.extract_and_train_streaming(
        sf_cfg, ShardedSpikeDataset(tmp_path / "sf_shards"),
        class_names=["a", "b", "c"], run_diagnostics=False, mesh=None,
        readout="logistic", l2_c=1.0, max_iter=60,
    )
    assert float(got["sf_acc"]) == pytest.approx(sf_ref.accuracy, abs=1e-6)
    # The separable construction must actually be learned.
    assert sf_ref.accuracy == 1.0
    np.testing.assert_allclose(
        got["sf_w"], np.asarray(sf_ref.readout.w), rtol=5e-2, atol=1e-3,
        err_msg="cross-process streamed logistic weights diverged",
    )
    np.testing.assert_allclose(
        got["sf_b"], np.asarray(sf_ref.readout.b), rtol=5e-2, atol=1e-3,
        err_msg="cross-process streamed logistic bias diverged",
    )

    # Continuous streaming across the 2-process mesh must match a
    # single-process ContinuousKWS on the same audio (same seeds ->
    # same reservoir/readout; tolerance for reduction order).
    from lsm_tpu.config import FrontendConfig
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.readout.scaler import ScalerState

    fcfg = FrontendConfig(n_filters=16)
    d = len(keys) * 64
    ro = logistic.LogisticParams(
        w=jnp.asarray(
            np.random.default_rng(3).normal(0, 0.1, (d, 4)).astype(np.float32)
        ),
        b=jnp.zeros((4,), jnp.float32),
    )
    sc = ScalerState(mean=jnp.zeros((d,), jnp.float32),
                     scale=jnp.ones((d,), jnp.float32))
    kws_ref = ContinuousKWS(
        res.init_reservoir(ReservoirConfig(
            num_neurons=128, num_output_neurons=64, small_world_k=16,
            mean_weight=0.03,
        ), n_channels=16),
        ro, sc, fcfg, "original", n_streams=8, chunk_len=1600,
    )
    audio_global = got["stream_audio"]
    for c in range(2):
        ref_logits = kws_ref.step(audio_global[:, c * 1600:(c + 1) * 1600])
    np.testing.assert_allclose(
        got["stream_logits"], ref_logits, rtol=1e-4, atol=1e-4
    )

    # The cross-process serving-state snapshot (an all-gather collective
    # taken on both workers) must carry the same full per-stream state a
    # single-process engine holds — every ContinuousState leaf.
    snap_ref = kws_ref.snapshot()
    for k, v in snap_ref.items():
        got_leaf = got["snap_" + k.replace("seg:", "seg__")]
        np.testing.assert_allclose(
            got_leaf, np.asarray(v), rtol=1e-4, atol=1e-5,
            err_msg=f"snapshot leaf {k} diverged across processes",
        )

    # Row-level packed extraction of streams 5,6 (rows on process 1's
    # shard) must equal the single-process engine's extraction leaf by
    # leaf — the migration unit is placement-independent.
    rows_ref = kws_ref.extract_streams([5, 6])
    for k, v in rows_ref.items():
        got_rows = got["rows_" + k.replace("seg:", "seg__")]
        np.testing.assert_allclose(
            got_rows, np.asarray(v), rtol=1e-4, atol=1e-5,
            err_msg=f"extracted rows leaf {k} diverged across processes",
        )

    # Full cross-process migration: the worker installed those rows into
    # slots 0,1 and stepped once more; replay the identical swap here.
    kws_ref.install_streams([0, 1], rows_ref)
    swap_audio = audio_global.copy()
    swap_audio[[0, 1]] = audio_global[[5, 6]]
    ref_after = kws_ref.step(swap_audio[:, :1600])
    np.testing.assert_allclose(
        got["logits_after_install"], ref_after, rtol=1e-4, atol=1e-4,
        err_msg="post-install logits diverged across processes",
    )

    # Partial-activity ingest across processes (replicated rows/idx).
    act_rows = (
        np.random.default_rng(13).standard_normal((2, 1600)) * 0.2
    ).astype(np.float32)
    ref_active = kws_ref.step_active(act_rows, np.array([2, 6]))
    np.testing.assert_allclose(
        got["logits_active"], ref_active, rtol=1e-4, atol=1e-4,
        err_msg="step_active diverged across processes",
    )

    # Live diagnostics on the 2-process mesh equals the single-process
    # engine's (integer window counts -> exact equality expected, but
    # allow float tolerance for the count reductions).
    ref_diag = kws_ref.diagnostics(stream_idx=np.array([2, 6]))
    np.testing.assert_allclose(
        got["diag_part"], ref_diag.participation, rtol=1e-6,
        err_msg="serving diagnostics diverged across processes",
    )
    np.testing.assert_allclose(
        got["diag_rate"], ref_diag.spikes_per_neuron, rtol=1e-6,
        err_msg="serving diagnostics rate diverged across processes",
    )

    # Multi-process StreamPool oracle: the identical admit/step/drain/
    # checkpoint/restore sequence on single-device pools must produce the
    # same decisions the 2-process pools did (VERDICT r4 item 4).
    from lsm_tpu.models.pool import StreamPool
    from lsm_tpu.models.streaming import StreamingKWS

    def _mk_eng():
        return StreamingKWS(
            res.init_reservoir(ReservoirConfig(
                num_neurons=128, num_output_neurons=64, small_world_k=16,
                mean_weight=0.03,
            ), n_channels=16),
            ro, sc, fcfg, "original", n_streams=4,
        )

    pool_a = StreamPool(_mk_eng(), chunk_len=1600)
    pool_b = StreamPool(_mk_eng(), chunk_len=1600)
    sess = ("s0", "s1", "s2")
    for s in sess:
        pool_a.admit(s)
    pool_audio = (
        np.random.default_rng(17).standard_normal((3, 3200)) * 0.2
    ).astype(np.float32)
    h0 = pool_a.step({s: pool_audio[i, :1600] for i, s in enumerate(sess)})
    pool_a.drain(["s1"], pool_b)
    h1a = pool_a.step({"s0": pool_audio[0, 1600:],
                       "s2": pool_audio[2, 1600:]})
    h1b = pool_b.step({"s1": pool_audio[1, 1600:]})
    ckpt = tmp_path / "oracle.pool.npz"
    pool_a.save(ckpt, compress=False)
    pool_a2 = StreamPool.restore(ckpt, _mk_eng())
    h2 = pool_a2.step({"s0": pool_audio[0, :1600],
                       "s2": pool_audio[2, :1600]})

    def _pool_vec(d, ss):
        return (np.asarray([d[s][0] for s in ss], np.int32),
                np.asarray([d[s][1] for s in ss], np.float32))

    for name, (ref_d, ss) in {
        "pool_h0": (h0, sess),
        "pool_h1a": (h1a, ("s0", "s2")),
        "pool_h1b": (h1b, ("s1",)),
        "pool_h2": (h2, ("s0", "s2")),
    }.items():
        p_ref, m_ref = _pool_vec(ref_d, ss)
        np.testing.assert_array_equal(
            got[f"{name}_p"], p_ref,
            err_msg=f"{name} predictions diverged across processes",
        )
        np.testing.assert_allclose(
            got[f"{name}_m"], m_ref, rtol=1e-3, atol=1e-3,
            err_msg=f"{name} margins diverged across processes",
        )


@pytest.mark.slow
def test_two_process_serving_cli(tmp_path):
    """The advertised multi-host serving mode end-to-end: stream_kws.py
    under LSM_TPU_COORDINATOR on 2 processes (1 CPU device each, gloo)
    must serve — each process feeds its PROCESS-LOCAL stream rows
    (regression: the CLI used to feed full global batches and crash in
    normalize_ingest_chunk on the first pre-roll/step) — and process 0's
    predictions must equal a single-process run byte-for-byte."""
    corpus = tmp_path / "corpus"
    env1 = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
    }

    def run1(args):
        return subprocess.run(
            [sys.executable, *args], cwd=tmp_path, env=env1,
            capture_output=True, text=True, timeout=420,
        )

    r = run1([
        "-c",
        "import sys; from lsm_tpu.io.dataset import write_synthetic_corpus;"
        " write_synthetic_corpus(sys.argv[1], ('yes','no','up','visual'),"
        " n_per_class=8)", str(corpus),
    ])
    assert r.returncode == 0, r.stderr[-2000:]
    r = run1([
        str(REPO / "main.py"), "--data-dir", str(corpus),
        "--num-neurons", "128", "--num-output-neurons", "64",
        "--batch-size", "32", "--n-filters", "16",
        "--samples-per-class", "8", "--save-model", "m.npz",
    ])
    assert r.returncode == 0, r.stderr[-2000:]

    # Single-process reference predictions.
    r = run1([
        str(REPO / "stream_kws.py"), "--model", "m.npz",
        "--data-dir", str(corpus), "--single-device",
        "--output", "single.npz",
    ])
    assert r.returncode == 0, r.stderr[-2000:]

    # 2-process SPMD serve of the same corpus.
    port = _free_port()
    env2 = {
        **env1,
        "LSM_TPU_COORDINATOR": f"localhost:{port}",
        "LSM_TPU_NUM_PROCESSES": "2",
        "LSM_TPU_NO_CACHE": "1",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "stream_kws.py"), "--model",
             "m.npz", "--data-dir", str(corpus), "--output", "multi.npz"],
            cwd=tmp_path, env={**env2, "LSM_TPU_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=420)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"serving proc {i} failed:\n{logs[i]}"
    # Device count per process comes from the inherited env
    # (8 virtual CPU devices under the test conftest -> mesh x16);
    # the contract under test is that the multi-process serve ran
    # on a mesh at all and matched the single-process predictions.
    assert "mesh x" in logs[0]

    single = np.load(tmp_path / "single.npz", allow_pickle=False)
    multi = np.load(tmp_path / "multi.npz", allow_pickle=False)
    np.testing.assert_array_equal(multi["predictions"],
                                  single["predictions"])
    np.testing.assert_array_equal(multi["labels"], single["labels"])

    # Session-churn pool mode under the same 2-process grid: 32 sessions
    # over 8 slots, every process running the identical SPMD admit/step/
    # finish loop. Exact-mode pool decisions are bit-equal to the static
    # one-slot-per-file run (per-slot state depends only on the session's
    # own audio), so multi-process pool == single-process static.
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "stream_kws.py"), "--model",
             "m.npz", "--data-dir", str(corpus), "--pool",
             "--max-streams", "8", "--output", "multi_pool.npz"],
            cwd=tmp_path, env={**env2, "LSM_TPU_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=420)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"pool serving proc {i} failed:\n{logs[i]}"
    assert "pool slots" in logs[0]
    mp = np.load(tmp_path / "multi_pool.npz", allow_pickle=False)
    np.testing.assert_array_equal(mp["predictions"], single["predictions"])
