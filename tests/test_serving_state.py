"""Serving-state checkpoint/restore (io/serving_state.py).

Contract: run k chunks, save, rebuild the engine FRESH (same weights),
load, run more chunks — every subsequent logits array is bit-equal to
the uninterrupted run. Both engines, single-device and CPU mesh; plus
the identity validation that keeps a snapshot from being installed into
an engine that could not continue it bit-exactly.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from lsm_tpu.config import FrontendConfig, ReservoirConfig
from lsm_tpu.io.serving_state import load_serving_state, save_serving_state
from lsm_tpu.models import reservoir as res
from lsm_tpu.models.continuous import ContinuousKWS
from lsm_tpu.models.streaming import StreamingKWS
from lsm_tpu.readout import logistic, scaler


def _weights(seed=0, d=5 * 64, k=4):
    rng = np.random.default_rng(seed)
    readout = logistic.LogisticParams(
        w=jnp.asarray(rng.normal(0, 0.1, (d, k)).astype(np.float32)),
        b=jnp.zeros((k,), jnp.float32),
    )
    st = scaler.ScalerState(
        mean=jnp.zeros((d,), jnp.float32), scale=jnp.ones((d,), jnp.float32)
    )
    return readout, st


@pytest.fixture(scope="module")
def setup():
    fcfg = FrontendConfig(n_filters=16, filterbank="gammatone")
    rcfg = ReservoirConfig(
        num_neurons=128, num_output_neurons=64, small_world_k=16,
        mean_weight=0.03,
    )
    params = res.init_reservoir(rcfg, n_channels=16)
    readout, st = _weights()
    return params, readout, st, fcfg


def _audio(n_streams, n_chunks, chunk_len, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n_chunks, n_streams, chunk_len)
    ).astype(np.float32) * 0.2


def _resume_bit_equal(make_engine, chunks, tmp_path):
    """Drive the save/restore contract for one engine constructor."""
    k = chunks.shape[0] // 2

    ref = make_engine()
    ref_out = [ref.step(c) for c in chunks]

    live = make_engine()
    for c in chunks[:k]:
        live.step(c)
    path = tmp_path / "state.npz"
    save_serving_state(path, live)

    resumed = make_engine()   # fresh: cold state
    load_serving_state(path, resumed)
    for i, c in enumerate(chunks[k:]):
        np.testing.assert_array_equal(
            resumed.step(c), ref_out[k + i],
            err_msg=f"post-restore chunk {i} diverged",
        )


def test_streaming_resume_bit_equal(setup, tmp_path):
    params, readout, st, fcfg = setup
    chunks = _audio(2, 6, 4000)
    _resume_bit_equal(
        lambda: StreamingKWS(params, readout, st, fcfg, "original", 2),
        chunks, tmp_path,
    )


def test_continuous_resume_bit_equal(setup, tmp_path):
    params, readout, st, fcfg = setup
    chunks = _audio(2, 6, 1600)
    _resume_bit_equal(
        lambda: ContinuousKWS(params, readout, st, fcfg, "original", 2),
        chunks, tmp_path,
    )


def test_continuous_resume_bit_equal_mesh(setup, tmp_path):
    """Snapshot from a single-device engine restores onto a mesh-sharded
    one (and vice versa): the snapshot holds FULL global-shape arrays,
    placement is the engine's concern."""
    from lsm_tpu.parallel.mesh import make_mesh

    params, readout, st, fcfg = setup
    mesh = make_mesh(n_data=4, n_model=1)
    chunks = _audio(8, 4, 1600)

    ref = ContinuousKWS(params, readout, st, fcfg, "original", 8)
    ref_out = [ref.step(c) for c in chunks]

    live = ContinuousKWS(params, readout, st, fcfg, "original", 8)
    for c in chunks[:2]:
        live.step(c)
    path = tmp_path / "state.npz"
    save_serving_state(path, live)

    resumed = ContinuousKWS(
        params, readout, st, fcfg, "original", 8, mesh=mesh
    )
    load_serving_state(path, resumed)
    for i, c in enumerate(chunks[2:]):
        np.testing.assert_allclose(
            resumed.step(c), ref_out[2 + i], rtol=1e-5, atol=1e-6,
            err_msg=f"post-restore chunk {i} diverged on the mesh",
        )
    # And back: snapshot the meshed engine, restore single-device.
    save_serving_state(path, resumed)
    back = ContinuousKWS(params, readout, st, fcfg, "original", 8)
    load_serving_state(path, back)
    extra = _audio(8, 1, 1600, seed=9)[0]
    np.testing.assert_allclose(
        back.step(extra), ref.step(extra), rtol=1e-5, atol=1e-6
    )


def test_streaming_resume_bit_equal_mesh(setup, tmp_path):
    from lsm_tpu.parallel.mesh import make_mesh

    params, readout, st, fcfg = setup
    mesh = make_mesh(n_data=4, n_model=1)
    chunks = _audio(8, 4, 4000)

    ref = StreamingKWS(params, readout, st, fcfg, "original", 8)
    ref_out = [ref.step(c) for c in chunks]

    live = StreamingKWS(params, readout, st, fcfg, "original", 8, mesh=mesh)
    for c in chunks[:2]:
        live.step(c)
    path = tmp_path / "state.npz"
    save_serving_state(path, live)

    resumed = StreamingKWS(params, readout, st, fcfg, "original", 8)
    load_serving_state(path, resumed)
    for i, c in enumerate(chunks[2:]):
        np.testing.assert_allclose(
            resumed.step(c), ref_out[2 + i], rtol=1e-5, atol=1e-6,
            err_msg=f"post-restore chunk {i} diverged",
        )


def test_snapshot_identity_validation(setup, tmp_path):
    params, readout, st, fcfg = setup
    kws = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    kws.step(_audio(2, 1, 1600)[0])
    path = tmp_path / "state.npz"
    save_serving_state(path, kws)

    # Wrong engine kind.
    exact = StreamingKWS(params, readout, st, fcfg, "original", 2)
    with pytest.raises(ValueError, match="engine mode"):
        load_serving_state(path, exact)

    # Wrong stream count.
    with pytest.raises(ValueError, match="stream count"):
        load_serving_state(
            path, ContinuousKWS(params, readout, st, fcfg, "original", 4)
        )

    # Wrong chunk geometry.
    with pytest.raises(ValueError, match="chunk length"):
        load_serving_state(
            path,
            ContinuousKWS(params, readout, st, fcfg, "original", 2,
                          chunk_len=3200),
        )

    # Wrong normalization decay.
    with pytest.raises(ValueError, match="normalization decay"):
        load_serving_state(
            path,
            ContinuousKWS(params, readout, st, fcfg, "original", 2,
                          norm_decay_db_per_bin=0.2),
        )

    # Wrong frontend.
    with pytest.raises(ValueError, match="frontend"):
        load_serving_state(
            path,
            ContinuousKWS(
                params, readout, st,
                dataclasses.replace(fcfg, hysteresis_gap=0.2),
                "original", 2,
            ),
        )

    # Different weights: shape-compatible but the continued stream would
    # not equal the one the snapshot recorded.
    ro2 = readout._replace(w=readout.w + np.float32(1e-3))
    with pytest.raises(ValueError, match="different model weights"):
        load_serving_state(
            path, ContinuousKWS(params, ro2, st, fcfg, "original", 2)
        )

    # Not a snapshot at all.
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, x=np.zeros(3))
    with pytest.raises(ValueError, match="not a serving-state snapshot"):
        load_serving_state(bogus, kws)


def test_v3_snapshot_roundtrip_has_no_dispatch_row(setup, tmp_path):
    """v3 header: no gtgram_two_phase identity row; loads back into an
    identical engine."""
    import json

    from lsm_tpu.io.serving_state import read_snapshot_meta

    params, readout, st, fcfg = setup
    kws = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    kws.step(_audio(2, 1, 1600)[0])
    path = tmp_path / "state.npz"
    save_serving_state(path, kws)
    meta = read_snapshot_meta(path)
    assert meta["format"] == "lsm_tpu.serving_state.v3"
    assert "gtgram_two_phase" not in meta
    with np.load(path) as data:
        assert json.loads(str(data["meta"])) == meta
    fresh = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    assert load_serving_state(path, fresh)["format"] == meta["format"]


def test_v2_snapshot_refused_by_version(setup, tmp_path):
    """A v2 file (with its gtgram_two_phase row) fails with the
    versioned-format error, never a field-by-field mismatch."""
    import json

    params, readout, st, fcfg = setup
    kws = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    path = tmp_path / "state.npz"
    save_serving_state(path, kws)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "meta"}
        meta = json.loads(str(data["meta"]))
    meta.update(format="lsm_tpu.serving_state.v2", gtgram_two_phase=False)
    v2 = tmp_path / "v2.npz"
    np.savez(v2, meta=json.dumps(meta), **arrays)
    with pytest.raises(ValueError, match="has format 'lsm_tpu.serving_state.v2'"):
        load_serving_state(v2, kws)


def test_restore_rejects_corrupt_leaf_shapes(setup):
    params, readout, st, fcfg = setup
    kws = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    snap = kws.snapshot()
    bad = dict(snap)
    bad["v"] = bad["v"][:, :-1]
    with pytest.raises(ValueError, match="snapshot leaf 'v'"):
        kws.restore(bad)
    missing = {k: v for k, v in snap.items() if k != "norm_hi"}
    with pytest.raises(ValueError, match="missing state leaf"):
        kws.restore(missing)
    extra = dict(snap)
    extra["seg:bogus_stat"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="does not track"):
        kws.restore(extra)


def test_stream_migration_bit_equal(setup):
    """Move a live stream from a 4-stream engine into slot 0 of a
    2-stream engine: the moved stream's logits continue bit-equal to the
    uninterrupted source run, and the destination's other slot is
    untouched (bit-equal to ITS uninterrupted run). Different stream
    counts on purpose: per-stream state is batch-independent."""
    from lsm_tpu.io.serving_state import migrate_streams

    params, readout, st, fcfg = setup
    mk = lambda n: ContinuousKWS(params, readout, st, fcfg, "original", n)
    chunks_a = _audio(4, 6, 1600, seed=2)
    chunks_b = _audio(2, 6, 1600, seed=3)

    ref_a = mk(4)
    ref_a_out = [ref_a.step(c) for c in chunks_a]
    ref_b = mk(2)
    ref_b_out = [ref_b.step(c) for c in chunks_b]

    a, b = mk(4), mk(2)
    for c in chunks_a[:3]:
        a.step(c)
    for c in chunks_b[:3]:
        b.step(c)
    migrate_streams(a, b, src_idx=3, dst_idx=0)
    a.reset(3)

    for i in range(3, 6):
        mixed = np.stack([chunks_a[i, 3], chunks_b[i, 1]])
        out = b.step(mixed)
        np.testing.assert_array_equal(
            out[0], ref_a_out[i][3],
            err_msg=f"migrated stream diverged at chunk {i}",
        )
        np.testing.assert_array_equal(
            out[1], ref_b_out[i][1],
            err_msg=f"untouched dst stream perturbed at chunk {i}",
        )


def test_stream_migration_streaming_engine(setup):
    from lsm_tpu.io.serving_state import migrate_streams

    params, readout, st, fcfg = setup
    mk = lambda n: StreamingKWS(params, readout, st, fcfg, "original", n)
    chunks_a = _audio(3, 4, 4000, seed=4)

    ref = mk(3)
    ref_out = [ref.step(c) for c in chunks_a]

    a, b = mk(3), mk(2)
    for c in chunks_a[:2]:
        a.step(c)
    # Swap two source streams into the destination, crossed.
    migrate_streams(a, b, src_idx=[0, 2], dst_idx=[1, 0])
    for i in range(2, 4):
        out = b.step(np.stack([chunks_a[i, 2], chunks_a[i, 0]]))
        np.testing.assert_array_equal(out[1], ref_out[i][0])
        np.testing.assert_array_equal(out[0], ref_out[i][2])


def test_stream_migration_validation(setup):
    from lsm_tpu.io.serving_state import migrate_streams

    params, readout, st, fcfg = setup
    a = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    with pytest.raises(ValueError, match="chunk length"):
        migrate_streams(
            a,
            ContinuousKWS(params, readout, st, fcfg, "original", 2,
                          chunk_len=3200),
            0, 0,
        )
    with pytest.raises(ValueError, match="engine mode"):
        migrate_streams(
            a, StreamingKWS(params, readout, st, fcfg, "original", 2), 0, 0
        )
    with pytest.raises(ValueError, match="model weights"):
        migrate_streams(
            a,
            ContinuousKWS(params, readout._replace(b=readout.b + 1), st,
                          fcfg, "original", 2),
            0, 0,
        )
    b = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    with pytest.raises(ValueError, match="out of range"):
        migrate_streams(a, b, 2, 0)
    with pytest.raises(ValueError, match="out of range"):
        migrate_streams(a, b, 0, -1)
    with pytest.raises(ValueError, match="duplicate"):
        migrate_streams(a, b, [0, 1], [0, 0])
    with pytest.raises(ValueError, match="one-to-one"):
        migrate_streams(a, b, [0, 1], [0])

    # The engine-level row-addressed methods validate too: XLA take /
    # scatter would silently CLAMP an out-of-range slot (moving the
    # wrong stream's state bit-exactly), so they must fail on the host.
    for eng in (a, StreamingKWS(params, readout, st, fcfg, "original", 2)):
        with pytest.raises(ValueError, match="out of range"):
            eng.extract_streams([2])
        rows = eng.extract_streams([0])
        with pytest.raises(ValueError, match="out of range"):
            eng.install_streams([-1], rows)
        with pytest.raises(ValueError, match="duplicate"):
            eng.install_streams(
                [0, 0],
                {k: np.repeat(v, 2, axis=0) for k, v in rows.items()}
                if not isinstance(eng, ContinuousKWS) else
                eng.extract_streams([0, 1]),
            )
        with pytest.raises(ValueError, match="integers"):
            eng.extract_streams([0.5])


def test_sparse_reservoir_resume_and_weight_crc(tmp_path):
    """Block-sparse reservoirs snapshot/restore too, and the weight
    checksum covers the RECURRENT weights: two engines identical except
    w_blocks must not accept each other's snapshots (the carried
    membrane only means anything under the same recurrence)."""
    import dataclasses as dc

    from lsm_tpu.models import sparse

    rcfg = ReservoirConfig(
        num_neurons=256, num_output_neurons=128, small_world_k=52,
        mean_weight=0.02, input_fanout=6, sparse=True,
    )
    sp = sparse.init_reservoir_sparse(rcfg, n_channels=16)
    fcfg = FrontendConfig(n_filters=16, filterbank="gammatone")
    readout, st = _weights(d=5 * 128)

    mk = lambda p: ContinuousKWS(p, readout, st, fcfg, "original", 2)
    chunks = _audio(2, 4, 1600, seed=5)
    _resume_bit_equal(lambda: mk(sp), chunks, tmp_path)

    live = mk(sp)
    live.step(chunks[0])
    path = tmp_path / "state.npz"
    save_serving_state(path, live)
    sp2 = dc.replace(sp, w_blocks=sp.w_blocks * np.float32(1.001))
    with pytest.raises(ValueError, match="different model weights"):
        load_serving_state(path, mk(sp2))


def test_leaf_fingerprint_contract():
    """The weight digest must be (a) representation-independent — an
    engine built from host np arrays and one built from the same bundle
    on device must agree, or migration between them falsely reports
    different weights — (b) order-DEPENDENT (permuted weight matrices
    must not collide), and (c) value-dependent. Covers both the >=1M-
    element weighted-modular-sum path (device + chunked-host variants,
    4-byte and sub-4-byte dtypes) and the small exact-bytes path."""
    from lsm_tpu.io.serving_state import (
        _DEVICE_HASH_THRESHOLD, _leaf_fingerprint,
    )

    rng = np.random.default_rng(0)
    big = rng.standard_normal(_DEVICE_HASH_THRESHOLD + 3).astype(np.float32)
    fp = _leaf_fingerprint(big)
    assert fp == _leaf_fingerprint(jnp.asarray(big))
    assert _leaf_fingerprint(big[::-1].copy()) != fp  # permutation
    tweaked = big.copy()
    tweaked[12345] += np.float32(1.0)
    assert _leaf_fingerprint(tweaked) != fp

    wire = rng.integers(-3000, 3000, _DEVICE_HASH_THRESHOLD + 1).astype(
        np.int16
    )
    assert _leaf_fingerprint(wire) == _leaf_fingerprint(jnp.asarray(wire))
    assert _leaf_fingerprint(wire[::-1].copy()) != _leaf_fingerprint(wire)

    small = rng.standard_normal(64).astype(np.float32)
    assert _leaf_fingerprint(small) == _leaf_fingerprint(jnp.asarray(small))
    assert _leaf_fingerprint(small[::-1].copy()) != _leaf_fingerprint(small)


def test_restore_rejects_truncated_file(setup, tmp_path):
    """A server killed mid --save-state leaves a truncated .npz; loading
    it must raise the same ValueError contract, not a zipfile
    traceback."""
    params, readout, st, fcfg = setup
    kws = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    path = tmp_path / "state.npz"
    save_serving_state(path, kws)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        load_serving_state(path, kws)


def test_stream_migration_mesh(setup):
    """Migration with a mesh-sharded source and single-device destination
    (and back): the packed device-side gather must produce identical rows
    whatever the placement."""
    from lsm_tpu.io.serving_state import migrate_streams
    from lsm_tpu.parallel.mesh import make_mesh

    params, readout, st, fcfg = setup
    mesh = make_mesh(n_data=4, n_model=1)
    chunks_a = _audio(8, 4, 1600, seed=6)

    ref = ContinuousKWS(params, readout, st, fcfg, "original", 8)
    ref_out = [ref.step(c) for c in chunks_a]

    a = ContinuousKWS(params, readout, st, fcfg, "original", 8, mesh=mesh)
    for c in chunks_a[:2]:
        a.step(c)
    b = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    migrate_streams(a, b, src_idx=[5, 6], dst_idx=[0, 1])
    for i in range(2, 4):
        out = b.step(chunks_a[i, 5:7])
        np.testing.assert_allclose(
            out, ref_out[i][5:7], rtol=1e-5, atol=1e-6,
            err_msg=f"mesh-extracted migration diverged at chunk {i}",
        )
    # And into a meshed destination.
    c_eng = ContinuousKWS(params, readout, st, fcfg, "original", 8, mesh=mesh)
    migrate_streams(b, c_eng, src_idx=[0], dst_idx=[3])
    out = c_eng.step(np.repeat(chunks_a[3, 5][None], 8, axis=0))[3]
    # c_eng slot 3 saw chunks up to i=3 for stream 5's audio... build the
    # expected value: feed ref's stream-5 audio into a fresh single-dev
    # engine via the same path instead.
    d_eng = ContinuousKWS(params, readout, st, fcfg, "original", 2)
    migrate_streams(b, d_eng, src_idx=[0], dst_idx=[0])
    out_d = d_eng.step(np.repeat(chunks_a[3, 5][None], 2, axis=0))[0]
    np.testing.assert_allclose(out, out_d, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_bench_state_tool_smoke(tmp_path):
    """tools/bench_state.py runs end-to-end (tiny geometry, CPU) and
    prints the parsable summary line — guards the measurement tool the
    VALIDATION numbers come from."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, str(repo / "tools" / "bench_state.py"),
         "--streams", "8", "--migrate-k", "2", "--reps", "1",
         "--state-path", str(tmp_path / "s.npz")],
        capture_output=True, text=True, timeout=420, env=env,
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("streams=8 ") and "migrate2_ms=" in line, line


def test_inspect_state_tool(setup, tmp_path):
    """tools/inspect_state.py renders the identity header + pool table
    engine-free, flags corrupt files, and --diff exits 1 on identity
    mismatches / 0 on identical geometry."""
    import os
    import subprocess
    import sys
    from pathlib import Path as _Path

    from lsm_tpu.io.serving_state import save_serving_state
    from lsm_tpu.models.pool import StreamPool

    params, readout, st, fcfg = setup
    pool = StreamPool(ContinuousKWS(params, readout, st, fcfg,
                                    "original", 2))
    pool.admit("alice")
    pool.save(tmp_path / "pool.npz")
    save_serving_state(
        tmp_path / "eng.npz",
        StreamingKWS(params, readout, st, fcfg, "original", 2),
    )
    (tmp_path / "junk.npz").write_bytes(b"not a zip")

    repo = _Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")

    def run(*args):
        return subprocess.run(
            [sys.executable, str(repo / "tools" / "inspect_state.py"),
             *args],
            capture_output=True, text=True, timeout=120, env=env,
            cwd=tmp_path,
        )

    r = run("pool.npz", "eng.npz")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "engine:      continuous" in r.stdout
    assert "session 'alice'" in r.stdout
    assert "engine:      exact" in r.stdout

    r = run("junk.npz")
    assert r.returncode == 1 and "INVALID" in r.stdout

    r = run("--diff", "pool.npz", "eng.npz")
    assert r.returncode == 1 and "meta[engine]" in r.stdout
    r = run("--diff", "pool.npz", "pool.npz")
    assert r.returncode == 0 and "identical identity" in r.stdout


def test_swap_readout_hot_cutover(setup, tmp_path):
    """swap_readout installs a new readout on a LIVE engine: stream
    state is untouched (post-swap logits equal an engine that served
    the same audio with the new readout from the start), the
    serving-state identity follows the swap (a post-swap snapshot
    validates against the new weights and rejects the old), and
    mismatched shapes fail loudly."""
    params, readout, st, fcfg = setup
    ro2, _ = _weights(seed=5)
    chunks = _audio(2, 4, 1600)

    for mk in (
        lambda ro: ContinuousKWS(params, ro, st, fcfg, "original", 2),
        lambda ro: StreamingKWS(params, ro, st, fcfg, "original", 2),
    ):
        live = mk(readout)
        ref2 = mk(ro2)                 # same audio, new readout throughout
        for c in chunks[:2]:
            live.step(c)
            ref2.step(c)
        live.swap_readout(ro2)
        for c in chunks[2:]:
            np.testing.assert_array_equal(
                live.step(c), ref2.step(c),
                err_msg="post-swap logits diverged from the new-readout "
                        "reference (stream state was disturbed)",
            )

        # Identity follows the swap.
        path = tmp_path / "swapped.npz"
        save_serving_state(path, live)
        with pytest.raises(ValueError, match="different model weights"):
            load_serving_state(path, mk(readout))
        cont = mk(ro2)
        load_serving_state(path, cont)
        extra = _audio(2, 1, 1600, seed=8)[0]
        np.testing.assert_array_equal(cont.step(extra), ref2.step(extra))

        # Shape mismatch: different class count is a different program.
        ro_bad, _ = _weights(seed=6, k=7)
        with pytest.raises(ValueError, match="swap_readout"):
            live.swap_readout(ro_bad)


def test_swap_readout_mesh(setup):
    """swap_readout on a mesh-sharded engine replicates the new readout
    to the mesh (process-aware placement) and keeps tracking a
    single-device engine served the same audio."""
    from lsm_tpu.parallel.mesh import make_mesh

    params, readout, st, fcfg = setup
    ro2, _ = _weights(seed=5)
    mesh = make_mesh(n_data=4, n_model=1)
    chunks = _audio(8, 3, 1600)

    live = ContinuousKWS(params, readout, st, fcfg, "original", 8,
                         mesh=mesh)
    ref2 = ContinuousKWS(params, ro2, st, fcfg, "original", 8)
    for c in chunks[:1]:
        live.step(c)
        ref2.step(c)
    live.swap_readout(ro2)
    for c in chunks[1:]:
        np.testing.assert_allclose(
            live.step(c), ref2.step(c), rtol=1e-5, atol=1e-6,
            err_msg="mesh post-swap logits diverged",
        )
