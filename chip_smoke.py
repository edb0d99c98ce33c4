#!/usr/bin/env python
"""On-card smoke run of the LSM pipeline and serving engines.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: only the cross-device paths

One process holds the card(s); CPU comparisons run in the same process on
jax.devices("cpu"). Phases (one card), each checked against the repo's
plain references (lsm_tpu/oracles.py):

  1. device    — the default backend must be a GPU (no fallback); prints
                 the card's name and power limit, JAX version, XLA_FLAGS.
  2. batch     — main.py --synthetic (2400 utterances, the flagship
                 config: gammatone x128, 1000-neuron LIF, multiplier 0.6,
                 'original' features, L-BFGS readout) with --save-model,
                 then classify.py --model over a WAV corpus on disk.
  3. band      — the frozen hard benchmark lands in ACC_BAND, EDGE OF CHAOS.
  4. oracles   — reservoir spike counts bit-equal to the sequential NumPy
                 LIF under dyadic weights (1000 neurons, T=400); gtgram vs
                 the float64 scipy cascade; hysteresis bit-equal to its
                 sequential oracle; readout fit on card vs on CPU.
  5. serving   — exact engine decisions vs the batch path on the same
                 windows; continuous engine finite logits and a
                 save/load_serving_state round trip, at 1024 streams.
  6. sparse10k — the 10240-neuron block-sparse scan vs its densify()
                 oracle under dyadic weights.

--four-cards runs only: the data-parallel pipeline vs one card, the
tensor-parallel 10k sparse reservoir (n_model=4) vs the single-card scan,
and the mesh-sharded serving engines vs one card.

Any failing phase exits non-zero. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase. FULL is what runs on the card; the
    test suite runs each phase at TINY on the CPU."""

    n_per_class: int = 200         # main.py --synthetic cap: 12 x 200 = 2400
    n_filters: int = 128
    num_neurons: int = 1000
    num_output_neurons: int = 400
    min_accuracy: float = 0.95     # easy synthetic corpus (separable)
    corpus_per_class: int = 10     # WAV files per class for classify.py
    oracle_batch: int = 8          # reservoir-oracle utterances (T = 400)
    gtgram_batch: int = 4
    hard_per_class: int = 30       # frozen hard benchmark size
    check_band: bool = True        # ACC_BAND is calibrated for the flagship
    streams: int = 1024
    hops: int = 10                 # 100 ms hops; 10 fill the 1 s window
    sparse_neurons: int = 10240
    sparse_batch: int = 32


FULL = Sizes()
TINY = Sizes(
    n_per_class=5, n_filters=16, num_neurons=128, num_output_neurons=32,
    min_accuracy=0.3, corpus_per_class=2, oracle_batch=2, gtgram_batch=1,
    hard_per_class=5, check_band=False, streams=4, hops=3,
    sparse_neurons=512, sparse_batch=2,
)

HOP = 1600                 # 100 ms at 16 kHz
MESH_CARDS = 4             # --four-cards mesh size


@dataclasses.dataclass
class Ctx:
    """State shared between phases of one run."""

    work: Path
    label: str = "device"          # card name + power limit, beside times
    model: Optional[Path] = None   # bundle saved by the batch phase
    features: Optional[Path] = None


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def parse_nvidia_smi(text: str) -> list:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output -> [(name, power_limit), ...], one per card."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def nvidia_smi_cards() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return parse_nvidia_smi(out)


def _ready(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn: Callable):
    t0 = time.perf_counter()
    out = _ready(fn())
    return out, time.perf_counter() - t0


def _load_script(name: str):
    """Import a repo-root CLI script (main.py, classify.py) as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_cli_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _argv(args: list):
    prev = sys.argv
    sys.argv = list(args)
    try:
        yield
    finally:
        sys.argv = prev


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def phase_device(n_cards: int) -> dict:
    import jax

    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU — JAX's default backend is {plat!r} "
            f"({devs[0].device_kind}); this script runs only on a GPU"
        )
    if len(devs) < n_cards:
        raise SystemExit(
            f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}"
        )
    cards = nvidia_smi_cards()
    for name, limit in cards:
        print(f"{name}, {limit}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"devices: {[d.device_kind for d in devs]}")
    name, limit = cards[0]
    return dict(label=f"{name}, {limit}", kind=devs[0].device_kind,
                count=len(devs))


# ---------------------------------------------------------------------------
# Phase 2: the batch main path through main.py and classify.py
# ---------------------------------------------------------------------------

def phase_batch(sizes: Sizes, ctx: Ctx) -> dict:
    import numpy as np

    from lsm_tpu.config import COMMANDS_12
    from lsm_tpu.io import artifacts, native
    from lsm_tpu.io.dataset import write_synthetic_corpus

    main_cli, classify_cli = _load_script("main"), _load_script("classify")
    work = ctx.work / "batch"
    work.mkdir(parents=True, exist_ok=True)
    model = work / "model.npz"
    metrics = work / "metrics.jsonl"
    common = ["--n-filters", str(sizes.n_filters), "--single-device"]
    with contextlib.chdir(work), _argv(
        ["main.py", "--synthetic", "--samples-per-class",
         str(sizes.n_per_class), "--num-neurons", str(sizes.num_neurons),
         "--num-output-neurons", str(sizes.num_output_neurons),
         "--filterbank", "gammatone", "--feature-set", "original",
         "--multiplier", "0.6", "--save-model", str(model),
         "--metrics-out", str(metrics)] + common
    ):
        t0 = time.perf_counter()
        main_cli.main()
        main_wall = time.perf_counter() - t0
    rec = {}
    for line in metrics.read_text().splitlines():
        r = json.loads(line)
        rec[r["metric"]] = r
    acc = float(rec["test_accuracy"]["value"])
    n = int(rec["stage1_wall_s"]["utterances"])
    check(n == 12 * sizes.n_per_class, f"main.py ran {n} utterances")
    check(acc >= sizes.min_accuracy,
          f"main.py test accuracy {acc:.4f} < {sizes.min_accuracy}")
    for stage in ("stage1_wall_s", "stage2_wall_s", "stage3_wall_s"):
        print(f"  main.py {stage} = {rec[stage]['value']} s "
              f"(first call, compile included) [{ctx.label}]")
    print(f"  main.py total wall {main_wall:.3f} s [{ctx.label}]; "
          f"test accuracy {acc:.4f}; regime {rec['regime']['value']}")

    corpus = work / "corpus"
    write_synthetic_corpus(corpus, COMMANDS_12, sizes.corpus_per_class,
                           seed=7)
    preds_path = work / "preds.npz"
    with _argv(["classify.py", "--model", str(model), "--data-dir",
                str(corpus), "--output", str(preds_path),
                "--single-device"]):
        t0 = time.perf_counter()
        classify_cli.main()
        cls_wall = time.perf_counter() - t0
    with np.load(preds_path) as p:
        preds, labels = p["predictions"], p["labels"]
    cls_acc = float((preds == labels).mean())
    decoder = "native C++ (native/wavio.cpp)" if native.available() else "NumPy"
    print(f"  classify.py: {len(preds)} WAV files, decoder {decoder}, "
          f"accuracy {cls_acc:.4f}, wall {cls_wall:.3f} s [{ctx.label}]")
    check(len(preds) == 12 * sizes.corpus_per_class, "classify.py count")
    check(cls_acc >= sizes.min_accuracy,
          f"classify.py accuracy {cls_acc:.4f} < {sizes.min_accuracy}")
    ctx.model = model
    ctx.features = work / artifacts.FEATURES_FILENAME
    return dict(accuracy=acc, classify_accuracy=cls_acc, decoder=decoder)


# ---------------------------------------------------------------------------
# Phase 3: the frozen hard benchmark
# ---------------------------------------------------------------------------

def phase_band(sizes: Sizes, ctx: Ctx) -> dict:
    from lsm_tpu import pipeline
    from lsm_tpu.config import PipelineConfig, ReservoirConfig, FrontendConfig
    from lsm_tpu.io import dataset
    from lsm_tpu.oracles import (
        ACC_BAND, HARD_N_CLASSES, HARD_SEED,
    )

    audio, labels = dataset.synthetic_audio_batch_hard(
        n_per_class=sizes.hard_per_class, n_classes=HARD_N_CLASSES,
        seed=HARD_SEED,
    )
    cfg = PipelineConfig(
        batch_size=64,
        frontend=FrontendConfig(n_filters=sizes.n_filters),
        reservoir=ReservoirConfig(
            num_neurons=sizes.num_neurons,
            num_output_neurons=sizes.num_output_neurons,
            small_world_k=int(0.10 * sizes.num_neurons * 2),
        ),
    )
    t0 = time.perf_counter()
    res, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, mesh=None)
    wall = time.perf_counter() - t0
    regime = ext.diagnostics.regime
    print(f"  hard benchmark: accuracy {res.accuracy:.4f} (band {ACC_BAND}), "
          f"regime {regime}, wall {wall:.3f} s [{ctx.label}]")
    if sizes.check_band:
        check(regime == "EDGE OF CHAOS", f"regime {regime}")
        check(ACC_BAND[0] <= res.accuracy <= ACC_BAND[1],
              f"hard-benchmark accuracy {res.accuracy:.4f} outside {ACC_BAND}")
    return dict(accuracy=float(res.accuracy), regime=regime)


# ---------------------------------------------------------------------------
# Phase 4: oracles at real widths
# ---------------------------------------------------------------------------

def _spikes(sizes: Sizes, n: int, seed: int):
    """(n, n_filters, 400) uint8 spikes of synthetic utterances, on device."""
    import jax.numpy as jnp

    from lsm_tpu.config import FrontendConfig
    from lsm_tpu.io.dataset import synthetic_audio_batch
    from lsm_tpu.models.frontend import featurize_batch

    audio, _ = synthetic_audio_batch(
        n_per_class=-(-n // 12), n_classes=12, seed=seed
    )
    return featurize_batch(
        jnp.asarray(audio[:n]), FrontendConfig(n_filters=sizes.n_filters)
    )


def phase_oracles(sizes: Sizes, ctx: Ctx) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from lsm_tpu import oracles
    from lsm_tpu.config import FEATURE_SETS, ReservoirConfig
    from lsm_tpu.io.dataset import synthetic_audio_batch
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models.calibration import calibrate_weight
    from lsm_tpu.ops import gammatone as gt
    from lsm_tpu.ops import hysteresis

    out = {}
    # Reservoir: full width, dyadic weights, production dispatch (bf16
    # operands, f32 state) vs the sequential NumPy LIF.
    spikes = _spikes(sizes, sizes.oracle_batch, seed=3)
    rcfg = ReservoirConfig(
        num_neurons=sizes.num_neurons,
        num_output_neurons=sizes.num_output_neurons,
        small_world_k=int(0.10 * sizes.num_neurons * 2),
    )
    _, mw = calibrate_weight(rcfg, spikes, 0.6)
    params = oracles.quantize_dyadic(
        res.init_reservoir(rcfg, sizes.n_filters, mean_weight=mw)
    )
    stats = _ready(res.simulate_batch(params, spikes))
    keys = tuple(FEATURE_SETS["original"])
    feats = np.asarray(res.extract_features(params, spikes, keys))
    sp = np.asarray(spikes)
    no = params.n_outputs
    total = 0
    for b in range(sp.shape[0]):
        counts = oracles.lif_raster(params, sp[b]).sum(axis=0)
        np.testing.assert_array_equal(
            np.asarray(stats["all_counts"])[b], counts[: params.n_neurons],
            err_msg=f"reservoir spike counts, utterance {b}",
        )
        np.testing.assert_array_equal(
            feats[b, :no], counts[:no], err_msg=f"extract_features, {b}"
        )
        total += int(counts.sum())
    check(total > 0, "reservoir oracle: no spikes")
    print(f"  reservoir: {sp.shape[0]} x {sp.shape[1]}ch x T={sp.shape[2]}, "
          f"{params.n_neurons} neurons, dyadic weights (1/"
          f"{int(oracles.DYADIC_GRID)}), bf16 operands/f32 state: spike "
          f"counts bit-equal to the NumPy oracle ({total} spikes)")
    out["reservoir_spikes"] = total

    # Gammatone: gtgram_iir (state path HIGHEST, input path DEFAULT) vs
    # the float64 scipy cascade. The contract is asserted on white noise
    # (the test suite's signal); word audio is reported, not asserted:
    # TF32 exceeds the bound in its quiet bins (PERF.md).
    rng = np.random.default_rng(0)
    n = sizes.gtgram_batch
    words, _ = synthetic_audio_batch(n_per_class=-(-n // 12), n_classes=12,
                                     seed=9)
    signals = {
        "noise": (rng.standard_normal((n, 16000)) * 0.1).astype(np.float32),
        "words": words[:n],
    }
    fs, wt, ht, fmin = 16000.0, 0.025, 0.01, 50.0
    for kind, wave in signals.items():
        ours = np.asarray(gt.gtgram_iir(jnp.asarray(wave), fs, wt, ht,
                                        sizes.n_filters, fmin))
        ref = np.stack([
            oracles.gtgram_float64(w, fs, wt, ht, sizes.n_filters, fmin)
            for w in wave
        ])
        err = oracles.gtgram_error(ours, ref)
        print(f"  gammatone ({kind}): {n} x {sizes.n_filters}ch: median rel "
              f"err {err['median_rel']:.3e}, p99 {err['p99_rel']:.3e}, max "
              f"{err['max_rel']:.3e}; contract |d| <= {oracles.GTGRAM_ATOL}"
              f" + {oracles.GTGRAM_RTOL}|ref| (state path HIGHEST, input "
              f"path DEFAULT): "
              f"{'holds' if err['within_contract'] else 'exceeded'}"
              f"{'' if kind == 'noise' else ' (reported, not asserted)'}")
        if kind == "noise":
            check(err["within_contract"], "gtgram outside its contract")
        out[f"gtgram_{kind}"] = err

    # Hysteresis encoder: bit-equal to the sequential Schmitt trigger.
    thr, gap = (0.70, 0.80, 0.90, 0.95), 0.1
    spec = rng.random((8, sizes.n_filters, 100)).astype(np.float32)
    enc = np.asarray(hysteresis.hysteresis_encode(jnp.asarray(spec), thr, gap))
    for b in range(spec.shape[0]):
        np.testing.assert_array_equal(
            enc[b], hysteresis.hysteresis_encode_reference(spec[b], thr, gap)
        )
    print(f"  hysteresis: 8 x {sizes.n_filters}ch x 100 bins bit-equal "
          "to the sequential oracle")

    # Readout: the same features fit on the card and on the CPU.
    out["readout"] = readout_agreement(ctx.features, ctx.label)
    return out


def readout_agreement(features: Path, label: str) -> dict:
    """Fit the L-BFGS readout on the default device and on the CPU from
    the same feature artifact; report prediction agreement and the
    largest logit difference (at logistic.READOUT_PRECISION)."""
    import jax
    import numpy as np

    from lsm_tpu.config import PipelineConfig
    from lsm_tpu.io import artifacts
    from lsm_tpu.readout import logistic

    art = artifacts.load_features(features)
    k = int(max(art.y_train.max(), art.y_test.max())) + 1
    rc = PipelineConfig().readout

    def fit_predict():
        p, it = logistic.fit_logistic(
            np.asarray(art.x_train, np.float32),
            np.asarray(art.y_train, np.int32), k,
            l2_c=rc.l2_c, max_iter=rc.max_iter, tol=rc.tol,
        )
        logits = logistic.predict_logits(p, np.asarray(art.x_test, np.float32))
        return np.asarray(logits), int(it)

    (dev_logits, dev_it), dev_s = _timed(fit_predict)
    with jax.default_device(jax.devices("cpu")[0]):
        (cpu_logits, cpu_it), cpu_s = _timed(fit_predict)
    agree = float((dev_logits.argmax(-1) == cpu_logits.argmax(-1)).mean())
    dmax = float(np.abs(dev_logits - cpu_logits).max())
    scale = float(np.abs(cpu_logits).max())
    acc_dev = float((dev_logits.argmax(-1) == art.y_test).mean())
    acc_cpu = float((cpu_logits.argmax(-1) == art.y_test).mean())
    print(f"  readout ({logistic.READOUT_PRECISION}): {art.x_train.shape} "
          f"train, {len(art.y_test)} test; agreement device/CPU {agree:.4f}, "
          f"max |logit diff| {dmax:.3e} (max |logit| {scale:.3e}); accuracy "
          f"device {acc_dev:.4f} / CPU {acc_cpu:.4f}; L-BFGS iters "
          f"{dev_it}/{cpu_it}; fit wall {dev_s:.3f} s [{label}]")
    check(agree >= 0.99, f"readout device/CPU agreement {agree:.4f} < 0.99")
    return dict(agreement=agree, max_logit_diff=dmax, acc_device=acc_dev,
                acc_cpu=acc_cpu)


# ---------------------------------------------------------------------------
# Phase 5: serving engines
# ---------------------------------------------------------------------------

def _stream_audio(n: int):
    from lsm_tpu.io.dataset import synthetic_audio_batch

    audio, labels = synthetic_audio_batch(
        n_per_class=-(-n // 12), n_classes=12, seed=11
    )
    return audio[:n], labels[:n]


def _batch_logits(bundle, windows):
    """The batch path on (B, 16000) windows: featurize -> reservoir ->
    scaler -> readout, as separate library calls."""
    import jax.numpy as jnp
    import numpy as np

    from lsm_tpu.config import FEATURE_SETS
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models.frontend import featurize_batch
    from lsm_tpu.readout import logistic, scaler

    spikes = featurize_batch(jnp.asarray(windows), bundle.frontend)
    feats = res.extract_features(
        bundle.reservoir, spikes, tuple(FEATURE_SETS[bundle.feature_set])
    )
    return np.asarray(logistic.predict_logits(
        bundle.readout, scaler.transform(bundle.scaler, feats)))


def _engine(kind: str, bundle, n_streams: int, mesh=None):
    from lsm_tpu.models.continuous import ContinuousKWS
    from lsm_tpu.models.streaming import StreamingKWS

    cls = StreamingKWS if kind == "exact" else ContinuousKWS
    return cls(bundle.reservoir, bundle.readout, bundle.scaler,
               bundle.frontend, bundle.feature_set, n_streams=n_streams,
               mesh=mesh)


def phase_serving(sizes: Sizes, ctx: Ctx) -> dict:
    import numpy as np

    from lsm_tpu.io import model as model_io
    from lsm_tpu.io.serving_state import load_serving_state, save_serving_state

    bundle = model_io.load_model(ctx.model)
    audio, labels = _stream_audio(sizes.streams)
    hops = min(sizes.hops, audio.shape[1] // HOP)

    # Exact engine: each hop's decision vs the batch path on the window.
    kws = _engine("exact", bundle, sizes.streams)
    window = np.zeros_like(audio)
    walls, agree, dmax = [], [], 0.0
    for h in range(hops):
        chunk = audio[:, h * HOP:(h + 1) * HOP]
        logits, dt = _timed(lambda: kws.step(chunk))
        walls.append(dt)
        window = np.concatenate([window[:, HOP:], chunk], axis=1)
        ref = _batch_logits(bundle, window)
        agree.append(float((logits.argmax(-1) == ref.argmax(-1)).mean()))
        dmax = max(dmax, float(np.abs(logits - ref).max()))
    final_acc = float((logits.argmax(-1) == labels).mean())
    print(f"  exact engine: {sizes.streams} streams x {hops} hops; decision "
          f"agreement with the batch path per hop {agree}; max |logit "
          f"diff| {dmax:.3e}; accuracy at the full window {final_acc:.4f}; "
          f"hop wall median {np.median(walls[1:] or walls) * 1e3:.3f} ms "
          f"(first {walls[0]:.3f} s, compile included) [{ctx.label}]")
    check(min(agree) >= 0.99, f"exact engine vs batch path: {agree}")
    if hops * HOP == audio.shape[1]:
        check(final_acc >= sizes.min_accuracy,
              f"exact engine full-window accuracy {final_acc:.4f}")

    # Continuous engine: finite logits, then a snapshot round trip that
    # must continue bit-exactly.
    ck = _engine("continuous", bundle, sizes.streams)
    walls = []
    half = max(1, hops // 2)
    for h in range(half):
        lg, dt = _timed(lambda: ck.step(audio[:, h * HOP:(h + 1) * HOP]))
        walls.append(dt)
        check(bool(np.isfinite(lg).all()), f"continuous hop {h}: non-finite")
    state = ctx.work / "serving_state.npz"
    save_serving_state(state, ck)
    resumed = _engine("continuous", bundle, sizes.streams)
    load_serving_state(state, resumed)
    for h in range(half, hops):
        chunk = audio[:, h * HOP:(h + 1) * HOP]
        a, dt = _timed(lambda: ck.step(chunk))
        walls.append(dt)
        b = resumed.step(chunk)
        check(bool(np.isfinite(a).all()), f"continuous hop {h}: non-finite")
        np.testing.assert_array_equal(a, b, err_msg=f"resumed hop {h}")
    print(f"  continuous engine: {sizes.streams} streams x {hops} hops, "
          f"finite logits; save/load_serving_state at hop {half} continues "
          f"bit-exactly; hop wall median "
          f"{np.median(walls[1:] or walls) * 1e3:.3f} ms [{ctx.label}]")
    return dict(exact_agreement=min(agree), exact_full_window_acc=final_acc)


# ---------------------------------------------------------------------------
# Phase 6: the 10k block-sparse reservoir
# ---------------------------------------------------------------------------

def _sparse_params(sizes: Sizes, spikes):
    from lsm_tpu import oracles
    from lsm_tpu.config import ReservoirConfig
    from lsm_tpu.models import sparse
    from lsm_tpu.models.calibration import calibrate_weight

    n = sizes.sparse_neurons
    rcfg = ReservoirConfig(num_neurons=n, num_output_neurons=400 if n >= 1024
                           else 128, small_world_k=int(0.10 * n * 2))
    _, mw = calibrate_weight(rcfg, spikes, 0.6)
    return oracles.quantize_dyadic(
        sparse.init_reservoir_sparse(rcfg, spikes.shape[1], mean_weight=mw)
    )


def _check_features(got, ref, no: int, what: str) -> None:
    """Raster-exact features (counts, spike times, ISI means, bursts) must
    be bit-equal. The two variance features are E[x^2] - E[x]^2 epilogues
    whose f32 cancellation error scales with E[x]^2 and whose FMA
    contraction may differ between two compiled programs, so they are
    compared to a few f32 ulps of that second moment."""
    import numpy as np

    from lsm_tpu.config import FEATURE_SETS

    keys = FEATURE_SETS["all"]
    col = {k: slice(i * no, (i + 1) * no) for i, k in enumerate(keys)}
    for k in keys:
        if "variance" not in k:
            np.testing.assert_array_equal(got[:, col[k]], ref[:, col[k]],
                                          err_msg=f"{what}: {k}")
    for k, moment in (("spike_variances", "spike_counts"),
                      ("isi_variances", "mean_isi")):
        scale = max(1.0, float(np.abs(ref[:, col[moment]]).max()) ** 2)
        np.testing.assert_allclose(
            got[:, col[k]], ref[:, col[k]], rtol=0,
            atol=16 * float(np.finfo(np.float32).eps) * scale,
            err_msg=f"{what}: {k}")


def phase_sparse(sizes: Sizes, ctx: Ctx) -> dict:
    import numpy as np

    from lsm_tpu.config import FEATURE_SETS
    from lsm_tpu.models import reservoir as res
    from lsm_tpu.models import sparse

    keys = tuple(FEATURE_SETS["all"])
    spikes = _spikes(sizes, sizes.sparse_batch, seed=5)
    params = _sparse_params(sizes, spikes)
    got, dt = _timed(lambda: sparse.extract_features_sparse(params, spikes, keys))
    ref = res.extract_features_batch(sparse.densify(params), spikes, keys)
    got, ref = np.asarray(got), np.asarray(ref)
    no = params.n_outputs
    _check_features(got, ref, no, "sparse vs densify()")
    fired = float(got[:, :no].sum())
    check(fired > 0, "sparse reservoir: no output spikes")
    print(f"  sparse {params.n_neurons} neurons ({params.w_blocks.shape[1]} "
          f"blocks/row), {sizes.sparse_batch} utterances: features equal to "
          f"the dense scan on densify() (dyadic weights); {fired:.0f} output "
          f"spikes; first call {dt:.3f} s (compile included) [{ctx.label}]")
    return dict(output_spikes=fired)


# ---------------------------------------------------------------------------
# --four-cards: the cross-device paths, each vs one card
# ---------------------------------------------------------------------------

def phase_four_cards(sizes: Sizes, ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lsm_tpu import pipeline
    from lsm_tpu.config import (
        FEATURE_SETS, FrontendConfig, PipelineConfig, ReservoirConfig,
    )
    from lsm_tpu.io import artifacts
    from lsm_tpu.io.dataset import synthetic_audio_batch
    from lsm_tpu.io.model import ModelBundle
    from lsm_tpu.models import sparse
    from lsm_tpu.parallel import mesh as meshlib
    from lsm_tpu.parallel.sharded import extract_features_model_sharded_sparse
    from lsm_tpu.readout import logistic

    devs = jax.devices()[:MESH_CARDS]
    dp = meshlib.make_mesh(n_data=MESH_CARDS, devices=devs)
    out = {}

    # Data-parallel pipeline vs one card.
    cfg = PipelineConfig(
        frontend=FrontendConfig(n_filters=sizes.n_filters),
        reservoir=ReservoirConfig(
            num_neurons=sizes.num_neurons,
            num_output_neurons=sizes.num_output_neurons,
            small_world_k=int(0.10 * sizes.num_neurons * 2),
        ),
    )
    audio, labels = synthetic_audio_batch(
        n_per_class=sizes.n_per_class, n_classes=12
    )
    sp1, t1 = _timed(lambda: pipeline.featurize_audio_array(cfg, audio, mesh=None))
    sp4, t4 = _timed(lambda: pipeline.featurize_audio_array(cfg, audio, mesh=dp))
    np.testing.assert_array_equal(sp4, sp1, err_msg="DP spikes")
    ds = artifacts.SpikeDataset(x_spikes=sp1, y_labels=labels)
    e1 = pipeline.extract_lsm_features(cfg, ds, mesh=None)
    e4 = pipeline.extract_lsm_features(cfg, ds, mesh=dp)
    x1 = np.concatenate([e1.artifact.x_train, e1.artifact.x_test])
    x4 = np.concatenate([e4.artifact.x_train, e4.artifact.x_test])
    np.testing.assert_allclose(x4, x1, rtol=1e-4, atol=1e-4,
                               err_msg="DP features")
    r1 = pipeline.train_and_evaluate(cfg, e1.artifact, mesh=None)
    r4 = pipeline.train_and_evaluate(cfg, e4.artifact, mesh=dp)
    print(f"  DP pipeline ({MESH_CARDS} cards): {len(audio)} utterances, "
          f"spikes byte-identical to one card; features max |diff| "
          f"{float(np.abs(x4 - x1).max()):.3e}; accuracy {r4.accuracy:.4f} "
          f"(one card {r1.accuracy:.4f}); featurize first call "
          f"{t4:.3f} s vs {t1:.3f} s [{ctx.label}]")
    check(abs(r4.accuracy - r1.accuracy) <= 2.0 / len(e1.artifact.y_test),
          "DP accuracy differs from one card")
    out["dp_accuracy"] = float(r4.accuracy)

    # Tensor-parallel 10k block-sparse reservoir (n_model=4) vs one card.
    keys = tuple(FEATURE_SETS["all"])
    spikes = _spikes(sizes, sizes.sparse_batch, seed=5)
    params = _sparse_params(sizes, spikes)
    tp_mesh = meshlib.make_mesh(n_data=1, n_model=MESH_CARDS, devices=devs)
    single = np.asarray(sparse.extract_features_sparse(
        params, spikes, keys, matmul_dtype=None))
    tp, dt = _timed(lambda: extract_features_model_sharded_sparse(
        params, spikes, keys, tp_mesh, matmul_dtype=None))
    _check_features(np.asarray(tp), single, params.n_outputs,
                    "TP sparse vs one card")
    print(f"  TP sparse {params.n_neurons} neurons, n_model={MESH_CARDS}: "
          f"features equal to the single-card sparse scan (dyadic weights); "
          f"first call {dt:.3f} s [{ctx.label}]")

    # Mesh-sharded serving engines vs one card.
    k = len(cfg.commands)
    d = len(FEATURE_SETS[cfg.feature_set]) * sizes.num_output_neurons
    rng = np.random.default_rng(0)
    bundle = ModelBundle(
        reservoir=e1.params,
        readout=logistic.LogisticParams(
            w=jnp.asarray(rng.normal(0, 0.1, (d, k)), jnp.float32),
            b=jnp.zeros((k,), jnp.float32)),
        scaler=e1.scaler,
        frontend=cfg.frontend,
        feature_set=cfg.feature_set,
        class_names=cfg.commands,
    )
    streams = -(-sizes.streams // MESH_CARDS) * MESH_CARDS
    saudio, _ = _stream_audio(streams)
    hops = min(3, sizes.hops)
    for kind in ("exact", "continuous"):
        one = _engine(kind, bundle, streams)
        four = _engine(kind, bundle, streams, mesh=dp)
        agree, dmax = [], 0.0
        for h in range(hops):
            chunk = saudio[:, h * HOP:(h + 1) * HOP]
            a, b = one.step(chunk), four.step(chunk)
            agree.append(float((a.argmax(-1) == b.argmax(-1)).mean()))
            dmax = max(dmax, float(np.abs(a - b).max()))
        print(f"  {kind} engine on {MESH_CARDS} cards, {streams} streams x "
              f"{hops} hops: decision agreement with one card {agree}, max "
              f"|logit diff| {dmax:.3e}")
        check(min(agree) >= 0.99, f"{kind} engine mesh vs one card: {agree}")
    return out


# ---------------------------------------------------------------------------

ONE_CARD_PHASES = (
    ("batch", phase_batch),
    ("band", phase_band),
    ("oracles", phase_oracles),
    ("serving", phase_serving),
    ("sparse10k", phase_sparse),
)


def run_phases(phases, sizes: Sizes, ctx: Ctx) -> dict:
    results = {}
    for name, fn in phases:
        print(f"--- phase {name} ---", flush=True)
        t0 = time.perf_counter()
        results[name] = fn(sizes, ctx)
        print(f"--- phase {name}: passed in {time.perf_counter() - t0:.1f} s "
              f"[{ctx.label}]", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the cross-device paths, on four GPUs")
    args = ap.parse_args(argv)
    n_cards = MESH_CARDS if args.four_cards else 1

    print("--- phase device ---", flush=True)
    dev = phase_device(n_cards)

    from lsm_tpu.cli.common import enable_compile_cache

    enable_compile_cache()
    phases = (("four_cards", phase_four_cards),) if args.four_cards \
        else ONE_CARD_PHASES
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ctx = Ctx(work=Path(tmp), label=dev["label"])
        run_phases(phases, FULL, ctx)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
