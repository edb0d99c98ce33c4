"""Frozen accuracy band for the CONTINUOUS streaming path (VERDICT r3
item 4).

The continuous engine's two deliberate approximations (causal
chunk-lookahead normalization, carried membrane) are policed by the
matched-readout protocol: calibrate the readout on continuous-mode
features (fit_continuous_readout, carried-state condition), serve
continuous, compare against the exact batch pipeline on the same frozen
hard benchmark. High-powered measurements (n_test=1224,
tools/bench_continuous.py --n-per-class 340): gammatone matched 0.8100
vs exact 0.8125 — delta -0.0025 +- 0.0137 SE (2026-08-17); mel matched
0.7561 vs exact 0.7402 — delta +0.0159 +- 0.0154 SE (2026-08-19). Both
frontends at parity (docs/SENSITIVITY.md "Continuous-mode knobs").

This CPU-sized replica (n_per_class=20, n_test=48) freezes that
contract at test scale FOR BOTH FRONTENDS. Measured CPU: gammatone
exact 0.6250, matched continuous 0.7917 (2026-08-17); mel exact 0.6250,
matched continuous 0.6250 (2026-08-19, VERDICT r4 item 3's frozen mel
row). At n=48 the draws are noisy both ways (SE ~0.07) and the tiny
corpus also sits below the flagship band's exact accuracy. The bands
are correspondingly generous — their power is against the documented
failure modes, which are CATASTROPHIC, not marginal: serving a
batch-trained readout in continuous mode measured -0.24 delta
(carry-in) / -0.67 (cold) at n=1224, and the pre-fix normalization bugs
scored near chance. A regression of that class lands far below the band.

Protocol invariants (do not change without recalibrating): seed 42
corpus, default flagship config, chunk 100 ms, norm_decay 0.1, the
fixed-seed carry-in permutation of fit_continuous_readout.
"""

import numpy as np
import pytest

from lsm_tpu import pipeline
from lsm_tpu.config import FEATURE_SETS, FrontendConfig, PipelineConfig
from lsm_tpu.io import dataset

N_PER_CLASS = 20
N_CLASSES = 12
SEED = 42
CHUNK_LEN = 1600          # 100 ms
NORM_DECAY = 0.1
# Band: the matched readout must stay within 0.15 of exact AND above a
# per-frontend absolute floor — batch-readout serving (delta -0.24) and
# the historical normalization bugs (near chance, 0.083) both land far
# outside. Floors sit ~0.15 under the frozen matched measurements above
# (gammatone 0.7917, mel 0.6250).
MAX_DELTA = 0.15


@pytest.mark.slow
@pytest.mark.parametrize("filterbank,min_acc", [
    ("gammatone", 0.60),
    ("mel", 0.45),
])
def test_matched_continuous_readout_lands_in_band(filterbank, min_acc):
    audio, labels = dataset.synthetic_audio_batch_hard(
        n_per_class=N_PER_CLASS, n_classes=N_CLASSES, seed=SEED
    )
    cfg = PipelineConfig(batch_size=64,
                         frontend=FrontendConfig(filterbank=filterbank))
    result, ext = pipeline.run_pipeline_arrays(cfg, audio, labels, mesh=None)
    exact_acc = result.accuracy

    x_train, x_test, y_train, y_test = pipeline.stratified_split(
        audio, labels, cfg.test_size, cfg.split_seed
    )

    from lsm_tpu.models.continuous import ContinuousKWS, fit_continuous_readout

    ro, sc = fit_continuous_readout(
        ext.params, cfg.frontend, x_train, y_train, num_classes=N_CLASSES,
        feature_set=cfg.feature_set, chunk_len=CHUNK_LEN,
        norm_decay_db_per_bin=NORM_DECAY,
        l2_c=cfg.readout.l2_c, max_iter=cfg.readout.max_iter,
        tol=cfg.readout.tol,
    )

    # Carry-in eval: each test stream enters its utterance with state
    # carried from a different (label-independent) utterance — the
    # always-on operating condition fit_continuous_readout calibrates for.
    n = x_test.shape[0]
    nc = cfg.frontend.num_samples // CHUNK_LEN
    kws = ContinuousKWS(
        ext.params, ro, sc, cfg.frontend, cfg.feature_set,
        n_streams=n, chunk_len=CHUNK_LEN,
        norm_decay_db_per_bin=NORM_DECAY,
    )
    prev = x_test[np.random.default_rng(12345).permutation(n)]
    for c in range(nc):
        kws.step(prev[:, c * CHUNK_LEN:(c + 1) * CHUNK_LEN])
    logits = None
    for c in range(nc):
        logits = kws.step(x_test[:, c * CHUNK_LEN:(c + 1) * CHUNK_LEN])
    acc = float((np.argmax(logits, -1) == y_test).mean())

    assert acc >= min_acc, (
        f"matched continuous {filterbank} accuracy {acc:.4f} below the "
        f"floor {min_acc} (exact {exact_acc:.4f}) — a catastrophic "
        "continuous-path regression (normalization/carry/calibration)"
    )
    assert exact_acc - acc <= MAX_DELTA, (
        f"matched continuous {filterbank} delta {exact_acc - acc:+.4f} "
        f"exceeds {MAX_DELTA} — continuous-mode approximations are "
        "costing accuracy beyond the frozen contract (n=1224 "
        "measured -0.0025 gammatone; recalibrate via "
        "tools/bench_continuous.py only if the protocol changed "
        "intentionally)"
    )
