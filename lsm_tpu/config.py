"""Configuration dataclasses for the LSM speech pipeline.

These mirror the reference's flag/constant surface (reference:
create_dataset.py:10-17, extract_lsm_features.py:10-16, main.py:33-59)
but are a single typed config store instead of scattered module-level
constants. Every field that corresponds to a reference CLI flag or
constant cites its source.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The 12 keyword classes (reference create_dataset.py:108-120,
# train_classifier.py:8-20).
COMMANDS_12 = (
    "yes", "no", "up", "visual", "backward", "stop",
    "bird", "cat", "nine", "eight", "zero", "follow",
)

# Full Speech Commands v0.02 vocabulary (for the 35-class config,
# BASELINE.json configs[2]).
COMMANDS_35 = (
    "backward", "bed", "bird", "cat", "dog", "down", "eight", "five",
    "follow", "forward", "four", "go", "happy", "house", "learn", "left",
    "marvin", "nine", "no", "off", "on", "one", "right", "seven", "sheila",
    "six", "stop", "three", "tree", "two", "up", "visual", "wow", "yes",
    "zero",
)

# Feature-set key lists (reference extract_lsm_features.py:19-28).
FEATURE_SETS = {
    "all": [
        "spike_counts", "spike_variances", "mean_spike_times",
        "first_spike_times", "last_spike_times", "mean_isi",
        "isi_variances", "burst_counts",
    ],
    "rate": ["spike_counts", "spike_variances", "burst_counts"],
    "timing": ["mean_spike_times", "first_spike_times", "last_spike_times"],
    "rhythm": ["mean_isi", "isi_variances"],
    "original": [
        "spike_counts", "spike_variances", "mean_spike_times",
        "mean_isi", "isi_variances",
    ],
}


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stage-1 featurization + spike encoding config.

    Reference: create_dataset.py:10-17 (constants) and :39-98 (semantics).
    """

    sample_rate: int = 16000           # SAMPLE_RATE, create_dataset.py:10
    duration: float = 1.0              # DURATION, create_dataset.py:11
    time_bins: int = 100               # TIME_BINS, create_dataset.py:12
    n_filters: int = 128               # --n-filters, create_dataset.py:183
    filterbank: str = "gammatone"      # --filterbank, create_dataset.py:185-192
    # Hysteresis spike encoder (create_dataset.py:13-14).
    spike_thresholds: Tuple[float, ...] = (0.70, 0.80, 0.90, 0.95)
    hysteresis_gap: float = 0.1
    redundancy_factor: int = 1         # REDUNDANCY_FACTOR, create_dataset.py:17
    # mel path (librosa defaults at create_dataset.py:45-48)
    n_fft: int = 2048
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None   # None -> sample_rate / 2
    power_top_db: float = 80.0         # power_to_db default / explicit -80 floor
    # gammatone path (create_dataset.py:50-60)
    gt_window_time: float = 0.025
    gt_f_min: float = 50.0
    # 'iir' = exact Slaney 4th-order gammatone cascade (matches the
    # `gammatone` pip package used by the reference); 'fft' = FFT-weighted
    # approximation (faster; min-max normalization downstream absorbs gain).
    gammatone_method: str = "iir"

    @property
    def num_samples(self) -> int:
        return int(self.sample_rate * self.duration)

    @property
    def n_thresholds(self) -> int:
        return len(self.spike_thresholds)

    @property
    def spike_train_length(self) -> int:
        # 100 bins x 4 thresholds = 400 (create_dataset.py:85).
        return self.time_bins * self.n_thresholds


@dataclasses.dataclass(frozen=True)
class ReservoirConfig:
    """Stage-2 LSM reservoir config.

    Reference constants: extract_lsm_features.py:10-16; SimulationParams
    construction at extract_lsm_features.py:164-175 and the post-hoc
    mean_weight / weight_variance mutation at :185-186.
    """

    num_neurons: int = 1000            # NUM_NEURONS
    num_output_neurons: int = 400      # NUM_OUTPUT_NEURONS
    leak_coefficient: float = 0.01     # LEAK_COEFFICIENT = 1/100
    refractory_period: int = 2         # REFRACTORY_PERIOD
    membrane_threshold: float = 2.0    # MEMBRANE_THRESHOLD
    small_world_p: float = 0.1         # SMALL_WORLD_P
    small_world_k: int = 200           # SMALL_WORLD_K = int(0.10*N*2)
    mean_weight: float = 0.0           # set after w_critico calibration
    # The reference sets `weight_variance = 10` post-construction
    # (extract_lsm_features.py:186). snnpy's exact semantics are not
    # on disk; we define it as a RELATIVE variance: recurrent weights are
    # drawn N(mean_weight, (|mean_weight| * sqrt(weight_variance))^2).
    # This choice is validated by the diagnostics regime (edge of chaos)
    # and the end-to-end accuracy band, per SURVEY.md section 7.
    weight_variance: float = 10.0
    # Optional heterogeneous leak (extract_lsm_features.py:174,183):
    # per-neuron leak ~ N(leak_coefficient, (leak_coefficient/divisor)^2),
    # clipped to [0, 1].
    leak_variance_divisor: Optional[float] = None
    # Input projection [inferred - snnpy source not on disk; SURVEY.md 2.3].
    # Each input channel projects to `input_fanout` randomly chosen reservoir
    # neurons with weight `input_weight`. SPARSE fanout is essential: only
    # ~C*fanout/N neurons receive direct input, the rest are recruited
    # through recurrence, which is what makes the w_critico `multiplier` the
    # participation knob the diagnostics tune (extract_lsm_features.py:144-151)
    # and why "pure redundancy" helps (identical copies project to different
    # random neurons, SPIKE_TRAIN_DATASET.md:58-59). Calibrated empirically
    # with tools/calibrate.py: fanout=8, weight=1.0 lands EDGE OF CHAOS
    # (90.5% participation, 9.3 spikes/neuron) at the reference-default
    # multiplier 0.6, sub-critical at 0.3, super-critical at 1.0 — matching
    # the regime map the reference's diagnostics describe
    # (extract_lsm_features.py:144-151).
    input_fanout: int = 8
    input_weight: float = 1.0
    # Burst definition [inferred]: a spike whose ISI from the previous
    # spike is <= burst_isi_max counts as a burst event.
    burst_isi_max: int = 5
    # Number of equal time windows used for the windowed-rate variance
    # behind the `spike_variances` feature [inferred].
    n_rate_windows: int = 10
    # Block-sparse scaled reservoirs (models/sparse.py): number of random
    # long-range partner blocks per 128-neuron source block. Rewired edges
    # (fraction small_world_p) land inside the source block's partner
    # blocks instead of uniformly over all neurons, which makes the weight
    # matrix BLOCK-sparse (band + R blocks per block-row) so the recurrent
    # matmul and memory cost scale with the ~10% true density instead of N^2.
    # Same out-degree k/2, same weight distribution, same small-world
    # short-path property (an R-regular random block digraph is an
    # expander); the reservoir contract is statistical (SURVEY.md 2.3).
    sparse_partner_blocks: int = 4
    # None = auto: block-sparse for device-init-scale reservoirs
    # (>= 4096 neurons) whose size is a multiple of 128; the flagship
    # 1000-neuron reservoir always stays dense (frozen accuracy band).
    sparse: Optional[bool] = None
    seed: int = 42                     # np.random.seed(42), extract_lsm_features.py:30

    def use_sparse(self) -> bool:
        if self.sparse is not None:
            return self.sparse
        return self.num_neurons >= 4096 and self.num_neurons % 128 == 0


@dataclasses.dataclass(frozen=True)
class ReadoutConfig:
    """Stage-3 readout config (reference train_classifier.py:36-40)."""

    l2_c: float = 1.0                  # sklearn C (inverse regularization)
    max_iter: int = 1000
    tol: float = 1e-4                  # sklearn lbfgs default tol
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline config (reference main.py:33-59)."""

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    reservoir: ReservoirConfig = dataclasses.field(default_factory=ReservoirConfig)
    readout: ReadoutConfig = dataclasses.field(default_factory=ReadoutConfig)
    feature_set: str = "original"      # --feature-set, main.py:46-55
    multiplier: float = 0.6            # --multiplier, main.py:56
    max_samples_per_class: int = 1000  # MAX_SAMPLES_PER_CLASS, create_dataset.py:15
    test_size: float = 0.2             # extract_lsm_features.py:161
    split_seed: int = 42
    commands: Tuple[str, ...] = COMMANDS_12
    # Compute batch size for featurization / reservoir simulation: the
    # per-step recurrent matmul is (B, N) x (N, N), so B sets its size.
    batch_size: int = 512
    # Debug sanitizer mode (--check; SURVEY.md section 5.2): route the
    # single-device stage computations through checkify float checks
    # (NaN/Inf anywhere inside the jitted stage -> located hard error)
    # and validate stage OUTPUTS host-side (spike 0/1 invariant, finite
    # non-constant features). Costs a pass over the data; defaults off.
    check: bool = False
    # Decoder->device audio format for the raw-WAV (cold) stages:
    # "int16" (default) is bit-transparent for PCM16 corpora at half the
    # f32 H2D bytes; "ulaw" is uint8 G.711 mu-law at a QUARTER of the f32
    # bytes, decoded on device — lossy (~38 dB speech SNR) but measured
    # accuracy-neutral (tests/test_ulaw.py, docs/VALIDATION.md). The
    # featurizer accepts all three wire dtypes (models/frontend.py).
    audio_wire: str = "int16"


def feature_dim(feature_set: str, num_output_neurons: int) -> int:
    return len(FEATURE_SETS[feature_set]) * num_output_neurons


def frontend_to_dict(cfg: FrontendConfig) -> dict:
    """JSON-serializable FrontendConfig (sharded-dataset metadata)."""
    return dataclasses.asdict(cfg)


def corpus_meta(cfg: "PipelineConfig") -> dict:
    """Sharded-dataset writer metadata: the featurization + vocabulary a
    corpus was built with. ONE definition because the keys are a
    cross-stage contract — extract_lsm_features.py --streaming-fit reads
    'frontend' and 'class_names' to recover the true featurization."""
    return {
        "frontend": frontend_to_dict(cfg.frontend),
        "class_names": list(cfg.commands),
    }


def frontend_from_dict(d: dict) -> FrontendConfig:
    """Inverse of frontend_to_dict. Tolerates unknown keys (metadata
    written by a newer version) and coerces JSON lists back to the
    tuple fields."""
    fields = {f.name for f in dataclasses.fields(FrontendConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if "spike_thresholds" in kw:
        kw["spike_thresholds"] = tuple(kw["spike_thresholds"])
    return FrontendConfig(**kw)
