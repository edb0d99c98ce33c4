"""Shared CLI plumbing: logging setup and config assembly from flags."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

from lsm_tpu.config import (
    COMMANDS_12,
    COMMANDS_35,
    FEATURE_SETS,
    FrontendConfig,
    PipelineConfig,
    ReservoirConfig,
)


# Default persistent compile cache: a fixed directory inside the checkout
# (listed in .gitignore). The path is part of the cache key, so it must
# not move between runs.
_REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
    when the environment sets it, else the fixed in-checkout .jax_cache/."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_REPO_CACHE_DIR)


def enable_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (on for every CLI entry
    point; LSM_TPU_NO_CACHE=1 disables) at compile_cache_dir().

    A repeat invocation of the same program then deserializes its
    executables instead of recompiling them. Must be called before the
    first compile; never fatal (the cache is an optimization)."""
    if os.environ.get("LSM_TPU_NO_CACHE"):
        return
    cache_dir = compile_cache_dir()
    try:
        import jax

        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except (OSError, RuntimeError, ValueError) as exc:
        logging.getLogger(__name__).warning("compile cache disabled: %s", exc)


def force_cpu_devices(n: int) -> None:
    """Force the CPU backend with `n` virtual devices (mesh verification
    without several cards). Must run before any backend use; shared by
    the bench tools' --cpu-devices flags so the override cannot drift."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)


def setup_logging(verbose: bool = True) -> None:
    """CLI process setup: stdout logging, the multi-host runtime
    (env-gated), and the persistent compile cache (every entry point
    calls this first, so all three ride along)."""
    # Multi-host launches: LSM_TPU_COORDINATOR / LSM_TPU_DISTRIBUTED
    # join the distributed runtime before any backend use, after which
    # every stage's auto mesh spans every process's devices
    # (parallel/mesh.py).
    from lsm_tpu.parallel.mesh import maybe_init_distributed_from_env

    maybe_init_distributed_from_env()
    enable_compile_cache()
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(message)s",
        stream=sys.stdout,
        force=True,
    )


def add_frontend_flags(p: argparse.ArgumentParser) -> None:
    # Exact reference surface (create_dataset.py:181-194).
    p.add_argument("--n-filters", type=int, default=128,
                   help="Number of filters for the filterbank.")
    p.add_argument("--filterbank", type=str, default="gammatone",
                   choices=["mel", "gammatone"],
                   help="Type of filterbank to use.")


def add_extract_flags(p: argparse.ArgumentParser) -> None:
    # Exact reference surface (extract_lsm_features.py:218-221).
    p.add_argument("--feature-set", type=str, default="original",
                   choices=list(FEATURE_SETS.keys()))
    p.add_argument("--multiplier", type=float, default=0.6)
    p.add_argument("--leak-variance-divisor", type=float, default=None)


def add_extension_flags(p: argparse.ArgumentParser) -> None:
    # Extensions beyond the reference CLI.
    p.add_argument("--data-dir", type=str, default="speech_commands_v0.02",
                   help="Speech Commands-style dataset root.")
    p.add_argument("--vocab", type=str, default="v12", choices=["v12", "v35"],
                   help="12-command reference vocabulary or full 35-class set.")
    p.add_argument("--synthetic", action="store_true",
                   help="Use a synthetic corpus (no dataset on disk needed).")
    p.add_argument("--samples-per-class", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--gammatone-method", type=str, default="iir",
                   choices=["iir", "fft"])
    p.add_argument("--num-neurons", type=int, default=1000)
    p.add_argument("--num-output-neurons", type=int, default=400)
    p.add_argument("--sparse", dest="sparse", action="store_true",
                   default=None,
                   help="Force the block-sparse reservoir (default: "
                        "automatic for >=4096 neurons with N %% 128 == 0; "
                        "requires N %% 128 == 0).")
    p.add_argument("--dense", dest="sparse", action="store_false",
                   help="Force the dense reservoir representation.")
    p.add_argument("--redundancy-factor", type=int, default=1,
                   help="Duplicate each filter channel R times before the "
                        "reservoir (reference REDUNDANCY_FACTOR, "
                        "create_dataset.py:17; SPIKE_TRAIN_DATASET.md).")
    p.add_argument("--commands", type=str, default=None,
                   help="Comma-separated keyword subset (arbitrary vocab, "
                        "e.g. 'yes,no,up,down' for the 4-word config); "
                        "overrides --vocab. Class index = position in the "
                        "list.")
    p.add_argument("--single-device", action="store_true",
                   help="Disable the automatic data-parallel mesh and run "
                        "every stage on one device (default: shard over "
                        "all devices).")
    p.add_argument("--check", action="store_true",
                   help="Debug sanitizer mode: run stages under checkify "
                        "float checks (single-device paths; under a mesh "
                        "checkify does not compose with shard_map, so a "
                        "device-side input finiteness guard plus the "
                        "host-side output validators run instead) and "
                        "validate stage outputs (0/1 spikes, finite "
                        "non-constant features); NaN/Inf fails loudly "
                        "instead of being papered over. Costs a pass over "
                        "the data.")
    p.add_argument("--metrics-out", type=str, default=None,
                   help="Append structured JSONL metric records (per-stage "
                        "rates, w_critico, regime, accuracy) to this file.")
    p.add_argument("--audio-wire", type=str, default="int16",
                   choices=["int16", "ulaw"],
                   help="Decoder->device audio format for raw-WAV stages. "
                        "int16 (default): bit-transparent for PCM16 "
                        "corpora at half the f32 bytes. ulaw: uint8 G.711 "
                        "mu-law, a QUARTER of the f32 bytes — lossy but "
                        "measured accuracy-neutral (tests/test_ulaw.py); "
                        "for host->device-bandwidth-bound ingest.")


def mesh_from_args(args: argparse.Namespace):
    """The pipeline `mesh` argument implied by the CLI flags."""
    return None if getattr(args, "single_device", False) else "auto"


def resolve_commands(args: argparse.Namespace):
    """The keyword vocabulary implied by the CLI flags: --commands (an
    arbitrary comma-separated subset, e.g. BASELINE configs[0]'s
    yes,no,up,down) wins over --vocab; defaults to the reference's 12
    (reference create_dataset.py:108-120)."""
    raw = getattr(args, "commands", None)
    if raw:
        commands = tuple(w.strip() for w in raw.split(",") if w.strip())
        if len(commands) < 2:
            raise SystemExit(
                f"--commands needs at least 2 comma-separated words, got {raw!r}"
            )
        if len(set(commands)) != len(commands):
            raise SystemExit(f"--commands has duplicate words: {raw!r}")
        return commands
    return COMMANDS_35 if getattr(args, "vocab", "v12") == "v35" else COMMANDS_12


def metrics_from_args(args: argparse.Namespace):
    """MetricLogger for --metrics-out (None when the flag is unset)."""
    path = getattr(args, "metrics_out", None)
    if not path:
        return None
    from lsm_tpu.utils.logging import MetricLogger

    return MetricLogger(path=path)


def build_config(args: argparse.Namespace) -> PipelineConfig:
    commands = resolve_commands(args)
    frontend = FrontendConfig(
        n_filters=getattr(args, "n_filters", 128),
        filterbank=getattr(args, "filterbank", "gammatone"),
        gammatone_method=getattr(args, "gammatone_method", "iir"),
        redundancy_factor=getattr(args, "redundancy_factor", 1),
    )
    n_neurons = getattr(args, "num_neurons", 1000)
    reservoir = ReservoirConfig(
        num_neurons=n_neurons,
        num_output_neurons=getattr(args, "num_output_neurons", 400),
        small_world_k=int(0.10 * n_neurons * 2),
        leak_variance_divisor=getattr(args, "leak_variance_divisor", None),
        sparse=getattr(args, "sparse", None),
    )
    return PipelineConfig(
        frontend=frontend,
        reservoir=reservoir,
        feature_set=getattr(args, "feature_set", "original"),
        multiplier=getattr(args, "multiplier", 0.6),
        max_samples_per_class=getattr(args, "samples_per_class", 1000),
        commands=commands,
        batch_size=getattr(args, "batch_size", 512),
        check=getattr(args, "check", False),
        audio_wire=getattr(args, "audio_wire", "int16"),
    )
