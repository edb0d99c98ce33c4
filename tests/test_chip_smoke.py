"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and each
of its phases must run end to end at tiny widths (the same code the card
runs at full width)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


smoke = _load_smoke()


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_smoke_without_gpu_exits_nonzero(tmp_path, alone):
    """No GPU (here: JAX_PLATFORMS=cpu), or no repo beside the script:
    non-zero exit, a clear message, and no `ok` result line."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        script, cwd = REPO / "chip_smoke.py", REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, env=env, cwd=cwd,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr + r.stdout
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("Some, Vendor, Card, [N/A]", [("Some, Vendor, Card", "[N/A]")]),
])
def test_parse_nvidia_smi(text, want):
    assert smoke.parse_nvidia_smi(text) == want


def test_parse_nvidia_smi_rejects_garbage():
    with pytest.raises(ValueError, match="unexpected nvidia-smi line"):
        smoke.parse_nvidia_smi("no separator here")


@pytest.fixture(scope="module")
def batch_ctx(tmp_path_factory):
    """The batch phase at tiny width: its saved model and feature artifact
    feed the oracle and serving phases."""
    ctx = smoke.Ctx(work=tmp_path_factory.mktemp("smoke"), label="cpu test")
    result = smoke.phase_batch(smoke.TINY, ctx)
    return ctx, result


@pytest.mark.parametrize(
    "phase",
    ["batch", "band", "oracles", "serving", "sparse10k", "four_cards"],
)
def test_smoke_phase_runs_tiny_on_cpu(batch_ctx, phase):
    ctx, batch_result = batch_ctx
    if phase == "batch":
        assert batch_result["accuracy"] >= smoke.TINY.min_accuracy
        assert ctx.model.exists() and ctx.features.exists()
        return
    fn = dict(smoke.ONE_CARD_PHASES, four_cards=smoke.phase_four_cards)[phase]
    out = fn(smoke.TINY, ctx)
    assert isinstance(out, dict)
    json.dumps(out)        # every phase result is plain, printable data
