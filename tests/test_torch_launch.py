"""The port's entry point and package boundary: a tiny CPU run of
``python -m repro_torch.launch.ofl``, device selection, and the rule that
``repro_torch`` imports neither ``jax`` nor the JAX package."""
from __future__ import annotations

import json
import math
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.config.train import OFLConfig
from repro_torch.launch.ofl import METHODS
from repro_torch.utils.device import get_device

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("method", METHODS)
def test_cli_tiny_cpu_run(tmp_path, method):
    out = tmp_path / "ofl.json"
    proc = subprocess.run(
        [
            sys.executable, "-m", "repro_torch.launch.ofl", "--method", method, "--device", "cpu",
            "--clients", "2", "--classes", "3", "--image", "8", "--per-class", "12", "--epochs", "2",
            "--gen-iters", "2", "--batch", "8", "--local-epochs", "1", "--out", str(out),
        ],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = [l for l in proc.stderr.splitlines() if l.strip()][-1]
    assert f"[{method}]" in last and "ensemble_acc" in last
    result = json.loads(out.read_text())
    assert result["method"] == method
    assert 0.0 <= result["ensemble_acc"] <= 1.0
    if method == "fedens":  # no server is trained: the ensemble alone is reported
        assert "server_acc" not in result and "server_acc" not in last
    else:
        assert 0.0 <= result["server_acc"] <= 1.0 and "server_acc" in last
    if method in ("coboosting", "dense", "f_dafl"):
        assert all(math.isfinite(result[k]) for k in ("gen_loss", "distill_loss"))


def test_cli_offers_the_reference_methods():
    from repro.launch.ofl import METHODS as REFERENCE_METHODS

    assert METHODS == REFERENCE_METHODS


def test_package_imports_neither_jax_nor_repro():
    """Import every module of repro_torch in a fresh interpreter; neither
    ``jax`` nor ``repro`` may end up loaded."""
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.kernels.ensemble_kl.kernel" in names and "repro_torch.launch.ofl" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "", f"repro_torch loaded {proc.stdout.strip()}"


def test_cuda_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def test_config_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown kernel backend"):
        OFLConfig(backend="pallas")
