"""The port stands alone: no module of aki_torch, and not chip_smoke.py,
imports jax or anything of aki_tpu; and its entry points do not fall back
to the CPU when the caller did not ask for it."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import aki_torch
from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import aki_tiny

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_aki_tpu():
    modules = sorted(m.name for m in pkgutil.walk_packages(aki_torch.__path__, "aki_torch."))
    assert "aki_torch.ops.flash_mma" in modules and "aki_torch.infer.engine" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aki_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_source_imports_neither():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|aki_tpu)\b", src, re.M)
    for path in (ROOT / "aki_torch").rglob("*.py"):
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|aki_tpu)\b",
                             path.read_text(), re.M), path


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AKIModel(aki_tiny())
    from aki_torch.infer import engine

    model = AKIModel(aki_tiny(), device="cpu")
    ids = np.full((1, 6), 5, np.int32)
    ids[0, 1] = model.cfg.media_token_id
    images = np.zeros((1, 28, 28, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.generate(model, ids, images, np.ones_like(ids), 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.prefill(model, ids, images, np.ones_like(ids), 16)
