"""The harness end to end at aki_tiny on the CPU: each traffic kind runs a
2 s window and prints the contract's line; a run needs a card and the
program; and nothing it loads is JAX or the JAX package."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell

ROOT = harness.ROOT
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def line_of(cell, trace: bool) -> dict:
    line, _ = run_cell(cell, 2**31 + 99, 2.0, trace, torch.device("cpu"))
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert DEVICE_KEYS <= set(out["device"]) and out["attempted"] > 0
    return out


@pytest.mark.parametrize("name", ["serve_cell", "train_cell"])
def test_a_window_prints_the_line(name, request):
    cell = request.getfixturevalue(name)
    out = line_of(cell, False)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    traced = line_of(cell, True)
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert traced["metrics"] and {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aki_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "aki_tpu.models", sys)
    assert harness.forbidden_modules() == ["aki_tpu", "jax"]


def test_nothing_the_benchmark_runs_loads_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, run, controls, yardstick\n"
        "from benchmark.reference import aki_plain, lowp, weights\n"
        "import benchmark.drivers.program\n"
        "for w in harness.manifest()['workloads']:\n"
        "    cell = harness.cell(w['name'])\n"
        "    harness.driver(cell.traffic['kind'])\n"
        "    for m in cell.per_layer:\n"
        "        harness.load_module(harness.HERE / 'metrics' / (m['name'] + '.py'))\n"
        "import aki_torch.infer.server, aki_torch.train.runner, aki_torch.models.quant\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve_w8a8_vqa",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve_w8a8_vqa",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
