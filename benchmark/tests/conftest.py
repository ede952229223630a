"""Fixtures of the benchmark's tests: tiny cells that run the harness end to
end on the CPU, and the ``card`` marker of the tests that need a CUDA card
(they decide inside a fixture, never at import)."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs the cell at its own size)")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda", 0)


def tiny_model() -> dict:
    from aki_torch.models.configs import aki_tiny

    return dataclasses.asdict(aki_tiny())


@pytest.fixture
def serve_cell():
    """serve_w8a8_vqa at aki_tiny: 4 clients and slots, 20-40-token prompts,
    budgets of 2-6; the cell's own limits."""
    from benchmark import harness

    cell = harness.cell("serve_w8a8_vqa")
    cell.config = dict(cell.config, model=tiny_model())
    tp = copy.deepcopy(cell.traffic)
    tp.update(clients=4, prompt_tokens=[20, 40], assistant_at=10, budget=[2, 6], pool=32,
              drain_s=30)
    tp["server"].update(num_slots=4, max_len=64, prompt_bucket=48, admit_batch=4,
                        upload_chunk=2)
    tp["check"].update(requests=4)
    cell.traffic = tp
    return cell


@pytest.fixture
def train_cell():
    """train_bf16_pretrain at aki_tiny: 4 caption rows of 24 tokens and 2
    interleaved rows of 40 with 1-3 of 3 images; the cell's own limits."""
    from benchmark import harness

    cell = harness.cell("train_bf16_pretrain")
    cell.config = dict(cell.config, model=tiny_model(),
                       tokenizer={"bos": 1, "eos": 0, "text": [10, 110]})
    tp = copy.deepcopy(cell.traffic)
    tp["datasets"][0].update(rows=4, text_len=24, text_tokens=[8, 24])
    tp["datasets"][1].update(rows=2, text_len=40, max_images=3, text_tokens=[20, 40],
                             images=[1, 3])
    cell.traffic = tp
    return cell
