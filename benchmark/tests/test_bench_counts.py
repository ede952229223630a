"""The yardstick's operation and byte counts against the hand counts on
record at the port's own shapes (PERF.md's table of kernels: K5 at the
48-row serving prefill, K2 and the backward on the interleaved rows of
4 x 1,114)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmark import yardstick

# (op, rows, width, bound ms) of PERF.md's K5 rows, bf16 rows
K5 = [("rms", 31440, 3072, 0.086532), ("silu", 31440, 8192, 0.384450),
      ("ln", 34992, 1152, 0.036142), ("gelu", 34992, 4352, 0.136419)]


@pytest.mark.parametrize("op,rows,d,ms", K5)
def test_fused_quant_bound(op, rows, d, ms):
    flops, nbytes = yardstick.fused_quant_work(op, rows, d)
    assert round(yardstick.bound_s(flops, nbytes, yardstick.PEAK_F32_FLOPS) * 1e3, 6) == ms
    assert nbytes / yardstick.PEAK_HBM_BYTES > flops / yardstick.PEAK_F32_FLOPS


def interleaved_rows(model: dict) -> dict:
    """The four interleaved rows of the record (6, 6, 3 and 2 images; the
    assistant after, among and before the images; rows 1 and 3 padded)."""
    layouts = [([2, 40, 80, 120, 160, 200], 230, 256), ([5, 30, 60, 150, 180, 210], 100, 240),
               ([10, 90, 170], 220, 256), ([50, 130], 20, 200)]
    ids = np.full((4, 256), 1000, np.int32)
    valid = np.zeros((4, 256), np.int32)
    for r, (media, asst, n) in enumerate(layouts):
        ids[r, media] = model["media_token_id"]
        ids[r, asst] = model["assistant_token_id"]
        ids[r, n:] = model["pad_token_id"]
        valid[r, :n] = 1
    return dict(input_ids=ids, attn_valid=valid, slots=6)


def test_interleaved_attention_bounds():
    from aki_torch.models.configs import aki_4b

    model = dataclasses.asdict(aki_4b())
    mask = yardstick.attention_masks(interleaved_rows(model), model)
    assert mask.shape == (4, 1114, 1114)
    fwd = yardstick.allowed_work(4, 1114, 1114, 32, 32, 96, mask, 1)
    dq, dkv, _ = yardstick.backward_work(4, 1114, 1114, 32, 32, 96, mask)
    for work, ms in ((fwd, 0.035093), (dq, 0.052640), (dkv, 0.070187)):
        assert round(work[0] / yardstick.PEAK_BF16_FLOPS * 1e3, 6) == ms
        assert yardstick.bound_s(*work) == work[0] / yardstick.PEAK_BF16_FLOPS


def test_training_rows_keep_to_the_mix():
    """The pretrain mix's rows: KALE captions spread evenly over 62-126
    valid tokens (mean 94), full MMC4 rows of 256 with 2-5 images; every
    step of every seed has the same sizes and image places, in its own
    order; the images present are those the text names."""
    import torch

    from benchmark import harness
    from benchmark.drivers import train_steps

    cell = harness.cell("train_bf16_pretrain")
    caps, docs = train_steps.step_sizes(cell.traffic)
    assert caps == [66, 74, 82, 90, 98, 106, 114, 122] and sum(caps) / len(caps) == 94
    assert [n for n, _ in docs] == [256] * 4 and sorted(len(p) for _, p in docs) == [2, 3, 4, 5]
    media = cell.config["model"]["media_token_id"]
    seen = set()
    for seed, i in ((1, 0), (1, 1), (2**31 + 7, 0)):
        paired, inter = train_steps.Feed(cell.traffic, cell.config, seed, "cpu").batches(i)
        assert sorted(paired["attn_valid"].sum(1).tolist()) == caps
        assert (paired["input_ids"][:, 1] == media).all()
        places = sorted(tuple(np.flatnonzero(r == media)) for r in inter["input_ids"])
        assert places == sorted(tuple(p) for _, p in docs)
        assert inter["attn_valid"].all()
        n_img = (inter["images"].flatten(2).abs().sum(-1) > 0).sum(1).tolist()
        assert n_img == [int((r == media).sum()) for r in inter["input_ids"]]
        seen.add(tuple(paired["attn_valid"].sum(1).tolist()))
        assert torch.equal(torch.as_tensor(paired["labels"] != -100),
                           torch.as_tensor(paired["attn_valid"] == 1))
    assert len(seen) > 1          # the seed and the step order the rows


def test_valid_spliced_tokens_and_pairs():
    import torch

    ids = torch.tensor([[1, 9, 5, 5, 0, 0], [1, 5, 9, 5, 9, 5]])
    valid = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    # row 0: 4 text + 1 image x 3; row 1: 6 text + 2 images x 3
    assert yardstick.valid_spliced_tokens(ids, valid, 9, 4, 2) == 4 + 6 + 3 * 3
    mask = torch.tensor([[[1, 0, 0], [1, 1, 0], [1, 1, 0]]], dtype=torch.bool)
    assert yardstick.valid_pairs(mask) == 3


def test_the_serving_mix_is_bench_pys():
    """The VQA pool keeps to ``bench.py``'s mix: bucket/2 .. bucket-1 text
    tokens, <image> at 1, <|assistant|> at 40, budgets of 8-32, one uint8
    image; every seed serves the same sizes, in its own order."""
    from aki_torch.models.configs import aki_4b

    from benchmark import harness
    from benchmark.drivers import serve_closed_loop

    model = dataclasses.asdict(aki_4b())
    tp = harness.cell("serve_w8a8_vqa").traffic
    bucket = tp["server"]["prompt_bucket"]
    tp = dict(tp, pool=64)
    pool = serve_closed_loop.make_pool(tp, model, 2**31 + 5)
    other = serve_closed_loop.make_pool(tp, model, 3)
    assert tp["prompt_tokens"] == [bucket // 2, bucket - 1] and tp["budget"] == [8, 32]
    for ids, px, budget in pool:
        assert bucket // 2 <= len(ids) < bucket and 8 <= budget <= 32
        assert ids[tp["media_at"]] == model["media_token_id"] == ids[1]
        assert ids[tp["assistant_at"]] == model["assistant_token_id"] == ids[40]
        assert px.shape == (384, 384, 3) and px.dtype == np.uint8
    sizes = [(len(ids), b) for ids, _, b in pool]
    assert sorted(sizes) == sorted((len(ids), b) for ids, _, b in other) != sizes
