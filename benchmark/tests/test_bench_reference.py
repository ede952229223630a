"""The plain reference against the port at aki_tiny on the CPU: the same
weights load into both, the port's served tokens and training steps agree
with it within the cell's limits, and a broken timed path, or the check's
control, does not."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.drivers import program
from benchmark.reference import weights as W
from benchmark.run import run_cell

CPU = torch.device("cpu")
SEED = 2**31 + 4321


def run(cell, **kw):
    line, rec = run_cell(cell, SEED, 2.0, False, CPU, **kw)
    return json.loads(line), rec


def test_weights_load_into_the_port_by_name(serve_cell):
    model_cfg = serve_cell.config["model"]
    w = W.make_weights(model_cfg, SEED, torch.float32, CPU)
    model = program.build_model(model_cfg, w, torch.float32, CPU)
    for name, t in model.state_dict().items():
        assert torch.equal(t, w[name]), name
    assert len(w) == len(model.state_dict())


def test_start_state_made_again_chunk_by_chunk(serve_cell, monkeypatch):
    model_cfg = serve_cell.config["model"]
    monkeypatch.setattr(W, "CHUNK", 1000)       # chunks that cut leaves
    w = W.make_weights(model_cfg, SEED, torch.float32, CPU)
    seen = {}
    for leaf, lo, vals in W.start_values(model_cfg, SEED, torch.float32, CPU):
        assert torch.equal(w[leaf.name].reshape(-1)[lo: lo + vals.numel()], vals)
        seen[leaf.name] = seen.get(leaf.name, 0) + vals.numel()
    assert seen == {leaf.name: leaf.numel for leaf in W.leaves(model_cfg) if leaf.init == "normal"}


def test_served_tokens_agree_and_the_control_does_not(serve_cell):
    line, rec = run(serve_cell)
    assert line["correct"], line["checks"]
    ctrl, _ = run(serve_cell, control="w4a8")
    got, low = line["checks"]["served_gap_std"]["value"], ctrl["checks"]["served_gap_std"]["value"]
    assert low > 3 * got


def test_an_altered_token_is_not_correct(serve_cell, monkeypatch):
    from aki_torch.infer import server

    decode = server.ServingEngine._decode_chunk

    def altered(self, active, n, live):
        toks = decode(self, active, n, live)
        return torch.cat([(toks[:1] + 7) % self.cfg.initial_tokenizer_len, toks[1:]])

    monkeypatch.setattr(server.ServingEngine, "_decode_chunk", altered)
    line, _ = run(serve_cell)
    assert not line["correct"]


def test_training_steps_agree(train_cell):
    """The first gradients within the cell's limit; the change after three
    steps within three times its limit: a leaf of aki_tiny holds a few
    thousand values at most, so AdamW's sign-like first updates flipping on
    a few near-zero gradients move its norm more than at AKI-4B's widths
    (the limit's own readings, §2 of PERF.md). The step losses are read,
    not compared."""
    line, rec = run(train_cell)
    checks = line["checks"]
    assert set(checks) == {"grad_rel", "change_rel", "nonfinite_losses"}
    assert rec["readings"]["loss_rel"] < 1e-3
    for k in ("grad_rel", "nonfinite_losses"):
        assert checks[k]["value"] <= checks[k]["limit"], checks
    assert checks["change_rel"]["value"] <= 3 * checks["change_rel"]["limit"], checks


def test_a_state_left_unchanged_is_not_correct(train_cell, monkeypatch):
    from aki_torch.train import optim

    def no_update(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        self.count += 1
        return optim.global_norm(grads)

    monkeypatch.setattr(optim.AdamWClip, "step", no_update)
    line, _ = run(train_cell)
    assert not line["correct"]
    assert line["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(train_cell, monkeypatch):
    from aki_torch.train import step

    forward = step.aki_forward

    def half(model, input_ids, images, attn_valid, labels=None, **kw):
        h = input_ids.shape[0] // 2
        return forward(model, input_ids[:h], images[:h], attn_valid[:h], labels[:h], **kw)

    monkeypatch.setattr(step, "aki_forward", half)
    line, _ = run(train_cell)
    assert not line["correct"]


def test_the_training_control_reads_higher(train_cell):
    """The reference one precision step down (float8 wherever the program
    holds bf16) in the program's place parts from the float32 reference
    further than the port's bf16 steps do."""
    from benchmark.drivers import train_steps as drv
    from benchmark.reference.lowp import fp8_product, fp8_store

    _, rec = run(train_cell)
    feed = drv.Feed(train_cell.traffic, train_cell.config, SEED, CPU)
    kept = [drv.on_device(feed.batches(i), CPU) for i in range(train_cell.traffic["check_steps"])]
    want = drv.reference_readings(train_cell, SEED, kept, CPU)
    got = drv.reference_readings(train_cell, SEED, kept, CPU, product_of=fp8_product,
                                 store=fp8_store)
    ctrl = drv.readings_of(got, want, train_cell.traffic["check"]["steady_leaf"])
    assert all(ctrl[k] > rec["readings"][k] for k in ctrl)
    assert max(ctrl[k] / rec["readings"][k] for k in ctrl) > 3


@pytest.mark.card
def test_controls_fail_at_the_cells_own_size(card, tmp_path):
    """On the card: the serving control (W4A8) and the training control
    (float8 reference) at the cells' own sizes come out not correct."""
    from benchmark import controls

    out = tmp_path / "c.jsonl"
    controls.main(["--workload", "serve_w8a8_vqa", "--seeds", "11", "--seconds", "10",
                   "--control", "--out", str(out)])
    controls.main(["--workload", "train_bf16_pretrain", "--seeds", "11", "--control",
                   "--out", str(out)])
    from benchmark import harness

    limits = {**harness.cell("serve_w8a8_vqa").traffic["check"],
              **harness.cell("train_bf16_pretrain").traffic["check"]}
    for line in out.read_text().splitlines():
        rec = json.loads(line)
        if rec["kind"].startswith("control"):
            vals = {k: (v["value"] if isinstance(v, dict) else v) for k, v in rec["checks"].items()}
            assert any(k in limits and limits[k] is not None and v > limits[k]
                       for k, v in vals.items()), rec


def test_the_served_reference_follows_the_serving_block(serve_cell):
    """Each statement of the configuration's ``serving`` block changes the
    reference's served logits: the weight bits, int8 activations, the
    tower's quantization and the int8 cache; a mode it does not know
    raises."""
    from benchmark.drivers import serve_closed_loop
    from benchmark.reference import aki_plain as ref

    model_cfg = serve_cell.config["model"]
    pool = serve_closed_loop.make_pool(serve_cell.traffic, model_cfg, SEED)[:2]
    prompts = [(ids, px, [7, 9, 11, 13]) for ids, px, _ in pool]
    w = W.make_weights(model_cfg, SEED, torch.bfloat16, CPU)
    base = dict(serve_cell.config["serving"])
    assert base == {"quant": "w8a8", "vision_quant": True, "kv_int8": True, "image_uint8": True}

    def logits(**change):
        served = ref.Served.of({**base, **change})
        with torch.no_grad():
            return torch.cat(ref.served_logits(w, model_cfg, prompts, served))

    want = logits()
    for change in ({"quant": "w8"}, {"quant": "w4a8"}, {"vision_quant": False},
                   {"kv_int8": False}):
        assert not torch.equal(logits(**change), want), change
    with pytest.raises(ValueError):
        ref.Served.of({**base, "quant": "w2"})


def test_the_trainer_is_held_to_frozen_tower(train_cell):
    """The configuration's ``frozen_tower`` decides which leaves the
    reference trains; a Trainer that trains otherwise stops the run."""
    train_cell.config = dict(train_cell.config,
                             training=dict(train_cell.config["training"], frozen_tower=False))
    with pytest.raises(RuntimeError, match="frozen_tower=False"):
        run(train_cell)
