"""The port's checkpoints: naming, newest-by-step, keep_last, the frozen
filter, lenient restore, resume, and a port checkpoint read by the JAX
package's importer (``aki_tpu.convert``) with equal logits (fp32, 1e-4: a
whole forward in another framework, as in ``test_torch_model.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.convert.cli import load_torch_state_dict
from aki_tpu.convert.torch_to_jax import convert_aki_checkpoint
from aki_tpu.models import configs as jax_configs
from aki_tpu.models.aki import aki_forward as jax_aki_forward
from aki_tpu.models.common import F32 as JAX_F32
from aki_torch.models.aki import AKIModel, aki_forward
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny
from aki_torch.train.checkpoints import CheckpointManager
from aki_torch.train.metrics import MetricsLogger
from aki_torch.train.optim import make_optimizer
from aki_torch.train.runner import RunnerConfig, Trainer
from aki_torch.train.step import Batch, TrainState

CFG = aki_tiny()


def new_state(seed=0) -> TrainState:
    model = AKIModel(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))
    return TrainState(model, make_optimizer(model, 1e-3))


def trainer(tmp_path, **run) -> Trainer:
    """A CPU Trainer on ``tmp_path`` (metrics to JSONL only: importing
    TensorBoard costs seconds here)."""
    return Trainer(CFG, RunnerConfig(run_dir=str(tmp_path), **run), device="cpu",
                   metrics=MetricsLogger(str(tmp_path), use_tensorboard=False))


def batch(seed=0, b=2, t=12) -> Batch:
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, CFG.initial_tokenizer_len - 1, size=(b, t)).astype(np.int32)
    ids[:, 1] = CFG.media_token_id
    ids[:, 7] = CFG.assistant_token_id
    labels = np.where(np.arange(t)[None] > 7, ids, -100).astype(np.int32)
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    return Batch(ids, images, np.ones((b, t), np.int32), labels)


def test_naming_latest_and_keep_last(tmp_path):
    state = new_state()
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    assert mgr.latest() is None
    for epoch, step in ((0, 10), (1, 5), (0, 20)):
        state.step = step
        path = mgr.save(state, epoch=epoch)
        assert path.name == f"checkpoint_{epoch}_{step}.pt"
    assert [(e, s) for e, s, _ in mgr.list_checkpoints()] == [(0, 10), (0, 20)]
    assert mgr.latest().name == "checkpoint_0_20.pt"
    assert CheckpointManager(str(tmp_path)).latest() == mgr.latest()


def test_frozen_filter_and_include_frozen(tmp_path):
    state = new_state()
    mgr = CheckpointManager(str(tmp_path))
    plain = torch.load(mgr.save(state, epoch=0, step=1), weights_only=False)
    full = torch.load(mgr.save(state, epoch=0, step=2, include_frozen=True), weights_only=False)
    names = set(state.model.state_dict())
    frozen = {n for n in names if n.startswith("vision_encoder.")}
    assert frozen and set(plain["model_state_dict"]) == names - frozen
    assert set(full["model_state_dict"]) == names
    assert {"optimizer_state_dict", "step", "epoch"} <= set(plain)


def test_lenient_restore_and_resume(tmp_path):
    first = trainer(tmp_path, warmup_steps=0, log_every=1, checkpoint_steps=2)
    assert first.run_epoch(iter([batch(1), batch(2)]), epoch=3) == 2
    saved = {n: p.detach().clone() for n, p in first.model.named_parameters()}
    path = CheckpointManager(str(tmp_path)).latest()
    assert path.name == "checkpoint_3_2.pt"

    resumed = trainer(tmp_path, training_mode="resume", seed=7)
    assert (resumed.state.step, resumed.epoch, resumed.state.optimizer.count) == (2, 3, 2)
    for n, p in resumed.model.named_parameters():
        if not n.startswith("vision_encoder."):
            assert torch.equal(p, saved[n]), n
    tower_w = "vision_encoder.encoder.layers.0.self_attn.q_proj.weight"
    assert not torch.equal(dict(resumed.model.named_parameters())[tower_w], saved[tower_w])
    assert len(resumed.state.optimizer.opt.state) == len(resumed.state.optimizer.params)

    # a key missing from the file and a key of another shape keep the init
    blob = torch.load(path, weights_only=False)
    del blob["model_state_dict"]["lang_model.model.norm.weight"]
    blob["model_state_dict"]["vision_tokenizer.latents"] = torch.zeros(3, CFG.perceiver.dim)
    torch.save(blob, tmp_path / "checkpoint_9_9.pt")
    fresh = new_state(seed=11)
    init = {n: p.detach().clone() for n, p in fresh.model.named_parameters()}
    fresh, epoch = CheckpointManager(str(tmp_path)).restore(fresh)
    assert (fresh.step, epoch) == (2, 3)      # the counters the file holds
    got = dict(fresh.model.named_parameters())
    for n in ("lang_model.model.norm.weight", "vision_tokenizer.latents"):
        assert torch.equal(got[n], init[n])
    assert torch.equal(got["lang_model.lm_head.weight"], saved["lang_model.lm_head.weight"])

    sft = trainer(tmp_path, training_mode="sft_scratch")
    assert (sft.state.step, sft.state.optimizer.count, len(sft.state.optimizer.opt.state)) \
        == (0, 0, 0)


def test_restore_skips_only_another_optimizer(tmp_path):
    """A saved optimizer state of other groups keeps the fresh one; a state
    that fits is loaded whole, or the restore raises."""
    first = trainer(tmp_path, warmup_steps=0, log_every=1, checkpoint_steps=2)
    first.run_epoch(iter([batch(1), batch(2)]), epoch=0)
    blob = torch.load(CheckpointManager(str(tmp_path)).latest(), weights_only=False)
    adamw = blob["optimizer_state_dict"]["adamw"]

    fresh, _ = CheckpointManager(str(tmp_path)).restore(new_state(seed=11))
    assert fresh.optimizer.count == 2
    names = {id(p): n for n, p in fresh.model.named_parameters()}
    order = [names[id(p)] for g in fresh.optimizer.opt.param_groups for p in g["params"]]
    live = {names[id(p)]: st for p, st in fresh.optimizer.opt.state.items()}
    assert set(live) == {order[i] for i in adamw["state"]}
    for i, st in adamw["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(live[order[i]][k], st[k]), (order[i], k)

    other = tmp_path / "other"
    other.mkdir()
    adamw["param_groups"][0]["params"].pop()            # a group of another size
    torch.save(blob, other / "checkpoint_0_2.pt")
    fresh, _ = CheckpointManager(str(other)).restore(new_state(seed=11))
    assert (fresh.step, fresh.optimizer.count, len(fresh.optimizer.opt.state)) == (2, 0, 0)

    adamw["param_groups"][0]["params"].append(len(order) - 1)
    first_moment = min(adamw["state"])
    adamw["state"][first_moment]["exp_avg"] = torch.zeros(3)   # fits, but broken
    torch.save(blob, other / "checkpoint_0_2.pt")
    with pytest.raises(ValueError, match="a moment of"):
        CheckpointManager(str(other)).restore(new_state(seed=11))


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A port checkpoint read by the JAX importer (with the tower added, as
    an imported run dir carries it) gives the port's logits."""
    state = new_state(seed=3)
    with torch.no_grad():                      # nonzero biases, so they count
        for n, p in state.model.named_parameters():
            if n.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    path = CheckpointManager(str(tmp_path)).save(state, epoch=0, step=0)
    sd, blob = load_torch_state_dict(str(path))
    assert blob["step"] == 0 and not any(k.startswith("vision_encoder.") for k in sd)
    sd.update({k: v for k, v in state.model.state_dict().items()
               if k.startswith("vision_encoder.")})
    params = convert_aki_checkpoint(sd, jax_configs.aki_tiny())
    b = batch(5)
    cfg_j = jax_configs.aki_tiny()
    want = jax.jit(lambda p, *x: jax_aki_forward(p, cfg_j, *x, policy=JAX_F32,
                                                 use_flash=False).logits)(
        jax.tree.map(jnp.asarray, params), b.input_ids, b.images, b.attn_valid)
    with torch.no_grad():
        got = aki_forward(state.model, b.input_ids, b.images, b.attn_valid, policy=F32,
                          use_flash=False, device="cpu").logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["resume", "sft_resume"])
def test_resume_without_checkpoint_starts_fresh(tmp_path, mode):
    fresh = trainer(tmp_path, training_mode=mode)
    assert (fresh.state.step, fresh.epoch) == (0, 0)
