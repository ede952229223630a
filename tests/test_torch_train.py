"""The port's training path against ``aki_tpu.train`` at aki_tiny in fp32:
optimizer masks, schedules, the train step (gradients, losses, grad_norm),
accumulation, multi-dataset steps, the frozen tower, remat and the runner.

Weights move through ``aki_torch.convert.from_jax_params``; inputs come from
a numpy seed. Tolerances: gradients within 1e-5 of each tensor's norm and
losses within 1e-4 relative over three AdamW steps (the same f32 math
summed in another order, through two layers and a clipped Adam update);
1e-5 for identities that hold exactly in real arithmetic (accumulation,
summed datasets) and bit equality where the computation is the same.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train import schedules as jax_schedules
from aki_tpu.train.step import Batch as JaxBatch
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import BF16, F32
from aki_torch.models.configs import aki_tiny
from aki_torch.train import optim, schedules
from aki_torch.train.metrics import MetricsLogger, ProfilerHook
from aki_torch.train.runner import RunnerConfig, Trainer
from aki_torch.train.step import Batch, TrainState, make_loss_fn, make_train_step

from ._jax_tiny import tiny_params

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
GRAD_TOL = 1e-5      # of each tensor's norm
LOSS_RTOL = 1e-4


def make_batch(rng, b=2, t=12, accum=None):
    def one():
        ids = rng.randint(5, CFG.initial_tokenizer_len - 1, size=(b, t)).astype(np.int32)
        ids[:, 1] = CFG.media_token_id
        ids[:, 7] = CFG.assistant_token_id
        valid = np.ones((b, t), np.int32)
        valid[-1, t - 3:] = 0                    # last row right-padded
        labels = np.where(np.arange(t)[None] > 7, ids, -100).astype(np.int32)
        labels[valid == 0] = -100
        imgs = rng.randn(b, CFG.siglip.image_size, CFG.siglip.image_size, 3)
        return Batch(ids, imgs.astype(np.float32), valid, labels)
    if accum is None:
        return one()
    parts = [one() for _ in range(accum)]
    return Batch(*(np.stack([getattr(p, f) for p in parts])
                   for f in ("input_ids", "images", "attn_valid", "labels")))


def to_jax(batch: Batch) -> JaxBatch:
    return JaxBatch(input_ids=jnp.asarray(batch.input_ids), images=jnp.asarray(batch.images),
                    attn_valid=jnp.asarray(batch.attn_valid), labels=jnp.asarray(batch.labels))


@pytest.fixture(scope="module")
def params():
    return tiny_params(0)


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


def trainable(model):
    return {n: p for n, p in model.named_parameters() if not optim.is_frozen_path(n)}


@pytest.mark.parametrize("policy", ["all", "except_embeddings"])
def test_optimizer_masks_match_jax(params, policy):
    """Tag every JAX leaf with its index, carry the tags through the
    converter, and check that each port parameter is in the decay and
    frozen sets exactly when the JAX leaves it came from are."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i + 1, np.float32) for i, (_, x) in enumerate(flat)])
    paths = [jax_optim._path_str(p) for p, _ in flat]
    jdecay = {"all": jax_optim.decay_everything,
              "except_embeddings": jax_optim.decay_except_embeddings}[policy]
    pdecay = {"all": optim.decay_everything,
              "except_embeddings": optim.decay_except_embeddings}[policy]
    model = AKIModel(CFG, device="cpu")
    opt = optim.make_optimizer(model, 1e-3, decay_predicate=pdecay)
    name_of = {id(p): n for n, p in model.named_parameters()}
    decay_names = {name_of[id(p)] for g in opt.opt.param_groups if g["weight_decay"] > 0
                   for p in g["params"]}
    in_optimizer = {name_of[id(p)] for g in opt.opt.param_groups for p in g["params"]}
    frozen_names = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen_names == set(name_of.values()) - in_optimizer
    seen = set()
    for name, tensor in from_jax_params(tagged, CFG).items():
        ids = {int(i) for i in np.unique(tensor.numpy())} - {0}
        assert ids, name
        for i in ids:
            path = paths[i - 1]
            frozen = jax_optim.is_frozen_path(path)
            assert (name in frozen_names) == frozen, (name, path)
            assert (name in decay_names) == (jdecay(path) and not frozen), (name, path)
        seen |= ids
    assert seen == set(range(1, len(flat) + 1))
    assert decay_names and frozen_names
    if policy == "except_embeddings":
        assert not any("embed" in n for n in decay_names)


@pytest.mark.parametrize("name,args", [
    ("cosine", (1e-3, 1e-5, 3, 10)), ("cosine", (1e-3, 1e-5, 0, 10)),
    ("linear", (1e-3, 0.0, 3, 10)), ("constant", (1e-3, 0.0, 3, 10)),
])
def test_schedules_match_optax(name, args):
    want = jax_schedules.make_schedule(name, *args)
    got = schedules.make_schedule(name, *args)
    for n in range(13):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-12)
    assert got(0) == (0.0 if args[2] > 0 else args[0])


@pytest.fixture(scope="module")
def jax_run(params):
    """JAX reference: first-step gradients, then three AdamW steps."""
    batch = make_batch(np.random.RandomState(1))
    jb = to_jax(batch)
    loss_fn = jax_make_loss_fn(CFG_J, JAX_F32, False, False)
    grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params), jb)
    opt = jax_optim.make_optimizer(params, 1e-3, weight_decay=0.1, grad_clip=1.0)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, params), opt)
    step = jax.jit(jax_make_train_step(CFG_J, opt, policy=JAX_F32, remat=True,
                                       use_flash=False))
    metrics = []
    for _ in range(3):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(batch=batch, grads=from_jax_params(jax.tree.map(np.asarray, grads), CFG),
                metrics=metrics)


@pytest.mark.parametrize("use_flash", [False, True])
def test_train_step_matches_jax(params, jax_run, use_flash):
    model = port_model(params)
    opt = optim.make_optimizer(model, 1e-3, weight_decay=0.1, grad_clip=1.0)
    batch = jax_run["batch"]
    make_loss_fn(CFG, F32, remat=True, use_flash=use_flash, device="cpu")(model, batch).backward()
    for name, p in trainable(model).items():
        want = jax_run["grads"][name]
        assert p.grad is not None, name
        tol = GRAD_TOL * max(float(want.norm()), 1e-3)
        assert float((p.grad - want).abs().max()) <= tol, name
    assert all(p.grad is None for n, p in model.named_parameters() if optim.is_frozen_path(n))

    state = TrainState(model, opt)
    step = make_train_step(CFG, policy=F32, remat=True, use_flash=use_flash, device="cpu")
    for want in jax_run["metrics"]:
        got = {k: float(v) for k, v in step(state, batch).items()}
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    assert state.step == opt.count == 3


class RecordingSGD:
    """A linear optimizer with the AdamWClip interface: p -= lr * g, and the
    gradients of each step kept in ``seen``."""

    def __init__(self, model, lr=1e-2):
        self.params = dict(trainable(model))
        for n, p in model.named_parameters():
            p.requires_grad_(n in self.params)
        self.lr, self.seen = lr, []

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self):
        self.seen.append({n: p.grad.clone() for n, p in self.params.items()})
        for p in self.params.values():
            p -= self.lr * p.grad
        return optim.global_norm([p.grad for p in self.params.values()])


def test_grad_accum_matches_big_batch(params):
    rng = np.random.RandomState(2)
    micro = make_batch(rng, b=2, accum=2)
    big = Batch(*(x.reshape(4, *x.shape[2:]) for x in (
        micro.input_ids, micro.images, micro.attn_valid, micro.labels)))
    big.attn_valid[:] = 1               # uniform token counts: mean of means == mean
    micro.attn_valid[:] = 1
    for b in (big, micro):
        b.labels[:] = np.where(np.arange(12) > 7, b.input_ids, -100)
    runs = []
    for batch, accum in ((big, 1), (micro, 2)):
        model = port_model(params)
        state = TrainState(model, RecordingSGD(model))
        m = make_train_step(CFG, policy=F32, grad_accum=accum, device="cpu")(state, batch)
        runs.append((float(m["loss"]), state.optimizer.seen[0]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    for name, g in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][name].numpy(), g.numpy(), rtol=1e-5, atol=1e-7)


def test_multi_dataset_step_sums_weighted_grads(params):
    rng = np.random.RandomState(3)
    batches = [dataclasses.replace(make_batch(rng), loss_weight=w) for w in (2.0, 0.5)]
    single = []
    for b in batches:
        model = port_model(params)
        state = TrainState(model, RecordingSGD(model))
        m = make_train_step(CFG, policy=F32, device="cpu")(state, b)
        single.append((float(m["loss"]), state.optimizer.seen[0]))
    model = port_model(params)
    state = TrainState(model, RecordingSGD(model))
    m = make_train_step(CFG, policy=F32, device="cpu")(state, tuple(batches))
    np.testing.assert_allclose(float(m["loss"]), (single[0][0] + single[1][0]) / 2, rtol=1e-6)
    for name, g in state.optimizer.seen[0].items():
        np.testing.assert_allclose(g.numpy(), (single[0][1][name] + single[1][1][name]).numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_frozen_tower_untouched_and_stateless(params):
    model = port_model(params)
    tower = {n: p.detach().clone() for n, p in model.vision_encoder.named_parameters()}
    opt = optim.make_optimizer(model, 1e-2)
    state = TrainState(model, opt)
    step = make_train_step(CFG, policy=F32, device="cpu")
    for _ in range(2):
        step(state, make_batch(np.random.RandomState(4)))
    held = {id(p) for p in opt.opt.state}
    for n, p in model.vision_encoder.named_parameters():
        assert torch.equal(p, tower[n]) and p.grad is None and not p.requires_grad
        assert id(p) not in held
    assert len(held) == len(opt.params) == len(trainable(model))


def test_remat_and_bf16_tower_keep_the_loss(params):
    batch = make_batch(np.random.RandomState(5))
    losses, grads = [], []
    for remat in (False, True):
        model = port_model(params)
        loss = make_loss_fn(CFG, F32, remat=remat, use_flash=True, device="cpu")(model, batch)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in trainable(model).items()})
    assert losses[0] == losses[1]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-8)
    bf16 = []
    for frozen_bf16 in (False, True):
        model = port_model(params)
        if frozen_bf16:
            optim.cast_frozen_to(model)
            assert model.vision_encoder.post_layernorm.weight.dtype == torch.bfloat16
        with torch.no_grad():
            bf16.append(float(make_loss_fn(CFG, BF16, remat=True, use_flash=True,
                                           device="cpu")(model, batch)))
    assert bf16[0] == bf16[1]


def test_run_epoch_groups_accumulation_and_logs(params, tmp_path):
    rng = np.random.RandomState(6)
    loader = [make_batch(rng) for _ in range(5)]
    trainer = Trainer(CFG, RunnerConfig(run_dir=str(tmp_path), grad_accum=2, log_every=1,
                                        warmup_steps=0, precision="fp32"),
                      model=port_model(params), device="cpu",
                      metrics=MetricsLogger(str(tmp_path), use_tensorboard=False))
    assert trainer.run_epoch(iter(loader), epoch=0) == 2   # the 5th batch is dropped
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["training_loss"]) and r["grad_norm"] > 0 for r in recs)
    mixed = [dataclasses.replace(loader[0], loss_weight=1.0),
             dataclasses.replace(loader[1], loss_weight=2.0)]
    with pytest.raises(AssertionError, match="one loss_weight"):
        Trainer._stack_micro(mixed)


def test_profiler_hook_writes_a_trace(tmp_path):
    hook = ProfilerHook(str(tmp_path), start_step=1, num_steps=2)
    for step in range(4):
        hook.step(step)
        torch.ones(8) @ torch.ones(8)
    assert [p.name for p in (tmp_path / "profile").iterdir()] == ["trace_1.json"]


def test_trainer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, RunnerConfig())
    with pytest.raises(TypeError):
        RunnerConfig(mesh=None)          # multi-device fields are not ported
