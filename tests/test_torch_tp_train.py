"""Training over the ``tensor`` axis (Megatron blocks, the differentiable
collectives, FSDP2 over the ``(data, fsdp)`` sub-mesh of the TP-local
weights) on gloo groups, against the JAX package's ``make_train_step`` on
the global batch at aki_tiny in fp32 (the comparison JAX's own
``tests/test_sharding_consistency.py`` makes between its sharded and
unsharded steps).

Two groups, as the meshes need two world sizes
(``tests/_torch_dist_cases.py:tp_train_cases``): 2 ranks run tensor=2
(steps, checkpoints both ways with one device and fsdp=2); 4 ranks run fsdp=2 x tensor=2
(also with ``host_offload_params``), data=2 x tensor=2,
tensor=2 x seq=2 and the MoE model at expert=2 x tensor=2 (held to the
port's single-device Trainer, which ``tests/test_torch_moe.py`` holds to
JAX). At ``tensor=2`` aki_tiny's tower (2 heads) and Perceiver (2 heads)
are cut to one head a rank, with the decoder. Tolerances: gradients within
1e-5 of each tensor's norm; 3 AdamW steps' loss and grad_norm within 1e-4;
the replicated weights' gradients equal on the tensor ranks; checkpoints
restore bitwise. Both CLIs at ``mesh.tensor=2`` run in
``tests/test_torch_train_cli.py``'s group, against the single-device CLI
that the same file holds to JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import MoEConfig, aki_tiny
from aki_torch.train import optim
from aki_torch.train.runner import Trainer

from ._jax_tiny import tiny_params
from ._torch_dist import run_group
from ._torch_dist_cases import NoMetrics, run_config, state_numpy, train
from .test_torch_zero import assert_offload_run, make_batch, port_model, to_jax

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-4
MOE = dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=1.25)


def jax_reference(params, batch) -> dict:
    """The JAX step unsharded on ``batch``: 3 steps' metrics and the first
    step's gradients (as the port's state dict)."""
    jb = to_jax(batch)
    jparams = jax.tree.map(jnp.asarray, params)
    grads = jax.jit(jax.grad(jax_make_loss_fn(CFG_J, JAX_F32, False, False)))(jparams, jb)
    opt = jax_optim.make_optimizer(params, 1e-3, weight_decay=0.1, grad_clip=1.0)
    state = JaxTrainState.create(jparams, opt)
    step = jax.jit(jax_make_train_step(CFG_J, opt, policy=JAX_F32, remat=True,
                                       use_flash=False))
    metrics = []
    for _ in range(3):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, grads=from_jax_params(jax.tree.map(np.asarray, grads), CFG))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    params = tiny_params(0)
    # 13 text tokens: 18 spliced, split over seq=2 as well
    batch = make_batch(np.random.RandomState(11), t=13)
    ref = jax_reference(params, batch)
    weights = tmp / "weights.pt"
    torch.save(from_jax_params(params, CFG), weights)

    # a run dir written on one device after 3 steps, restored at tensor=2
    # and at fsdp=2 x tensor=2
    single = Trainer(CFG, run_config(str(tmp / "single")), model=port_model(params),
                     device="cpu", metrics=NoMetrics())
    train(single, batch)
    single.ckpt.save(single.state, epoch=0)

    # the MoE model's single-device reference
    moe_cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3, moe=MoEConfig(**MOE)))
    moe_model = AKIModel(moe_cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    moe_weights = tmp / "moe.pt"
    torch.save(moe_model.state_dict(), moe_weights)
    moe_ref = Trainer(moe_cfg, run_config(str(tmp / "moe_single"), moe_aux_weight=0.5),
                      model=moe_model, device="cpu", metrics=NoMetrics())
    moe_metrics, moe_grads = train(moe_ref, batch)

    common = dict(weights=str(weights), batch=batch, restore_dir=str(tmp / "single"))
    two = run_group("_torch_dist_cases:tp_train_cases", 2, tmp / "g2", timeout=300,
                    run_dir=str(tmp / "runs2"), **common)
    four = run_group("_torch_dist_cases:tp_train_cases", 4, tmp / "g4", timeout=300,
                     run_dir=str(tmp / "runs4"), moe_weights=str(moe_weights),
                     moe_fields=MOE, **common)
    return dict(params=params, batch=batch, ref=ref, two=two, four=four,
                single=single, single_state=state_numpy(single),
                moe=dict(metrics=moe_metrics, grads=moe_grads))


def assert_steps(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=LOSS_RTOL)


def assert_grads(got, want, norm):
    """The first step's gradients (read after the clip) against the
    unclipped reference ones."""
    factor = min(1.0, 1.0 / norm)
    assert set(got) == {n for n in want if not optim.is_frozen_path(n)}
    for name, g in got.items():
        w = np.asarray(want[name]) * factor
        tol = GRAD_TOL * max(float(np.linalg.norm(w)), 1e-3)
        assert float(np.abs(g - w).max()) <= tol, name


CASES = {"tp2": ("two", 4), "fsdp2_tp2": ("four", 2), "dp2_tp2": ("four", 2),
         "tp2_seq2": ("four", 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_steps_match_jax(run, case):
    """Each mesh's 3 steps (loss, grad_norm) and first-step gradients are
    JAX's on the global batch; each rank keeps its (data, fsdp) rows (the
    tensor ranks the same rows)."""
    group, rows = CASES[case]
    ref = run["ref"]
    ranks = [r[case] for r in run[group]]
    for r in ranks:
        assert_steps(r["metrics"], ref["metrics"])
        assert r["local_rows"] == rows
    assert_grads(ranks[0]["grads"], ref["grads"], ref["metrics"][0]["grad_norm"])


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_grads_equal_on_tensor_ranks(run, case):
    """The norms, the tables, the extra head, the head's and the row-parallel
    products' biases and the Perceiver latents: the same gradient on every
    rank of a tensor pair (the ranks that differ only in their tensor
    coordinate hold the same shard of it)."""
    group, _ = CASES[case]
    ranks = [r[case] for r in run[group]]
    by_tensor = {}
    for r in ranks:
        by_tensor.setdefault(r["tensor_rank"], []).append(r["replicated"])
    assert sorted(by_tensor) == [0, 1]
    names = set(by_tensor[0][0])
    assert {"lang_model.model.norm.weight", "vision_tokenizer.latents",
            "lang_model.model.embed_tokens.weight",
            "lang_model.lm_head.additional_fc.weight"} <= names
    for a, b in zip(by_tensor[0], by_tensor[1]):
        assert set(a) == set(b) == names
        for n in names:
            assert np.array_equal(a[n], b[n]), n


def test_tp2_splits_whole_heads(run):
    """tensor=2 at aki_tiny: the decoder, the tower and the Perceiver are
    cut (each holds 1 of their 2 heads), the head by vocab rows, the
    tables and the extra head whole; column-parallel biases go with their
    rows."""
    split = run["two"][0]["tp2"]["split"]
    assert split["lang_model.model.layers.0.self_attn.qkv_proj.weight"] == 0
    assert split["lang_model.model.layers.0.mlp.down_proj.weight"] == 1
    assert split["lang_model.lm_head.weight"] == split["lang_model.lm_head.bias"] == 0
    assert split["vision_encoder.encoder.layers.0.self_attn.q_proj.bias"] == 0
    assert split["vision_encoder.embeddings.patch_embedding.weight"] == 0
    assert split["vision_tokenizer.layers.1.0.to_kv.weight"] == 0
    assert split["vision_tokenizer.layers.1.1.3.weight"] == 1
    assert split["vision_tokenizer.projection.bias"] == 0
    for whole in ("lang_model.model.embed_tokens.weight", "vision_tokenizer.latents",
                  "lang_model.lm_head.additional_fc.weight",
                  "vision_encoder.encoder.layers.0.self_attn.out_proj.bias",
                  "lang_model.model.layers.0.input_layernorm.weight"):
        assert whole not in split


@pytest.mark.parametrize("group,case", [("two", "tp2"), ("four", "fsdp2_tp2")])
def test_tp_checkpoint_restores_on_one_device(run, group, case):
    """Written at tensor=2 / fsdp=2 x tensor=2 (gathered part by part, rank
    0 writes), restored on one device bitwise, weights and AdamW moments;
    the next step matches the sharded run's 4th."""
    r0 = run[group][0][case]
    run_dir = r0["ckpt"].rsplit("/", 1)[0]
    t = Trainer(CFG, run_config(run_dir, training_mode="resume"),
                model=port_model(run["params"]), device="cpu", metrics=NoMetrics())
    got, want = state_numpy(t), r0["saved"]
    assert got["step"] == want["step"] == 3
    for kind in ("weights", "moments"):
        assert set(got[kind]) == set(want[kind])
        for k in want[kind]:
            assert np.array_equal(got[kind][k], want[kind][k]), k
    m = t.step_fn(t.state, t.put_batch(run["batch"]))
    np.testing.assert_allclose(float(m["loss"]), r0["step4"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), r0["step4"]["grad_norm"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("case,want", [("tp2_on_fsdp2", "tp2"),
                                       ("single_on_tp2", "single"),
                                       ("single_on_fsdp2_tp2", "single")])
def test_tp_checkpoint_moves_between_meshes(run, case, want):
    """A tensor=2 run dir restored at fsdp=2, and a single-device one at
    tensor=2 and at fsdp=2 x tensor=2: every weight and moment bitwise."""
    group = "four" if case.endswith("fsdp2_tp2") else "two"
    got = run[group][0][case]
    ref = run["single_state"] if want == "single" else run["two"][0]["tp2"]["saved"]
    assert got["step"] == ref["step"] == 3
    assert all(r[case]["step"] == 3 for r in run[group])
    for kind in ("weights", "moments"):
        assert set(got[kind]) == set(ref[kind])
        for k in ref[kind]:
            assert np.array_equal(got[kind][k], ref[kind][k]), k


def test_host_offload_at_fsdp2_tp2(run):
    """host_offload_params at fsdp=2 x tensor=2 (each rank's state: its
    FSDP2 shards of its tensor blocks): 3 steps bitwise those of the same
    mesh without it and within 1e-4 of JAX; every storage empty between
    steps; the offloaded checkpoint bitwise the plain one; a resume from it
    takes the plain run's 4th step bitwise."""
    assert_offload_run(run["four"], "fsdp2_tp2", "fsdp2_tp2_offload", run["ref"]["metrics"])


def test_moe_trains_at_expert2_tensor2(run):
    """The MoE model at expert=2 x tensor=2: each expert weight is a block
    over both axes, and 3 steps and the first step's gradients are the
    single-device Trainer's."""
    for r in run["four"]:
        got = r["moe_ep2_tp2"]
        assert got["expert_tensor"] == {f"lang_model.model.layers.{i}.mlp.w_{w}"
                                        for i in range(CFG.phi3.num_layers)
                                        for w in ("gate", "up", "down")}
        assert_steps(got["metrics"], run["moe"]["metrics"])
    grads = run["four"][0]["moe_ep2_tp2"]["grads"]
    want = run["moe"]["grads"]
    assert set(grads) == set(want)
    for n, g in grads.items():
        tol = GRAD_TOL * max(float(np.linalg.norm(want[n])), 1e-3)
        assert float(np.abs(g - want[n]).max()) <= tol, n

