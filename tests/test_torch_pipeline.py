"""Pipeline parallelism on a 2-rank gloo group (``pipe=2``, 2
microbatches) at aki_tiny in fp32: the dense model's Trainer against the
JAX package's unsharded ``make_train_step`` (the pipe changes no number),
the MoE decoder's pipelined forward (hidden states, the aux through the
pipe, the input's gradient) against JAX's ``phi3_forward_pp`` on a 2-device
``pipe`` mesh, and the configuration errors.

One group runs every case (``tests/_torch_dist_cases.py:pipe_cases``).
Tolerances: hidden states and aux within 1e-5; gradients within 1e-5 of
each tensor's norm; losses and grad norms within 1e-4.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from aki_tpu.parallel.mesh import create_mesh as jax_create_mesh
from aki_tpu.parallel.pipeline import phi3_forward_pp as jax_forward_pp
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import MoEConfig, aki_tiny
from aki_torch.parallel.pipeline import shard_pipeline

from ._jax_tiny import cfg_params, tiny_params
from ._torch_dist import run_group
from ._torch_dist_cases import NoMetrics, run_config, state_numpy, train
from .test_torch_zero import make_batch, to_jax

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
MOE = dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=1.0)
TOL = 1e-5
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    params = tiny_params(0)
    batch = make_batch(np.random.RandomState(14))
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

    # the MoE decoder through JAX's pipe, on 4 rows of 10 spliced tokens
    cfg_j = dataclasses.replace(CFG_J, phi3=dataclasses.replace(
        CFG_J.phi3, moe=jax_configs.MoEConfig(**MOE)))
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3, moe=MoEConfig(**MOE)))
    mparams = cfg_params(cfg_j, 1)
    rng = np.random.RandomState(15)
    b, t, d = 4, 10, CFG.phi3.hidden_size
    kvv = np.ones((b, t), np.int32)
    kvv[3, 7:] = 0
    fwd = dict(x=rng.randn(b, t, d).astype(np.float32), g=rng.randn(b, t, d).astype(np.float32),
               positions=np.tile(np.arange(t, dtype=np.int32), (b, 1)), kv_valid=kvv,
               img_start=np.array([1, 1, 0, 2], np.int32),
               txt_start=np.array([4, 4, 0, 5], np.int32),
               txt_end=np.array([8, 6, 0, 9], np.int32))
    mesh = jax_create_mesh(JaxMeshConfig(data=1, fsdp=1, pipe=2))
    spec = JaxSpec(*(jnp.asarray(fwd[k]) for k in ("img_start", "txt_start", "txt_end")))

    def loss(x):
        h, aux = jax_forward_pp(jax.tree.map(jnp.asarray, mparams["phi3"]), cfg_j.phi3, x,
                                jnp.asarray(fwd["positions"]), spec, jnp.asarray(kvv), mesh,
                                num_microbatches=2, policy=JAX_F32, use_flash=False)
        return jnp.sum(h * fwd["g"]) + aux, (h, aux)

    (_, (h, aux)), dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(fwd["x"]))
    weights, moe_weights = tmp / "weights.pt", tmp / "moe.pt"
    torch.save(from_jax_params(params, CFG), weights)
    torch.save(from_jax_params(mparams, cfg), moe_weights)
    from aki_torch.train.runner import Trainer

    single = Trainer(CFG, run_config(str(tmp / "single")), model=port_model(params),
                     device="cpu", metrics=NoMetrics())
    train(single, batch)
    single.ckpt.save(single.state, epoch=0)
    ranks = run_group("_torch_dist_cases:pipe_cases", 2, tmp / "group", timeout=300,
                      weights=str(weights), moe_weights=str(moe_weights), moe_fields=MOE,
                      batch=batch, fwd=fwd, run_dir=str(tmp / "runs"),
                      restore_dir=str(tmp / "single"))
    return dict(metrics=metrics, grads=from_jax_params(jax.tree.map(np.asarray, grads), CFG),
                moe=dict(hidden=np.asarray(h), aux=float(aux), dx=np.asarray(dx)), ranks=ranks,
                params=params, batch=batch, single=state_numpy(single))


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


def test_pipe_step_matches_jax(run):
    """Each stage holds one of the two layers; 3 steps' loss and grad_norm
    on every stage, and the first step's gradients of every parameter a
    stage holds, are JAX's unsharded step's."""
    stages = [r["dense"] for r in run["ranks"]]
    assert [s["layers"] for s in stages] == [[0], [1]]
    for s in stages:
        for g, want in zip(s["metrics"], run["metrics"]):
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    factor = min(1.0, 1.0 / run["metrics"][0]["grad_norm"])
    seen = set()
    for s in stages:
        for name, g in s["grads"].items():
            want = run["grads"][name].numpy() * factor
            tol = TOL * max(float(np.linalg.norm(want)), 1e-3)
            assert float(np.abs(g - want).max()) <= tol, name
            seen.add(name)
    assert any(".layers.0." in n for n in seen) and any(".layers.1." in n for n in seen)


def test_moe_aux_through_the_pipe_matches_jax(run):
    """The MoE decoder's pipelined forward on every stage: hidden states and
    the aux (summed over the microbatches over M) are JAX
    ``phi3_forward_pp``'s, and so is the input's gradient."""
    want = run["moe"]
    for r in run["ranks"]:
        got = r["moe"]
        tol = TOL * max(float(np.abs(want["hidden"]).max()), 1.0)
        assert float(np.abs(got["hidden"] - want["hidden"]).max()) <= tol
        assert abs(got["aux"] - want["aux"]) <= TOL * max(abs(want["aux"]), 1.0)
        assert want["aux"] > 0
        tol = TOL * max(float(np.linalg.norm(want["dx"])), 1.0)
        assert float(np.abs(got["dx"] - want["dx"]).max()) <= tol


def test_pipe_config_errors_are_value_errors(run):
    for r in run["ranks"]:
        assert "num_microbatches" in r["odd_batch"]
    sizes = {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1, "pipe": 2, "expert": 1}
    for extra, match in (({"tensor": 2}, "tensor"), ({"seq": 2}, "seq"),
                         ({"expert": 2}, "expert")):
        mesh = types.SimpleNamespace(shape={**sizes, **extra})
        with pytest.raises(ValueError, match=match):
            shard_pipeline(AKIModel(CFG, device="cpu"), mesh)
    three = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3, num_layers=3))
    with pytest.raises(ValueError, match="split evenly"):
        shard_pipeline(AKIModel(three, device="cpu"), types.SimpleNamespace(shape=sizes))


def _stages_union(ranks, key):
    """The stages' weights and moments, each name from the stage holding
    it (the names outside the layers are the same on both)."""
    out = {"weights": {}, "moments": {}}
    for r in ranks:
        for kind in out:
            for k, v in r[key][kind].items():
                if k in out[kind]:
                    assert np.array_equal(out[kind][k], v), k
                out[kind][k] = v
    return out


def test_pipe_checkpoint_restores_on_one_device(run):
    """Written at pipe=2 (each stage's layers and moments to the first
    stage, rank 0 writes), restored on one device: every weight and moment
    bitwise the stages'; the next step matches the pipeline's 4th."""
    from aki_torch.train.runner import Trainer

    dense = run["ranks"][0]["dense"]
    t = Trainer(CFG, run_config(dense["ckpt"].rsplit("/", 1)[0], training_mode="resume"),
                model=port_model(run["params"]), device="cpu", metrics=NoMetrics())
    got, want = state_numpy(t), _stages_union([r["dense"] for r in run["ranks"]], "saved")
    assert got["step"] == 3
    assert set(got["moments"]) == set(want["moments"])
    for kind in ("weights", "moments"):
        for k, v in want[kind].items():
            assert np.array_equal(got[kind][k], v), k
    m = t.step_fn(t.state, t.put_batch(run["batch"]))
    np.testing.assert_allclose(float(m["loss"]), dense["step4"]["loss"], rtol=LOSS_RTOL)


def test_one_device_checkpoint_restores_at_pipe2(run):
    """A single-device run dir restored at pipe=2: each stage holds its
    layers' weights and moments bitwise."""
    got, want = _stages_union(run["ranks"], "restored"), run["single"]
    assert set(got["moments"]) == set(want["moments"])
    for kind in ("weights", "moments"):
        for k, v in got[kind].items():
            assert np.array_equal(v, want[kind][k]), k
    assert all(r["restored"]["step"] == 3 for r in run["ranks"])
