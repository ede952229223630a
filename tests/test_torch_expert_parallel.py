"""Expert parallelism and the MoE decoder over a split batch, on a 4-rank
gloo group (``data=2 x expert=2``, ``fsdp=2 x expert=2``, ``data=4``) at
aki_tiny widths in fp32, against the JAX package on the global tokens.

One MoE layer, each rank holding 2 of the 4 rows and 2 of the 4 experts:
its outputs, aux and gradients equal JAX ``moe_mlp``'s on the global
tokens, and so do its kept choices, with room for every choice and with
overflow (where a rank routing its own rows alone would drop others). Then
the MoE model's Trainer (aux weight 0.5), 3 steps against JAX's unsharded
``make_train_step``, and a checkpoint written at fsdp=2 x expert=2 restored
on one device. Tolerances: outputs and aux within 1e-5; gradients within
1e-5 of each tensor's norm; losses and grad norms within 1e-4; drops equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models import moe as jax_moe
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import MoEConfig, aki_tiny

from ._jax_tiny import cfg_params
from ._torch_dist import run_group
from ._torch_dist_cases import NoMetrics, run_config
from .test_torch_zero import make_batch, to_jax

MOE = {"fit": dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=2.0),
       "overflow": dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=0.5)}
D = 16
TOL = 1e-5
LOSS_RTOL = 1e-4


def jax_keep(params, x, cfg):
    """JAX's routing of ``moe_mlp`` on the global tokens: kept choices."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ params["router"]["w"], axis=-1)
    top_p, top_idx = jax.lax.top_k(probs, cfg.top_k)
    n, e = xf.shape[0], cfg.num_experts
    cap = max(int(-(-n * cfg.top_k * cfg.capacity_factor // e)), 1)
    flat = jax.nn.one_hot(top_idx, e, dtype=jnp.int32).transpose(1, 0, 2).reshape(-1, e)
    pos = ((jnp.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(cfg.top_k, n).T
    return np.asarray((pos < cap) & (top_p > 0)), cap


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    rng = np.random.RandomState(31)
    x = rng.randn(4, 6, D).astype(np.float32)
    g = rng.randn(4, 6, D).astype(np.float32)
    params = jax_moe.init_moe(jax.random.PRNGKey(5), D, jax_configs.MoEConfig(**MOE["fit"]),
                              0.5)
    params = jax.tree.map(np.asarray, params)
    layer = {"router": params["router"]["w"].T.copy(),
             **{w: params[w] for w in ("w_gate", "w_up", "w_down")}}
    ref = {}
    for name, fields in MOE.items():
        cfg = jax_configs.MoEConfig(**fields)

        def loss(p, xx):
            o, aux = jax_moe.moe_mlp(p, xx, cfg)
            return jnp.sum(o * g) + 0.5 * aux, (o, aux)

        (_, (o, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        keep, cap = jax_keep(params, x, cfg)
        ref[name] = dict(out=np.asarray(o), aux=float(aux), dx=np.asarray(gx), keep=keep,
                         cap=cap, router=np.asarray(gp["router"]["w"]).T,
                         experts={w: np.asarray(gp[w]) for w in ("w_gate", "w_up", "w_down")})

    cfg_j = dataclasses.replace(jax_configs.aki_tiny(), phi3=dataclasses.replace(
        jax_configs.aki_tiny().phi3, moe=jax_configs.MoEConfig(**MOE["fit"])))
    cfg = dataclasses.replace(aki_tiny(), phi3=dataclasses.replace(
        aki_tiny().phi3, moe=MoEConfig(**MOE["fit"])))
    mparams = cfg_params(cfg_j, 0)
    batch = make_batch(np.random.RandomState(13))
    opt = jax_optim.make_optimizer(mparams, 1e-3, weight_decay=0.1, grad_clip=1.0)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, mparams), opt)
    step = jax.jit(jax_make_train_step(cfg_j, opt, policy=JAX_F32, remat=True,
                                       use_flash=False, moe_aux_weight=0.5))
    metrics = []
    for _ in range(3):
        state, m = step(state, to_jax(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    weights = tmp / "weights.pt"
    torch.save(from_jax_params(mparams, cfg), weights)
    ranks = run_group("_torch_dist_cases:expert_cases", 4, tmp / "group", timeout=300,
                      layer=layer, x=x, g=g, moe_cfgs=MOE, weights=str(weights), batch=batch,
                      run_dir=str(tmp / "runs"))
    return dict(ref=ref, ranks=ranks, metrics=metrics, cfg=cfg, weights=weights, x=x,
                layer=layer)


def _close(got, want, what):
    tol = TOL * max(float(np.linalg.norm(want)), 1.0)
    assert float(np.abs(got - want).max()) <= tol, what


def _by_batch(ranks, name, key):
    """Rows of the expert rank 0 copies, in batch order."""
    rs = sorted((r[name] for r in ranks if r[name]["expert_rank"] == 0),
                key=lambda r: r["batch_index"])
    return np.concatenate([r[key] for r in rs])


@pytest.mark.parametrize("name", ["fit", "overflow"])
def test_ep_layer_matches_jax_on_global_tokens(run, name):
    want = run["ref"][name]
    ranks = run["ranks"]
    _close(_by_batch(ranks, name, "out"), want["out"], "out")
    _close(_by_batch(ranks, name, "dx"), want["dx"], "dx")
    for r in ranks:
        assert abs(r[name]["aux"] - want["aux"]) <= TOL
        assert r[name]["cap"] == want["cap"]
    # the expert ranks hold the same tokens and compute the same outputs
    for b in range(2):
        pair = [r[name] for r in ranks if r[name]["batch_index"] == b]
        assert np.array_equal(pair[0]["out"], pair[1]["out"])
    # parameter gradients: summed over the batch ranks, experts concatenated
    router = sum(r[name]["router"] for r in ranks if r[name]["expert_rank"] == 0)
    _close(router, want["router"], "router grad")
    for w, wg in want["experts"].items():
        blocks = [sum(r[name]["experts"][w] for r in ranks if r[name]["expert_rank"] == e)
                  for e in range(2)]
        _close(np.concatenate(blocks), wg, f"{w} grad")


@pytest.mark.parametrize("name", ["fit", "overflow"])
def test_ep_drops_are_global(run, name):
    """Each rank's kept choices are JAX's on the global tokens; under
    overflow a rank routing its own rows alone (local capacity, local
    places) would keep others."""
    want = run["ref"][name]["keep"]
    got = _by_batch(run["ranks"], name, "keep")
    assert np.array_equal(got, want)
    assert int((~got).sum()) == int((~want).sum())
    if name == "overflow":
        assert (~want).sum() > 0
        from aki_torch.models.moe import MoEMLP, route

        mc = MoEConfig(**MOE[name])
        moe = MoEMLP(D, mc, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            moe.router.weight.copy_(torch.as_tensor(run["layer"]["router"]))
        local = np.concatenate([route(moe, torch.as_tensor(run["x"][i * 2:(i + 1) * 2])
                                      .reshape(-1, D), mc).keep.numpy() for i in range(2)])
        assert not np.array_equal(local, want)
    else:
        assert want.all()


@pytest.mark.parametrize("name", ["fit", "overflow"])
def test_ep_buffer_holds_the_rank_s_rows(run, name):
    """The dispatched buffer grows with a rank's own tokens, not the
    global set's: E experts of ``min(global cap, local tokens)`` rows."""
    cap = run["ref"][name]["cap"]
    for r in run["ranks"]:
        n_tok = r[name]["tokens"]
        assert n_tok * 2 == run["x"].shape[0] * run["x"].shape[1]
        assert r[name]["buffer"] == (MOE[name]["num_experts"], min(cap, n_tok), D)
    if name == "fit":                 # room for every choice: the local bound binds
        assert cap > n_tok


@pytest.mark.parametrize("name", ["dp2_ep2", "fsdp2_ep2", "dp4"])
def test_moe_trainer_sharded_matches_jax(run, name):
    """The MoE model's Trainer with the batch split (and the experts over
    ``expert``): 3 steps' loss (aux weight 0.5 included) and grad_norm are
    JAX's unsharded step's on the global batch, on every rank."""
    for r in run["ranks"]:
        for g, want in zip(r[f"train_{name}"]["metrics"], run["metrics"]):
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)


def test_ep_checkpoint_restores_on_one_device(run):
    """Written at fsdp=2 x expert=2 (every expert gathered), restored on one
    device bitwise."""
    from aki_torch.train.runner import Trainer

    r0 = run["ranks"][0]["train_fsdp2_ep2"]
    model = AKIModel(run["cfg"], device="cpu")
    t = Trainer(run["cfg"], run_config(r0["ckpt"].rsplit("/", 1)[0], training_mode="resume",
                                       moe_aux_weight=0.5),
                model=model, device="cpu", metrics=NoMetrics())
    from aki_torch.train.optim import is_frozen_path

    live = t.model.state_dict()
    assert set(live) == set(r0["saved"])
    for k, v in r0["saved"].items():
        if not is_frozen_path(k):                 # the tower is not saved
            assert np.array_equal(live[k].numpy(), v), k
    assert t.state.step == 3
