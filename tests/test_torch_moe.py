"""The port's MoE decoder (``aki_torch.models.moe`` and where it is wired in)
against the JAX package at small sizes in f32.

- ``moe_mlp`` by scatter and by dense dispatch against JAX ``moe_mlp``, with
  no overflow (capacity factor 4) and with overflow (0.6, and 0.01 at two
  experts and k = 1): output, aux and the gradients of x, the router and
  the experts within 1e-5 (the same f32 math summed in another order over
  at most 32 terms); the two dispatches within JAX's own 1e-5 of each other;
- the capacity against JAX's, read from which rows JAX's layer drops when
  every token prefers the same experts, at edge values;
- ``aki_tiny`` with a MoE decoder: ``aki_forward``'s logits and aux against
  JAX's within 1e-5, weights through ``from_jax_params``; one train step
  against JAX ``make_train_step`` at two aux weights (loss and grad_norm
  within 1e-4 relative, the router's update within 1e-4 of its norm), the aux changing the loss and the
  router's update; the dataset's loss weight scaling the CE loss only;
  greedy tokens equal to the JAX engine's;
- ``with_aux`` with a cache and ``quantize_params`` on a MoE model raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.infer import engine as jax_engine
from aki_tpu.models import configs as jax_configs
from aki_tpu.models import moe as jax_moe
from aki_tpu.models.aki import aki_forward as jax_aki_forward
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import Batch as JaxBatch
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.infer import engine
from aki_torch.models import moe
from aki_torch.models.aki import AKIModel, aki_forward
from aki_torch.models.common import F32
from aki_torch.models.configs import MoEConfig, aki_tiny
from aki_torch.models.phi3 import KVCache
from aki_torch.models.quant import quantize_params
from aki_torch.train import optim
from aki_torch.train.step import Batch, TrainState, make_loss_fn, make_train_step

from ._jax_tiny import cfg_params

D = 16
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_RTOL = 1e-4
MOE = dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=2.0)
CFG = dataclasses.replace(aki_tiny(), phi3=dataclasses.replace(
    aki_tiny().phi3, moe=MoEConfig(**MOE)))
CFG_J = dataclasses.replace(jax_configs.aki_tiny(), phi3=dataclasses.replace(
    jax_configs.aki_tiny().phi3, moe=jax_configs.MoEConfig(**MOE)))


def layer_pair(fields, seed):
    """JAX ``init_moe`` params at scale 0.2 and the port layer holding them."""
    cfg_j, cfg = jax_configs.MoEConfig(**fields), MoEConfig(**fields)
    params = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(seed), D, cfg_j,
                                                       0.2))
    layer = moe.MoEMLP(D, cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        layer.router.weight.copy_(torch.tensor(params["router"]["w"].T))
        for w in ("w_gate", "w_up", "w_down"):
            getattr(layer, w).copy_(torch.tensor(params[w]))
    return cfg_j, cfg, params, layer


JAX_MOE = jax.jit(jax_moe.moe_mlp, static_argnames=("cfg", "dispatch"))


def jax_layer(params, x, cfg_j, dispatch):
    def loss(p, x):
        out, aux = jax_moe.moe_mlp(p, x, cfg_j, dispatch=dispatch)
        return jnp.sum(jnp.sin(out)) + 0.01 * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    grads = {"x": gx, "router": gp["router"]["w"].T, **{w: gp[w] for w in
                                                         ("w_gate", "w_up", "w_down")}}
    return np.asarray(out), float(aux), {k: np.asarray(v) for k, v in grads.items()}


def port_layer(layer, x, cfg, dispatch):
    layer.zero_grad(set_to_none=True)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_mlp(layer, xt, cfg, dispatch=dispatch)
    (out.sin().sum() + 0.01 * aux).backward()
    grads = {"x": xt.grad, "router": layer.router.weight.grad,
             **{w: getattr(layer, w).grad for w in ("w_gate", "w_up", "w_down")}}
    return out.detach().numpy(), aux.item(), {k: v.numpy() for k, v in grads.items()}


LAYER_CASES = {
    "no_overflow": (dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=4.0),
                    (2, 6)),
    "overflow": (dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=0.6),
                 (2, 12)),
    "cap1_e2_k1": (dict(num_experts=2, top_k=1, intermediate_size=8, capacity_factor=0.01),
                   (1, 8)),
}


@pytest.mark.parametrize("dispatch", moe.DISPATCHES)
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_mlp_matches_jax(case, dispatch):
    fields, (b, t) = LAYER_CASES[case]
    cfg_j, cfg, params, layer = layer_pair(fields, seed=3)
    x = np.random.RandomState(3).randn(b, t, D).astype(np.float32)
    want_out, want_aux, want_g = jax_layer(params, x, cfg_j, dispatch)
    out, aux, grads = port_layer(layer, x, cfg, dispatch)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_g[k], **TOL, err_msg=k)
    # the case holds what it claims: drops exactly where there is overflow
    r = moe.route(layer, torch.from_numpy(x.reshape(-1, D)), cfg)
    assert (not bool(r.keep.all())) == (case != "no_overflow")
    assert len(set(r.top_p.flatten().tolist())) == r.top_p.numel()     # no ties


@pytest.mark.parametrize("case", ["overflow", "cap1_e2_k1"])
def test_scatter_equals_dense(case):
    fields, (b, t) = LAYER_CASES[case]
    _, cfg, _, layer = layer_pair(fields, seed=4)
    x = np.random.RandomState(4).randn(b, t, D).astype(np.float32)
    s_out, s_aux, s_g = port_layer(layer, x, cfg, "scatter")
    d_out, d_aux, d_g = port_layer(layer, x, cfg, "dense")
    np.testing.assert_allclose(s_out, d_out, rtol=1e-5, atol=1e-6)
    assert s_aux == d_aux
    for k, g in s_g.items():
        np.testing.assert_allclose(g, d_g[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_unknown_dispatch_raises():
    _, cfg, _, layer = layer_pair(LAYER_CASES["overflow"][0], seed=0)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_mlp(layer, torch.zeros(1, 2, D), cfg, dispatch="sparse")


@pytest.mark.parametrize("n_tok,k,cf,e", [
    (1310, 2, 1.25, 8),     # phase 8's micro-batch: 410
    (8, 1, 0.01, 2),        # below one slot: 1
    (10, 1, 0.7, 7),        # 10 x 0.7 = 7.000000000000001 -> 2, not 1
    (12, 2, 0.5, 4),        # exactly 3
    (7, 2, 1.0, 3),         # 14 / 3 -> 5
])
def test_capacity_matches_jax(n_tok, k, cf, e):
    """Every token's first choice is expert 0 and its second expert 1, so
    JAX's layer keeps exactly the first ``cap`` tokens: its capacity is the
    count of rows with an output."""
    fields = dict(num_experts=e, top_k=k, intermediate_size=8, capacity_factor=cf)
    cfg_j, cfg, params, layer = layer_pair(fields, seed=5)
    w = np.zeros((D, e), np.float32)
    w[:, 0], w[:, 1] = 1.0, 0.5
    params["router"]["w"] = w
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(w.T))
    x = (np.abs(np.random.RandomState(5).randn(1, n_tok, D)) + 0.1).astype(np.float32)
    out, _ = JAX_MOE(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg=cfg_j)
    rows = int((np.abs(np.asarray(out[0])).max(-1) > 0).sum())
    cap = moe.capacity(n_tok, cfg)
    assert cap < n_tok and rows == cap
    got, _ = moe.moe_mlp(layer, torch.from_numpy(x), cfg)
    assert int((got[0].abs().amax(-1) > 0).sum()) == cap


def tiny_batch(rng, b=2, t=14):
    ids = rng.randint(5, CFG.initial_tokenizer_len - 1, size=(b, t)).astype(np.int32)
    ids[:, 1] = CFG.media_token_id
    ids[:, 8] = CFG.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[-1, t - 4:] = 0
    labels = np.where((np.arange(t)[None] > 8) & (valid == 1), ids, -100).astype(np.int32)
    s = CFG.siglip.image_size
    return Batch(ids, rng.randn(b, s, s, 3).astype(np.float32), valid, labels)


@pytest.fixture(scope="module")
def params():
    return cfg_params(CFG_J, 0)


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


def test_moe_model_builds_the_routed_mlp(params):
    model = port_model(params)
    names = {n for n, _ in model.named_parameters()
             if n.startswith("lang_model.model.layers.0.mlp.")}
    assert names == {f"lang_model.model.layers.0.mlp.{w}" for w in
                     ("router.weight", "w_gate", "w_up", "w_down")}
    assert all(isinstance(layer.mlp, moe.MoEMLP) for layer in model.lang_model.model.layers)
    fresh = AKIModel(CFG, device="cpu")
    w = fresh.lang_model.model.layers[1].mlp.w_down
    assert w.shape == (4, 32, 64) and abs(float(w.detach().std()) - 0.02) < 2e-3


def test_aki_forward_logits_and_aux_match_jax(params):
    batch = tiny_batch(np.random.RandomState(1))
    want = jax_aki_forward(jax.tree.map(jnp.asarray, params), CFG_J,
                           *(jnp.asarray(x) for x in (batch.input_ids, batch.images,
                                                      batch.attn_valid)),
                           labels=jnp.asarray(batch.labels), policy=JAX_F32, use_flash=False)
    got = aki_forward(port_model(params), batch.input_ids, batch.images, batch.attn_valid,
                      labels=batch.labels, policy=F32, device="cpu")
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits), **TOL)
    np.testing.assert_allclose(got.aux.item(), float(want.aux), **TOL)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **TOL)
    assert got.aux.item() > 0


def test_loss_weight_scales_the_ce_loss_only(params):
    """The per-dataset multiplier scales the CE loss and the aux is added
    after it, against JAX ``make_loss_fn``."""
    batch = tiny_batch(np.random.RandomState(3))
    jb = JaxBatch(*(jnp.asarray(x) for x in (batch.input_ids, batch.images, batch.attn_valid,
                                             batch.labels)), loss_weight=jnp.float32(0.25))
    want = jax.jit(jax_make_loss_fn(CFG_J, JAX_F32, False, False, moe_aux_weight=0.3))(
        jax.tree.map(jnp.asarray, params), jb)
    model = port_model(params)
    weighted = dataclasses.replace(batch, loss_weight=0.25)
    got = make_loss_fn(CFG, F32, remat=False, use_flash=True, device="cpu",
                       moe_aux_weight=0.3)(model, weighted)
    out = aki_forward(model, batch.input_ids, batch.images, batch.attn_valid,
                      labels=batch.labels, policy=F32, device="cpu")
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got.item(), 0.25 * out.loss.item() + 0.3 * out.aux.item(),
                               rtol=1e-6)


def routers(layers) -> np.ndarray:
    return np.stack([layer.mlp.router.weight.detach().numpy().T for layer in layers])


@pytest.mark.parametrize("aux_weight", [0.0, 0.5])
def test_train_step_matches_jax(params, aux_weight):
    batch = tiny_batch(np.random.RandomState(2))
    jb = JaxBatch(*(jnp.asarray(x) for x in (batch.input_ids, batch.images, batch.attn_valid,
                                             batch.labels)))
    opt = jax_optim.make_optimizer(params, 1e-3, weight_decay=0.1, grad_clip=1.0)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, params), opt)
    jstep = jax.jit(jax_make_train_step(CFG_J, opt, policy=JAX_F32, use_flash=False,
                                        moe_aux_weight=aux_weight))
    jstate, jm = jstep(jstate, jb)
    want_update = (np.asarray(jstate.params["phi3"]["layers"]["moe"]["router"]["w"])
                   - params["phi3"]["layers"]["moe"]["router"]["w"])

    model = port_model(params)
    layers = model.lang_model.model.layers
    before = routers(layers)
    state = TrainState(model, optim.make_optimizer(model, 1e-3, weight_decay=0.1,
                                                   grad_clip=1.0))
    m = make_train_step(CFG, policy=F32, device="cpu", moe_aux_weight=aux_weight)(state, batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=STEP_RTOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=STEP_RTOL)
    # AdamW's first step divides each gradient by its own size, so an entry
    # whose gradient is near eps is ill-conditioned: the update is held
    # within 1e-4 of its norm, as the train tests hold gradients
    update = routers(layers) - before
    assert np.linalg.norm(update - want_update) <= STEP_RTOL * np.linalg.norm(want_update)


def test_aux_weight_moves_the_loss_and_the_router(params):
    """The JAX test's property on the port alone: from one state and batch,
    the aux weight raises the loss and changes the router's update."""
    batch = tiny_batch(np.random.RandomState(2))
    runs = {}
    for w in (0.0, 0.5):
        model = port_model(params)
        before = routers(model.lang_model.model.layers)
        state = TrainState(model, optim.make_optimizer(model, 1e-3))
        m = make_train_step(CFG, policy=F32, device="cpu", moe_aux_weight=w)(state, batch)
        runs[w] = (m["loss"].item(), routers(model.lang_model.model.layers) - before)
    (l0, u0), (l1, u1) = runs[0.0], runs[0.5]
    assert np.isfinite([l0, l1]).all() and l1 > l0
    assert np.abs(u1 - u0).max() > 0


def test_greedy_tokens_match_jax_engine(params):
    rng = np.random.RandomState(4)
    b, t = 2, 12
    ids = rng.randint(1, CFG.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = CFG.media_token_id
    ids[0, 9] = ids[1, 7] = CFG.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 8:] = 0
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    want, want_n = jax_engine.generate(jax.tree.map(jnp.asarray, params), CFG_J,
                                       jnp.asarray(ids), jnp.asarray(images),
                                       jnp.asarray(valid), max_new_tokens=8, max_len=32,
                                       policy=JAX_F32, use_flash=False)
    got, got_n = engine.generate(port_model(params), ids, images, valid, 8, 32, policy=F32,
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_with_aux_and_a_cache_raises(params):
    model = port_model(params)
    dec = model.lang_model.model
    x = torch.zeros(1, 3, CFG.phi3.hidden_size)
    pos = torch.arange(3)[None]
    cache = KVCache.create(CFG.phi3, 1, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="with_aux"):
        dec(x, pos, cache=cache, cache_index=torch.zeros(1, dtype=torch.int64), policy=F32,
            with_aux=True)
    hidden, _, aux = dec(x, pos, policy=F32, with_aux=True)
    assert hidden.shape == x.shape and aux.dtype == torch.float32 and aux.item() > 0


def test_quantize_params_refuses_a_moe_model(params):
    model = port_model(params)
    with pytest.raises(NotImplementedError, match="MoE"):
        quantize_params(model, "w8a8")
    assert all(isinstance(layer.mlp, moe.MoEMLP) for layer in model.lang_model.model.layers)
