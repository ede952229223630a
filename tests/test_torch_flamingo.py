"""The port's Flamingo decoder (``aki_torch.models.flamingo``) against
``aki_tpu/models/flamingo.py`` at ``aki_tiny`` in f32.

- ``gated_xattn_block`` against JAX's: immediate (``==``) and ``>=``
  masking, ``use_cached_media``, text before any image, gates 0 and open;
  within 1e-5 (the same f32 math summed in another order);
- ``flamingo_decoder_forward`` against JAX's at ``cross_attn_every_n`` 1 and
  2 with random open gates: hidden states within 1e-5, and the gradients of
  a fixed projection of them (decoder layers, blocks, embeddings, media)
  within 1e-5 of each tensor's norm;
- at init (gates 0) the decoder equals ``Phi3Model.forward`` exactly, with
  and without recompute;
- ``convert.from_jax_xattn`` loads JAX's stacked ``xattn`` tree into the
  blocks (OpenFlamingo's names, kernels transposed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from aki_tpu.models import flamingo as jax_flamingo
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.models.configs import aki_tiny as jax_aki_tiny
from aki_torch.convert import from_jax_params, from_jax_xattn
from aki_torch.models import flamingo
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny

from ._jax_tiny import tiny_params

CFG, CFG_J = aki_tiny(), jax_aki_tiny()
D = CFG.phi3.hidden_size
HEADS, DIM_HEAD, FF_MULT = 2, 8, 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5      # of each tensor's norm


def xattn_tree(n_blocks, seed, open_gates):
    """JAX ``init_gated_xattn`` (numpy leaves), with random gates in
    [0.5, 1.5] when ``open_gates``."""
    tree = jax.tree.map(np.asarray, jax_flamingo.init_gated_xattn(
        jax.random.PRNGKey(seed), D, D, n_blocks, dim_head=DIM_HEAD, heads=HEADS,
        ff_mult=FF_MULT))
    if open_gates:
        rng = np.random.RandomState(seed)
        for g in ("attn_gate", "ff_gate"):
            tree[g] = rng.uniform(0.5, 1.5, tree[g].shape).astype(np.float32)
    return tree


def port_blocks(tree) -> nn.ModuleList:
    blocks = nn.ModuleList(flamingo.GatedCrossAttentionBlock(
        D, D, heads=HEADS, dim_head=DIM_HEAD, ff_mult=FF_MULT, device="cpu")
        for _ in range(tree["to_q"].shape[0]))
    blocks.load_state_dict(from_jax_xattn(tree), strict=True)
    return blocks


def inputs(rng, b=2, t=10, t_img=2, n_lat=3, first=2):
    """Text embeddings, positions, media and two <image> locations a row,
    the first at ``first`` (the tokens before it see no image)."""
    embeds = rng.randn(b, t, D).astype(np.float32)
    positions = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    media = rng.randn(b, t_img, n_lat, D).astype(np.float32)
    locs = np.zeros((b, t), bool)
    locs[:, first] = True
    locs[:, first + 4] = True
    return embeds, positions, media, locs


@pytest.mark.parametrize("open_gates", [False, True])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("immediate", [True, False])
def test_block_matches_jax(immediate, cached, open_gates):
    tree = xattn_tree(1, 3, open_gates)
    embeds, _, media, locs = inputs(np.random.RandomState(4))
    kw = dict(heads=HEADS, dim_head=DIM_HEAD, only_attend_immediate_media=immediate,
              use_cached_media=cached)
    want = jax_flamingo.gated_xattn_block(jax.tree.map(lambda a: jnp.asarray(a[0]), tree),
                                          jnp.asarray(embeds), jnp.asarray(media),
                                          jnp.asarray(locs), **kw)
    got = flamingo.gated_xattn_block(port_blocks(tree)[0], torch.from_numpy(embeds),
                                     torch.from_numpy(media), torch.from_numpy(locs), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if not open_gates:
        np.testing.assert_array_equal(got.detach().numpy(), embeds)


def test_text_before_any_image():
    """Rows before the first image: zero cross-attention under immediate
    masking, JAX's uniform softmax over every latent under ``>=``."""
    tree = xattn_tree(1, 5, True)
    tree["ff_gate"][:] = 0.0           # the block's output is then the attention's
    block = port_blocks(tree)[0]
    embeds, _, media, locs = inputs(np.random.RandomState(6), first=3)
    x, m, lc = map(torch.from_numpy, (embeds, media, locs))
    kw = dict(heads=HEADS, dim_head=DIM_HEAD)
    imm = flamingo.gated_xattn_block(block, x, m, lc, **kw).detach()
    assert torch.equal(imm[:, :3], x[:, :3])
    ge = flamingo.gated_xattn_block(block, x, m, lc, only_attend_immediate_media=False,
                                    **kw).detach()
    a = block.attn
    v = (m.reshape(2, -1, D) @ a.to_kv.weight.T)[..., HEADS * DIM_HEAD:]
    uniform = v.mean(1, keepdim=True) @ a.to_out.weight.T * torch.tanh(block.attn_gate)
    torch.testing.assert_close(ge[:, :3], x[:, :3] + uniform.expand(2, 3, D), rtol=1e-5,
                               atol=1e-5)
    want = jax_flamingo.gated_xattn_block(jax.tree.map(lambda t: jnp.asarray(t[0]), tree),
                                          *map(jnp.asarray, (embeds, media, locs)),
                                          only_attend_immediate_media=False, **kw)
    np.testing.assert_allclose(ge.numpy(), np.asarray(want), **TOL)


def jax_decoder(params, tree, embeds, positions, media, locs, valid, n, proj):
    def fn(phi3, xattn, embeds, media):
        h = jax_flamingo.flamingo_decoder_forward(
            {"phi3": phi3, "xattn": xattn}, CFG_J, embeds, jnp.asarray(positions), media,
            jnp.asarray(locs), kv_valid=jnp.asarray(valid), cross_attn_every_n=n,
            policy=JAX_F32, use_flash=False, xattn_heads=HEADS, xattn_dim_head=DIM_HEAD)
        return jnp.sum(h * proj), h

    (_, hidden), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jax.tree.map(jnp.asarray, a) for a in (params["phi3"], tree, embeds, media)))
    return np.asarray(hidden), jax.tree.map(np.asarray, grads)


def port_model():
    params = tiny_params(0)
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return params, model


def decoder_inputs(seed):
    rng = np.random.RandomState(seed)
    embeds, positions, media, locs = inputs(rng)
    valid = np.ones(locs.shape, np.int32)
    valid[1, 7:] = 0                       # a right-padded row
    proj = rng.randn(*embeds.shape).astype(np.float32)
    return embeds, positions, media, locs, valid, proj


def port_decoder(model, blocks, embeds, positions, media, locs, valid, n, remat=False,
                 remat_policy="full"):
    e = torch.tensor(embeds, requires_grad=True)
    m = torch.tensor(media, requires_grad=True)
    hidden = flamingo.flamingo_decoder_forward(
        model.lang_model, blocks, CFG, e, torch.from_numpy(positions), m,
        torch.from_numpy(locs), kv_valid=torch.from_numpy(valid), cross_attn_every_n=n,
        policy=F32, remat=remat, xattn_heads=HEADS, xattn_dim_head=DIM_HEAD,
        remat_policy=remat_policy)
    return hidden, e, m


def assert_grad_close(got: torch.Tensor, want: np.ndarray, name: str):
    tol = GRAD_TOL * max(float(np.linalg.norm(want)), 1e-3)
    assert float(np.abs(got.detach().numpy() - want).max()) <= tol, name


@pytest.mark.parametrize("every_n", [1, 2])
def test_decoder_matches_jax(every_n):
    params, model = port_model()
    tree = xattn_tree(CFG.phi3.num_layers // every_n, 7, True)
    embeds, positions, media, locs, valid, proj = decoder_inputs(8)
    want, (g_phi3, g_xattn, g_embeds, g_media) = jax_decoder(
        params, tree, embeds, positions, media, locs, valid, every_n, proj)
    blocks = port_blocks(tree)
    hidden, e, m = port_decoder(model, blocks, embeds, positions, media, locs, valid, every_n)
    np.testing.assert_allclose(hidden.detach().numpy(), want, **TOL)
    (hidden * torch.from_numpy(proj)).sum().backward()

    assert_grad_close(e.grad, g_embeds, "embeds")
    assert_grad_close(m.grad, g_media, "media")
    want_xattn = from_jax_xattn(g_xattn)
    for name, p in blocks.named_parameters():
        assert_grad_close(p.grad, want_xattn[name].numpy(), name)
    zeros = jax.tree.map(np.zeros_like, params)
    want_lm = from_jax_params({**zeros, "phi3": g_phi3}, CFG)
    layer_params = [(n, p) for n, p in model.named_parameters() if ".layers." in n
                    and n.startswith("lang_model.")]
    assert layer_params
    for name, p in layer_params:
        assert_grad_close(p.grad, want_lm[name].numpy(), name)
    assert_grad_close(model.lang_model.model.norm.weight.grad,
                      want_lm["lang_model.model.norm.weight"].numpy(), "norm")


@pytest.mark.parametrize("remat", [False, True])
def test_zero_gates_equal_the_plain_decoder(remat):
    _, model = port_model()
    blocks = port_blocks(xattn_tree(CFG.phi3.num_layers, 9, False))
    embeds, positions, media, locs, valid, _ = decoder_inputs(10)
    hidden, _, _ = port_decoder(model, blocks, embeds, positions, media, locs, valid, 1,
                                remat=remat)
    base, _ = model.lang_model.model(torch.from_numpy(embeds), torch.from_numpy(positions),
                                     kv_valid=torch.from_numpy(valid), policy=F32)
    assert torch.equal(hidden, base)


def test_xattn_converter():
    tree = xattn_tree(3, 11, True)
    sd = from_jax_xattn(tree)
    blocks = port_blocks(tree)
    assert set(sd) == set(blocks.state_dict())
    assert {n.split(".", 1)[1] for n in sd} == {
        "attn.norm.weight", "attn.norm.bias", "attn.to_q.weight", "attn.to_kv.weight",
        "attn.to_out.weight", "attn_gate", "ff.0.weight", "ff.0.bias", "ff.1.weight",
        "ff.3.weight", "ff_gate"}
    b = blocks[2]
    np.testing.assert_array_equal(b.attn.to_kv.weight.detach().numpy(), tree["to_kv"][2].T)
    np.testing.assert_array_equal(b.ff[3].weight.detach().numpy(), tree["ff2"][2].T)
    np.testing.assert_array_equal(b.ff_gate.detach().numpy(), tree["ff_gate"][2])
    assert b.attn.to_kv.weight.shape == (2 * HEADS * DIM_HEAD, D)


def test_block_init_and_block_count():
    blk = flamingo.GatedCrossAttentionBlock(D, D, device="cpu",
                                            generator=torch.Generator().manual_seed(0))
    assert float(blk.attn_gate.detach()) == float(blk.ff_gate.detach()) == 0.0
    assert torch.equal(blk.attn.norm.weight, torch.ones(D))
    assert abs(float(blk.ff[1].weight.detach().std()) - 0.02) < 2e-3
    assert blk.attn.to_q.weight.shape == (8 * 64, D) and blk.ff[1].weight.shape == (4 * D, D)
    _, model = port_model()
    with pytest.raises(ValueError, match="blocks"):
        flamingo.flamingo_decoder_forward(model.lang_model, nn.ModuleList([blk]), CFG,
                                          torch.zeros(1, 4, D), torch.zeros(1, 4), None,
                                          torch.zeros(1, 4, dtype=torch.bool),
                                          cross_attn_every_n=1, policy=F32)
