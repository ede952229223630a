"""Tensor-parallel serving on a 2-rank gloo group (``tensor=2``) at
aki_tiny in fp32: prefill logits, the vision tokens (the tower and the
Perceiver cut to one of their two heads a rank) and greedy ``generate``
(bf16 and int8 KV cache) against the JAX engine unsharded, a served
``kv_int8`` drain against the unsharded port's, and the split itself:
each rank's fused q|k|v and gate|up rows, its cache's heads and its
head's vocab rows. W8A8 weights with the int8 KV cache at the 128-wide
``aki_tiny`` of ``tests/test_torch_quant.py`` against JAX's sharded engine
(the same weights under its rules on a 2-device mesh, flash routes): the
projections whole, the cache and the attention on the rank's heads, and
prefill attention by the flash forward, not the bf16-P serving route. The
MoE decoder with its experts cut along their inner dim against the JAX
engine.

One group runs every case (``tests/_torch_dist_cases.py:tp_cases``); JAX's
own ``tests/test_tp_serving.py`` holds its sharded engine to the unsharded
one. Tolerances: logits and vision tokens within 1e-5; tokens identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses

import jax
from aki_tpu.convert.torch_to_jax import convert_aki_checkpoint
from aki_tpu.infer import engine as jax_engine
from aki_tpu.models import aki as jax_aki
from aki_tpu.models import configs as jax_configs
from aki_tpu.models import quant as jax_quant
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.parallel.mesh import MeshConfig, create_mesh
from aki_tpu.parallel.sharding import shard_params
from aki_torch.convert import from_jax_params
from aki_torch.infer.server import ServingEngine
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import MoEConfig, aki_tiny
from aki_torch.parallel.sharding import fit_spec, local_slice, parts_for_path, spec_for_path

from ._jax_tiny import cfg_params, tiny_params
from ._torch_dist import run_group
from .test_torch_quant import INT8_TINY, JAX_INT8_TINY, jax_quantize_params

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
MAX_LEN, NEW = 32, 8
MOE = dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=1.25)


def int8_reference(tmp) -> dict:
    """W8A8 + int8-KV greedy tokens of JAX's sharded engine (tensor=2, the
    flash routes) on the 128-wide aki_tiny, and the float weights and
    prompt for the ranks."""
    model = AKIModel(INT8_TINY, device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():                      # nonzero biases, so they count
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    qparams = jax_quantize_params(convert_aki_checkpoint(model.state_dict(), JAX_INT8_TINY),
                                  mode="w8a8", fuse=False, vision=True)
    rng = np.random.RandomState(8)
    b, t = 2, 40
    ids = rng.randint(1, INT8_TINY.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = INT8_TINY.media_token_id
    ids[0, 30] = ids[1, 25] = INT8_TINY.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 34:] = 0
    s = INT8_TINY.siglip.image_size
    images = rng.randn(b, s, s, 3).astype(np.float32)
    mesh = create_mesh(MeshConfig(fsdp=1, tensor=2))
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jax_quant, "FUSED_ACT_QUANT", "on")
        toks, num = jax_engine.generate(shard_params(qparams, mesh), JAX_INT8_TINY,
                                        jnp.asarray(ids), jnp.asarray(images),
                                        jnp.asarray(valid), max_new_tokens=6, max_len=64,
                                        policy=JAX_F32, use_flash=True, kv_int8=True,
                                        tp_mesh=mesh)
        q4 = jax_quantize_params(convert_aki_checkpoint(model.state_dict(), JAX_INT8_TINY),
                                 mode="w4a8", fuse=False, vision=True)
        toks4, num4 = jax_engine.generate(shard_params(q4, mesh), JAX_INT8_TINY,
                                          jnp.asarray(ids), jnp.asarray(images),
                                          jnp.asarray(valid), max_new_tokens=6, max_len=64,
                                          policy=JAX_F32, use_flash=True, kv_int8=True,
                                          tp_mesh=mesh)
    weights = tmp / "int8.pt"
    torch.save(model.state_dict(), weights)
    return dict(tokens=np.asarray(toks), num=np.asarray(num), tokens4=np.asarray(toks4),
                num4=np.asarray(num4), ranks=dict(weights=str(weights), cfg=INT8_TINY, prompt=(ids, images, valid),
                           new=6, max_len=64))


def moe_reference(tmp, ids, images, valid) -> dict:
    """The MoE decoder's prefill logits and greedy tokens from the JAX
    engine, unsharded."""
    cfg_j = dataclasses.replace(CFG_J, phi3=dataclasses.replace(
        CFG_J.phi3, moe=jax_configs.MoEConfig(**MOE)))
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3, moe=MoEConfig(**MOE)))
    params = cfg_params(cfg_j, 1)
    jp = jax.tree.map(jnp.asarray, params)
    state = jax_engine.prefill(jp, cfg_j, ids, images, valid, MAX_LEN, policy=JAX_F32,
                               use_flash=False)
    toks, num = jax_engine.generate(jp, cfg_j, ids, images, valid, max_new_tokens=NEW,
                                    max_len=MAX_LEN, policy=JAX_F32, use_flash=False)
    weights = tmp / "moe.pt"
    torch.save(from_jax_params(params, cfg), weights)
    return dict(logits=np.asarray(state.last_logits), tokens=np.asarray(toks),
                num=np.asarray(num), ranks=dict(weights=str(weights), fields=MOE))


def prompts():
    rng = np.random.RandomState(4)
    b, t = 2, 12
    ids = rng.randint(1, CFG.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = CFG.media_token_id
    ids[0, 9] = ids[1, 7] = CFG.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 8:] = 0
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    requests = []
    for i in range(5):
        r = np.random.RandomState(50 + i)
        r_ids = r.randint(5, CFG.initial_tokenizer_len - 1, size=(10 + i,))
        r_ids[1] = CFG.media_token_id
        r_ids[6] = CFG.assistant_token_id
        requests.append((list(map(int, r_ids)), r.randn(28, 28, 3).astype(np.float32), 3 + i))
    return (ids, images, valid), requests


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    params = tiny_params(3)
    prompt, requests = prompts()
    ids, images, valid = (jnp.asarray(x) for x in prompt)
    state = jax_engine.prefill(params, CFG_J, ids, images, valid, MAX_LEN, policy=JAX_F32,
                               use_flash=False)
    ref = dict(logits=np.asarray(state.last_logits),
               vision=np.asarray(jax_aki.encode_vision(params, CFG_J, images, JAX_F32)))
    for kv_int8 in (False, True):
        toks, num = jax_engine.generate(params, CFG_J, ids, images, valid, max_new_tokens=NEW,
                                        max_len=MAX_LEN, policy=JAX_F32, use_flash=False,
                                        kv_int8=kv_int8)
        ref[f"generate_int8={kv_int8}"] = (np.asarray(toks), np.asarray(num))
    eng = ServingEngine(port_model(params), num_slots=4, max_len=MAX_LEN, prompt_bucket=16,
                        admit_batch=2, decode_chunk=2, policy=F32, kv_int8=True, device="cpu")
    reqs = [eng.submit(r_ids, img, max_new_tokens=m) for r_ids, img, m in requests]
    eng.run_until_drained()
    ref["served"] = [r.result(timeout=60) for r in reqs]
    eng.close()
    weights = tmp / "weights.pt"
    torch.save(from_jax_params(params, CFG), weights)
    ref["int8"] = int8_reference(tmp)
    ref["moe"] = moe_reference(tmp, ids, images, valid)
    ranks = run_group("_torch_dist_cases:tp_cases", 2, tmp / "group", timeout=300,
                      weights=str(weights), prompt=prompt, requests=requests, max_len=MAX_LEN,
                      new=NEW, int8=ref["int8"]["ranks"], moe=ref["moe"]["ranks"])
    return dict(ref=ref, ranks=ranks, params=params)


def test_tp_prefill_logits_match_jax(run):
    want = run["ref"]["logits"]
    for r in run["ranks"]:
        tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(r["logits"] - want).max()) <= tol


@pytest.mark.parametrize("kv_int8", [False, True])
def test_tp_generate_tokens_match_jax(run, kv_int8):
    want_toks, want_num = run["ref"][f"generate_int8={kv_int8}"]
    for r in run["ranks"]:
        toks, num = r[f"generate_int8={kv_int8}"]
        assert np.array_equal(toks, want_toks) and np.array_equal(num, want_num)


def test_tp_server_kv_int8_matches_unsharded(run):
    assert all(r["served"] == run["ref"]["served"] for r in run["ranks"])
    assert all(len(t) > 0 for t in run["ref"]["served"])


def test_tp_cache_and_weights_are_head_sharded(run):
    """Each rank's prefill cache holds 2 of the 4 KV heads (bf16: (L, B, S,
    2, D); int8: the flat head-major last dim 2*D), its qkv weight 2 heads'
    q, k and v rows, its head half the vocab rows."""
    p = CFG.phi3
    for r in run["ranks"]:
        assert r["cache_k"] == (p.num_layers, 2, MAX_LEN, p.num_kv_heads // 2, p.head_dim)
        assert r["cache8_k"] == (p.num_layers, 2, MAX_LEN, p.num_kv_heads // 2 * p.head_dim)
        assert r["cache8_ks"] == (p.num_layers, 2, MAX_LEN, p.num_kv_heads // 2)
        assert r["qkv_rows"] == (p.num_heads + 2 * p.num_kv_heads) * p.head_dim // 2
        assert r["head_rows"] == p.vocab_size // 2


def test_fused_split_is_per_part(run):
    """Rank r's qkv block is its heads' rows of q, of k and of v, in that
    order (not a slice across the q|k boundary); gate|up likewise."""
    sd = from_jax_params(run["params"], CFG)
    p = CFG.phi3
    name = "lang_model.model.layers.0.self_attn.qkv_proj.weight"
    w = sd[name]
    parts = parts_for_path(name, CFG)
    spec = fit_spec(spec_for_path(name), w.shape, {"tensor": 2}, parts)
    q, k, v = torch.split(w, list(parts))
    for r in range(2):
        got = local_slice(w, spec, "tensor", r, 2, parts)
        hq, hk = p.num_heads * p.head_dim // 2, p.num_kv_heads * p.head_dim // 2
        assert torch.equal(got, torch.cat([q[r * hq:(r + 1) * hq], k[r * hk:(r + 1) * hk],
                                           v[r * hk:(r + 1) * hk]]))
    name = "lang_model.model.layers.1.mlp.gate_up_proj.weight"
    w = sd[name]
    parts = parts_for_path(name, CFG)
    gate, up = torch.split(w, list(parts))
    n = p.intermediate_size // 2
    for r in range(2):
        got = local_slice(w, fit_spec(spec_for_path(name), w.shape, {"tensor": 2}, parts),
                          "tensor", r, 2, parts)
        assert torch.equal(got, torch.cat([gate[r * n:(r + 1) * n], up[r * n:(r + 1) * n]]))


def test_tp_vision_tokens_match_jax(run):
    """The tower and the Perceiver at tensor=2 (each rank one of their two
    heads, the patch embedding's and the projection's columns gathered):
    the vision tokens are JAX's."""
    want = run["ref"]["vision"]
    for r in run["ranks"]:
        assert r["tower_split"] and r["perceiver_split"]
        assert r["tower_q_rows"] == CFG.siglip.hidden_size // 2
        assert r["perceiver_q_rows"] == CFG.perceiver.heads * CFG.perceiver.dim_head // 2
        tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(r["vision"] - want).max()) <= tol


def test_tp_w8a8_generate_matches_jax_sharded(run):
    """W8A8 + int8-KV greedy tokens at tensor=2 are those of JAX's sharded
    engine; the int8 projections stay whole (every row), the int8 cache
    holds the rank's head."""
    want = run["ref"]["int8"]
    for r in run["ranks"]:
        got = r["w8a8"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["num"], want["num"])
        p = INT8_TINY.phi3
        assert got["qkv_rows"] == (p.num_heads + 2 * p.num_kv_heads) * p.head_dim
        assert got["cache_k"][-1] == p.num_kv_heads // 2 * p.head_dim


def test_tp_w4a8_generate_matches_jax_sharded(run):
    """W4A8 takes W8A8's route under tensor=2: the int4 projections stay
    whole (every row, packed along ``in``), and the greedy tokens are those
    of JAX's sharded engine on its ``jnp.int4`` weights."""
    want = run["ref"]["int8"]
    p = INT8_TINY.phi3
    for r in run["ranks"]:
        got = r["w4a8"]
        np.testing.assert_array_equal(got["tokens"], want["tokens4"])
        np.testing.assert_array_equal(got["num"], want["num4"])
        assert got["qkv_bits"] == 4 and got["qkv_in"] == p.hidden_size
        assert got["qkv_rows"] == (p.num_heads + 2 * p.num_kv_heads) * p.head_dim


def test_tp_w8a8_attends_with_the_flash_forward_on_local_heads(run):
    """Under tp with int8 weights, the decoder's prefill and the tower
    attend through the flash forward on one head (JAX's TP branch comes
    before its bf16-P serving one); no bf16-P attention runs."""
    p, s = INT8_TINY.phi3, INT8_TINY.siglip
    for r in run["ranks"]:
        routes = r["w8a8"]["routes"]
        assert not [x for x in routes if x[1].endswith("bf16p")]
        assert ("phi3", "flash_mma_attention", 1) in routes
        assert ("siglip", "flash_mma_attention", 1) in routes
        assert all(h == 1 for *_, h in routes)
        # two prefills (generate's and one more): every tower and decoder
        # layer once each
        assert len(routes) == 2 * (s.num_layers + p.num_layers)


def test_tp_moe_matches_jax(run):
    """The MoE decoder at tensor=2 (each rank half of every expert's inner
    dim): prefill logits and greedy tokens are the JAX engine's."""
    want = run["ref"]["moe"]
    for r in run["ranks"]:
        got = r["moe"]
        assert got["w_gate"] == (MOE["num_experts"], CFG.phi3.hidden_size,
                                 MOE["intermediate_size"] // 2)
        tol = 1e-5 * max(float(np.abs(want["logits"]).max()), 1.0)
        assert float(np.abs(got["logits"] - want["logits"]).max()) <= tol
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["num"], want["num"])
