"""Tensor-parallel serving on a 2-rank gloo group (``tensor=2``) at
aki_tiny in fp32: prefill logits and greedy ``generate`` (bf16 and int8 KV
cache) against the JAX engine unsharded, a served ``kv_int8`` drain against
the unsharded port's, and the split itself: each rank's fused q|k|v and
gate|up rows, its cache's heads and its head's vocab rows.

One group runs every case (``tests/_torch_dist_cases.py:tp_cases``); JAX's
own ``tests/test_tp_serving.py`` holds its sharded engine to the unsharded
one. Tolerances: logits within 1e-5; tokens identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.infer import engine as jax_engine
from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_torch.convert import from_jax_params
from aki_torch.infer.server import ServingEngine
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny
from aki_torch.parallel.sharding import fit_spec, local_slice, parts_for_path, spec_for_path

from ._jax_tiny import tiny_params
from ._torch_dist import run_group

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
MAX_LEN, NEW = 32, 8


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
    ref = dict(logits=np.asarray(state.last_logits))
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
    ranks = run_group("_torch_dist_cases:tp_cases", 2, tmp / "group", timeout=300,
                      weights=str(weights), prompt=prompt, requests=requests, max_len=MAX_LEN,
                      new=NEW)
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
