"""The port's generation engine against the JAX engine at aki_tiny, fp32.

Greedy tokens must be identical. Prefill logits hold to 1e-4 (the whole
stack in fp32, summed in another order). Sampled tokens come from different
RNGs and are not compared; the top-k / top-p masks are, on fixed logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.infer import engine as jax_engine
from aki_tpu.infer.sampling import SamplingConfig as JaxSampling
from aki_tpu.infer.sampling import sample as jax_sample
from aki_tpu.models import configs as jax_configs
from aki_tpu.models.aki import init_aki
from aki_tpu.models.common import F32 as JAX_F32
from aki_torch.convert import from_jax_params
from aki_torch.infer import engine
from aki_torch.infer.sampling import SamplingConfig, filter_logits, sample
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN, NEW = 32, 8


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_j, cfg = jax_configs.aki_tiny(), aki_tiny()
    params = jax.tree.map(np.asarray, init_aki(jax.random.PRNGKey(3), cfg_j))
    model = AKIModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    rng = np.random.RandomState(4)
    b, t = 2, 12
    ids = rng.randint(1, cfg.initial_tokenizer_len, (b, t)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[0, 9] = ids[1, 7] = cfg.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, 8:] = 0                   # right-padded row
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    return dict(cfg_j=cfg_j, params=params, model=model, ids=ids, valid=valid,
                images=images)


def _jax_generate(tiny, **kw):
    toks, num = jax_engine.generate(
        tiny["params"], tiny["cfg_j"], jnp.asarray(tiny["ids"]),
        jnp.asarray(tiny["images"]), jnp.asarray(tiny["valid"]),
        max_new_tokens=NEW, max_len=MAX_LEN, policy=JAX_F32, use_flash=False, **kw)
    return np.asarray(toks), np.asarray(num)


def _generate(tiny, **kw):
    toks, num = engine.generate(tiny["model"], tiny["ids"], tiny["images"],
                                tiny["valid"], NEW, MAX_LEN, policy=F32,
                                device="cpu", **kw)
    return toks.numpy(), num.numpy()


@pytest.mark.parametrize("mode", ["mma", "dot", "causal"])
def test_prefill_last_logits_match_jax(tiny, mode):
    want = jax_engine.prefill(
        tiny["params"], tiny["cfg_j"], jnp.asarray(tiny["ids"]),
        jnp.asarray(tiny["images"]), jnp.asarray(tiny["valid"]), MAX_LEN,
        policy=JAX_F32, use_flash=False, attn_mode=mode)
    got = engine.prefill(tiny["model"], tiny["ids"], tiny["images"], tiny["valid"],
                         MAX_LEN, policy=F32, attn_mode=mode, device="cpu")
    np.testing.assert_allclose(got.last_logits.numpy(), np.asarray(want.last_logits),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.kv_valid.numpy(), np.asarray(want.kv_valid))


def test_greedy_tokens_identical_right_padded_batch(tiny):
    want_toks, want_num = _jax_generate(tiny)
    got_toks, got_num = _generate(tiny)
    np.testing.assert_array_equal(got_toks, want_toks)
    np.testing.assert_array_equal(got_num, want_num)


def test_eos_stops_like_jax(tiny):
    toks, _ = _jax_generate(tiny)
    eos = int(toks[0, 3])              # row 0 stops at step 3 (or earlier)
    want_toks, want_num = _jax_generate(tiny, eos_id=eos)
    got_toks, got_num = _generate(tiny, eos_id=eos)
    assert want_num[0] < NEW
    np.testing.assert_array_equal(got_toks, want_toks)
    np.testing.assert_array_equal(got_num, want_num)


def test_on_prefill_runs_once_before_the_first_decode_step(tiny, monkeypatch):
    calls = []
    real_step = engine.decode_step

    def step(*args, **kw):
        calls.append("decode")
        return real_step(*args, **kw)

    monkeypatch.setattr(engine, "decode_step", step)
    _generate(tiny, on_prefill=lambda: calls.append("prefill"))
    assert calls == ["prefill"] + ["decode"] * NEW


def test_decode_step_matches_jax(tiny):
    jstate = jax_engine.prefill(
        tiny["params"], tiny["cfg_j"], jnp.asarray(tiny["ids"]),
        jnp.asarray(tiny["images"]), jnp.asarray(tiny["valid"]), MAX_LEN,
        policy=JAX_F32, use_flash=False)
    state = engine.prefill(tiny["model"], tiny["ids"], tiny["images"], tiny["valid"],
                           MAX_LEN, policy=F32, device="cpu")
    tok = np.array([7, 11], np.int32)
    jstate = jax_engine.decode_step(tiny["params"], tiny["cfg_j"], jstate,
                                    jnp.asarray(tok), policy=JAX_F32)
    state = engine.decode_step(tiny["model"], state, torch.from_numpy(tok),
                               policy=F32, device="cpu")
    np.testing.assert_allclose(state.last_logits.numpy(), np.asarray(jstate.last_logits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(state.cache.k.numpy(), np.asarray(jstate.cache.k),
                               **LOGIT_TOL)


def _fixed_logits():
    # four clear leaders then a tail: every kept token has probability
    # > 5% at temperature 0.7, so 4000 JAX draws all but surely hit each
    lead = np.array([3.0, 2.6, 2.2, 1.9], np.float32)
    rng = np.random.RandomState(5)
    tail = rng.uniform(-3.0, -1.0, (2, 12)).astype(np.float32)
    return np.concatenate([np.tile(lead, (2, 1)), tail], 1)[:, rng.permutation(16)]


@pytest.mark.parametrize("cfg_kw", [dict(top_k=3), dict(top_p=0.8),
                                    dict(top_k=4, top_p=0.6)])
def test_topk_topp_masks_match_jax(cfg_kw):
    logits = _fixed_logits()
    kept = torch.isfinite(filter_logits(torch.from_numpy(logits),
                                        SamplingConfig(temperature=0.7, **cfg_kw))).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    draws = np.asarray(jax.vmap(lambda k: jax_sample(
        jnp.asarray(logits), JaxSampling(temperature=0.7, **cfg_kw), k))(keys))
    for row in range(logits.shape[0]):
        assert set(np.unique(draws[:, row])) == set(np.flatnonzero(kept[row]))
    gen = torch.Generator().manual_seed(0)
    drawn = sample(torch.from_numpy(logits), SamplingConfig(temperature=0.7, **cfg_kw), gen)
    assert all(kept[r, drawn[r]] for r in range(logits.shape[0]))


def test_greedy_sample_is_argmax():
    logits = torch.from_numpy(_fixed_logits())
    np.testing.assert_array_equal(sample(logits, SamplingConfig()).numpy(),
                                  logits.argmax(-1).numpy())
