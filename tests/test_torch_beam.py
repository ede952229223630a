"""The port's beam search against the JAX package's at aki_tiny, fp32.

Same weights (``from_jax_params``), same prompts: tokens and lengths must be
identical and the HF ``sequence_scores`` within 1e-5 (the same f32 sums of
log-probs from logits that agree to ~1e-6). Cases cover K 1/2/4, the
no-repeat-ngram rule 0/2, both ``early_stopping`` modes, right-padded
prompts, an eos the search reaches (so hypotheses finish), suppressed ids,
several return sequences and the int8 KV cache. ``_ngram_banned`` is held
to the JAX rule on random rows, and K = 1 to the port's greedy engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.infer.beam import _ngram_banned as jax_ngram_banned
from aki_tpu.infer.beam import generate_beam as jax_generate_beam
from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_torch.convert import from_jax_params
from aki_torch.infer.beam import _ngram_banned, _top, generate_beam
from aki_torch.infer.engine import generate
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny

from ._jax_tiny import tiny_params

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
NEW, MAX_LEN = 6, 48


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg = jax_configs.aki_tiny(), aki_tiny()
    params = tiny_params(7)
    model = AKIModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    rng = np.random.RandomState(8)
    b, t = 2, 12
    ids = rng.randint(5, cfg.initial_tokenizer_len - 1, (b, t)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[:, 6] = cfg.assistant_token_id
    valid = np.ones((b, t), np.int32)
    ids[1, 9:] = cfg.pad_token_id        # right-padded second row
    valid[1, 9:] = 0
    images = rng.randn(b, 28, 28, 3).astype(np.float32)
    greedy, _ = generate(model, ids, images, valid, NEW, MAX_LEN, policy=F32, device="cpu")
    return dict(cfg_j=cfg_j, params=params, model=model, ids=ids, valid=valid,
                images=images, greedy=greedy.numpy())


# eos: None, or the first greedy token of row 0, which ends hypotheses in
# the cases marked "finishes" (lengths below NEW come back)
CASES = {
    "k1": dict(num_beams=1),
    "k2_ngram2_eos_r2": dict(num_beams=2, no_repeat_ngram_size=2, eos=True,
                             num_return_sequences=2, finishes=True),
    "k4_early_eos_r3": dict(num_beams=4, early_stopping=True, eos=True,
                            num_return_sequences=3, finishes=True),
    "k4_ngram2_eos_lp07_suppress": dict(num_beams=4, no_repeat_ngram_size=2, eos=True,
                                        length_penalty=0.7, suppress_tokens=(3, 4),
                                        finishes=True),
    "k2_eos_int8_kv": dict(num_beams=2, eos=True, num_return_sequences=2, kv_int8=True,
                           finishes=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_matches_jax(tiny, case):
    kw = dict(CASES[case])
    finishes = kw.pop("finishes", False)
    kw["eos_id"] = int(tiny["greedy"][0, 0]) if kw.pop("eos", False) else -1
    kw.update(max_new_tokens=NEW, max_len=MAX_LEN)
    want = jax_generate_beam(tiny["params"], tiny["cfg_j"], jnp.asarray(tiny["ids"]),
                             jnp.asarray(tiny["images"]), jnp.asarray(tiny["valid"]),
                             policy=JAX_F32, use_flash=False, **kw)
    got = generate_beam(tiny["model"], tiny["ids"], tiny["images"], tiny["valid"],
                        policy=F32, device="cpu", **kw)
    w_toks, w_lens, w_scores = (np.asarray(x) for x in want)
    g_toks, g_lens, g_scores = (x.numpy() for x in got)
    assert g_toks.shape == (2, kw.get("num_return_sequences", 1), NEW)
    np.testing.assert_array_equal(g_toks, w_toks)
    np.testing.assert_array_equal(g_lens, w_lens)
    np.testing.assert_allclose(g_scores, w_scores, **SCORE_TOL)
    assert (g_lens < NEW).any() == finishes


def test_beam_k1_equals_greedy(tiny):
    toks, lens, _ = generate_beam(tiny["model"], tiny["ids"], tiny["images"], tiny["valid"],
                                  NEW, MAX_LEN, num_beams=1, eos_id=-1, policy=F32,
                                  device="cpu")
    np.testing.assert_array_equal(toks[:, 0].numpy(), tiny["greedy"])
    assert lens.tolist() == [[NEW], [NEW]]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_banned_matches_jax(n):
    rng = np.random.RandomState(n)
    vocab, t = 7, 14
    jax_rule = jax.jit(jax.vmap(jax_ngram_banned, in_axes=(0, 0, None, None)),
                       static_argnums=(2, 3))
    lengths = rng.randint(0, t + 1, 64)
    seq = rng.randint(0, vocab, (64, t))
    seq[np.arange(t)[None] >= lengths[:, None]] = -1   # the sentinel past the live tokens
    want = np.asarray(jax_rule(jnp.asarray(seq, jnp.int32), jnp.asarray(lengths, jnp.int32),
                               n, vocab))
    assert want.any() and not want.all()
    got = _ngram_banned(torch.tensor(seq), torch.tensor(lengths), n, vocab)
    np.testing.assert_array_equal(got.numpy(), want)
    # one row alone, as the JAX function takes it, and rows with two batch dims
    np.testing.assert_array_equal(
        _ngram_banned(torch.tensor(seq[5]), torch.tensor(lengths[5]), n, vocab).numpy(),
        want[5])
    got = _ngram_banned(torch.tensor(seq).reshape(8, 8, t),
                        torch.tensor(lengths).reshape(8, 8), n, vocab)
    np.testing.assert_array_equal(got.reshape(64, vocab).numpy(), want)


def test_top_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")]])
    vals, idx = _top(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert vals[0, :4].tolist() == [3.0, 3.0, 3.0, 1.0]
