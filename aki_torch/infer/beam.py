"""Beam-search generation, the HF-``generate`` parity surface (counterpart of
``aki_tpu/infer/beam.py``).

The reference's ``generate`` (``src/flamingo.py:137-188``) forwards
``num_beams`` / ``length_penalty`` / ``early_stopping`` /
``no_repeat_ngram_size`` / ``num_return_sequences`` to HF's beam search.
Here: one prefill at batch B through ``engine.prefill`` (the vision tower
and the flash forward run once per image, not once per beam), the KV cache
expanded to B*K rows (``KVCache`` k/v, or the four leaves of ``KVCacheQ``),
then a Python loop of ``engine.decode_step``; beam reordering gathers the
cache rows in place.

Semantics are those of ``transformers.generation.BeamSearchScorer``, as in
the JAX package:

- 2K candidates per step; eos candidates ranked >= K are dropped; the first
  K non-eos candidates in rank order continue as live beams;
- an eos candidate at rank < K finishes a hypothesis with score
  ``sum_logprobs / (t+1) ** length_penalty`` (t+1 = generated length
  including the eos); the finished heap keeps the best K;
- ``early_stopping=False`` stops a batch when the worst kept score >=
  ``best_running_sum / (t+1) ** length_penalty`` (HF's heuristic), ``True``
  as soon as K hypotheses exist;
- at the step limit, unfinished batches fold their live beams in with score
  ``sum / max_new_tokens ** length_penalty``;
- ``no_repeat_ngram_size`` bans any token completing an n-gram already
  present in (text prompt + generated), on the log-probs before the beam
  scores are added.

Every selection ranks ties toward the lower index, as ``lax.top_k`` does:
``torch.topk`` promises no order among equal values, so :func:`_top` is a
stable descending sort.
"""

from __future__ import annotations

import torch

from ..models.aki import AKIModel
from ..models.common import BF16, Policy
from ..models.phi3 import KVCache, KVCacheQ
from .engine import GenState, decode_step, prefill

NEG = -1.0e9


def _top(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest entries of each row and their indices, equal
    values in index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _expand_beams(state: GenState, k: int) -> GenState:
    """Repeat every row K times (row b -> rows b*K .. b*K+K-1). Cache leaves
    carry the batch on dim 1, the bookkeeping on dim 0."""
    cache = state.cache
    rep = lambda x, dim: x.repeat_interleave(k, dim=dim)  # noqa: E731
    if isinstance(cache, KVCacheQ):
        cache = KVCacheQ(*(rep(x, 1) for x in cache.buffers()))
    else:
        cache = KVCache(k=rep(cache.k, 1), v=rep(cache.v, 1))
    return GenState(cache=cache, kv_valid=rep(state.kv_valid, 0),
                    lengths=rep(state.lengths, 0), last_logits=rep(state.last_logits, 0))


def _gather_beams(state: GenState, rows: torch.Tensor) -> None:
    """Reorder the B*K rows of ``state`` by ``rows`` (the beam-parent
    gather), in place."""
    cache = state.cache
    leaves = cache.buffers() if isinstance(cache, KVCacheQ) else (cache.k, cache.v)
    for x in leaves:
        x.copy_(x.index_select(1, rows))
    for x in (state.kv_valid, state.lengths, state.last_logits):
        x.copy_(x.index_select(0, rows))


def _ngram_banned(seq: torch.Tensor, length: torch.Tensor, n: int,
                  vocab: int) -> torch.Tensor:
    """Mask (..., V) of the tokens banned by the no-repeat-ngram rule, for
    rows ``seq`` (..., T) of ``length`` (...) live tokens: token v is banned
    iff ``seq[i:i+n-1] == seq[L-n+1:L]`` and ``seq[i+n-1] == v`` for some
    window ``i <= L-n`` (HF ``NoRepeatNGramLogitsProcessor`` over prompt +
    generated)."""
    t_tot = seq.shape[-1]
    length = torch.as_tensor(length, device=seq.device)
    ar = torch.arange(n - 1, device=seq.device)
    suffix = seq.gather(-1, (length[..., None] - (n - 1) + ar).clamp(0, t_tot - 1))
    starts = torch.arange(t_tot - n + 1, device=seq.device)
    wins = seq[..., starts[:, None] + ar]                        # (..., W, n-1)
    nxt = seq[..., n - 1:]                                       # (..., W)
    match = (wins == suffix[..., None, :]).all(-1) & (starts <= length[..., None] - n)
    # windows whose next token is not a token id (the -1 sentinel) ban nothing
    match &= (nxt >= 0) & (nxt < vocab)
    banned = torch.zeros(seq.shape[:-1] + (vocab + 1,), dtype=torch.bool, device=seq.device)
    banned.scatter_(-1, torch.where(match, nxt, vocab), True)
    return banned[..., :vocab]


@torch.inference_mode()
def generate_beam(
    model: AKIModel,
    input_ids,
    images,
    attn_valid,
    max_new_tokens: int,
    max_len: int,
    num_beams: int,
    eos_id: int,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    no_repeat_ngram_size: int = 0,
    num_return_sequences: int = 1,
    suppress_tokens: tuple[int, ...] = (),
    policy: Policy = BF16,
    use_flash: bool = True,
    order: str = "image_first",
    kv_int8: bool = False,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-search decode.

    Returns ``(tokens (B, num_return_sequences, max_new_tokens) — generated
    tokens incl. a terminating eos when the hypothesis ended on one,
    pad-filled after; lengths (B, R); scores (B, R) — HF
    ``sequence_scores``, i.e. sum-logprob / len**length_penalty)``.
    """
    if not 1 <= num_return_sequences <= num_beams:
        raise ValueError(f"num_return_sequences {num_return_sequences} not in "
                         f"[1, num_beams={num_beams}]")
    state = prefill(model, input_ids, images, attn_valid, max_len, policy=policy,
                    use_flash=use_flash, order=order, kv_int8=kv_int8, device=device)
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    attn_valid = torch.as_tensor(attn_valid, device=dev)
    b, t_txt = input_ids.shape
    k, m = num_beams, max_new_tokens
    vocab, pad = model.cfg.output_vocab, model.cfg.pad_token_id
    state = _expand_beams(state, k)

    # only beam 0 live at step 0 (HF: beam_scores[:, 1:] = -1e9), so the
    # first expansion explores K distinct tokens instead of K copies
    beam_scores = torch.full((b, k), NEG, device=dev)
    beam_scores[:, 0] = 0.0

    # text-side sequence buffer for the ngram rule: valid prompt tokens, the
    # sentinel -1 elsewhere (never matches a token), generated tokens
    # appended at the row's valid length (no pad gap)
    seq0 = torch.where(attn_valid > 0, input_ids, -1)
    seq_buf = torch.cat([seq0, seq0.new_full((b, m), -1)], dim=1)
    seq_buf = seq_buf[:, None].repeat(1, k, 1)                          # (B,K,Ttot)
    txt_len = attn_valid.sum(dim=1).long()[:, None].repeat(1, k)        # (B,K)

    full = lambda shape, v, dtype=torch.int64: torch.full(shape, v, dtype=dtype,  # noqa: E731
                                                          device=dev)
    gen_buf = full((b, k, m), pad)
    fin_scores = full((b, k), float("-inf"), torch.float32)
    fin_seqs = full((b, k, m), pad)
    fin_lens = full((b, k), 0)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    rank = torch.arange(2 * k, device=dev)
    suppress = torch.tensor(suppress_tokens, dtype=torch.int64, device=dev)

    for t in range(m):
        logp = torch.log_softmax(state.last_logits.float().reshape(b, k, vocab), dim=-1)
        if suppress_tokens:
            # HF SuppressTokensLogitsProcessor: hard-ban a fixed id set
            logp[:, :, suppress] = float("-inf")
        if no_repeat_ngram_size > 0:
            banned = _ngram_banned(seq_buf, txt_len + t, no_repeat_ngram_size, vocab)
            logp = logp.masked_fill(banned, float("-inf"))

        cand = beam_scores[:, :, None] + logp                           # (B,K,V)
        scores2k, idx2k = _top(cand.reshape(b, k * vocab), 2 * k)
        tok2k, par2k = idx2k % vocab, idx2k // vocab
        is_eos = tok2k == eos_id

        # live beams: the first K non-eos candidates in rank order
        live_sel = torch.argsort(torch.where(is_eos, 2 * k + rank, rank), dim=1)[:, :k]
        live_scores = scores2k.gather(1, live_sel)
        live_tok = tok2k.gather(1, live_sel)
        live_par = par2k.gather(1, live_sel)

        # finished-hypothesis adds: eos candidates ranked < K
        denom = torch.tensor(float(t + 1), device=dev) ** length_penalty
        add_scores = torch.where(is_eos & (rank < k) & ~done[:, None], scores2k / denom,
                                 float("-inf"))
        # hypothesis payload: the parent's generated prefix + the eos at t
        add_seqs = gen_buf.gather(1, par2k[:, :, None].expand(-1, -1, m)).clone()
        add_seqs[:, :, t] = eos_id
        add_lens = full((b, 2 * k), t + 1)

        # merge into the best-K heap
        fin_scores, top_idx = _top(torch.cat([fin_scores, add_scores], dim=1), k)
        fin_seqs = torch.cat([fin_seqs, add_seqs], dim=1).gather(
            1, top_idx[:, :, None].expand(-1, -1, m))
        fin_lens = torch.cat([fin_lens, add_lens], dim=1).gather(1, top_idx)

        # HF done heuristic (early_stopping=False): worst kept >= the best
        # possible continuation at the current generated length
        fin_count = torch.isfinite(fin_scores).sum(dim=1)
        if early_stopping:
            newly_done = fin_count >= k
        else:
            worst = fin_scores.min(dim=1).values
            newly_done = (fin_count >= k) & (worst >= scores2k[:, 0] / denom)

        # freeze finished batches: pad token, parent 0, scores unchanged
        live_tok = torch.where(done[:, None], pad, live_tok)
        live_par = torch.where(done[:, None], 0, live_par)
        beam_scores = torch.where(done[:, None], beam_scores, live_scores)
        done = done | newly_done

        # reorder rows by parent, then decode the chosen tokens
        rows = (torch.arange(b, device=dev)[:, None] * k + live_par).reshape(-1)
        _gather_beams(state, rows)
        gen_buf = gen_buf.gather(1, live_par[:, :, None].expand(-1, -1, m))
        seq_buf = seq_buf.gather(1, live_par[:, :, None].expand(-1, -1, seq_buf.shape[-1]))
        gen_buf[:, :, t] = live_tok
        seq_buf.scatter_(2, (txt_len + t)[:, :, None], live_tok[:, :, None])
        state = decode_step(model, state, live_tok.reshape(-1), policy=policy, device=device)

    # finalize: unfinished batches fold their live beams in (score normalized
    # by the full generated length, no eos appended)
    live_scores = torch.where(done[:, None], float("-inf"),
                              beam_scores / float(m) ** length_penalty)
    top_scores, top_idx = _top(torch.cat([fin_scores, live_scores], dim=1),
                               num_return_sequences)
    out_seqs = torch.cat([fin_seqs, gen_buf], dim=1).gather(
        1, top_idx[:, :, None].expand(-1, -1, m))
    out_lens = torch.cat([fin_lens, full((b, k), m)], dim=1).gather(1, top_idx)
    pos = torch.arange(m, device=dev)
    out_seqs = torch.where(pos < out_lens[:, :, None], out_seqs, pad)
    return out_seqs, out_lens, top_scores
