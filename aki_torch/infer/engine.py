"""KV-cached generation: MMA prefill, causal decode (counterpart of
``aki_tpu/infer/engine.py``).

- prefill: the spliced prompt under the MMA block mask fills cache slots
  ``[0, T_full)``; each row's next-token logits are taken at its last
  valid position only.
- decode: one query row per step, causal over the cache under ``kv_valid``;
  the new token is written at slot ``lengths[b]`` with RoPE position
  ``lengths[b]`` (so positions continue after the vision tokens).
- generate: a Python loop of decode steps. Rows that finished keep decoding
  pad tokens, as in JAX; their outputs are masked from the result.
- ``kv_int8``: the cache is the flat int8 :class:`KVCacheQ`; decode then
  attends through the int8 decode kernel
  (:func:`~aki_torch.ops.decode_attention.decode_attention_flat`).
- serving admission (``slot_state`` / ``slots``): the prefill writes its
  rows into given rows of a wider slot cache and merges the bookkeeping
  (counterpart of ``aki_tpu/infer/engine.py:56-162``).

Caches and slot states are updated in place; every entry point runs under
``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..models.aki import AKIModel, embed_text, encode_vision, lm_logits
from ..models.common import BF16, Policy, resolve_device
from ..models.fusion import splice_vision_tokens
from ..models.phi3 import KVCache, KVCacheQ, slot_rows
from ..ops.masks import causal_spec
from .sampling import SamplingConfig, sample


@dataclasses.dataclass
class GenState:
    cache: KVCache | KVCacheQ
    kv_valid: torch.Tensor     # (B, max_len) int32 0/1 over cache slots
    lengths: torch.Tensor      # (B,) live tokens (== next write slot)
    last_logits: torch.Tensor  # (B, V) f32


def _on(model: AKIModel, device) -> torch.device:
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"model is on {model.device}, entry point asked for {device}")
    return model.device


def use_tensor_parallel(model: AKIModel, tp_mesh) -> None:
    """Cut ``model`` to this rank's ``tensor`` block unless it already is."""
    if tp_mesh is not None and model.lang_model.model.tp is None:
        from ..parallel.tensor import shard_tensor_parallel

        shard_tensor_parallel(model, tp_mesh)


@torch.inference_mode()
def prefill(
    model: AKIModel,
    input_ids,
    images,
    attn_valid,
    max_len: int,
    policy: Policy = BF16,
    use_flash: bool = True,
    order: str = "image_first",
    vision_tokens: torch.Tensor | None = None,
    attn_mode: str | None = None,
    device="cuda",
    kv_int8: bool = False,
    slot_state: GenState | None = None,
    slots=None,
    tp_mesh=None,
) -> GenState:
    """Run the prompt through the model, filling a fresh KV cache of
    ``max_len`` slots (int8 :class:`KVCacheQ` with ``kv_int8``).

    ``attn_mode`` ("mma" | "dot" | "causal") selects the ablation: MMA
    block, text-before-image ordering with a causal mask, or the
    image-first splice with the MMA block zeroed; it overrides ``order``.
    ``use_flash=False`` runs the plain attention instead of the kernel.

    ``slot_state`` / ``slots``: serving admission. Row r of the prompt
    batch writes its K/V into row ``slots[r]`` of ``slot_state.cache``
    (whose kind, not ``kv_int8``, decides the cache) and its kv_valid,
    length and last logits into the same rows of ``slot_state``; a slot
    equal to the slot count drops the row (padded admissions). ``slots``
    is read on the host. Returns ``slot_state``, updated in place.

    ``tp_mesh``: tensor-parallel serving over the mesh's ``tensor`` axis;
    the model is cut to this rank's heads in place on first use
    (:func:`~aki_torch.parallel.tensor.shard_tensor_parallel`), and every
    rank of the axis makes the same call.
    """
    dev = _on(model, device)
    use_tensor_parallel(model, tp_mesh)
    if attn_mode is not None:
        if attn_mode not in ("mma", "dot", "causal"):
            raise ValueError(f"attn_mode {attn_mode!r}")
        order = "text_first" if attn_mode == "dot" else "image_first"
    cfg = model.cfg
    input_ids = torch.as_tensor(input_ids, device=dev)
    attn_valid = torch.as_tensor(attn_valid, device=dev)
    b = input_ids.shape[0]
    if vision_tokens is None:
        vision_tokens = encode_vision(model, torch.as_tensor(images, device=dev),
                                      policy, use_flash)
    sp = splice_vision_tokens(embed_text(model, input_ids, policy), vision_tokens,
                              input_ids, attn_valid, cfg.media_token_id,
                              cfg.assistant_token_id, order=order)
    spec = causal_spec(b, dev) if attn_mode == "causal" else sp.spec
    t_full = sp.embeds.shape[1]
    if max_len < t_full:
        raise ValueError(f"cache of {max_len} slots is shorter than the "
                         f"{t_full}-token spliced prompt")

    if slot_state is not None:
        if slots is None:
            raise ValueError("slot_state requires slots")
        cache = slot_state.cache
    elif kv_int8:
        # the decoder's config: a tensor-parallel rank's local KV heads
        cache = KVCacheQ.create(model.lang_model.model.cfg, b, max_len, device=dev)
    else:
        cache = KVCache.create(model.lang_model.model.cfg, b, max_len,
                               dtype=policy.compute_dtype, device=dev)
    kv_valid = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    kv_valid[:, :t_full] = sp.attn_valid
    zero = torch.zeros((b,), dtype=torch.int64, device=dev)
    hidden, cache = model.lang_model.model(
        sp.embeds, sp.positions, spec=spec, kv_valid=kv_valid, cache=cache,
        cache_index=zero, policy=policy, use_flash=use_flash,
        cache_slots=slots if slot_state is not None else None)
    lengths = sp.attn_valid.sum(dim=1).to(torch.int64)
    last_idx = (lengths - 1).clamp(0, t_full - 1)
    last_hidden = hidden[torch.arange(b, device=dev), last_idx][:, None]
    last_logits = lm_logits(model, last_hidden, policy)[:, 0].float()
    if slot_state is not None:
        # merge the bookkeeping into the slot rows; dropped rows write nothing
        src, dst = slot_rows(slots, slot_state.lengths.shape[0], dev)
        slot_state.kv_valid[dst] = kv_valid[src]
        slot_state.lengths[dst] = lengths[src]
        slot_state.last_logits[dst] = last_logits[src]
        return slot_state
    return GenState(cache=cache, kv_valid=kv_valid, lengths=lengths, last_logits=last_logits)


@torch.inference_mode()
def decode_step(model: AKIModel, state: GenState, token_ids,
                policy: Policy = BF16, device="cuda",
                live_width: int | None = None) -> GenState:
    """Advance one token: ``token_ids`` (B,) are the ids chosen from
    ``state.last_logits``. ``state.cache`` is updated in place.
    ``live_width``: only the first ``live_width`` rows are live (the
    server's tail compaction); the int8-KV decode then reads only those
    rows of the cache and gives zero attention to the others, whose
    bookkeeping the caller keeps. Other attention paths ignore it."""
    dev = _on(model, device)
    token_ids = torch.as_tensor(token_ids, device=dev)
    embeds = embed_text(model, token_ids[:, None], policy)
    s = state.kv_valid.shape[1]
    # mark the new slot valid before attention (a token attends to itself);
    # a write past the cache clamps to the last slot, as JAX's update does
    kv_valid = state.kv_valid.scatter(1, state.lengths.clamp(max=s - 1)[:, None], 1)
    hidden, cache = model.lang_model.model(
        embeds, state.lengths[:, None], spec=None, kv_valid=kv_valid,
        q_offset=state.lengths, cache=state.cache, cache_index=state.lengths,
        policy=policy, live_width=live_width)
    logits = lm_logits(model, hidden, policy)[:, 0]
    return GenState(cache=cache, kv_valid=kv_valid, lengths=state.lengths + 1,
                    last_logits=logits.float())


@torch.inference_mode()
def generate(
    model: AKIModel,
    input_ids,
    images,
    attn_valid,
    max_new_tokens: int,
    max_len: int,
    eos_id: int | None = None,
    sampling: SamplingConfig = SamplingConfig(),
    generator: torch.Generator | None = None,
    policy: Policy = BF16,
    use_flash: bool = True,
    order: str = "image_first",
    attn_mode: str | None = None,
    device="cuda",
    on_prefill: Callable[[], None] | None = None,
    kv_int8: bool = False,
    tp_mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched generation. Returns (tokens (B, max_new_tokens) — pad-filled
    after a row stops —, number generated per row (B,), counting the eos).
    Sampling draws from ``generator`` (one seeded 0 on the model's device
    when None, as JAX defaults to ``PRNGKey(0)``). ``on_prefill`` is called
    once the prefill is issued and before the first decode step (e.g. to
    record a CUDA event that splits the call's time). ``kv_int8`` keeps the
    cache in int8 (:class:`KVCacheQ`). ``tp_mesh``: as :func:`prefill`."""
    state = prefill(model, input_ids, images, attn_valid, max_len, policy=policy,
                    use_flash=use_flash, order=order, attn_mode=attn_mode,
                    device=device, kv_int8=kv_int8, tp_mesh=tp_mesh)
    if on_prefill is not None:
        on_prefill()
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    pad, eos = model.cfg.pad_token_id, -1 if eos_id is None else eos_id
    done = torch.zeros_like(state.lengths, dtype=torch.bool)
    tokens = []
    for _ in range(max_new_tokens):
        tok = sample(state.last_logits, sampling, generator)
        tok = torch.where(done, pad, tok)
        done = done | (tok == eos)
        state = decode_step(model, state, tok, policy=policy, device=device)
        tokens.append(tok)
    tokens = torch.stack(tokens, dim=1)
    is_eos = (tokens == eos).to(torch.int32)
    num = (is_eos.cumsum(dim=1) == 0).sum(dim=1) + is_eos.any(dim=1).to(torch.int64)
    return tokens, num.clamp(max=max_new_tokens)
