"""Vision-token splice into the text stream (counterpart of
``aki_tpu/models/fusion.py``): a vectorised gather over a fixed output
length ``T_full = T_txt + n_vis - 1`` (one image a row) or
``T_txt + N_img * (n_vis - 1)`` (:func:`splice_vision_tokens_multi`), no
per-sample loop.

- labels over vision spans become -100; vision positions are valid;
- the MMA spec per sample is ``(img, img + n_vis, assistant + n_vis)``, with
  ``assistant = 0`` when absent; rows without ``<image>`` keep spec
  ``(0, 0, assistant)`` and park the unused vision slots at the tail as
  invalid;
- ``order="text_first"`` is the DOT ablation: question text (up to and
  including ``<|assistant|>``) before the vision block, causal spec;
- every gather clamps its indices, as the JAX ``take_along_axis`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.masks import MMASpec

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class SplicedBatch:
    embeds: torch.Tensor            # (B, T_full, D)
    attn_valid: torch.Tensor        # (B, T_full) int32 0/1
    labels: torch.Tensor | None     # (B, T_full), -100 on vision/pad
    spec: MMASpec                   # block-mask spec in spliced coordinates
    text_pos: torch.Tensor          # (B, T_txt): spliced index of each text pos
    positions: torch.Tensor         # (B, T_full) RoPE positions (= arange)


def _first_index_of(ids: torch.Tensor, token_id: int):
    """(first index of token_id per row, 0 when absent; whether it occurs)."""
    hit = ids == token_id
    any_hit = hit.any(dim=1)
    idx = hit.to(torch.int32).argmax(dim=1)
    return torch.where(any_hit, idx, 0), any_hit


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, t]]`` along dim 1, indices clamped into range."""
    idx = idx.clamp(0, x.shape[1] - 1)
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def _finish(text_embeds, vision_tokens, attn_valid, labels, is_vis, vis_idx,
            text_idx, has_img, spec, text_pos) -> SplicedBatch:
    embeds = torch.where(is_vis[..., None], _take(vision_tokens, vis_idx),
                         _take(text_embeds, text_idx))
    text_valid = _take(attn_valid.to(torch.int32), text_idx)
    valid = torch.where(is_vis, has_img[:, None].to(torch.int32), text_valid)
    out_labels = None
    if labels is not None:
        out_labels = torch.where(is_vis, IGNORE_INDEX, _take(labels.to(torch.int64), text_idx))
    b, t_full = is_vis.shape
    positions = torch.arange(t_full, device=is_vis.device).expand(b, t_full)
    return SplicedBatch(embeds=embeds, attn_valid=valid, labels=out_labels,
                        spec=spec, text_pos=text_pos, positions=positions)


def splice_vision_tokens(
    text_embeds: torch.Tensor,
    vision_tokens: torch.Tensor,
    input_ids: torch.Tensor,
    attn_valid: torch.Tensor,
    media_token_id: int,
    assistant_token_id: int,
    labels: torch.Tensor | None = None,
    order: str = "image_first",
) -> SplicedBatch:
    """Splice one image's ``(B, n_vis, D)`` vision tokens into each
    ``(B, T_txt, D)`` text row at its ``<image>`` token."""
    if order == "text_first":
        return _splice_text_first(text_embeds, vision_tokens, input_ids,
                                  attn_valid, media_token_id,
                                  assistant_token_id, labels)
    if order != "image_first":
        raise ValueError(f"unknown order: {order}")
    b, t_txt, _ = text_embeds.shape
    n_vis = vision_tokens.shape[1]
    t_full = t_txt + n_vis - 1
    dev = text_embeds.device

    img_idx, has_img = _first_index_of(input_ids, media_token_id)
    asst_idx, _ = _first_index_of(input_ids, assistant_token_id)
    # imageless rows: park the vision block at the tail (invalid positions)
    ins = torch.where(has_img, img_idx, t_txt).to(torch.int64)[:, None]

    pos = torch.arange(t_full, device=dev)[None]
    is_vis = (pos >= ins) & (pos < ins + n_vis)
    vis_idx = pos - ins
    # text source: before the block -> pos; after -> pos - (n_vis - 1)
    text_idx = torch.where(pos < ins + n_vis, torch.minimum(pos, ins), pos - (n_vis - 1))

    z = torch.zeros_like(img_idx)
    spec = MMASpec(
        img_start=torch.where(has_img, img_idx, z).to(torch.int32),
        txt_start=torch.where(has_img, img_idx + n_vis, z).to(torch.int32),
        txt_end=torch.where(has_img, asst_idx + n_vis, asst_idx).to(torch.int32),
    )
    # spliced index of each text position; <image> maps to the first vision slot
    tpos = torch.arange(t_txt, device=dev)[None]
    text_pos = torch.where(tpos <= ins, tpos, tpos + (n_vis - 1))
    return _finish(text_embeds, vision_tokens, attn_valid, labels, is_vis,
                   vis_idx, text_idx, has_img, spec, text_pos)


def _splice_text_first(text_embeds, vision_tokens, input_ids, attn_valid,
                       media_token_id, assistant_token_id, labels):
    """DOT ordering: [text without <image>, up to and including
    <|assistant|>] ++ vision ++ rest, under a causal spec."""
    b, t_txt, _ = text_embeds.shape
    n_vis = vision_tokens.shape[1]
    t_full = t_txt + n_vis - 1
    dev = text_embeds.device

    img_idx, has_img = _first_index_of(input_ids, media_token_id)
    asst_idx, _ = _first_index_of(input_ids, assistant_token_id)
    img_idx, asst_idx = img_idx.to(torch.int64), asst_idx.to(torch.int64)
    # <|assistant|> in text-without-<image> coordinates
    asst_wo = torch.where(has_img & (asst_idx > img_idx), asst_idx - 1, asst_idx)
    ins = torch.where(has_img, asst_wo + 1, t_txt)[:, None]
    has, img = has_img[:, None], img_idx[:, None]

    pos = torch.arange(t_full, device=dev)[None]
    is_vis = (pos >= ins) & (pos < ins + n_vis)
    vis_idx = pos - ins
    wo_idx = torch.where(pos < ins, pos, pos - n_vis)
    # text-without-<image> index -> original text index (skip <image>)
    orig_idx = torch.where(has & (wo_idx >= img), wo_idx + 1, wo_idx)

    z = torch.zeros((b,), dtype=torch.int32, device=dev)
    spec = MMASpec(img_start=z, txt_start=z, txt_end=z)

    tpos = torch.arange(t_txt, device=dev)[None]
    wo_of_orig = torch.where(has & (tpos > img), tpos - 1, tpos)
    text_pos = torch.where(wo_of_orig < ins, wo_of_orig, wo_of_orig + n_vis)
    text_pos = torch.where(has & (tpos == img), ins, text_pos)
    return _finish(text_embeds, vision_tokens, attn_valid, labels, is_vis,
                   vis_idx, orig_idx, has_img, spec, text_pos)


def collapse_logits(logits: torch.Tensor, text_pos: torch.Tensor) -> torch.Tensor:
    """Gather spliced logits ``(B, T_full, V)`` back to text positions."""
    return _take(logits, text_pos.to(torch.int64))


def _first_n_indices(ids: torch.Tensor, token_id: int, n: int, fill: int):
    """Indices of the first ``n`` occurrences of ``token_id`` per row,
    ``fill`` where a row has fewer; and the number found (at most n)."""
    hit = ids == token_id
    occ = torch.where(hit, hit.cumsum(dim=1), 0)   # 1-based occurrence number
    idx = torch.full((ids.shape[0], n), fill, dtype=torch.int64, device=ids.device)
    for j in range(n):
        hit_j = occ == j + 1
        idx[:, j] = torch.where(hit_j.any(dim=1), hit_j.to(torch.int32).argmax(dim=1), fill)
    return idx, hit.sum(dim=1).clamp(max=n)


def splice_vision_tokens_multi(
    text_embeds: torch.Tensor,
    vision_tokens: torch.Tensor,
    input_ids: torch.Tensor,
    attn_valid: torch.Tensor,
    media_token_id: int,
    assistant_token_id: int,
    labels: torch.Tensor | None = None,
) -> SplicedBatch:
    """Interleaved multi-image splice: ``(B, N_img, n_vis, D)`` vision
    tokens, image j of a row at its j-th ``<image>``.

    Image j's MMA block opens rows ``[s_j, s_j + n_vis)`` to keys
    ``[s_j + n_vis, assistant + 1)`` in spliced coordinates: each image
    attends forward to everything up to and including ``<|assistant|>``,
    which is the single-image rule for N_img = 1. An image a row lacks is
    parked after the row's text (its positions invalid) with an empty block,
    ``img_start = txt_start = txt_end = 0``. The spec is ``(B, N_img)``.
    """
    b, t_txt, d = text_embeds.shape
    n_img, n_vis = vision_tokens.shape[1], vision_tokens.shape[2]
    t_full = t_txt + n_img * (n_vis - 1)
    stride = n_vis - 1
    dev = text_embeds.device

    img_idx, n_present = _first_n_indices(input_ids, media_token_id, n_img, t_txt)
    asst_idx, _ = _first_index_of(input_ids, assistant_token_id)
    asst_idx = asst_idx.to(torch.int64)

    slot = torch.arange(n_img, device=dev)[None]
    present = slot < n_present[:, None]
    raw = torch.where(present, img_idx, t_txt)                 # text index of image j
    s = raw + slot * stride                                    # its spliced start (B, N)

    pos = torch.arange(t_full, device=dev)[None].expand(b, t_full)
    pe = pos[:, :, None]
    in_img = (pe >= s[:, None]) & (pe < (s + n_vis)[:, None])  # (B, T, N)
    is_vis = in_img.any(dim=2)
    img_of = in_img.to(torch.int32).argmax(dim=2)              # (B, T)
    off_of = (pos - _take(s, img_of)).clamp(0, n_vis - 1)
    n_done = (pe >= (s + n_vis)[:, None]).sum(dim=2)           # blocks ended at or before pos
    text_idx = torch.where(is_vis, _take(raw, img_of), pos - n_done * stride)

    flat_vis = vision_tokens.reshape(b, n_img * n_vis, d)
    vis_idx = img_of * n_vis + off_of
    embeds = torch.where(is_vis[..., None], _take(flat_vis, vis_idx),
                         _take(text_embeds, text_idx))
    text_valid = _take(attn_valid.to(torch.int32), text_idx)
    valid = torch.where(is_vis, _take(present.to(torch.int32), img_of), text_valid)
    out_labels = None
    if labels is not None:
        out_labels = torch.where(is_vis, IGNORE_INDEX, _take(labels.to(torch.int64), text_idx))

    # images before <|assistant|> shift it by one block each
    asst_done = ((asst_idx[:, None] >= raw + 1) & present).sum(dim=1)
    asst_spliced = asst_idx + asst_done * stride
    spec = MMASpec(
        img_start=torch.where(present, s, 0).to(torch.int32),
        txt_start=torch.where(present, s + n_vis, 0).to(torch.int32),
        txt_end=torch.where(present, (asst_spliced + 1)[:, None], 0).to(torch.int32),
    )

    tpos = torch.arange(t_txt, device=dev)[None].expand(b, t_txt)
    n_started = ((tpos[:, :, None] > raw[:, None]) & present[:, None]).sum(dim=2)
    text_pos = tpos + n_started * stride
    return SplicedBatch(embeds=embeds, attn_valid=valid, labels=out_labels, spec=spec,
                        text_pos=text_pos, positions=pos)
