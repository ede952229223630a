"""Interleaved (MMC4-style) image-text pipeline for multi-image pretraining
(counterpart of ``aki_tpu/data/interleaved.py``: byte-equal batches).

Behavioral port of ``train/data.py:104-235``:

- images arrive base64-encoded with a precomputed image x sentence CLIP
  similarity matrix;
- images under ``min_kb`` are dropped; one-to-one image<->sentence matching
  by Hungarian assignment on the (negated) similarities, thresholded;
- matched sentences get ``<|endofchunk|><image>`` prefixes (first eoc
  removed, whitespace normalized), text ends ``<|endofchunk|></s>``;
- image tensors padded with zeros to ``max_num_images``;
- samples whose single ``<image>`` lands at the sequence end are rejected
  (all labels would be -100, ``data.py:221-231``).
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Iterator

import numpy as np
from .images import decode_image, preprocess, zero_image
from .tar_reader import expand_shards, shard_sample_stream

IGNORE_INDEX = -100
MIN_KB = 3  # data.py:24 — images <= 3KB are dropped


@dataclasses.dataclass
class InterleavedConfig:
    shards: str | list[str]
    batch_size: int = 4
    max_tokens: int = 256
    image_size: int = 384
    sim_threshold: float = 0.24
    min_num_images: int = 1
    max_num_images: int = 6
    seed: int = 0
    shuffle_buffer: int = 1000
    loss_multiplier: float = 1.0     # per-dataset loss weight
                                     # (reference --loss_multiplier_mmc4,
                                     # train/train.py:103)


@dataclasses.dataclass
class InterleavedBatch:
    input_ids: np.ndarray    # (B, T)
    attn_valid: np.ndarray   # (B, T)
    labels: np.ndarray       # (B, T)
    images: np.ndarray       # (B, N_img, S, S, 3)
    loss_weight: float = 1.0


def preprocess_interleaved(info: dict, tokenizer, cfg: InterleavedConfig,
                           rng: np.random.RandomState):
    sentences = list(info["text_list"])
    sim = np.asarray(info["similarity_matrix"], dtype=np.float32)

    valid_images, valid_idx = [], []
    for i, im in enumerate(info["image_info"]):
        b64 = im.get("image_base64")
        if b64 is None:
            continue
        raw = base64.b64decode(b64)
        if len(raw) // 1000 <= MIN_KB:
            continue
        valid_images.append(raw)
        valid_idx.append(i)
    if not valid_idx:
        raise ValueError("No images in sample")

    from scipy.optimize import linear_sum_assignment

    sim = sim[valid_idx]
    img_ix, sent_ix = linear_sum_assignment(-sim)
    images, sentence_ixs = [], []
    for i, j in zip(img_ix, sent_ix):
        if sim[i][j] < cfg.sim_threshold:
            continue
        images.append(valid_images[i])
        sentence_ixs.append(j)
    if not images:
        raise ValueError("No matched images in sample")

    keep = range(min(len(images), cfg.max_num_images))
    images = [images[k] for k in keep]
    sentence_ixs = [sentence_ixs[k] for k in keep]

    arrs = [
        preprocess(decode_image(raw), cfg.image_size, rng=rng, hflip=True)
        for raw in images
    ]
    while len(arrs) < cfg.max_num_images:
        arrs.append(zero_image(cfg.image_size))

    # Byte-exact text construction (data.py:185-197): no-space prefixes,
    # remove first eoc, then the whitespace-cleanup replace chain.
    for ix in sentence_ixs:
        sentences[ix] = f"<|endofchunk|><image>{sentences[ix]}"
    text = " ".join(sentences)
    text = text.replace("<|endofchunk|>", "", 1)  # but remove first eoc
    text = (
        text.replace(" <|endofchunk|>", "<|endofchunk|>")
        .replace("<image> ", "<image>")
        .replace(" <image>", "<image>")
    )
    text = f"{text}<|endofchunk|>"

    # Reference: f"{text}<|endofchunk|>{tokenizer.eos_token}" tokenized with
    # add_bos/add_eos True -> [bos] + body + [eos_str_token] + [eos], with
    # truncation reserving the bracketing specials (data.py:197-205).
    eos = tokenizer.info.eos_id
    body = tokenizer.encode(text) + [eos]
    ids = [tokenizer.info.bos_id] + body[: cfg.max_tokens - 2] + [eos]

    media = tokenizer.info.media_id
    n_media = sum(1 for t in ids if t == media)
    # Reference checks position max_tokens-1 of the max_length-padded tensor
    # (data.py:222-231): reject only if the single <image> sits at the very
    # end of a full-length sequence.
    if n_media == 1 and len(ids) == cfg.max_tokens and ids[-1] == media:
        raise ValueError("Only one image at the end of sample")
    if n_media == 0:
        # Not reachable in the reference (it pads, never truncates away the
        # first <image> in practice); guarded here because the static-shape
        # splice downstream requires >= 1 media token.
        raise ValueError("No image token after truncation")

    return np.stack(arrs), ids


def batches(cfg: InterleavedConfig, tokenizer, epoch: int = 0,
            rank: int = 0, world: int = 1, worker: int = 0,
            num_workers: int = 1) -> Iterator[InterleavedBatch]:
    rng = np.random.RandomState((cfg.seed + epoch) * 7919 + rank * 131 + worker)
    pad = tokenizer.info.pad_id
    t = cfg.max_tokens
    stream = shard_sample_stream(
        expand_shards(cfg.shards), epoch=epoch, seed=cfg.seed,
        shuffle_buffer=cfg.shuffle_buffer,
        rank=rank, world=world, worker=worker, num_workers=num_workers,
    )
    buf_imgs, buf_ids = [], []
    for sample in stream:
        try:
            payload = sample.get("json")
            if payload is None:
                continue
            info = json.loads(payload)
            imgs, ids = preprocess_interleaved(info, tokenizer, cfg, rng)
        except Exception:  # noqa: BLE001 — log_and_continue semantics
            continue
        buf_imgs.append(imgs)
        buf_ids.append(ids)
        if len(buf_imgs) == cfg.batch_size:
            b = len(buf_imgs)
            input_ids = np.full((b, t), pad, np.int32)
            valid = np.zeros((b, t), np.int32)
            for i, ids_i in enumerate(buf_ids):
                input_ids[i, : len(ids_i)] = ids_i
                valid[i, : len(ids_i)] = 1
            labels = np.where(valid == 1, input_ids, IGNORE_INDEX).astype(np.int32)
            yield InterleavedBatch(
                input_ids=input_ids, attn_valid=valid, labels=labels,
                images=np.stack(buf_imgs).astype(np.float32),
                loss_weight=cfg.loss_multiplier,
            )
            buf_imgs, buf_ids = [], []
