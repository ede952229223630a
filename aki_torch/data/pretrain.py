"""Pretraining data pipeline: image-caption webdataset shards -> batches
(counterpart of ``aki_tpu/data/pretrain.py``: byte-equal batches).

Reference semantics (``train/data.py``):

- filter: sample must have a caption and an image (``data.py:59-65``);
- caption template ``<image>{caption}<|endofchunk|>`` with dataset-specific
  parsing for blip3_grounding (literal_eval) / blip3_ocr (json)
  (``data.py:68-101``);
- tokenize to ``max_text_len`` (128), padded to that fixed length;
- image preprocess + RandomHorizontalFlip (``data.py:47-56``);
- labels: input_ids with pad -> -100; the media/eoc special tokens stay in
  the loss like the reference's NextTokenPrediction (``losses.py:83-116``
  masks only pads; splicing masks the vision span later).

Batches come out as numpy; the trainer moves them to the device
(``Trainer.put_batch``), and a background thread keeps ``depth`` batches in
flight (:class:`Prefetcher`).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import queue
import threading
from typing import Iterator

import numpy as np

from .images import decode_image, preprocess
from .tar_reader import shard_sample_stream, expand_shards
from .tokenizer import train_encode

IGNORE_INDEX = -100
IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


@dataclasses.dataclass
class PretrainConfig:
    shards: str | list[str]
    batch_size: int = 8
    max_text_len: int = 128
    image_size: int = 384
    dataset_name: str = "blip3_kale"
    seed: int = 0
    shuffle_buffer: int = 5000
    resampled: bool = False
    num_samples: int | None = None   # per-epoch budget (train_num_samples_X)
    loss_multiplier: float = 1.0     # per-dataset loss weight


def parse_caption(sample: dict, dataset_name: str) -> str | None:
    """Dataset-specific caption extraction, structure-exact vs data.py:77-94.

    - cc3m/cc12m/blip3_kale: ``s.strip()``
    - blip3_grounding_50m: ``literal_eval(s)[0][0].strip()``
    - blip3_ocr_200m: ``json.loads(s)[1]['text'].strip()``

    A parse failure skips the sample (the reference raises inside the wds
    map, which log_and_continue swallows).
    """
    raw = sample.get("txt")
    if raw is None:
        return None
    text = raw.decode("utf-8", errors="replace")
    try:
        if dataset_name in ("cc3m", "cc12m", "blip3_kale"):
            return text.strip()
        if dataset_name == "blip3_grounding_50m":
            return str(ast.literal_eval(text)[0][0]).strip()
        if dataset_name == "blip3_ocr_200m":
            return str(json.loads(text)[1]["text"]).strip()
    except Exception:  # noqa: BLE001 — log_and_continue semantics
        return None
    raise NotImplementedError(f"Dataset {dataset_name} not supported")


def has_image_and_caption(sample: dict) -> bool:
    return any(e in sample for e in IMAGE_EXTS) and bool(sample.get("txt"))


def caption_text(caption: str) -> str:
    """Byte-exact ``f"<image>{s.strip()}<|endofchunk|>"`` (data.py:80-82) —
    no spaces around the special tokens; spaces change the SP token stream."""
    return f"<image>{caption.strip()}<|endofchunk|>"


@dataclasses.dataclass
class PretrainBatch:
    input_ids: np.ndarray    # (B, T) int32
    attn_valid: np.ndarray   # (B, T) int32
    labels: np.ndarray       # (B, T) int32, pad -> -100
    images: np.ndarray       # (B, S, S, 3) float32
    loss_weight: float = 1.0


def sample_stream(
    cfg: PretrainConfig,
    tokenizer,
    epoch: int = 0,
    rank: int = 0,
    world: int = 1,
    worker: int = 0,
    num_workers: int = 1,
    augment: bool = True,
) -> Iterator[tuple[np.ndarray, list[int]]]:
    rng = np.random.RandomState((cfg.seed + epoch) * 9973 + rank * 131 + worker)
    shards = expand_shards(cfg.shards)
    stream = shard_sample_stream(
        shards, epoch=epoch, seed=cfg.seed,
        shuffle_buffer=cfg.shuffle_buffer,
        rank=rank, world=world, worker=worker, num_workers=num_workers,
        resampled=cfg.resampled,
    )
    for sample in stream:
        if not has_image_and_caption(sample):
            continue
        caption = parse_caption(sample, cfg.dataset_name)
        if not caption:
            continue
        try:
            img_bytes = next(sample[e] for e in IMAGE_EXTS if e in sample)
            img = preprocess(
                decode_image(img_bytes), cfg.image_size,
                rng=rng if augment else None, hflip=augment,
            )
        except Exception:  # noqa: BLE001 — log_and_continue semantics
            continue
        # bos + body + eos, truncation reserving both specials (the
        # reference tokenizer has add_bos_token = add_eos_token = True)
        ids = train_encode(tokenizer, caption_text(caption), cfg.max_text_len)
        yield img, ids


def batches(
    cfg: PretrainConfig,
    tokenizer,
    epoch: int = 0,
    **stream_kwargs,
) -> Iterator[PretrainBatch]:
    pad = tokenizer.info.pad_id
    t = cfg.max_text_len
    if cfg.num_samples is not None and cfg.num_samples <= 0:
        return  # zero-budget shard (worker split remainder)
    buf_imgs, buf_ids = [], []
    count = 0
    for img, ids in sample_stream(cfg, tokenizer, epoch, **stream_kwargs):
        buf_imgs.append(img)
        buf_ids.append(ids)
        count += 1
        if len(buf_imgs) == cfg.batch_size:
            yield _collate(buf_imgs, buf_ids, t, pad, cfg.loss_multiplier)
            buf_imgs, buf_ids = [], []
        if cfg.num_samples is not None and count >= cfg.num_samples:
            break
    # drop_last semantics (WebLoader partial batches are dropped)


def _collate(imgs, idss, t, pad, loss_weight=1.0) -> PretrainBatch:
    b = len(imgs)
    input_ids = np.full((b, t), pad, np.int32)
    valid = np.zeros((b, t), np.int32)
    for i, ids in enumerate(idss):
        n = min(len(ids), t)
        input_ids[i, :n] = ids[:n]
        valid[i, :n] = 1
    labels = np.where(valid == 1, input_ids, IGNORE_INDEX).astype(np.int32)
    return PretrainBatch(
        input_ids=input_ids, attn_valid=valid, labels=labels,
        images=np.stack(imgs).astype(np.float32), loss_weight=loss_weight,
    )


class Prefetcher:
    """Background-thread batch prefetch (the host-side analogue of
    DataLoader workers + pin_memory)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self.exc: Exception | None = None
        self.thread.start()

    def _run(self, it):
        try:
            for item in it:
                self.q.put(item)
        except Exception as e:  # noqa: BLE001
            self.exc = e
        finally:
            self.q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._SENTINEL:
            if self.exc:
                raise self.exc
            raise StopIteration
        return item
