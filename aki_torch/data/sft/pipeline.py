"""SFT sample pipeline: records -> rendered/tokenized samples -> batches
(counterpart of ``aki_tpu/data/sft/pipeline.py``: byte-equal batches).

Reference semantics:

- prompt masking: everything up to and *including* ``<|assistant|>`` gets
  label ``-100``; all labels ignored if no assistant token survives
  truncation (``base.py:65-95``);
- truncation/padding to ``max_length + 1`` right-padded
  (``loader_utils.py:80-82``);
- image-less samples carry a zero image (``loader_utils.py:114-119``);
- image augmentation RandomResizedCrop(0.5..1.0) + flip (``base.py:110-114``);
- error policy: skip to next record on any processing failure
  (``base.py:128-147``);
- weighted mixture over datasets with optional round-robin first-k
  (``multidata_wrapper.py:8-82``), length = sum(len)/num_ranks;
- per-(rank, worker) seeding (``loader_utils.py:124-143``).
"""

from __future__ import annotations

import dataclasses
import logging
import random as _random
from typing import Iterator

import numpy as np

from ..images import decode_image, preprocess, zero_image
from .parsers import PARSERS, TEMPLATE_NAME_BY_TASK, optionize
from .templatizer import Templatizer
from .templates import IGNORE_INDEX

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SFTSample:
    input_ids: list[int]
    labels: list[int]
    image: np.ndarray | None


@dataclasses.dataclass
class SFTBatch:
    input_ids: np.ndarray
    attn_valid: np.ndarray
    labels: np.ndarray
    images: np.ndarray


class SFTDataset:
    """One parsed dataset + its templatizer; renders samples on demand."""

    def __init__(self, class_name: str, data_cfg: dict, tokenizer,
                 max_length: int = 512, image_size: int = 384,
                 template_name: str = "default",
                 rng: _random.Random | None = None,
                 augment: bool = True):
        self.records = PARSERS[class_name](**data_cfg)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.rng = rng or _random.Random(0)
        self.np_rng = np.random.RandomState(self.rng.randrange(2 ** 31))
        self.augment = augment
        task_type = self.records[0]["task_type"] if self.records else ""
        tname = TEMPLATE_NAME_BY_TASK.get(task_type)
        self.templatizer = (
            Templatizer.from_names(template_name, tname, rng=self.rng)
            if tname else None
        )

    def __len__(self):
        return len(self.records)

    def clone_for_worker(self, rng: _random.Random) -> "SFTDataset":
        """Shallow copy sharing the parsed records but with worker-private
        RNG state (thread-safe multi-worker loading; loader.py)."""
        import copy

        c = copy.copy(self)
        c.rng = rng
        c.np_rng = np.random.RandomState(rng.randrange(2 ** 31))
        if c.templatizer is not None:
            c.templatizer = copy.copy(c.templatizer)
            c.templatizer.rng = rng
        return c

    def render_text(self, record: dict) -> str:
        if "text" in record:
            return record["text"]
        examples = []
        for ex in record["examples"]:
            ex = dict(ex)
            if ex.pop("_needs", None) == "optionize":
                option, answer = optionize(
                    ex.pop("options"), ex.pop("answer_index"), rng=self.rng
                )
                ex["option"] = option
                ex["answer"] = answer
            examples.append(ex)
        if "image" in record:
            return self.templatizer(examples)
        return self.templatizer(examples, image_prompt=None)

    def encode(self, text: str) -> tuple[list[int], list[int]]:
        """Tokenize + prompt-mask labels (base.py:65-95); additionally mask
        the framework special tokens anywhere in the target
        (SupervisedPrediction, losses.py:136-140)."""
        from ..tokenizer import train_encode

        ids = train_encode(self.tokenizer, text, self.max_length)
        asst = self.tokenizer.info.assistant_id
        try:
            split = ids.index(asst) + 1
        except ValueError:
            split = len(ids)
        special = {self.tokenizer.info.media_id,
                   self.tokenizer.info.end_of_chunk_id}
        labels = [IGNORE_INDEX] * split + [
            IGNORE_INDEX if t in special else t for t in ids[split:]
        ]
        return ids, labels

    def sample(self, index: int) -> SFTSample:
        record = self.records[index % len(self.records)]
        tries = 0
        while True:
            try:
                return self._process(record)
            except Exception as e:  # noqa: BLE001 — retry-next semantics
                log.warning("Error processing %r: %r", record.get("image"), e)
                tries += 1
                if tries > len(self.records):
                    raise
                index = 0 if index >= len(self.records) - 1 else index + 1
                record = self.records[index]

    def _process(self, record: dict) -> SFTSample:
        text = self.render_text(record)
        ids, labels = self.encode(text)
        image = None
        if record.get("image"):
            img = decode_image(open(record["image"], "rb").read())
            image = preprocess(
                img, self.image_size,
                rng=self.np_rng if self.augment else None,
                hflip=self.augment, random_resized_crop=self.augment,
            )
        return SFTSample(input_ids=ids, labels=labels, image=image)


class MultiDataset:
    """Weighted mixture (multidata_wrapper.py): per-item dataset choice by
    normalized weights, optional round-robin for the first n_datasets items
    of each batch."""

    def __init__(self, datasets: list[SFTDataset],
                 sampling_weights="uniform",
                 force_one_per_dataset: bool = False,
                 batch_per_device: int = 16,
                 num_ranks: int = 1,
                 seed: int = 0):
        assert datasets
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]
        self.len = sum(self.lengths) // num_ranks
        n = len(datasets)
        if sampling_weights == "uniform":
            w = np.full(n, 1.0 / n)
        elif sampling_weights == "length_ratio":
            w = np.array(self.lengths, float)
            w /= w.sum()
        else:
            w = np.array(sampling_weights, float)
            assert len(w) == n
            w /= w.sum()
        self.weights = w
        self.force_one = force_one_per_dataset
        self.batch_per_device = batch_per_device
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.len

    def __iter__(self) -> Iterator[SFTSample]:
        bidx = 0
        n = len(self.datasets)
        for _ in range(self.len):
            if self.force_one and bidx < n:
                di = bidx
            else:
                di = int(self.rng.choice(n, p=self.weights))
            ds = self.datasets[di]
            yield ds.sample(int(self.rng.randint(len(ds))))
            if self.force_one:
                bidx = (bidx + 1) % self.batch_per_device


def collate(samples: list[SFTSample], pad_id: int, max_length: int,
            image_size: int = 384) -> SFTBatch:
    """Pad/truncate to max_length+1; zero image for image-less samples
    (loader_utils.py:53-121)."""
    t = max_length + 1
    b = len(samples)
    input_ids = np.full((b, t), pad_id, np.int32)
    labels = np.full((b, t), IGNORE_INDEX, np.int32)
    valid = np.zeros((b, t), np.int32)
    images = np.zeros((b, image_size, image_size, 3), np.float32)
    for i, s in enumerate(samples):
        n = min(len(s.input_ids), t)
        input_ids[i, :n] = s.input_ids[:n]
        labels[i, :n] = s.labels[:n]
        valid[i, :n] = 1
        images[i] = s.image if s.image is not None else zero_image(image_size)
    return SFTBatch(input_ids=input_ids, attn_valid=valid, labels=labels,
                    images=images)


def batches(mixture: MultiDataset, batch_size: int, pad_id: int,
            max_length: int, image_size: int = 384,
            drop_last: bool = True) -> Iterator[SFTBatch]:
    buf: list[SFTSample] = []
    for sample in mixture:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate(buf, pad_id, max_length, image_size)
            buf = []
    if buf and not drop_last:
        yield collate(buf, pad_id, max_length, image_size)


def worker_seed(base_seed: int, rank: int, worker: int) -> int:
    """Lightning-style per-(rank, worker) seed (loader_utils.py:124-143)."""
    ss = np.random.SeedSequence([base_seed, rank, worker])
    return int(ss.generate_state(1)[0])
