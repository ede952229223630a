"""Webdataset-compatible tar shard streaming, no webdataset (counterpart
of ``aki_tpu/data/tar_reader.py``: the same samples in the same order).

Reproduces the semantics of the reference pipeline stages
(``train/data.py:339-438``, ``train/data_utils.py``):

- brace-expanded shard lists (``{00000..00099}.tar``);
- deterministic epoch-seeded shard shuffle (``detshuffle2``,
  ``data_utils.py:160-190``);
- with-replacement shard resampling (``ResampledShards2``);
- shard split across (host, worker) (``wds.split_by_node/worker``);
- tar -> samples grouped by key prefix, duplicate-key tolerant
  (``group_by_keys_nothrow``, ``data_utils.py:103-143``);
- swallow-and-continue error handling (``log_and_continue``,
  ``data_utils.py:97-100``);
- bounded shuffle buffer (``wds.shuffle(5000)``).

Everything is a plain-Python iterator pipeline, run on the loader's worker
threads (:mod:`aki_torch.data.loader`).
"""

from __future__ import annotations

import logging
import random
import re
import tarfile
from typing import Iterable, Iterator

log = logging.getLogger(__name__)


def brace_expand(pattern: str) -> list[str]:
    """Expand a single {AAAA..BBBB} range (webdataset shard syntax)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [
        pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        for i in range(int(lo), int(hi) + 1)
    ]


def expand_shards(patterns: str | Iterable[str]) -> list[str]:
    if isinstance(patterns, str):
        patterns = [patterns]
    out: list[str] = []
    for p in patterns:
        out.extend(brace_expand(p))
    return out


def det_shuffle(items: list, epoch: int, seed: int = 0) -> list:
    """Deterministic epoch-seeded shuffle (detshuffle2 semantics)."""
    rng = random.Random(seed + epoch)
    items = list(items)
    rng.shuffle(items)
    return items


def resample_shards(shards: list[str], epoch: int, n: int,
                    seed: int = 0) -> list[str]:
    """With-replacement sampling (ResampledShards2 semantics)."""
    rng = random.Random((seed, epoch).__hash__())
    return [rng.choice(shards) for _ in range(n)]


def split_by_rank_worker(
    shards: list[str], rank: int = 0, world: int = 1,
    worker: int = 0, num_workers: int = 1,
) -> list[str]:
    """Node split then worker split (wds.split_by_node/split_by_worker)."""
    shards = shards[rank::world] if world > 1 else shards
    return shards[worker::num_workers] if num_workers > 1 else shards


def log_and_continue(exn: Exception) -> bool:
    """Reference error policy: warn and keep going (data_utils.py:97-100)."""
    log.warning("Handling dataset error (%r). Ignoring.", exn)
    return True


def iter_tar_samples(
    path: str, handler=log_and_continue, prefer_native: bool = True,
) -> Iterator[dict[str, bytes]]:
    """Yield dicts {"__key__", "<ext>": bytes, ...} grouped by key prefix.

    Uses the native C++ indexer (:mod:`aki_torch.data.native_tar`) when
    it builds (pread-based, GIL-free), else streaming ``tarfile``.
    Duplicate extensions within a key start a new sample instead of raising
    (group_by_keys_nothrow semantics).
    """
    if path.startswith("pipe:"):
        # reference streams shards through a shell command, e.g.
        # "pipe:aws s3 cp s3://bucket/shard.tar -" (train.py:224-229)
        import subprocess
        import tarfile as _tarfile

        proc = subprocess.Popen(
            path[len("pipe:"):], shell=True, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        try:
            tf = _tarfile.open(fileobj=proc.stdout, mode="r|*")
            yield from _group_members(tf, handler)
        except Exception as e:  # noqa: BLE001
            if not handler(e):
                raise
        finally:
            proc.stdout.close()
            proc.wait()
        return
    if prefer_native:
        from .native_tar import iter_samples, native_available

        if native_available():
            try:
                yield from iter_samples(path)
                return
            except Exception as e:  # noqa: BLE001 — reference swallows
                if not handler(e):
                    raise
                return
    try:
        tf = tarfile.open(path, mode="r|*")
    except Exception as e:  # noqa: BLE001 — reference swallows everything
        if handler(e):
            return
        raise
    yield from _group_members(tf, handler)


def _group_members(tf, handler) -> Iterator[dict[str, bytes]]:
    """Group tar members into key-prefixed samples (dup-tolerant)."""
    sample: dict = {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if "/" in name:
                name = name.rsplit("/", 1)[1]
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            ext = ext.lower()
            try:
                data = tf.extractfile(member).read()
            except Exception as e:  # noqa: BLE001
                if handler(e):
                    continue
                raise
            if sample and (sample.get("__key__") != key or ext in sample):
                yield sample
                sample = {}
            sample.setdefault("__key__", key)
            sample[ext] = data
        if sample:
            yield sample
    except Exception as e:  # noqa: BLE001 — corrupt tar tail etc.
        if sample:
            yield sample
        if not handler(e):
            raise
    finally:
        tf.close()


def shuffled(iterator: Iterator, bufsize: int, rng: random.Random) -> Iterator:
    """Bounded reservoir shuffle (wds.shuffle semantics)."""
    buf: list = []
    for item in iterator:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        idx = rng.randrange(len(buf))
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def shard_sample_stream(
    shards: list[str],
    epoch: int = 0,
    seed: int = 0,
    shuffle_shards: bool = True,
    shuffle_buffer: int = 5000,
    rank: int = 0,
    world: int = 1,
    worker: int = 0,
    num_workers: int = 1,
    resampled: bool = False,
    handler=log_and_continue,
) -> Iterator[dict]:
    """The full shard -> sample pipeline with reference ordering semantics."""
    if resampled:
        shards = resample_shards(shards, epoch, len(shards), seed)
    elif shuffle_shards:
        shards = det_shuffle(shards, epoch, seed)
    shards = split_by_rank_worker(shards, rank, world, worker, num_workers)

    def raw():
        for s in shards:
            yield from iter_tar_samples(s, handler)

    if shuffle_buffer > 1:
        rng = random.Random((seed, epoch, rank, worker).__hash__())
        yield from shuffled(raw(), shuffle_buffer, rng)
    else:
        yield from raw()


def dataset_size(shards: str | Iterable[str]) -> int | None:
    """Total sample count from shard metadata (reference ``get_dataset_size``,
    ``data_utils.py:63-96``): a ``sizes.json`` mapping shard basename ->
    count next to the shards, else a ``__len__`` file, else None."""
    import json
    from pathlib import Path

    paths = [p for p in expand_shards(shards) if not p.startswith("pipe:")]
    if not paths:
        return None
    d = Path(paths[0]).parent
    sizes_file = d / "sizes.json"
    if sizes_file.exists():
        sizes = json.loads(sizes_file.read_text())
        return sum(int(sizes[Path(p).name]) for p in paths
                   if Path(p).name in sizes)
    len_file = d / "__len__"
    if len_file.exists():
        return int(len_file.read_text().strip())
    return None
