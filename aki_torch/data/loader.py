"""Parallel host input pipeline: multi-worker batch loading on threads
(counterpart of ``aki_tpu/data/loader.py``: the same batches in the same
order).

The reference runs 4+ DataLoader worker *processes* per GPU
(``train/data.py:425-438``, ``configs/sft.yaml`` workers: 4). Here the
workers are THREADS: the hot loops release the GIL (the native tar indexer
reads with ``pread`` outside it, ``native/tar_index.cpp``; PIL's JPEG decode
releases it, and numpy resize/normalize mostly does too), so N worker
threads decode in parallel without process spawns or tensor pickling.

Semantics match torch's multi-worker DataLoader:

- worker ``w`` of ``n`` sees its own shard split (``split_by_rank_worker``)
  or its own seeded sample stream;
- batches are collected round-robin across workers (torch's worker
  rotation), skipping exhausted workers;
- each worker prefetches ``depth`` batches ahead (prefetch_factor);
- a worker exception propagates to the consumer at its queue position.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

_SENTINEL = object()


class WorkerPool:
    """Run ``make_iter(worker, num_workers)`` on N threads; yield batches
    round-robin across workers."""

    def __init__(self, make_iter: Callable[[int, int], Iterator],
                 num_workers: int, depth: int = 4):
        assert num_workers >= 1
        self.num_workers = num_workers
        self.queues: list[queue.Queue] = [
            queue.Queue(maxsize=depth) for _ in range(num_workers)
        ]
        self.threads = []
        for w in range(num_workers):
            t = threading.Thread(
                target=self._run, args=(make_iter, w), daemon=True
            )
            t.start()
            self.threads.append(t)

    def _run(self, make_iter, w: int):
        q = self.queues[w]
        try:
            for item in make_iter(w, self.num_workers):
                q.put(item)
        except Exception as e:  # noqa: BLE001 — surface at the consumer
            q.put(("__error__", e))
        finally:
            q.put(_SENTINEL)

    def __iter__(self):
        live = list(range(self.num_workers))
        while live:
            for w in list(live):
                item = self.queues[w].get()
                if item is _SENTINEL:
                    live.remove(w)
                    continue
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__error__":
                    raise item[1]
                yield item


def make_loader(make_iter: Callable[[int, int], Iterator],
                num_workers: int = 1, depth: int = 4) -> Iterator:
    """WorkerPool when num_workers > 1, single prefetch thread otherwise."""
    if num_workers <= 1:
        from .pretrain import Prefetcher

        return Prefetcher(make_iter(0, 1), depth=depth)
    return iter(WorkerPool(make_iter, num_workers, depth=depth))
