"""Continuous-batching serving engine (counterpart of
``aki_tpu/infer/server.py``).

A fixed pool of KV-cache *slots* serves many requests at once:

- queued requests are admitted in batches: one prefill covers up to
  ``admit_batch`` newcomers (MMA mask, fixed shapes, dummy-padded) and
  writes their K/V straight into their slots (``engine.prefill`` with
  ``slot_state``/``slots``);
- every engine step decodes all active slots together, in chunks of
  ``decode_chunk`` steps with the tokens kept on the card: one host sync
  per chunk, read one chunk late so that the host's bookkeeping overlaps
  the next chunk's device work;
- finished slots (eos / budget) free at chunk boundaries and refill from
  the queue; a request whose budget is fully dispatched frees its slot at
  dispatch time;
- images are uploaded by background threads, from pinned host memory on a
  side stream; a request becomes admissible once its pixels are on the
  card. uint8 pixels are normalised on the card (``x / 127.5 - 1``);
- tail compaction (``compact_tail``) moves the live slots to the front and
  decodes at a narrower ``live_width``, which the int8-KV decode kernel
  reads as a prefix of the cache's rows.

The device work is three calls — the admission prefill, the decode chunk
and the compaction's row moves — plus the split-path insert kept as the
admission's oracle; the host loop is bookkeeping only. Every argument of
the JAX constructor keeps its meaning. With ``tp_mesh`` (tensor-parallel
serving, one engine per rank of the mesh's ``tensor`` axis, all fed the
same requests in the same order) the decoder holds this rank's heads
(:mod:`aki_torch.parallel.tensor`), the KV cache, bf16 or int8, holds
them on its head dim, and uploads run in ``submit`` so that every rank
admits the same requests at the same step.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..models.aki import AKIModel
from ..models.common import BF16, Policy, resolve_device
from ..models.phi3 import KVCache, KVCacheQ, slot_rows
from .engine import GenState, decode_step, prefill, use_tensor_parallel
from .sampling import SamplingConfig, sample

_log = logging.getLogger(__name__)
LOG_ENTRIES = 1 << 16


@dataclasses.dataclass
class Request:
    input_ids: list[int]
    image: np.ndarray              # (H, W, C) preprocessed (or uint8 pixels)
    max_new_tokens: int = 128
    eos_id: int | None = None
    _result: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    # the pixels on the card, set by the uploader before the request can be
    # admitted
    _image_dev: torch.Tensor | None = None
    # tokens live on the request, not the slot: a slot can be reassigned
    # while this request's last chunk is still being read
    _tokens: list = dataclasses.field(default_factory=list)
    _dispatched: int = 0           # decode steps dispatched so far

    def result(self, timeout=None) -> list[int]:
        return self._result.get(timeout=timeout)


class ServingEngine:
    def __init__(self, model: AKIModel, num_slots: int = 8, max_len: int = 1024,
                 prompt_bucket: int = 512, admit_batch: int = 4, decode_chunk: int = 8,
                 policy: Policy = BF16, sampling: SamplingConfig = SamplingConfig(),
                 kv_int8: bool = False, admit_policy: str = "greedy",
                 prompt_buckets: tuple[int, ...] | None = None,
                 image_uint8: bool = False, tp_mesh=None,
                 compact_tail: bool = False, attn_mode: str | None = None,
                 align_completions: bool = True, upload_chunk: int | None = None,
                 upload_threads: int = 2, upload_ramp: bool = True, device="cuda"):
        if admit_policy not in ("greedy", "batched"):
            raise ValueError(f"admit_policy {admit_policy!r}")
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"model is on {model.device}, the engine asked for {device}")
        use_tensor_parallel(model, tp_mesh)
        # every rank of a tensor-parallel engine must make the same
        # scheduling decisions: its uploads run in submit, in order
        self.tensor_parallel = model.lang_model.model.tp is not None
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.policy = policy
        self.sampling = sampling
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.admit_batch = max(1, min(admit_batch, num_slots))
        self.decode_chunk = max(1, decode_chunk)
        # prompt-length buckets (ascending): an admission runs its prefill at
        # the smallest bucket covering the batch's longest prompt
        self.prompt_buckets = tuple(sorted(prompt_buckets or (prompt_bucket,)))
        if self.prompt_buckets[-1] != prompt_bucket:
            raise ValueError("largest prompt_buckets entry must equal "
                             f"prompt_bucket ({prompt_bucket})")
        # "greedy": admit into every free slot at once; "batched": under a
        # backlog, hold admission until a full admit_batch can form
        self.admit_policy = admit_policy
        # completion-aligned admission: cohorts by chunks-to-completion, so
        # that a batch's slots free together
        self.align_completions = align_completions
        self.upload_chunk = admit_batch if upload_chunk is None else max(1, upload_chunk)
        self.upload_threads = max(1, upload_threads)
        # the first pop of each uploader thread in a burst moves half a chunk
        self.upload_ramp = upload_ramp
        self._ramp_pops = self.upload_threads if upload_ramp else 0
        self.kv_int8 = kv_int8
        self.image_uint8 = image_uint8
        self._host_dtype = np.uint8 if image_uint8 else np.float32
        self.attn_mode = attn_mode
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)

        self.state = self._make_empty_state(num_slots)
        # tail compaction: decode at a live prefix of the slot rows once the
        # occupancy falls to num_slots/2 (then /4); the buffers keep full size
        self._live = num_slots
        self._compact_widths = []
        if compact_tail:
            self._compact_widths = sorted({num_slots // 2, num_slots // 4} - {0})
        s = self.cfg.siglip.image_size
        self._zero_img = self._put(np.zeros((s, s, 3), self._host_dtype))
        # host bookkeeping
        self.slot_req: list[Request | None] = [None] * num_slots
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._ready: list[Request] = []    # drained from the queue (scheduler-local)
        self._head_id = None               # head-of-line request passed over once
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._upload_q: list[Request] = []
        self._upload_inflight = 0
        self._upload_cv = threading.Condition()
        self._upload_pool: list[threading.Thread] = []
        self._shutdown = False
        # chunks in flight: (host tokens, their copy's event, slot->request
        # snapshot at dispatch)
        self._pending: list = []
        self.decode_dispatches = 0
        # (kind, key, host time) of each device call: "decode" keys
        # (chunk_len, live_width), "prefill" keys (batch, bucket)
        self.dispatch_log: deque = deque(maxlen=LOG_ENTRIES)
        # host time of each request's completion
        self.completion_log: deque = deque(maxlen=LOG_ENTRIES)
        self._move_chunk = min(8, num_slots)

    # -- device state -----------------------------------------------------------
    def _put(self, x: np.ndarray) -> torch.Tensor:
        """A host array copied to the engine's device. On the card the copy
        runs from pinned memory, non-blocking on the upload stream, and this
        returns once it has landed; the result is marked as used on the
        engine's stream."""
        host = torch.from_numpy(np.ascontiguousarray(x))
        if self._upload_stream is None:
            return host.to(self.device, copy=True)
        with torch.cuda.stream(self._upload_stream):
            dev = host.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._upload_stream)
        done.synchronize()
        dev.record_stream(self._stream)
        return dev

    @torch.inference_mode()
    def _make_empty_state(self, width: int) -> GenState:
        """A zeroed GenState with ``width`` slot rows."""
        dev = self.device
        if self.kv_int8:
            cache = KVCacheQ.create(self.model.lang_model.model.cfg, width, self.max_len,
                                    device=dev)
        else:
            cache = KVCache.create(self.model.lang_model.model.cfg, width, self.max_len,
                                   dtype=self.policy.compute_dtype, device=dev)
        return GenState(
            cache=cache,
            kv_valid=torch.zeros((width, self.max_len), dtype=torch.int32, device=dev),
            lengths=torch.zeros((width,), dtype=torch.int64, device=dev),
            last_logits=torch.zeros((width, self.cfg.output_vocab), dtype=torch.float32,
                                    device=dev))

    def _state_rows(self, state: GenState) -> tuple[torch.Tensor, ...]:
        """The per-slot buffers of a state: cache buffers (layer-major) first,
        then kv_valid, lengths, last_logits (slot-major)."""
        cache = state.cache
        bufs = cache.buffers() if isinstance(cache, KVCacheQ) else (cache.k, cache.v)
        return bufs + (state.kv_valid, state.lengths, state.last_logits)

    @torch.inference_mode()
    def _move(self, src: list[int], dst: list[int]) -> None:
        """In-place slot-row moves rows[dst] = rows[src] (the gathered source
        rows are the only transient)."""
        s = torch.tensor(src, device=self.device)
        d = torch.tensor(dst, device=self.device)
        rows = self._state_rows(self.state)
        n_cache = len(rows) - 3
        for i, buf in enumerate(rows):
            if i < n_cache:
                buf[:, d] = buf[:, s]
            else:
                buf[d] = buf[s]

    def _compact_to(self, width: int, occupied: list[int]) -> None:
        """Move the occupied slot rows to the front (ascending src to
        ascending dst with src >= dst, so in-order chunked moves never
        overwrite a source not yet moved) and shrink the decode's live
        prefix to ``width``. Buffers keep their size."""
        moves = [(s, d) for d, s in enumerate(occupied) if s != d]
        for i in range(0, len(moves), self._move_chunk):
            chunk = moves[i:i + self._move_chunk]
            self._move([m[0] for m in chunk], [m[1] for m in chunk])
        reqs = [self.slot_req[i] for i in occupied]
        self.slot_req = reqs + [None] * (self.num_slots - len(reqs))
        self._live = width

    def _images(self, img: torch.Tensor) -> torch.Tensor:
        if self.image_uint8:
            # on-card normalisation of uint8 RGB: (x/255 - 0.5)/0.5 == x/127.5 - 1
            return img.float() / 127.5 - 1.0
        return img

    def _prefill_batch(self, ids: np.ndarray, imgs: torch.Tensor, valid: np.ndarray,
                       slots: np.ndarray) -> None:
        """Admission: the prefill writes row r's K/V into slot ``slots[r]`` of
        the slot cache and its bookkeeping into the same row of the state (a
        slot of ``num_slots`` drops a padded row)."""
        self.state = prefill(self.model, ids, self._images(imgs), valid, self.max_len,
                             policy=self.policy, attn_mode=self.attn_mode,
                             device=self.device, slot_state=self.state, slots=slots)

    @torch.inference_mode()
    def _insert(self, new: GenState, slots) -> None:
        """The split admission path, kept as the fused path's oracle (tests):
        scatter the rows of a batch-sized prefill state into their slots."""
        src, dst = slot_rows(slots, self.num_slots, self.device)
        rows, new_rows = self._state_rows(self.state), self._state_rows(new)
        n_cache = len(rows) - 3
        for i, (buf, nb) in enumerate(zip(rows, new_rows)):
            if i < n_cache:
                buf[:, dst] = nb[:, src]
            else:
                buf[dst] = nb[src].to(buf.dtype)

    @torch.inference_mode()
    def _decode_chunk(self, active: list[bool], n: int, live: int | None) -> torch.Tensor:
        """``n`` decode steps of every slot, the tokens kept on the card:
        (n, num_slots). Inactive slots decode pad tokens; only their
        bookkeeping (kv_valid, lengths, last logits) is frozen — the cache
        may take a garbage row behind the frozen kv_valid, which admission
        overwrites."""
        act = torch.tensor(active, device=self.device)
        pad = self.cfg.pad_token_id
        st, toks = self.state, []
        for _ in range(n):
            tok = torch.where(act, sample(st.last_logits, self.sampling, self._generator), pad)
            new = decode_step(self.model, st, tok, policy=self.policy, device=self.device,
                              live_width=live)

            def keep(a, b):
                return torch.where(act.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

            st = GenState(cache=new.cache, kv_valid=keep(new.kv_valid, st.kv_valid),
                          lengths=keep(new.lengths, st.lengths),
                          last_logits=keep(new.last_logits, st.last_logits))
            toks.append(tok)
        self.state = st
        return torch.stack(toks)

    def _fetch_async(self, toks: torch.Tensor):
        """Start the copy of a chunk's tokens to the host: (host tensor,
        event to wait on, or None when already there)."""
        if self._stream is None:
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return host, ev

    # -- host API ---------------------------------------------------------------
    def warmup(self) -> None:
        """Run every device call once ahead of serving (cuBLAS and kernel
        set-up, the nvcc build of the kernels, the allocator's pools): one
        prefill per (admission size x prompt bucket), one chunk-sized
        upload, the decode chunk, and the compaction moves and narrow
        decodes. Admits nothing."""
        s = self.cfg.siglip.image_size
        for t in self.prompt_buckets:
            # non-max buckets serve only full admissions; the max bucket every
            # power of two
            b = 1 if t == self.prompt_bucket else self.admit_batch
            while True:
                ids = np.full((b, t), self.cfg.pad_token_id, np.int32)
                valid = np.zeros((b, t), np.int32)
                valid[:, 0] = 1
                imgs = torch.stack([self._zero_img] * b)
                self._prefill_batch(ids, imgs, valid, np.full((b,), self.num_slots))
                self._sync()
                if b >= self.admit_batch:
                    break
                b = min(b * 2, self.admit_batch)
        self._put(np.zeros((self.upload_chunk, s, s, 3), self._host_dtype))
        idle = [False] * self.num_slots
        self._decode_chunk(idle, self.decode_chunk, None)
        self._sync()
        if self._compact_widths:
            self._move([0], [0])
            for w in sorted(self._compact_widths, reverse=True):
                self._decode_chunk(idle, self.decode_chunk, w)
                self._sync()

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _uploader_loop(self, idx: int = 0) -> None:
        while True:
            with self._upload_cv:
                # threads past upload_threads idle
                while (not self._shutdown
                       and (not self._upload_q or idx >= self.upload_threads)):
                    self._upload_cv.wait()
                if self._shutdown and not self._upload_q:
                    return
                n = self.upload_chunk
                if self._ramp_pops > 0:
                    self._ramp_pops -= 1
                    n = max(1, n // 2)
                batch = self._upload_q[:n]
                del self._upload_q[:n]
                # the popped batch counts as pending until its rows reach the
                # admission queue, so that a drain never ends mid-transfer
                self._upload_inflight += len(batch)
            try:
                rows = np.stack([np.asarray(r.image, self._host_dtype) for r in batch])
                chunk = self._put(rows)            # one transfer per group
                for i, r in enumerate(batch):
                    r._image_dev = chunk[i]
                    self.queue.put(r)
            except Exception:
                # fail open: the requests stay servable through the host-row
                # path of _admit_many (a dead uploader must not hang a drain)
                _log.exception("image upload failed; admitting from host rows")
                for r in batch:
                    self.queue.put(r)
            finally:
                with self._upload_cv:
                    self._upload_inflight -= len(batch)

    def _pending_uploads(self) -> int:
        with self._upload_cv:
            return len(self._upload_q) + self._upload_inflight

    def close(self, timeout: float = 10.0) -> None:
        """Stop the uploader threads (after the uploads already queued)."""
        with self._upload_cv:
            self._shutdown = True
            self._upload_cv.notify_all()
        for t in self._upload_pool:
            t.join(timeout)

    def submit(self, input_ids: list[int], image, max_new_tokens: int = 128,
               eos_id: int | None = None) -> Request:
        req = Request(input_ids=list(input_ids), image=image,
                      max_new_tokens=max_new_tokens, eos_id=eos_id)
        if isinstance(image, torch.Tensor) and image.device == self.device:
            # pixels already on the card: admissible at once
            req._image_dev = image
            self.queue.put(req)
            return req
        if self.tensor_parallel:
            # no uploader threads: what is admissible then depends on the
            # order of submit alone, the same on every rank
            req._image_dev = self._put(np.asarray(image, self._host_dtype)[None])[0]
            self.queue.put(req)
            return req
        # host pixels ride the uploader threads; the request becomes
        # admissible once they are on the card
        with self._upload_cv:
            while len(self._upload_pool) < self.upload_threads:
                t = threading.Thread(target=self._uploader_loop,
                                     args=(len(self._upload_pool),), daemon=True)
                self._upload_pool.append(t)
                t.start()
            if self.upload_ramp and not self._upload_q and self._upload_inflight == 0:
                self._ramp_pops = self.upload_threads   # a fresh burst
            self._upload_q.append(req)
            self._upload_cv.notify_all()
        return req

    def _admit_many(self, slots: list[int], reqs: list[Request]) -> None:
        """One batched prefill for up to admit_batch requests, sized to the
        smallest power of two covering them, at the smallest prompt bucket
        covering the longest (partial admissions take the largest bucket)."""
        b = 1
        while b < len(reqs):
            b *= 2
        b = min(b, self.admit_batch)
        if b < self.admit_batch and len(self.prompt_buckets) > 1:
            t = self.prompt_bucket
        else:
            need = max(min(len(r.input_ids), self.prompt_bucket) for r in reqs)
            t = next(bk for bk in self.prompt_buckets if bk >= need)
        ids = np.full((b, t), self.cfg.pad_token_id, np.int32)
        valid = np.zeros((b, t), np.int32)
        slot_idx = np.full((b,), self.num_slots, np.int64)   # out of range: dropped
        img_rows = []
        for r, (slot, req) in enumerate(zip(slots, reqs)):
            n = min(len(req.input_ids), t)
            ids[r, :n] = req.input_ids[:n]
            valid[r, :n] = 1
            img_rows.append(req._image_dev if req._image_dev is not None
                            else np.asarray(req.image, self._host_dtype))
            slot_idx[r] = slot
        # dummy rows still need one valid token
        for r in range(len(reqs), b):
            valid[r, 0] = 1
            img_rows.append(self._zero_img)
        if any(isinstance(im, np.ndarray) for im in img_rows):
            # host rows (a failed upload): one batched transfer
            host = np.stack([im if isinstance(im, np.ndarray) else im.cpu().numpy()
                             for im in img_rows])
            imgs = self._put(host.astype(self._host_dtype))
        else:
            imgs = torch.stack(img_rows)
        self.dispatch_log.append(("prefill", (b, t), time.perf_counter()))
        self._prefill_batch(ids, imgs, valid, slot_idx)
        for slot, req in zip(slots, reqs):
            self.slot_req[slot] = req
            req._tokens = []
            req._dispatched = 0

    def _admit_free(self) -> None:
        """Fill free slots from the queue (subject to admit_policy).

        "batched" holds a partial admission whenever waiting lets a fuller
        batch form: busy slots will free, or the uploader has requests in
        flight. With ``align_completions`` or several prompt buckets, the
        whole backlog is sorted by (chunks to completion, prompt length)
        and the best-matched ``admit_batch`` taken; the head-of-line
        request is forced in after being passed over once."""
        while True:
            while True:
                try:
                    self._ready.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            if self._ready and self._live < self.num_slots:
                # back to the full slot pool: the buffers never shrank
                self._live = self.num_slots
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            ready = len(self._ready)
            if not free or ready == 0:
                return
            if self.admit_policy == "batched":
                incoming = ready + self._pending_uploads()
                if min(len(free), ready) < min(self.admit_batch, incoming):
                    return   # a fuller batch is forming
            n_take = min(len(free), self.admit_batch, ready)
            if self.align_completions or len(self.prompt_buckets) > 1:
                window = list(range(ready))

                def _key(i):
                    r = self._ready[i]
                    chunks = -(-r.max_new_tokens // self.decode_chunk)
                    return (chunks if self.align_completions else 0, len(r.input_ids))

                window.sort(key=_key)
                picked = window[:n_take]
                if 0 not in picked and id(self._ready[0]) == self._head_id:
                    picked[-1] = 0
                self._head_id = id(self._ready[0]) if 0 not in picked else None
                picked = sorted(picked)   # FIFO order inside the batch
            else:
                picked = list(range(n_take))
            take_reqs = [self._ready[i] for i in picked]
            for i in reversed(picked):
                del self._ready[i]
            if not take_reqs:
                return
            self._admit_many(free[:len(take_reqs)], take_reqs)

    def _process_chunk(self, toks: np.ndarray, snapshot: list) -> None:
        """Account one fetched chunk against the slot->request bindings of
        its dispatch (the slot may already hold a newer request)."""
        for slot in range(len(snapshot)):
            req = snapshot[slot]
            if req is None or req._result.qsize():
                continue   # empty slot, or request already completed
            for k in range(toks.shape[0]):
                if len(req._tokens) >= req.max_new_tokens:
                    break
                t = int(toks[k, slot])
                done = req.eos_id is not None and t == req.eos_id
                if not done:
                    req._tokens.append(t)
                if done or len(req._tokens) >= req.max_new_tokens:
                    self.completion_log.append(time.perf_counter())
                    req._result.put(req._tokens)
                    # free by identity: compaction may have moved the request
                    for i, live in enumerate(self.slot_req):
                        if live is req:
                            self.slot_req[i] = None
                            break
                    break

    def _flush_pending(self) -> None:
        while self._pending:
            host, ev, snapshot = self._pending.pop(0)
            if ev is not None:
                ev.synchronize()       # the one host sync of a chunk
            self._process_chunk(host.numpy(), snapshot)

    def step(self) -> int:
        """One scheduler tick: admit into free slots, compact the drain tail,
        dispatch one decode chunk of ``decode_chunk`` steps (a request whose
        budget is now fully dispatched and that has no eos frees its slot at
        once), then read the previous chunk's tokens. Returns the number of
        active slots at dispatch."""
        if not any(r is not None for r in self.slot_req):
            self._flush_pending()   # idle: account stragglers so their slots free
        self._admit_free()

        if (self._compact_widths and self.queue.empty() and not self._ready
                and self._pending_uploads() == 0):
            # pure drain tail: shrink the decode's live prefix to the smallest
            # compaction level covering the occupied slots
            occupied = [i for i, r in enumerate(self.slot_req) if r is not None]
            if occupied:
                target = next((w for w in self._compact_widths
                               if len(occupied) <= w and w < self._live), None)
                if target is not None:
                    self._compact_to(target, occupied)

        remaining = [(req.max_new_tokens - req._dispatched) if req is not None else 0
                     for req in self.slot_req]
        active = [r > 0 for r in remaining]
        n_active = sum(active)
        if n_active:
            n = self.decode_chunk
            live = self._live
            if self._compact_widths:
                # decode at the smallest compaction width covering the highest
                # occupied slot (slots fill in ascending order)
                hi = 1 + max(i for i, r in enumerate(self.slot_req) if r is not None)
                live = next((w for w in self._compact_widths if w >= hi), self.num_slots)
            self.decode_dispatches += 1
            self.dispatch_log.append(("decode", (n, live), time.perf_counter()))
            toks = self._decode_chunk(active, n, None if live >= self.num_slots else live)
            host, ev = self._fetch_async(toks)
            snapshot = list(self.slot_req)
            for slot, req in enumerate(self.slot_req):
                if req is not None and active[slot]:
                    req._dispatched += n
                    if req._dispatched >= req.max_new_tokens and req.eos_id is None:
                        # deterministic completion: free the slot now; the
                        # accounting still runs against the snapshot
                        self.slot_req[slot] = None
            self._flush_pending()
            self._pending.append((host, ev, snapshot))
        else:
            self._flush_pending()
        return n_active

    def has_work(self) -> bool:
        # uploads first: an uploader queues its requests before it stops
        # counting them, so a request is always seen in one place or the other
        return (self._pending_uploads() > 0 or not self.queue.empty()
                or bool(self._ready) or bool(self._pending)
                or any(r is not None for r in self.slot_req))

    def run_until_drained(self, max_steps: int = 100000, idle_timeout: float = 120.0) -> int:
        """Scheduler ticks until no work remains. Idle ticks (admission held
        for a forming batch, or the uploader mid-transfer) sleep and do not
        count against ``max_steps``; ``idle_timeout`` seconds of consecutive
        idleness raise."""
        steps = 0
        idle_since = None
        while self.has_work() and steps < max_steps:
            n = self.step()
            if n == 0 and self.has_work():
                if idle_since is None:
                    idle_since = time.perf_counter()
                elif time.perf_counter() - idle_since > idle_timeout:
                    raise RuntimeError(
                        f"serving drain stalled: no dispatchable work for "
                        f"{idle_timeout:.0f}s (queue {self.queue.qsize()}, ready "
                        f"{len(self._ready)}, uploads in flight {self._pending_uploads()})")
                time.sleep(0.002)
            else:
                idle_since = None
                steps += 1
        return steps
