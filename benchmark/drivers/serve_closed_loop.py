"""Closed-loop serving: a fixed number of clients, each sending its next
question as soon as its last answer arrives, against the port's
``ServingEngine``.

Set-up builds the model from the seed, quantizes it and sets the server's
cache and image types as the configuration's ``serving`` block states (the
reference follows the same block), warms the server (``warmup()``: every admission size at the bucket,
one upload, the decode chunk), makes the pool of requests, and fills every
slot once. The window then runs the scheduler (``step()``) on this thread;
after each tick the clients look at their requests: the first token is
known at the first tick after which ``Request._tokens`` is non-empty, the
answer at ``result()``. Once the window closes no client sends again, and
the requests sent in it are served to the end (at most ``drain_s``). Then
a sample of the answered requests, the longest among them, is held to the
plain reference.

The mix (the traffic file): prompts of ``prompt_tokens`` text tokens with
``<image>`` at ``media_at`` and ``<|assistant|>`` at ``assistant_at``, one
uint8 image, and a budget of ``budget`` new tokens, greedy. Sizes come from
a table drawn once from ``sizes_seed``, the same for every seed; the
run's seed orders the table and draws the tokens and pixels.
"""

from __future__ import annotations

import gc
import math
import queue
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import program
from benchmark.reference import aki_plain as ref
from benchmark.reference.weights import make_weights, sub_seed

# a tick that dispatched nothing (admission held for a forming batch, the
# uploads in flight) waits this long before the next, as the server's own
# run_until_drained does, so that the uploader threads get the interpreter
IDLE_TICK_S = 0.002


def size_table(tp: dict) -> list[tuple[int, int]]:
    """(text tokens, budget) of each request of the pool, from the mix's own
    seed."""
    rng = np.random.RandomState(tp["sizes_seed"])
    lo, hi = tp["prompt_tokens"]
    b_lo, b_hi = tp["budget"]
    return [(int(rng.randint(lo, hi + 1)), int(rng.randint(b_lo, b_hi + 1)))
            for _ in range(tp["pool"])]


def make_pool(tp: dict, model: dict, seed: int) -> list[tuple]:
    """The run's requests: (ids, uint8 pixels, budget), the table's sizes in
    the order the seed gives, tokens and pixels from the seed."""
    table = size_table(tp)
    order = np.random.RandomState(sub_seed(seed, 3) % 2**32).permutation(len(table))
    s = model["siglip"]["image_size"]
    vocab = model["initial_tokenizer_len"]
    pool = []
    for k, i in enumerate(order):
        m, budget = table[i]
        rng = np.random.default_rng(sub_seed(seed, 4, k))
        ids = rng.integers(5, vocab - 1, size=m)
        ids[tp["media_at"]] = model["media_token_id"]
        ids[tp["assistant_at"]] = model["assistant_token_id"]
        px = rng.integers(0, 256, size=(s, s, 3), dtype=np.uint8)
        pool.append((ids.tolist(), px, budget))
    return pool


class Client:
    """One client's request in flight and its times (host clock)."""

    def __init__(self, req, prompt, t_submit, in_window):
        self.req, self.prompt, self.t_submit, self.in_window = req, prompt, t_submit, in_window
        self.t_first = self.t_done = None
        self.tokens = None


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank (a missing value counts as
    infinite)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float | None = None,
        control: str | None = None) -> dict:
    """One run of the cell; ``control`` serves with another quantization mode
    of the program (the check's control), held to the same reference."""
    from aki_torch.infer.server import ServingEngine
    from aki_torch.models.quant import quantize_params

    t_start = time.perf_counter() if t_start is None else t_start
    conf, tp = cell.config, cell.traffic
    model_cfg, serving = conf["model"], conf["serving"]
    if device.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(device)   # a later run in one process
    weights = make_weights(model_cfg, seed, torch.bfloat16, device)
    model = program.build_model(model_cfg, weights, torch.bfloat16, device)
    del weights
    model.requires_grad_(False)
    quantize_params(model, mode=control or serving["quant"], vision=serving["vision_quant"])
    eng = ServingEngine(model, device=device, kv_int8=serving["kv_int8"],
                        image_uint8=serving["image_uint8"], **tp["server"])
    try:
        rec, sample = _serve(eng, cell, seed, seconds, trace, device, t_start)
    finally:
        eng.close()
    # the program's state is freed before the reference runs
    del eng, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gap, where = served_gap(conf, seed, sample, device)
    checks = rec["checks"]
    checks["served_gap_std"] = {"value": gap, "limit": tp["check"]["served_gap_std"]}
    rec["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                         for c in checks.values())
    rec["gap_at"], rec["sample"] = where, sample
    return rec


def _serve(eng, cell, seed, seconds, trace, device, t_start) -> dict:
    conf, tp = cell.config, cell.traffic
    model_cfg = conf["model"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    eng.warmup()
    pool = make_pool(tp, model_cfg, seed)
    sent = [0]
    clients: list[Client | None] = []
    done: list[Client] = []

    def send(in_window: bool) -> Client:
        prompt = pool[sent[0] % len(pool)]
        sent[0] += 1
        ids, px, budget = prompt
        t = time.perf_counter()
        return Client(eng.submit(ids, px, max_new_tokens=budget), prompt, t, in_window)

    def poll(accept: bool, in_window: bool) -> None:
        now = time.perf_counter()
        for c, cl in enumerate(clients):
            if cl is None:
                continue
            if cl.t_first is None and cl.req._tokens:
                cl.t_first = now
            try:
                toks = cl.req.result(timeout=0)
            except queue.Empty:
                continue
            cl.t_done, cl.tokens = now, toks
            if cl.t_first is None:
                cl.t_first = now
            done.append(cl)
            clients[c] = send(in_window) if accept else None

    # every slot filled once before the window opens: each first request
    # admitted and decoding
    clients.extend(send(False) for _ in range(tp["clients"]))
    first = list(clients)
    deadline = time.perf_counter() + tp["drain_s"]
    while any(cl.req._dispatched == 0 for cl in first):
        eng.step()
        poll(True, False)
        if time.perf_counter() > deadline:
            raise RuntimeError("serving: the slots did not fill")
    sync()
    setup_s = time.perf_counter() - t_start

    ticks = []
    t_open = time.perf_counter()
    sl = harness.ProfiledSlice(trace, t_open, seconds, tp["trace_slice"], sync, cuda)
    while True:
        now = time.perf_counter()
        # a traced window runs on until its slice has been profiled
        if now >= t_open + seconds and sl.done:
            break
        sl.tick(now)
        a = time.perf_counter()
        n = eng.step()
        ticks.append((a, time.perf_counter(), n))
        poll(True, True)
        if n == 0:
            time.sleep(IDLE_TICK_S)
    t_close = time.perf_counter()
    window_s = t_close - t_open

    # no client sends again; what was sent in the window is served to the end
    deadline = t_close + tp["drain_s"]
    while any(c is not None for c in clients) and time.perf_counter() < deadline:
        if eng.step() == 0:
            time.sleep(IDLE_TICK_S)
        poll(False, False)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    sent_in = [c for c in done if c.in_window] + [c for c in clients
                                                   if c is not None and c.in_window]
    ttft = [(c.t_first - c.t_submit) * 1e3 if c.t_first is not None else math.inf
            for c in sent_in]
    finished = [c for c in done if t_open <= c.t_done <= t_close]
    unanswered = sum(1 for c in sent_in if c.t_done is None)
    short = sum(1 for c in done if len(c.tokens) != c.prompt[2])
    e2e = {"requests_per_s": len(finished) / window_s,
           "ttft_p95_ms": p95(ttft) if ttft else math.inf,
           "setup_s": setup_s}

    slice_prefills = [key for kind, key, t in eng.dispatch_log
                      if kind == "prefill" and sl.inside(t)]

    # the check: a sample of the answered requests, the longest among them
    check = tp["check"]
    rng = np.random.RandomState(sub_seed(seed, 5) % 2**32)
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), -i))
    rest = [i for i in range(len(done)) if i != longest]
    picks = [longest] + sorted(rng.choice(rest, size=min(check["requests"] - 1, len(rest)),
                                          replace=False).tolist())
    sample = [(done[i].prompt[0], done[i].prompt[1], done[i].tokens) for i in picks]
    # the host-clock readers take the window less the profiled slice
    ctx = dict(window_s=window_s - sl.excluded_s,
               ticks=[t for t in ticks if sl.outside(t[0]) and sl.outside(t[1])],
               slots=tp["server"]["num_slots"],
               finished=[(len(c.prompt[0]), len(c.tokens)) for c in finished
                         if sl.outside(c.t_done)],
               model=model_cfg, trace=sl.summary(), slice_prefills=slice_prefills,
               n_vis=model_cfg["perceiver"]["num_latents"], media_at=tp["media_at"],
               assistant_at=tp["assistant_at"])

    checks = {"unanswered": {"value": unanswered, "limit": 0},
              "short_answers": {"value": short, "limit": 0}}
    rec = dict(e2e=e2e, ctx=ctx, checks=checks, attempted=len(sent_in), failed=unanswered,
               memory_peak_bytes=peak)
    return rec, sample


def served_gap(conf: dict, seed: int, sample: list, device) -> tuple[float, tuple]:
    """The widest gap, over the std, by which a served token's logit lies
    below the reference's best, over every served token of ``sample``;
    the reference takes its weights anew from the seed and serves them as
    the configuration's ``serving`` block states."""
    model_cfg = conf["model"]
    served = ref.Served.of(conf["serving"])
    w = make_weights(model_cfg, seed, torch.bfloat16, device)
    worst, where = -1.0, None
    with torch.no_grad(), ref.exact_f32():
        for lo in range(0, len(sample), 8):
            block = sample[lo: lo + 8]
            for j, logits in enumerate(ref.served_logits(w, model_cfg, block, served)):
                g, at = ref.widest_gap(logits, block[j][2])
                if g > worst:
                    worst, where = g, (lo + j, at)
    return worst, where
