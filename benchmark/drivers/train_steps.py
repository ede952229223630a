"""Training steps of the port's ``Trainer``, each over one batch of every
dataset of the mix, as the pretrain CLI feeds ``Trainer.step_fn``.

Set-up builds the model from the seed (float32 master weights), the
Trainer as the configuration says, and drives that same Trainer through its
first ``check_steps`` steps on rows that all differ, reading what the check
compares (each step's loss, each leaf's first gradient as AdamW got it,
each leaf's change after the last of them). The window then runs further
steps through the same call and feed, and ends on a synchronise. Once the
program's state is freed the plain reference follows the first steps from
the same weights and rows.

The mix (the traffic file): per dataset its rows, text length and the
ranges of valid tokens and images a row, over which the rows' sizes are
spread evenly; the places of the images are drawn once from
``sizes_seed``. Every step of every seed has the same rows, so that every
step does the same work; the run's seed orders the rows of each step and
draws the tokens and pixels.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, yardstick
from benchmark.drivers import program
from benchmark.reference import aki_plain as ref
from benchmark.reference.weights import leaves, make_weights, start_values, sub_seed

ROOT = Path(__file__).resolve().parents[2]


def spread(lo: int, hi: int, n: int) -> list[int]:
    """``n`` sizes spread evenly over [lo, hi]: the midpoints of its n equal
    parts, rounded half up."""
    return [int(lo + (k + 0.5) * (hi - lo) / n + 0.5) for k in range(n)]


def step_sizes(tp: dict) -> list[list]:
    """Per dataset, the sizes of a step's rows: the caption lengths (paired)
    or the (text tokens, image places) of each row (interleaved), the
    lengths and image counts spread evenly over the mix's ranges, the image
    places drawn once from the mix's own seed. Every step of every seed has
    these rows, in an order of its own."""
    rng = np.random.RandomState(tp["sizes_seed"])
    sizes = []
    for ds in tp["datasets"]:
        lengths = spread(*ds["text_tokens"], ds["rows"])
        if ds["type"] == "paired":
            sizes.append(lengths)
        else:
            sizes.append([yardstick.interleaved_layout(rng, n, k)
                          for n, k in zip(lengths, spread(*ds["images"], ds["rows"]))])
    return sizes


class Feed:
    """The step-by-step batches of one run: step i takes the mix's rows in an
    order drawn from (seed, i), its tokens from (seed, i) on the host and
    its pixels from (seed, i) on the device."""

    def __init__(self, tp: dict, conf: dict, seed: int, device):
        self.tp, self.seed, self.device = tp, seed, device
        self.sizes = step_sizes(tp)
        m = conf["model"]
        self.ids = dict(pad=m["pad_token_id"], media=m["media_token_id"],
                        eoc=m["end_of_chunk_token_id"], bos=conf["tokenizer"]["bos"],
                        eos=conf["tokenizer"]["eos"], text=conf["tokenizer"]["text"])
        self.image = m["siglip"]["image_size"]

    def batches(self, i: int) -> list[dict]:
        rng = np.random.RandomState(sub_seed(self.seed, 6, i) % 2**32)
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 7, i))
        out = []
        for ds, sizes in zip(self.tp["datasets"], self.sizes):
            sizes = [sizes[k] for k in rng.permutation(len(sizes))]
            if ds["type"] == "paired":
                out.append(yardstick.train_rows_paired(rng, gen, ds["rows"], ds["text_len"], sizes,
                                                       self.ids, self.image, self.device))
            else:
                out.append(yardstick.train_rows_interleaved(rng, gen, ds["text_len"],
                                                            ds["max_images"], sizes, self.ids,
                                                            self.image, self.device))
        return out


def host_rows(batches: list[dict]) -> list[dict]:
    """What the per-layer readers need of a step: its host ids and validity,
    and the image slots a row."""
    return [dict(input_ids=b["input_ids"], attn_valid=b["attn_valid"],
                 slots=b["images"].shape[1] if b["images"].dim() == 5 else 1) for b in batches]


def on_device(batches: list[dict], device) -> list[dict]:
    """A step's batches as the reference takes them: tensors on ``device``,
    copies of the program's."""
    return [{k: torch.as_tensor(v).to(device).clone() for k, v in b.items()} for b in batches]


def valid_tokens(rows: list[dict], media: int, n_vis: int) -> int:
    return sum(yardstick.valid_spliced_tokens(torch.as_tensor(r["input_ids"]),
                                              torch.as_tensor(r["attn_valid"]), media, n_vis,
                                              r["slots"]) for r in rows)


class _Silent:
    last = None

    def log(self, step, **scalars):
        pass

    def close(self):
        pass


def trainer_for(cell, model, device):
    from aki_torch.train.runner import RunnerConfig, Trainer

    tc = cell.config["training"]
    run_cfg = RunnerConfig(
        run_dir=str(ROOT / "build" / "bench_runs" / cell.name), learning_rate=tc["learning_rate"],
        min_lr=tc["min_lr"], weight_decay=tc["weight_decay"], warmup_steps=tc["warmup_steps"],
        total_steps=tc["total_steps"], lr_schedule=tc["lr_schedule"], grad_clip=tc["grad_clip"],
        grad_accum=tc["grad_accum"], precision=tc["precision"], remat=tc["remat"],
        remat_policy=tc["remat_policy"], decay_policy=tc["decay_policy"],
        training_mode="scratch", checkpoint_steps=1 << 62, log_every=1 << 62)
    return Trainer(program.aki_config(cell.config["model"]), run_cfg, model=model, device=device,
                   metrics=_Silent(), distributed=False)


def program_batch(batches: list[dict]):
    from aki_torch.train.step import Batch

    return tuple(Batch(b["input_ids"], b["images"], b["attn_valid"], b["labels"])
                 for b in batches)


def first_gradients(opt, named: dict, b1: float) -> dict[str, float]:
    """Per leaf, the norm of the first gradient as AdamW got it (clipped),
    worked out from its first moment after one update: m = (1 - b1) g."""
    return {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"])) / (1 - b1)
            for n, p in named.items() if p in opt.state}


def change_norms(named: dict, model_cfg: dict, seed: int, device) -> dict[str, float]:
    """Per trainable leaf, the norm of its change from the start state,
    which is made again from the seed one chunk at a time."""
    sq = {n: 0.0 for n in named}
    with torch.no_grad():
        for leaf, lo, vals in start_values(model_cfg, seed, torch.float32, device):
            if leaf.name in named:
                cur = named[leaf.name].reshape(-1)[lo: lo + vals.numel()]
                sq[leaf.name] += float((cur.float() - vals).double().square().sum())
        for leaf in leaves(model_cfg):
            if leaf.name in named and leaf.init != "normal":
                start = 1.0 if leaf.init == "ones" else 0.0
                sq[leaf.name] = float((named[leaf.name].double() - start).square().sum())
    return {n: math.sqrt(v) for n, v in sq.items()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float | None = None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    conf, tp = cell.config, cell.traffic
    model_cfg = conf["model"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    if cuda and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(device)   # a later run in one process
    weights = make_weights(model_cfg, seed, torch.float32, device)
    model = program.build_model(model_cfg, weights, torch.float32, device)
    del weights
    trainer = trainer_for(cell, model, device)
    feed = Feed(tp, conf, seed, device)
    frozen = conf["training"]["frozen_tower"]
    named = {n: p for n, p in model.named_parameters() if ref.is_trainable(n, frozen)}
    held = [n for n, p in model.named_parameters() if p.requires_grad != (n in named)]
    if held:
        raise RuntimeError(f"the Trainer trains otherwise than frozen_tower={frozen} states: "
                           f"{held[:4]} ({len(held)} parameters)")
    b1 = conf["training"]["b1"]

    # the first steps, through the window's own call and feed: what the
    # check compares is read from the state they leave
    checking = 0.0
    check_losses, first_grad, kept = [], {}, []
    for i in range(tp["check_steps"]):
        batches = feed.batches(i)
        kept.append(on_device(batches, device))
        m = trainer.step_fn(trainer.state, trainer.put_batch(program_batch(batches)))
        t0 = time.perf_counter()
        check_losses.append(float(m["loss"]))
        if i == 0:
            first_grad = first_gradients(trainer.state.optimizer.opt, named, b1)
        checking += time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.state.optimizer.zero_grad()
    change = change_norms(named, model_cfg, seed, device)
    sync()
    checking += time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start - checking

    slice_rows, steps, losses, n_steps = [], [], [], 0
    i = tp["check_steps"]
    t_open = time.perf_counter()
    sl = harness.ProfiledSlice(trace, t_open, seconds, tp["trace_slice"], sync, cuda)
    while True:
        now = time.perf_counter()
        # a traced window runs on until its slice has been profiled
        if now >= t_open + seconds and sl.done:
            break
        sl.tick(now)
        batches = feed.batches(i)
        m = trainer.step_fn(trainer.state, trainer.put_batch(program_batch(batches)))
        rows = host_rows(batches)
        if sl.open:
            slice_rows.append(rows)
        else:
            steps.append(rows)
        n_steps += 1
        losses.append(m["loss"])
        i += 1
    sync()
    t_close = time.perf_counter()
    window_s = t_close - t_open
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    nonfinite = sum(1 for x in losses if not math.isfinite(float(x)))
    n_vis = model_cfg["perceiver"]["num_latents"]
    tokens = sum(valid_tokens(rows, model_cfg["media_token_id"], n_vis)
                 for rows in steps + slice_rows)
    # the host-clock readers take the steps outside the profiled slice over
    # the window less the slice; every step of the slice was issued and
    # finished inside it (it starts and ends on a synchronise)
    ctx = dict(window_s=window_s - sl.excluded_s, steps=steps, slice_steps=slice_rows,
               trace=sl.summary(), model=model_cfg, chips=cell.chips)

    del trainer, model, named, losses, batches, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        print(f"train: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB held after the "
              f"program's state was freed", file=sys.stderr, flush=True)
    readings = compare(cell, seed, kept, check_losses, first_grad, change, device)
    # the numbers the traffic file gives a limit are compared; the others
    # (the step losses, see PERF.md) are read for the record only
    checks = {k: {"value": v, "limit": tp["check"][k]} for k, v in readings.items()
              if k in tp["check"]}
    checks["nonfinite_losses"] = {"value": nonfinite, "limit": 0}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    e2e = {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    return dict(e2e=e2e, ctx=ctx, correct=correct, checks=checks, attempted=n_steps,
                failed=nonfinite, memory_peak_bytes=peak, readings=readings)


def reference_readings(cell, seed: int, kept: list, device, product_of=None,
                       half: bool = False, store=ref.keep) -> dict:
    """The plain reference's losses, first gradients and changes over the
    kept steps, from the weights made again from the seed; ``product_of``
    (weights -> product) and ``store`` compute its projections and keep its
    activations another way, ``half`` keeps half of each batch (the check's
    control and faults)."""
    model_cfg = cell.config["model"]
    w = make_weights(model_cfg, seed, torch.float32, device)
    product = None if product_of is None else product_of(w)
    with ref.exact_f32():
        out = ref.train_steps(w, model_cfg, cell.config["training"], kept, product, half=half,
                              store=store)
    frozen = cell.config["training"]["frozen_tower"]
    out["change"] = change_norms({n: t for n, t in w.items() if ref.is_trainable(n, frozen)},
                                 model_cfg, seed, device)
    del w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def readings_of(got: dict, want: dict, steady: float) -> dict:
    """The numbers the check compares, of ``got`` against ``want`` (each
    {losses, first_grad, change}): the largest relative gap of a step's
    loss; and, by the worst leaf, the gap between the two norms of a leaf's
    first gradient, and of its change, over the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under ``steady`` of the median leaf's move by round-off
    alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_med = statistics.median(want["first_grad"].values())

    def worst(a: dict, b: dict, names) -> float:
        med = statistics.median(b[n] for n in names)
        return max(abs(a.get(n, 0.0) - b[n]) / max(b[n], med) for n in names)

    grad = worst(got["first_grad"], want["first_grad"], list(want["first_grad"]))
    moving = [n for n, g in want["first_grad"].items() if g >= steady * g_med]
    change = worst(got["change"], want["change"], moving)
    return {"loss_rel": loss, "grad_rel": grad, "change_rel": change}


def compare(cell, seed, kept, losses, first_grad, change, device) -> dict:
    want = reference_readings(cell, seed, kept, device)
    got = dict(losses=losses, first_grad=first_grad, change=change)
    return readings_of(got, want, cell.traffic["check"]["steady_leaf"])
