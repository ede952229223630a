"""CV-Bench evaluation CLI (counterpart of ``aki_tpu/infer/eval_cv_bench.py``).

Behavioral port of ``eval_cv_bench/eval.py``, byte-exact on the prompt and
scoring rule:

- text input (eval.py:167): ``"Answer with the option's letter from the
  given choices directly. {question}\\nOptions:\\n{A. choice lines}\\n"``
  (instruction FIRST, ``A.`` letter style — prompt wording shifts MCQ
  accuracy, so this is load-bearing);
- chat template (eval.py:54-64): ``<s> <|system|>\\n{SYSTEM}<|end|>\\n
  <|user|>\\n<image>\\n{query}<|end|>\\n<|assistant|>\\n`` tokenized with
  ``add_special_tokens=False`` (the literal ``<s> `` prefix supplies bos);
- prediction = decoded *new* tokens only, scored by EXACT string equality
  against the answer with parens stripped (eval.py:171-177);
- 2D accuracy = mean(ADE20K acc, COCO acc) — per-source average, not a
  pooled sample mean; combined = (2D + 3D) / 2 (eval.py:120-131).

Prompts are right-padded into the JAX package's length buckets and generated
in fixed-size batches. The buckets decide which prompts share a padded batch,
and so the outputs; they stay. The JAX ``warmup`` pass, which compiled each
bucket before the loop, has nothing to compile here and is gone: the CUDA
kernels build at their first use (``aki_torch/ops/cuda_build.py``). The JAX
``load_params`` (init + restore) is ``AKI.from_pretrained``.

Usage:
    python -m aki_torch.infer.eval_cv_bench --checkpoint runs/sft \
        --data /path/to/CV-Bench [--tokenizer /path/to/tok] [--limit N]
"""

from __future__ import annotations

import argparse
import csv
import re
from pathlib import Path

import numpy as np
import torch

from ..data.images import preprocess
from ..models.aki import AKIModel
from ..models.common import BF16, Policy
from ..models.modeling import chat_prompt
from .engine import generate

BUCKETS = (96, 128, 192, 256, 384, 512, 768, 1024)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def optionize_choices(choices: list[str]) -> str:
    """``A. choice`` lines (eval.py:40-51)."""
    options = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return "\n".join(f"{options[i]}. {c}" for i, c in enumerate(choices))


def render_prompt(question: str, choices: list[str]) -> str:
    """Full prompt, byte-exact vs eval.py:54-64 + :167."""
    return chat_prompt(
        "Answer with the option's letter from the given choices directly. "
        f"{question}\nOptions:\n{optionize_choices(choices)}\n")


def extract_letter(text: str) -> str | None:
    """Lenient letter extraction (diagnostics only — scoring is exact)."""
    m = re.search(r"\(?([A-F])\)?", text.strip())
    return m.group(1) if m else None


def pick_bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket")


def batches(cfg, samples, batch_size: int, max_new_tokens: int, n_vis: int | None = None):
    """The padded batches of a bucketed eval, bucket by bucket: yields
    ``(rows, ids, valid, images, max_len)``, ``rows`` the sample indices of
    the batch's first ``len(rows)`` rows; the rest repeat the first sample
    (ids and pixels) to fill ``batch_size``."""
    n_vis = n_vis or cfg.perceiver.num_latents
    by_bucket: dict[int, list[int]] = {}
    for i, s in enumerate(samples):
        by_bucket.setdefault(pick_bucket(len(s["ids"])), []).append(i)
    s_img = cfg.siglip.image_size
    for bucket, idxs in sorted(by_bucket.items()):
        # max_len: bucket + spliced vision + decode room, 128-aligned
        max_len = -(-(bucket + n_vis + max_new_tokens) // 128) * 128
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo: lo + batch_size]
            rows = chunk + [chunk[0]] * (batch_size - len(chunk))
            ids = np.full((batch_size, bucket), cfg.pad_token_id, np.int32)
            valid = np.zeros((batch_size, bucket), np.int32)
            imgs = np.zeros((batch_size, s_img, s_img, 3), np.float32)
            for r, si in enumerate(rows):
                s = samples[si]
                n = len(s["ids"])
                ids[r, :n] = s["ids"]
                valid[r, :n] = 1
                if r >= len(chunk):      # batch-pad rows repeat chunk[0]'s pixels
                    imgs[r] = imgs[0]
                    continue
                im = s["image"]
                if "image_size" in s:    # raw PIL image: preprocess per batch
                    im = preprocess(im, s["image_size"])
                imgs[r] = im
            yield chunk, ids, valid, imgs, max_len


def run_eval(model: AKIModel, tokenizer, samples, *, batch_size=16, max_new_tokens=256,
             policy: Policy = BF16, n_vis=None, attn_mode=None) -> list[str]:
    """Bucketed batched greedy generation on ``model``'s device.

    samples: list of dicts {ids, image (H,W,C) float32 or a PIL image with
    ``image_size``}. Returns the decoded prediction of each sample.
    ``attn_mode`` ("mma" | "dot" | "causal") runs the reference's ablation
    modes (README.md:81-87) through the same bucketed path.
    """
    results = [None] * len(samples)
    for chunk, ids, valid, imgs, max_len in batches(model.cfg, samples, batch_size,
                                                     max_new_tokens, n_vis):
        tokens, num = generate(model, ids, imgs, valid, max_new_tokens, max_len,
                               eos_id=tokenizer.info.end_id, policy=policy,
                               attn_mode=attn_mode, device=model.device)
        tokens, num = tokens.cpu().numpy(), num.cpu().numpy()
        for r, si in enumerate(chunk):
            results[si] = tokenizer.decode(tokens[r][: int(num[r])])
    return results


def score(samples, preds) -> tuple[list[dict], str]:
    """(per-sample rows, the report): exact-match accuracy per source; 2D =
    mean(ADE, COCO), combined = (2D + 3D) / 2 (eval.py:120-131 — per-source
    average, not pooled)."""
    results = []
    correct_by_source: dict[str, list[int]] = {}
    for i, (s, text) in enumerate(zip(samples, preds)):
        ok = int(text == s["answer"])  # reference: exact equality
        correct_by_source.setdefault(s["source"], []).append(ok)
        results.append({"idx": i, "source": s["source"], "pred": text[:40],
                        "gold": s["answer"], "correct": ok})

    def acc(src):
        vals = correct_by_source.get(src, [])
        return 100.0 * np.mean(vals) if vals else None

    def fmt(v):
        return f"{v:.2f}" if v is not None else "n/a"

    def mean_present(*vals):
        # partial runs (--limit selects a prefix of the source-ordered set)
        # average the sources present
        present = [v for v in vals if v is not None]
        return float(np.mean(present)) if present else None

    a_ade, a_coco, a_omni = acc("ADE20K"), acc("COCO"), acc("Omni3D")
    acc2d = mean_present(a_ade, a_coco)
    report = (
        f"CV-Bench Accuracy: {fmt(mean_present(acc2d, a_omni))}\n"
        f"2D Accuracy: {fmt(acc2d)}\n"
        f"3D Accuracy: {fmt(a_omni)}\n"
        f"ADE20K Accuracy: {fmt(a_ade)}\n"
        f"COCO Accuracy: {fmt(a_coco)}\n"
        f"Omni3D Accuracy: {fmt(a_omni)}\n"
    )
    return results, report


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The model flags every consumer CLI shares."""
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))


def load_aki(args):
    from ..models.modeling import AKI

    return AKI.from_pretrained(args.checkpoint, tokenizer_path=args.tokenizer,
                               tiny=args.tiny, device=args.device, dtype=DTYPES[args.dtype])


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--data", required=True,
                    help="local CV-Bench dir (HF datasets format or parquet)")
    ap.add_argument("--out", default="cv_bench_results")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--attn-mode", default=None, choices=("mma", "dot", "causal"),
                    help="attention ablation (README.md:81-87 table); default = mma, the "
                         "released-model mode")
    args = ap.parse_args(argv)

    aki = load_aki(args)
    tokenizer = aki.tokenizer

    import datasets as hfds

    ds = hfds.load_dataset(args.data, split="test")
    if args.limit:
        ds = ds.select(range(min(args.limit, len(ds))))

    samples = [{
        # add_special_tokens=False: the "<s> " prefix supplies bos
        "ids": tokenizer.encode(render_prompt(ex["question"], ex["choices"])),
        # raw image kept; preprocessing happens inside the batch loop
        "image": ex["image"],
        "image_size": aki.cfg.siglip.image_size,
        "answer": ex["answer"].replace("(", "").replace(")", ""),
        "source": ex.get("source", "unknown"),
    } for ex in ds]

    preds = run_eval(aki.model, tokenizer, samples, batch_size=args.batch,
                     max_new_tokens=args.max_new_tokens, policy=aki.policy,
                     attn_mode=args.attn_mode)
    results, report = score(samples, preds)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with (out / "predictions.csv").open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        w.writeheader()
        w.writerows(results)
    (out / "report.txt").write_text(report)
    print(report, end="")


if __name__ == "__main__":
    main()
