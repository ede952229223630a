"""MME / POPE yes-no benchmark harness (counterpart of
``aki_tpu/infer/eval_yorn.py``).

The reference verifies its causal/DOT/MMA ablation on MME/POPE subsets
(README.md:81-87 ablation tables) but delegates the evaluation to
VLMEvalKit; this module makes the ablation runnable in-repo, end to end:

- **loader**: the VLMEvalKit TSV interchange format both benchmarks ship
  in (columns ``index``, ``question``, ``answer``, ``category``, and
  ``image`` (base64) and/or ``image_path``); JSONL with the same keys is
  accepted too.
- **prompt**: the reference's evaluation chat template (literal ``<s> ``
  prefix, ``add_special_tokens=False``), the question passed through
  VERBATIM (MME/POPE questions carry their own "Please answer yes or no.").
- **MME scoring**: the official eval_tool ``calculation.py`` rule —
  per-category question accuracy ``acc`` plus image-level both-questions
  accuracy ``acc+``, category score = 100*(acc + acc+); perception sums its
  10 categories (max 2000), cognition its 4 (max 800). Predictions map by
  the official ``parse_pred_ans``: exact yes/no, else yes/no within the
  first 4 characters, else "other" (scored wrong).
- **POPE scoring**: the official POPE ``main.py`` rule — strip at the first
  period, drop commas, then word-level: any of {no, not} => "no", else
  "yes"; accuracy / precision / recall / F1 ("yes" positive) and the
  yes-ratio, per category (adversarial / popular / random) and pooled.

Generation rides the bucketed batched path of CV-Bench
(``eval_cv_bench.run_eval``), ``--attn-mode {mma,dot,causal}`` included.

Usage:
    python -m aki_torch.infer.eval_yorn --benchmark mme \
        --data MME.tsv [--image-root DIR] [--checkpoint runs/sft]
        [--attn-mode causal] [--tiny] [--limit N]
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import sys
from pathlib import Path

import numpy as np

from ..data.images import decode_image
from ..models.common import BF16, Policy
from ..models.modeling import chat_prompt

# official MME category split (eval_tool calculation.py)
MME_PERCEPTION = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
)
MME_COGNITION = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
)


def render_prompt(question: str) -> str:
    """Chat-template the raw benchmark question (byte-exact vs the
    reference's eval template, eval.py:54-64; the question string is not
    modified — MME/POPE TSV questions already end with their own
    yes/no instruction)."""
    return chat_prompt(question)


def load_records(path: str, image_root: str | None = None,
                 limit: int | None = None) -> list[dict]:
    """VLMEvalKit-format TSV (or JSONL with the same keys) -> records.

    Each record: {index, question, answer, category, image_key, and one
    of image_b64 / image_path}. ``image_key`` groups MME's two questions
    per image for acc+ (image_path when present, else index pairing is
    NOT assumed — base64-only files group by the image payload hash).
    """
    p = Path(path)
    rows: list[dict] = []
    if p.suffix == ".jsonl":
        for line in p.read_text().splitlines():
            if line.strip():
                rows.append(json.loads(line))
    else:
        csv.field_size_limit(sys.maxsize)  # base64 image cells are ~MBs
        with p.open(newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
    out = []
    for r in rows:
        rec = {
            "index": r.get("index"),
            "question": r["question"],
            "answer": str(r["answer"]).strip(),
            "category": r.get("category", ""),
        }
        img_path = r.get("image_path") or ""
        img_b64 = r.get("image") or ""
        if img_path:
            rec["image_path"] = (
                str(Path(image_root) / img_path) if image_root else img_path
            )
            rec["image_key"] = img_path
        elif img_b64:
            rec["image_b64"] = img_b64
            rec["image_key"] = hash(img_b64)
        else:
            raise ValueError(f"record {rec['index']}: no image/image_path")
        out.append(rec)
        if limit and len(out) >= limit:
            break
    return out


def record_pixels(rec: dict):
    """Decoded PIL image (preprocessing happens in the batch loop)."""
    if "image_b64" in rec:
        raw = base64.b64decode(rec["image_b64"])
    else:
        raw = Path(rec["image_path"]).read_bytes()
    return decode_image(raw)


# -- answer extraction --------------------------------------------------------

def mme_parse_pred(pred: str) -> str:
    """Official MME eval_tool ``parse_pred_ans``: exact yes/no, else
    yes/no inside the first 4 chars, else "other"."""
    p = pred.lower().strip()
    if p in ("yes", "no"):
        return p
    head = p[:4]
    if "yes" in head:
        return "yes"
    if "no" in head:
        return "no"
    return "other"


def pope_parse_pred(pred: str) -> str:
    """Official POPE ``main.py`` normalization: cut at the first period,
    drop commas, word-split; {no, not} anywhere => "no", else "yes"."""
    text = pred.lower()
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split()
    return "no" if ("no" in words or "not" in words) else "yes"


# -- scoring ------------------------------------------------------------------

def score_mme(records: list[dict], preds: list[str]) -> dict:
    """Per-category acc/acc+/score plus perception & cognition totals."""
    by_cat: dict[str, list[tuple]] = {}
    for rec, pred in zip(records, preds):
        by_cat.setdefault(rec["category"], []).append(
            (rec["image_key"], rec["answer"].lower(),
             mme_parse_pred(pred))
        )
    out: dict = {"categories": {}}
    for cat, items in by_cat.items():
        correct = [int(gold == p) for _, gold, p in items]
        acc = float(np.mean(correct))
        by_img: dict = {}
        for (key, gold, p), ok in zip(items, correct):
            by_img.setdefault(key, []).append(ok)
        # acc+ counts an image only when BOTH its questions are right;
        # stray singletons (partial --limit runs) can never score acc+
        accp = float(np.mean([
            int(len(v) >= 2 and all(v)) for v in by_img.values()
        ]))
        out["categories"][cat] = {
            "acc": 100.0 * acc, "acc_plus": 100.0 * accp,
            "score": 100.0 * (acc + accp), "n": len(items),
        }
    for name, cats in (("perception", MME_PERCEPTION),
                       ("cognition", MME_COGNITION)):
        present = [out["categories"][c]["score"] for c in cats
                   if c in out["categories"]]
        out[name] = float(np.sum(present)) if present else 0.0
    return out


def score_pope(records: list[dict], preds: list[str]) -> dict:
    """Accuracy/precision/recall/F1 (+yes-ratio), per category & pooled."""
    def metrics(pairs):
        tp = sum(1 for g, p in pairs if g == "yes" and p == "yes")
        fp = sum(1 for g, p in pairs if g == "no" and p == "yes")
        tn = sum(1 for g, p in pairs if g == "no" and p == "no")
        fn = sum(1 for g, p in pairs if g == "yes" and p == "no")
        n = max(1, tp + fp + tn + fn)
        prec = tp / max(1, tp + fp)
        rec = tp / max(1, tp + fn)
        f1 = 2 * prec * rec / max(1e-9, prec + rec) if tp else 0.0
        return {
            "accuracy": 100.0 * (tp + tn) / n, "precision": 100.0 * prec,
            "recall": 100.0 * rec, "f1": 100.0 * f1,
            "yes_ratio": 100.0 * (tp + fp) / n, "n": n,
        }

    pairs_all, by_cat = [], {}
    for rec, pred in zip(records, preds):
        pair = (rec["answer"].lower(), pope_parse_pred(pred))
        pairs_all.append(pair)
        by_cat.setdefault(rec["category"] or "all", []).append(pair)
    return {
        "overall": metrics(pairs_all),
        "categories": {c: metrics(v) for c, v in by_cat.items()},
    }


# -- generation and the CLI ---------------------------------------------------

def run(records, model, tokenizer, *, batch_size=16, max_new_tokens=32, attn_mode=None,
        policy: Policy = BF16) -> list[str]:
    """Bucketed batched generation over yes/no records (the CV-Bench path:
    the same buckets and ablation plumbing)."""
    from .eval_cv_bench import run_eval

    img_size = model.cfg.siglip.image_size
    samples = [{"ids": tokenizer.encode(render_prompt(rec["question"])),
                "image": record_pixels(rec), "image_size": img_size} for rec in records]
    return run_eval(model, tokenizer, samples, batch_size=batch_size,
                    max_new_tokens=max_new_tokens, attn_mode=attn_mode, policy=policy)


def main(argv=None):
    from .eval_cv_bench import add_model_args, load_aki

    ap = argparse.ArgumentParser()
    ap.add_argument("--benchmark", required=True, choices=("mme", "pope"))
    ap.add_argument("--data", required=True, help="TSV or JSONL file")
    ap.add_argument("--image-root", default=None)
    add_model_args(ap)
    ap.add_argument("--out", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--attn-mode", default=None, choices=("mma", "dot", "causal"))
    args = ap.parse_args(argv)

    aki = load_aki(args)
    records = load_records(args.data, args.image_root, args.limit)
    preds = run(records, aki.model, aki.tokenizer, batch_size=args.batch,
                max_new_tokens=args.max_new_tokens, attn_mode=args.attn_mode,
                policy=aki.policy)
    scorer = score_mme if args.benchmark == "mme" else score_pope
    report = scorer(records, preds)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "report.json").write_text(text)
        with (out / "predictions.jsonl").open("w") as f:
            for rec, pred in zip(records, preds):
                f.write(json.dumps({
                    "index": rec["index"], "category": rec["category"],
                    "answer": rec["answer"], "pred": pred,
                }) + "\n")
    print(text)


if __name__ == "__main__":
    main()
