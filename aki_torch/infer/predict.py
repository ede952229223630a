"""Batch prediction CLI — the external-eval-harness adapter (counterpart of
``aki_tpu/infer/predict.py``).

The reference delegates most benchmarks to VLMEvalKit
(``scripts/run_eval_vlmkit.sh``), which needs (image, prompt) -> answer.
This CLI reads a JSONL of requests, drives the continuous-batching
:class:`~aki_torch.infer.server.ServingEngine`, and writes a JSONL of
answers, so any harness can shell out to it.

Input lines:  {"image": "path.jpg", "question": "...", "id": optional}
Output lines: {"id": ..., "answer": "..."}

Usage:
    python -m aki_torch.infer.predict --checkpoint runs/imported \
        --input requests.jsonl --output answers.jsonl \
        [--tokenizer /models/phi-3.5-mini] [--slots 8]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.images import decode_image, preprocess
from ..models.modeling import chat_prompt
from .eval_cv_bench import add_model_args, load_aki
from .server import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prompt-bucket", type=int, default=512)
    ap.add_argument("--attn-mode", default=None, choices=("mma", "dot", "causal"),
                    help="prefill attention ablation (README.md:81-87)")
    args = ap.parse_args(argv)

    aki = load_aki(args)
    engine = ServingEngine(aki.model, num_slots=args.slots, max_len=args.max_len,
                           prompt_bucket=args.prompt_bucket, policy=aki.policy,
                           attn_mode=args.attn_mode, device=aki.model.device)
    tok = aki.tokenizer

    requests = [json.loads(line) for line in Path(args.input).read_text().splitlines()
                if line.strip()]
    pending = []
    try:
        for i, r in enumerate(requests):
            ids = tok.encode(chat_prompt(r["question"]))  # add_special_tokens=False
            img = preprocess(decode_image(Path(r["image"]).read_bytes()),
                             aki.cfg.siglip.image_size)
            req = engine.submit(ids, img, max_new_tokens=args.max_new_tokens,
                                eos_id=tok.info.end_id)
            pending.append((r.get("id", i), req))
        engine.run_until_drained()
    finally:
        engine.close()

    with Path(args.output).open("w") as f:
        for rid, req in pending:
            f.write(json.dumps({"id": rid, "answer": tok.decode(req.result(timeout=1))})
                    + "\n")
    print(f"wrote {len(pending)} answers -> {args.output}")


if __name__ == "__main__":
    main()
