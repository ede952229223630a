"""SFT dataset parsers: annotation files -> uniform record lists
(counterpart of ``aki_tpu/data/sft/parsers.py``: the same records).

Each parser reproduces one reference dataset class's parsing behavior
(``train/sft_data_utils/*.py``) but emits plain records instead of torch
Datasets:

    {"image": path | None, "examples": [dict] | None, "text": str | None,
     "task_type": str}

``examples`` records are rendered by the Templatizer at sample time (with
random pattern/option augmentation); ``text`` records (LLaVA) are fully
rendered multi-turn chats.  The registry keys match the reference YAML
class names so configs port 1:1.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import re
import random as _random
from collections import defaultdict
from pathlib import Path

from .templates import (
    HUMAN, MEDIA_TOKENS, ROLE_PATTERNS, SYSTEM_MESSAGE_ROLE,
)


# --------------------------------------------------------------------------
# shared helpers (base_task.py)
# --------------------------------------------------------------------------

def load_file(path, mode=None):
    path = str(path)
    mode = mode or path.rsplit(".", 1)[-1]
    if mode == "txt":
        return Path(path).read_text(encoding="utf-8")
    if mode == "json":
        return json.loads(Path(path).read_text(encoding="utf-8"))
    if mode == "jsonl":
        lines = [x.strip() for x in Path(path).read_text(encoding="utf-8").splitlines()]
        return [json.loads(x) for x in lines if x]
    if mode in ("pkl", "pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(f"Unknown mode: {mode}")


def idx2option(idx: int, style="upper", deco="dot") -> str:
    s = {
        "upper": chr(ord("A") + idx),
        "lower": chr(ord("a") + idx),
        "num": f"{idx + 1}",
    }[style]
    return {None: "{i}", "paren": "({i})", "dot": "{i}.", "rparen": "{i})"}[
        deco
    ].format(i=s)


def optionize(options, answer_idx, rng=None, shuffle=True,
              aug_idx_style=False, include_answer_str=False, sep="\n"):
    """MCQ option string + answer letter with shuffle augmentation
    (base_task.py:34-86)."""
    rng = rng or _random
    if isinstance(options, str):
        return options
    options = list(options)
    answer = options[answer_idx]
    if shuffle:
        rng.shuffle(options)
        answer_idx = options.index(answer)
    if aug_idx_style:
        style = rng.choice(["upper", "lower", "num"])
        deco = rng.choice(["paren", "dot", "rparen"])
    else:
        style, deco = "upper", "dot"
    indices = [idx2option(i, style, deco) for i in range(len(options))]
    answer_str = idx2option(answer_idx, style, None)
    if include_answer_str:
        answer_str = f"{answer_str}. {answer}"
    option_str = sep.join(f"{i} {o}" for i, o in zip(indices, options))
    return option_str, answer_str


def format_bbox(x, y, w, h, W, H, coord_style=3) -> str:
    """Normalized `<bbox>[x1, y1][x2, y2]</bbox>` (base_task.py:154-176)."""
    x1, y1, x2, y2 = x / W, y / H, (x + w) / W, (y + h) / H
    fmt = f"{{:.{coord_style}f}}"
    vals = [fmt.format(v) for v in (x1, y1, x2, y2)]
    return f"<bbox>[{vals[0]}, {vals[1]}][{vals[2]}, {vals[3]}]</bbox>"


def cluster_records(pairs, task_type) -> list[dict]:
    """(image, example) pairs -> one record per example, grouped by image
    (finalize_data, base_task.py:92-134)."""
    clusters = defaultdict(list)
    for image_path, ex in pairs:
        clusters[image_path].append(ex)
    records = []
    for image_path, examples in clusters.items():
        for ex in examples:
            rec = {"examples": [ex], "task_type": task_type}
            if image_path is not None:
                rec["image"] = str(image_path)
            records.append(rec)
    return records


# --------------------------------------------------------------------------
# parsers
# --------------------------------------------------------------------------

def parse_llava(data_path, image_path, **_):
    """LLaVA-Instruct multi-turn chats -> fully rendered texts
    (llava_dataset.py:58-117)."""
    raw = load_file(data_path, "json")
    image_tokens = ["<image>\n", "\n<image>"]
    pattern = "|".join(map(re.escape, image_tokens))
    records = []
    for item in raw:
        text = SYSTEM_MESSAGE_ROLE
        for conv in item["conversations"]:
            role = conv["from"]
            text += ROLE_PATTERNS[role]
            if ROLE_PATTERNS[role] == f"\n{HUMAN}":
                text += f"{MEDIA_TOKENS['image'][0]}\n"
            chunks = [c for c in re.split(f"({pattern})", conv["value"]) if c]
            for c in chunks:
                if c not in image_tokens:
                    text += c
            if role == "human":
                text += "<|end|>"
            if role == "gpt":
                records.append({
                    "image": os.path.join(image_path, item["image"]),
                    "task_type": "llava_inst",
                    "text": text,
                })
                text = SYSTEM_MESSAGE_ROLE
    return records


def parse_scienceqa(data_path, image_path, **_):
    ann = load_file(data_path, "json")
    pairs = []
    for key, item in ann.items():
        if item["split"] != "train":
            continue
        image = osp.join(image_path, key, item["image"]) if item["image"] else None
        pairs.append((image, {
            "question": item["question"],
            "options": item["choices"],
            "context": item["hint"] if item["hint"] != "" else "N/A",
            "solution": item["solution"],
            "answer_index": item["answer"],
            "_needs": "optionize",
        }))
    return cluster_records(pairs, "scienceqa_vqa")


def parse_vqav2(data_path, image_path, **_):
    qjs = load_file(f"{data_path}/v2_OpenEnded_mscoco_train2014_questions.json")
    ajs = load_file(f"{data_path}/v2_mscoco_train2014_annotations.json")
    subtype = qjs["data_subtype"]
    pairs = []
    for q, a in zip(qjs["questions"], ajs["annotations"]):
        img = f"{image_path}COCO_{subtype}_{str(q['image_id']).zfill(12)}.jpg"
        pairs.append((img, {
            "question": q["question"],
            "answer": a["multiple_choice_answer"],
        }))
    return cluster_records(pairs, "vqa_vqa")


def parse_aokvqa(data_path, image_path, split="train", **_):
    ann = load_file(data_path, "json")
    pairs = []
    for dic in ann:
        img = osp.join(image_path, f"{dic['image_id']:012}.jpg")
        pairs.append((img, {
            "question": dic["question"],
            "options": dic["choices"],
            "answer_index": dic["correct_choice_idx"],
            "rationale": " ".join(dic["rationales"]),
            "_needs": "optionize",
        }))
    return cluster_records(pairs, "aokvqa_vqa")


def parse_gqa(data_path, image_path, **_):
    js = load_file(data_path)
    pairs = []
    for dic in js.values():
        img = f"{image_path}{dic['imageId']}.jpg"
        pairs.append((img, {
            "question": dic["question"],
            "answer": dic["answer"],
            "full_answer": dic["fullAnswer"],
        }))
    return cluster_records(pairs, "gqa_vqa")


def parse_ocrvqa(data_path, image_path, split="train", **_):
    split_idx = ["train", "val", "test"].index(split) + 1
    raw = load_file(data_path)
    pairs = []
    for key, dic in raw.items():
        if dic["split"] != split_idx:
            continue
        ext = os.path.splitext(dic["imageURL"])[1]
        img = str(Path(image_path) / f"{key}{ext}")
        for q, a in zip(dic["questions"], dic["answers"]):
            pairs.append((img, {"question": q, "answer": a}))
    return cluster_records(pairs, "ocrvqa_vqa")


def parse_vsr(data_path, image_path_train, image_path_val, **_):
    raw = load_file(data_path)
    pairs = []
    for dic in raw:
        folder, filename = dic["image_link"].split("/")[-2:]
        root = {"train2017": image_path_train, "val2017": image_path_val}[folder]
        img = os.path.join(root, filename)
        # caption -> interrogative rewrite (vsr_dataset.py:44-48)
        parts = [s.lower().replace(".", "?").strip()
                 for s in dic["caption"].split("is")]
        question_interro = "Is " + " ".join(parts)
        pairs.append((str(img), {
            "question": dic["caption"],
            "question_interro": question_interro,
            "answer": "yes" if dic["label"] == 1 else "no",
        }))
    return cluster_records(pairs, "vsr_vqa")


def parse_vg(data_path, image_metadata_path, image_path, bbox_coord_style=3, **_):
    images = {d["image_id"]: d for d in load_file(image_metadata_path)}
    pairs = []
    for dic in load_file(data_path):
        image_id = dic["id"]
        img = osp.join(image_path, f"{image_id}.jpg")
        for r in dic["regions"]:
            meta = images[image_id]
            bbox = format_bbox(r["x"], r["y"], r["width"], r["height"],
                               meta["width"], meta["height"], bbox_coord_style)
            pairs.append((img, {"phrase": r["phrase"], "bbox": bbox}))
    return cluster_records(pairs, "vgloc_loc")


def parse_refexp(data_path, image_path, dataname="refcoco",
                 bbox_coord_style=3, **_):
    """MDETR-format RefCOCO/+/g (refexploc_dataset.py:31-86)."""
    ann = load_file(data_path)
    pairs = []
    for img, a in zip(ann["images"], ann["annotations"]):
        x, y, w, h = a["bbox"]
        bbox = format_bbox(x, y, w, h, img["width"], img["height"],
                           bbox_coord_style)
        pairs.append((
            osp.join(image_path, img["file_name"]),
            {"phrase": img["caption"], "bbox": bbox},
        ))
    return cluster_records(pairs, f"{dataname}_loc")


# Registry keyed by the reference YAML class names
# (sft_data_utils/__init__.py:20-31).
PARSERS = {
    "LLaVAInstructDataset": parse_llava,
    "ScienceQADataset": parse_scienceqa,
    "VQADataset": parse_vqav2,
    "AOKVQADataset": parse_aokvqa,
    "GQADataset": parse_gqa,
    "OCRVQADataset": parse_ocrvqa,
    "VSRDataset": parse_vsr,
    "VGDataset": parse_vg,
    "RefExpLocDataset": parse_refexp,
}

# dataset name used for template lookup, per task_type suffix
TEMPLATE_NAME_BY_TASK = {
    "scienceqa_vqa": "scienceqa",
    "vqa_vqa": "vqa",
    "aokvqa_vqa": "aokvqa",
    "gqa_vqa": "gqa",
    "ocrvqa_vqa": "ocrvqa",
    "vsr_vqa": "vsr",
    "vgloc_loc": "vg",
    "refcoco_loc": "refexploc",
    "refcoco+_loc": "refexploc",
    "refcocog_loc": "refexploc",
}
