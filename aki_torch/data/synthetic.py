"""Synthetic training data in the layouts the data layer reads, made from a
numpy seed: webdataset caption shards, MMC4-style interleaved shards, and
the annotation files and images of the 11 SFT datasets at the paths the
shipped ``sft_datasets/*.yaml`` name under ``root``. Real shards and
annotation sets are not in the repository; the tests and ``chip_smoke.py``
train on these. No training path calls this module. PIL is imported where
used.
"""

from __future__ import annotations

import base64
import io
import json
import tarfile
from pathlib import Path

import numpy as np

WORDS = ("a", "the", "red", "small", "dog", "cat", "sits", "on", "under", "table",
         "bright", "green", "field", "car", "two", "people", "walk", "near", "old",
         "house", "river", "blue", "sky", "with", "clouds", "and", "tree", "is", "of")


def text(rng: np.random.RandomState, n: int) -> str:
    return " ".join(WORDS[i] for i in rng.randint(len(WORDS), size=n))


def image_bytes(rng: np.random.RandomState, size: tuple[int, int], fmt: str = "JPEG") -> bytes:
    """An image of random pixels, (width, height) ``size``, encoded."""
    from PIL import Image

    pixels = rng.randint(0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format=fmt)
    return buf.getvalue()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_caption_shard(path, n: int, rng: np.random.RandomState,
                        sizes=((40, 40),), words=(4, 12), prefix: str = "s") -> None:
    """A webdataset shard of ``n`` (jpg, txt) samples, sizes taken in turn."""
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{prefix}{i:05d}.jpg", image_bytes(rng, sizes[i % len(sizes)]))
            _add(tf, f"{prefix}{i:05d}.txt", text(rng, rng.randint(*words)).encode())


def mmc4_sample(rng: np.random.RandomState, n_img: int, n_matched: int, n_sent: int,
                size=(96, 96), words=(6, 14)) -> dict:
    """One MMC4-style sample: ``n_sent`` sentences, ``n_img`` base64 images
    (random pixels, over the 3 KB floor at 96 x 96), a similarity matrix under which
    image i matches sentence i above the 0.24 threshold for i < n_matched
    and nothing else does."""
    sim = rng.uniform(0.0, 0.2, size=(n_img, n_sent))
    for i in range(min(n_matched, n_img, n_sent)):
        sim[i, i] = rng.uniform(0.3, 0.9)
    return {
        "text_list": [text(rng, rng.randint(*words)) for _ in range(n_sent)],
        "similarity_matrix": sim.tolist(),
        "image_info": [{"image_base64": base64.b64encode(image_bytes(rng, size)).decode()}
                       for _ in range(n_img)],
    }


def write_mmc4_shard(path, n: int, rng: np.random.RandomState, images=(2, 8),
                     size=(96, 96), words=(6, 14)) -> list[int]:
    """A shard of ``n`` JSON samples of 2-8 images (``images``), each
    matching a random number of them; returns the matched counts."""
    matched = []
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            n_img = rng.randint(images[0], images[1] + 1)
            k = rng.randint(1, n_img + 1)
            sample = mmc4_sample(rng, n_img, k, n_img + 2, size, words)
            _add(tf, f"{i:05d}.json", json.dumps(sample).encode())
            matched.append(k)
    return matched


def _images(rng, folder: Path, names, size) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    for name in names:
        (folder / name).write_bytes(image_bytes(rng, size))


def write_sft_datasets(root, rng: np.random.RandomState, n: int = 4, size=(48, 40),
                       names=None, words=(3, 10)) -> list[str]:
    """Annotation files and images of ``n`` records for each SFT dataset of
    ``names`` (default: all 11 of ``sft_datasets/``), at the shipped paths
    under ``root``; returns the names written."""
    root = Path(root)
    all_names = ("llava150k", "vqa", "gqa", "ocrvqa", "aokvqa", "scienceqa", "vsr", "vg",
                 "refcoco", "refcoco+", "refcocog")
    names = list(names or all_names)
    t = lambda: text(rng, rng.randint(*words))  # noqa: E731
    coco17, coco14 = root / "coco" / "train2017", root / "coco" / "train2014"
    for name in names:
        if name == "llava150k":
            ann = [{"id": str(i), "image": f"{i:012d}.jpg", "conversations": [
                {"from": "human", "value": f"<image>\n{t()} ?"}, {"from": "gpt", "value": t()},
                {"from": "human", "value": f"{t()} ?"}, {"from": "gpt", "value": t()}]}
                for i in range(n)]
            _images(rng, coco17, [a["image"] for a in ann], size)
            _write_json(root / "llava" / "llava_instruct_150k.json", ann)
        elif name == "vqa":
            ids = [100 + i for i in range(n)]
            _write_json(root / "vqav2" / "v2_OpenEnded_mscoco_train2014_questions.json", {
                "data_subtype": "train2014",
                "questions": [{"image_id": i, "question": f"{t()} ?"} for i in ids]})
            _write_json(root / "vqav2" / "v2_mscoco_train2014_annotations.json", {
                "annotations": [{"multiple_choice_answer": WORDS[i % len(WORDS)]}
                                for i in ids]})
            _images(rng, coco14, [f"COCO_train2014_{i:012d}.jpg" for i in ids], size)
        elif name == "gqa":
            ann = {f"q{i}": {"imageId": f"g{i}", "question": f"{t()} ?",
                             "answer": WORDS[i % len(WORDS)], "fullAnswer": t()}
                   for i in range(n)}
            _images(rng, root / "gqa" / "images", [f"g{i}.jpg" for i in range(n)], size)
            _write_json(root / "gqa" / "train_balanced_questions.json", ann)
        elif name == "ocrvqa":
            ann = {f"o{i}": {"split": 1, "imageURL": f"http://x/{i}.jpg",
                             "questions": [f"{t()} ?", f"{t()} ?"], "answers": [t(), t()]}
                   for i in range(n)}
            _images(rng, root / "ocrvqa" / "images", [f"o{i}.jpg" for i in range(n)], size)
            _write_json(root / "ocrvqa" / "dataset.json", ann)
        elif name == "aokvqa":
            ann = [{"image_id": 200 + i, "question": f"{t()} ?",
                    "choices": [t() for _ in range(4)], "correct_choice_idx": i % 4,
                    "rationales": [t(), t()]} for i in range(n)]
            _images(rng, coco17, [f"{200 + i:012d}.jpg" for i in range(n)], size)
            _write_json(root / "aokvqa" / "aokvqa_v1p0_train.json", ann)
        elif name == "scienceqa":
            ann = {}
            for i in range(n):
                has_image = i % 2 == 0
                ann[f"p{i}"] = {"split": "train", "image": "image.png" if has_image else None,
                                "question": f"{t()} ?", "choices": [t(), t(), t()],
                                "hint": t() if i % 3 else "", "solution": t(), "answer": i % 3}
                if has_image:
                    _images(rng, root / "scienceqa" / "train" / f"p{i}", ["image.png"], size)
            _write_json(root / "scienceqa" / "problems.json", ann)
        elif name == "vsr":
            lines = [json.dumps({"image_link": f"http://x/{'train2017' if i % 2 else 'val2017'}"
                                               f"/{300 + i:012d}.jpg",
                                 "caption": f"The {WORDS[i % 9]} is on the table.",
                                 "label": i % 2}) for i in range(n)]
            for i in range(n):
                folder = coco17 if i % 2 else root / "coco" / "val2017"
                _images(rng, folder, [f"{300 + i:012d}.jpg"], size)
            (root / "vsr").mkdir(parents=True, exist_ok=True)
            (root / "vsr" / "train.jsonl").write_text("\n".join(lines) + "\n")
        elif name == "vg":
            ann = [{"id": 400 + i, "regions": [
                {"x": int(x), "y": int(y), "width": 10, "height": 8, "phrase": t()}
                for x, y in rng.randint(0, 30, size=(2, 2))]} for i in range(n)]
            meta = [{"image_id": 400 + i, "width": size[0], "height": size[1]}
                    for i in range(n)]
            _images(rng, root / "vg" / "images", [f"{400 + i}.jpg" for i in range(n)], size)
            _write_json(root / "vg" / "region_descriptions.json", ann)
            _write_json(root / "vg" / "image_data.json", meta)
        elif name in ("refcoco", "refcoco+", "refcocog"):
            files = [f"COCO_train2014_{name}_{i}.jpg" for i in range(n)]
            ann = {"images": [{"file_name": f, "caption": t(), "width": size[0],
                               "height": size[1]} for f in files],
                   "annotations": [{"bbox": [float(v) for v in rng.uniform(0, 20, size=4)]}
                                   for _ in files]}
            _images(rng, coco14, files, size)
            _write_json(root / "mdetr" / f"finetune_{name}_train.json", ann)
        else:
            raise ValueError(f"no synthetic SFT dataset {name!r}")
    return names


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
