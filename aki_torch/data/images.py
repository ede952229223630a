"""Host-side image preprocessing (counterpart of ``aki_tpu/data/images.py``):
PIL + numpy, NHWC float32 out, byte for byte the JAX package's.

- base (``src/factory.py:79-84``): bicubic resize to (S, S), RGB,
  normalize ``(x - 0.5) / 0.5``;
- pretrain adds RandomHorizontalFlip(0.5) (``train/data.py:47-56``);
- SFT adds RandomResizedCrop(scale=(0.5, 1.0)) + flip
  (``sft_data_utils/base.py:110-114``).

PIL is imported inside the functions that need it: importing this module
(and the model modules that import it) must work where Pillow is absent.
"""

from __future__ import annotations

import io
import math

import numpy as np


def decode_image(data: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(data))


def to_array(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


def preprocess(
    img,
    size: int = 384,
    rng: np.random.RandomState | None = None,
    hflip: bool = False,
    random_resized_crop: bool = False,
) -> np.ndarray:
    """PIL image -> (size, size, 3) float32 in [-1, 1]."""
    from PIL import Image

    if random_resized_crop and rng is not None:
        img = _random_resized_crop(img, size, rng)
    else:
        img = img.resize((size, size), Image.BICUBIC)
    arr = to_array(img)
    if hflip and rng is not None and rng.rand() < 0.5:
        arr = arr[:, ::-1].copy()
    return arr


def zero_image(size: int = 384) -> np.ndarray:
    """Placeholder for image-less SFT samples — the reference collate pads
    with a zero pixel tensor (``loader_utils.py:114-119``)."""
    return np.zeros((size, size, 3), dtype=np.float32)


def _random_resized_crop(img, size: int, rng: np.random.RandomState,
                         scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw + 1)
            y = rng.randint(0, h - ch + 1)
            return img.crop((x, y, x + cw, y + ch)).resize((size, size), Image.BICUBIC)
    # fallback: center crop
    s = min(w, h)
    x, y = (w - s) // 2, (h - s) // 2
    return img.crop((x, y, x + s, y + s)).resize((size, size), Image.BICUBIC)
