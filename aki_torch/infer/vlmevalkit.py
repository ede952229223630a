"""VLMEvalKit model adapter for AKI (counterpart of
``aki_tpu/infer/vlmevalkit.py``).

The reference evaluates its released checkpoint through VLMEvalKit; this
module is the model class that plugs into VLMEvalKit's registry:

    from aki_torch.infer.vlmevalkit import AKIVLMEval
    # in vlmeval/config.py:  "AKI-4B": partial(AKIVLMEval, run_dir=...)

It duck-types ``vlmeval.vlm.base.BaseModel`` (no hard dependency — the
harness only calls the attributes and methods below):

- ``INTERLEAVE = False`` / ``allowed_types`` — one image per request,
  images and text fields collected from the message list;
- ``generate(message, dataset=None)`` -> str — greedy decode with the
  reference chat template (literal ``<s> `` prefix,
  ``add_special_tokens=False`` tokenization);
- ``use_custom_prompt(dataset)`` -> False — VLMEvalKit builds prompts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.modeling import AKI, chat_prompt


class AKIVLMEval:
    """VLMEvalKit-compatible wrapper around :class:`~aki_torch.models.modeling.AKI`."""

    INTERLEAVE = False
    allowed_types = ("text", "image")

    def __init__(self, run_dir: str | None = None, tokenizer_path: str | None = None,
                 tiny: bool = False, max_new_tokens: int = 256, max_len: int = 1024,
                 device="cuda", dtype=torch.bfloat16):
        self.model = AKI.from_pretrained(run_dir, tokenizer_path=tokenizer_path, tiny=tiny,
                                         device=device, dtype=dtype)
        self.model.max_len = max_len
        self.max_new_tokens = max_new_tokens

    # -- vlmeval BaseModel surface -------------------------------------------
    def use_custom_prompt(self, dataset: str | None = None) -> bool:
        return False

    def generate(self, message, dataset: str | None = None) -> str:
        return self.generate_inner(message, dataset)

    def generate_inner(self, message, dataset: str | None = None) -> str:
        texts, image = [], None
        for item in message:
            if item["type"] == "text":
                texts.append(item["value"])
            elif item["type"] == "image" and image is None:
                image = self._load_image(item["value"])
        tok = self.model.tokenizer
        ids = tok.encode(chat_prompt("\n".join(texts)))  # add_special_tokens=False
        if image is None:
            image = np.zeros((self.model.cfg.siglip.image_size,) * 2 + (3,), np.float32)
        tokens, num = self.model.generate([ids], image[None],
                                          max_new_tokens=self.max_new_tokens,
                                          eos_id=tok.info.end_id)
        return tok.decode(tokens[0, : int(num[0])].tolist())

    def _load_image(self, value) -> np.ndarray:
        """Accept a path, bytes, a PIL image, or a preprocessed array."""
        from ..data.images import decode_image, preprocess

        size = self.model.cfg.siglip.image_size
        if isinstance(value, np.ndarray):
            return value.astype(np.float32)
        if isinstance(value, (str, bytes)):
            if isinstance(value, str):
                with open(value, "rb") as f:
                    value = f.read()
            return preprocess(decode_image(value), size)
        return preprocess(value, size)  # PIL image
