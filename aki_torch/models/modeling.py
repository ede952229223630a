"""High-level model API (counterpart of ``aki_tpu/models/modeling.py``).

The reference's inference class is ``modeling_aki.AKI``, which loads its
backbones itself and offers ``AKI.from_pretrained``. :class:`AKI` is that
class here: the ``nn.Module`` (:class:`~aki_torch.models.aki.AKIModel`, so
named after the JAX package's parameter tree), its tokenizer and its
compute policy behind ``from_pretrained(run_dir)`` and ``forward`` /
``generate`` / ``answer`` — the surface external eval harnesses integrate
against. (The JAX package names this class ``AKIModel``; the port already
has a module of that name.)

One departure from the JAX package: a checkpoint that holds no
``vision_encoder.*`` weight is refused. The port's training checkpoints
leave the frozen tower out (``CheckpointManager.save`` without
``include_frozen``), and restoring one as JAX does would serve a random
tower; an imported run dir (``aki_torch.convert.cli``) carries it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..data.images import decode_image, preprocess
from ..data.sft.templates import SYSTEM_MESSAGE
from ..data.tokenizer import load_tokenizer
from ..train.checkpoints import CheckpointManager, load_weights
from ..train.optim import is_frozen_path
from .aki import AKIModel, AKIOutput, aki_forward
from .common import Policy, resolve_device
from .configs import AKIConfig, aki_4b, aki_tiny, config_for_tokenizer

CHAT_PROMPT = (
    "<s> <|system|>\n{system}<|end|>\n<|user|>\n<image>\n{question}<|end|>\n"
    "<|assistant|>\n"
)


def chat_prompt(question: str) -> str:
    """The reference eval/demo chat prompt around ``question``; tokenized
    without added specials (the literal ``<s> `` supplies bos, eval.py:81)."""
    return CHAT_PROMPT.format(system=SYSTEM_MESSAGE, question=question)


def checkpoint_path(run_dir: str) -> Path:
    """``run_dir`` itself when it is a file (a reference
    ``checkpoint_{epoch}.pt``), else the newest checkpoint of the run dir."""
    path = Path(run_dir)
    if path.is_file():
        return path
    latest = CheckpointManager(run_dir).latest() if path.is_dir() else None
    if latest is None:
        raise FileNotFoundError(f"no checkpoint_*.pt under {run_dir}")
    return latest


def restore(model: AKIModel, run_dir: str) -> dict:
    """Copy the weights of ``run_dir``'s checkpoint into ``model`` in place
    (the lenient rule of ``CheckpointManager.restore``; a ``module.`` prefix
    is stripped). The file is memory-mapped, so the host holds one copy of
    the weights at most. Returns the checkpoint's other entries."""
    blob = torch.load(checkpoint_path(run_dir), map_location="cpu", mmap=True,
                      weights_only=False)
    sd = blob.pop("model_state_dict", None)
    if sd is None:
        sd, blob = blob, {}
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if not any(is_frozen_path(k) for k in sd):
        raise ValueError(
            f"{run_dir} holds no vision_encoder.* weights, so the SigLIP tower "
            "would stay random: import the checkpoint with "
            "`python -m aki_torch.convert.cli --siglip DIR`, or save it with "
            "include_frozen=True")
    load_weights(model, sd)
    return blob


def load_model(cfg: AKIConfig, run_dir: str | None = None, seed: int = 0,
               device="cuda", dtype=torch.bfloat16) -> AKIModel:
    """The model at ``cfg`` in ``dtype`` on ``device``: random weights drawn
    from ``seed``, then ``run_dir``'s checkpoint restored over them."""
    device = resolve_device(device)
    model = AKIModel(cfg, device=device, dtype=dtype,
                     generator=torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    if run_dir:
        restore(model, run_dir)
    return model


@dataclasses.dataclass
class AKI:
    model: AKIModel
    tokenizer: object
    policy: Policy
    max_len: int = 1024

    @property
    def cfg(self) -> AKIConfig:
        return self.model.cfg

    @classmethod
    def from_pretrained(cls, run_dir: str | None = None,
                        tokenizer_path: str | None = None, tiny: bool = False,
                        seed: int = 0, device="cuda",
                        dtype=torch.bfloat16) -> "AKI":
        """The model of ``run_dir`` (a run dir, e.g. the output of
        ``aki_torch.convert.cli``, or one checkpoint file) at AKI-4B geometry
        (``tiny``: ``aki_tiny``) with the token layout of the tokenizer at
        ``tokenizer_path`` (the hash fixture when None). Without ``run_dir``
        the weights are random, drawn from ``seed``. Parameters and compute
        are in ``dtype``."""
        tokenizer = load_tokenizer(tokenizer_path)
        base = aki_tiny(tokenizer.info.vocab_size) if tiny else aki_4b()
        cfg = config_for_tokenizer(base, tokenizer.info)
        model = load_model(cfg, run_dir, seed, device, dtype)
        return cls(model=model, tokenizer=tokenizer,
                   policy=Policy(param_dtype=dtype, compute_dtype=dtype))

    # -- core API ------------------------------------------------------------
    def forward(self, input_ids, images, attn_valid=None, labels=None) -> AKIOutput:
        if attn_valid is None:
            attn_valid = np.ones(np.shape(input_ids), np.int32)
        return aki_forward(self.model, input_ids, images, attn_valid, labels=labels,
                           policy=self.policy, device=self.model.device)

    def generate(self, input_ids, images, attn_valid=None, max_new_tokens: int = 256,
                 **kw) -> tuple[torch.Tensor, torch.Tensor]:
        from ..infer.engine import generate

        if attn_valid is None:
            attn_valid = np.ones(np.shape(input_ids), np.int32)
        return generate(self.model, input_ids, images, attn_valid, max_new_tokens,
                        self.max_len, policy=self.policy, device=self.model.device, **kw)

    # -- convenience (chat) ----------------------------------------------------
    def answer(self, image_bytes: bytes, question: str, max_new_tokens: int = 256) -> str:
        ids = self.tokenizer.encode(chat_prompt(question))
        img = preprocess(decode_image(image_bytes), self.cfg.siglip.image_size)
        tokens, num = self.generate([ids], img[None], max_new_tokens=max_new_tokens,
                                    eos_id=self.tokenizer.info.end_id)
        return self.tokenizer.decode(tokens[0, : int(num[0])].tolist())
