"""Checkpoint import CLI: reference PyTorch weights -> a port run dir
(counterpart of ``aki_tpu/convert/cli.py``).

The port's parameters carry the reference checkpoint's names, so nothing is
re-laid out: the import gathers the weights a reference user has and writes
them as one ``CheckpointManager`` checkpoint, tower included, that
``AKI.from_pretrained`` and the eval / demo / predict CLIs read:

- ``--torch-checkpoint``: an AKI training checkpoint
  (``checkpoint_{epoch}.pt`` with ``model_state_dict``; a DDP ``module.``
  prefix is stripped; the vision encoder is absent by the reference's own
  filter, ``train_utils.py:376-410``), or the JAX package's export
  (``aki_tpu/convert/jax_to_torch.py:save_torch_checkpoint``);
- ``--siglip``: a local HF ``SiglipVisionModel`` directory (safetensors or
  ``pytorch_model*.bin``) for the frozen tower: ``vision_model.X`` becomes
  ``vision_encoder.X``; HF's pooling head (``vision_model.head.*``) is
  dropped, as the port has none;
- ``--phi3``: optional local HF Phi-3 directory, read for the LongRoPE
  factors of its ``config.json`` (checked against the baked-in ones).

Every weight of the model must be present, at its shape, except the two
head biases, which default to zeros as in ``from_jax_params``.

Usage:
    python -m aki_torch.convert.cli --torch-checkpoint ckpt.pt \
        --siglip /models/siglip-so400m --out runs/imported
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from ..models.aki import AKIModel
from ..models.configs import AKIConfig, aki_4b
from ..train.checkpoints import CheckpointManager
from ..train.optim import is_frozen_path

HEAD_BIASES = ("lang_model.lm_head.bias", "lang_model.lm_head.additional_fc.bias")


def load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """(model state dict without a ``module.`` prefix, the whole file), the
    tensors memory-mapped."""
    blob = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    sd = blob.get("model_state_dict", blob)
    return {k.removeprefix("module."): v for k, v in sd.items()}, blob


def load_hf_dir_state_dict(path: str) -> dict:
    """Every tensor of a local HF model dir (safetensors preferred)."""
    p = Path(path)
    sd = {}
    st_files = sorted(p.glob("*.safetensors"))
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            sd.update(load_file(str(f)))
        return sd
    bins = sorted(p.glob("pytorch_model*.bin"))
    if bins:
        for f in bins:
            sd.update(torch.load(str(f), map_location="cpu", mmap=True))
        return sd
    raise FileNotFoundError(f"no safetensors / bin files under {path}")


def rope_factors_from_config(path: str) -> dict:
    cfg = json.loads((Path(path) / "config.json").read_text())
    rs = cfg.get("rope_scaling") or {}
    out = {}
    if rs.get("type") == "longrope" or rs.get("rope_type") == "longrope":
        out["rope_short_factor"] = tuple(rs["short_factor"])
        out["rope_long_factor"] = tuple(rs["long_factor"])
    return out


def siglip_state_dict(hf_sd: dict) -> dict:
    """HF ``SiglipVisionModel`` weights under the port's ``vision_encoder.``
    names, without the pooling head."""
    return {"vision_encoder." + k.removeprefix("vision_model."): v
            for k, v in hf_sd.items()
            if k.startswith("vision_model.") and not k.startswith("vision_model.head.")}


def import_checkpoint(torch_checkpoint: str, out_dir: str, siglip: str | None = None,
                      phi3: str | None = None, cfg: AKIConfig | None = None) -> Path:
    """Write ``out_dir``'s checkpoint (tower included) from the reference
    weights; returns its path."""
    cfg = cfg or aki_4b()
    if phi3:
        factors = rope_factors_from_config(phi3)
        for key, val in factors.items():
            baked = getattr(cfg.phi3, key)
            if baked is not None and tuple(baked) != tuple(val):
                print(f"WARNING: {key} from {phi3}/config.json differs from the baked-in "
                      "Phi-3.5 factors; the checkpoint's values are authoritative: run "
                      "it with a config that carries them")
        cfg = dataclasses.replace(cfg, phi3=dataclasses.replace(cfg.phi3, **factors))

    sd, blob = load_torch_state_dict(torch_checkpoint)
    if not any(k.startswith("lang_model.") for k in sd):
        raise ValueError("checkpoint lacks lang_model.* keys — the reference always saves "
                         "the (trainable) language backbone (train_utils.py:376-410)")
    if not any(is_frozen_path(k) for k in sd):
        if not siglip:
            raise ValueError("checkpoint has no vision encoder (the reference drops it); "
                             "pass --siglip with a local SigLIP model dir")
        sd.update(siglip_state_dict(load_hf_dir_state_dict(siglip)))

    # the model's names and shapes, without its memory
    want = AKIModel(cfg, device="meta", generator=torch.Generator()).state_dict()
    for k in HEAD_BIASES:
        if k not in sd:
            sd[k] = torch.zeros(want[k].shape)
    missing = sorted(set(want) - set(sd))
    if missing:
        raise ValueError(f"{len(missing)} weights missing, e.g. {missing[:4]}")
    bad = [k for k in want if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"{len(bad)} weights have another shape than the config's, e.g. "
                         + ", ".join(f"{k} {tuple(sd[k].shape)} != {tuple(want[k].shape)}"
                                     for k in bad[:4]))
    path = CheckpointManager(out_dir).save_weights(
        {k: sd[k] for k in want}, epoch=int(blob.get("epoch", 0)),
        step=int(blob.get("step", 0)))
    print(f"imported -> {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--siglip", default=None)
    ap.add_argument("--phi3", default=None)
    args = ap.parse_args(argv)
    import_checkpoint(args.torch_checkpoint, args.out, siglip=args.siglip, phi3=args.phi3)


if __name__ == "__main__":
    main()
