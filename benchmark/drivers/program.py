"""The one place the drivers reach the program, ``aki_torch``: its
configuration from a configuration file's ``model`` block, and its model
holding the weights the benchmark made."""

from __future__ import annotations

import torch


def aki_config(model: dict):
    """The port's :class:`AKIConfig` of a configuration file's ``model``."""
    from aki_torch.models.configs import (AKIConfig, PerceiverConfig, Phi3Config,
                                          SigLIPVisionConfig)

    phi3 = {k: tuple(v) if isinstance(v, list) else v for k, v in model["phi3"].items()}
    top = {k: v for k, v in model.items() if k not in ("phi3", "siglip", "perceiver")}
    return AKIConfig(phi3=Phi3Config(**phi3), siglip=SigLIPVisionConfig(**model["siglip"]),
                     perceiver=PerceiverConfig(**model["perceiver"]), **top)


def build_model(model: dict, weights: dict, dtype: torch.dtype, device):
    """The port's AKIModel in ``dtype`` on ``device`` holding ``weights``
    (every parameter by the reference checkpoint's name, checked strictly)."""
    from aki_torch.models.aki import AKIModel

    m = AKIModel(aki_config(model), device=device, dtype=dtype)
    m.load_state_dict(weights, strict=True)
    return m
