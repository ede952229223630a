"""What the two training CLIs share (:mod:`aki_torch.train.pretrain`,
:mod:`aki_torch.train.sft`): arguments, the model configuration, the
recompute policy and the refusal of what the port does not run.

The JAX CLIs' YAML keys are read the same way. Keys that need a part of the
JAX package not ported yet raise ``NotImplementedError`` naming it (ROADMAP
Queue 1 item 10) rather than being ignored: a mesh of more than one device,
``fsdp_strategy`` other than ``full``, ``host_offload_params`` and
``pp_microbatches``. ``moe_aux_weight`` is read into the runner, as in
JAX, though the CLIs build the dense model, as JAX's do. One key is not
read: ``accum_unroll`` unrolls the JAX step's compiled accumulation scan,
and the loop here is eager (ROADMAP Queue 3).
``host_offload`` is read: the ``full`` recompute policy (``train/step.py``).
"""

from __future__ import annotations

import argparse
import os

from ..models.common import REMAT_POLICIES
from ..models.configs import AKIConfig, aki_4b, aki_tiny, config_for_tokenizer

MESH_AXES = {"data": 1, "fsdp": -1, "tensor": 1, "seq": 1, "pipe": 1, "expert": 1}


def parse_args(argv, description: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("overrides", nargs="*", help="key.path=value")
    return ap.parse_args(argv)


def model_config(cfg, tokenizer) -> AKIConfig:
    base = aki_tiny(tokenizer.info.vocab_size) if cfg.get("tiny") else aki_4b()
    return config_for_tokenizer(base, tokenizer.info)


def remat_policy() -> str:
    """``AKI_REMAT_POLICY`` as the JAX decoder reads it (default ``dots``);
    here a name outside the policies raises instead of meaning ``dots``."""
    name = os.environ.get("AKI_REMAT_POLICY", "dots")
    if name not in REMAT_POLICIES:
        raise ValueError(f"AKI_REMAT_POLICY={name!r}: one of {list(REMAT_POLICIES)}")
    return name


def refuse_unported(cfg, tc) -> None:
    """Raise on the keys that need the multi-device modes."""
    mesh = {**MESH_AXES, **(cfg.get("mesh") or {})}
    sizes = {k: mesh[k] for k in MESH_AXES}
    if sum(1 for s in sizes.values() if s == -1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if any(s not in (1, -1) for s in sizes.values()):
        raise NotImplementedError(
            f"mesh {sizes}: the port trains on one device; meshes of more are "
            "ROADMAP Queue 1 item 10")
    unported = {"fsdp_strategy": tc.get("fsdp_strategy", "full") != "full",
                "host_offload_params": bool(tc.get("host_offload_params", False)),
                "pp_microbatches": tc.get("pp_microbatches") is not None}
    for key, on in unported.items():
        if on:
            raise NotImplementedError(
                f"{key}={tc.get(key)!r}: not ported (ROADMAP Queue 1 item 10)")
