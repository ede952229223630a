"""What the two training CLIs share (:mod:`aki_torch.train.pretrain`,
:mod:`aki_torch.train.sft`): arguments, the model configuration, the
recompute policy, the multi-device keys and the refusal of what the port
does not run.

The JAX CLIs' YAML keys are read the same way. ``mesh`` (a
:class:`~aki_torch.parallel.mesh.MeshConfig`), ``fsdp_strategy``,
``host_offload_params`` and ``pp_microbatches`` reach the runner; under
``torchrun`` the CLI joins the process group first
(:func:`~aki_torch.parallel.mesh.init_distributed`) and every rank reads the
same data, keeping its rows of each batch. Training over the ``tensor``
axis raises ``NotImplementedError`` naming ROADMAP Queue 1 item 10 rather
than being ignored. ``moe_aux_weight`` is read into the runner, as in JAX,
though the CLIs build the dense model, as JAX's do. One key is not read:
``accum_unroll`` unrolls the JAX step's compiled accumulation scan, and the
loop here is eager (ROADMAP Queue 3). ``host_offload`` is read: the
``full`` recompute policy (``train/step.py``).
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..models.common import REMAT_POLICIES
from ..models.configs import AKIConfig, aki_4b, aki_tiny, config_for_tokenizer
from ..parallel.mesh import MeshConfig, init_distributed

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


def mesh_config(cfg) -> MeshConfig:
    """The YAML's ``mesh`` block (JAX's default: fsdp absorbs the devices)."""
    return MeshConfig(**{**MESH_AXES, **((cfg or {}).get("mesh") or {})})


def parallel_fields(cfg, tc) -> dict:
    """The runner's multi-device fields from the YAML."""
    return dict(mesh=mesh_config(cfg), fsdp_strategy=tc.get("fsdp_strategy", "full"),
                host_offload_params=tc.get("host_offload_params", False),
                pp_microbatches=tc.get("pp_microbatches"))


def join_group(device: str) -> str:
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set), join the
    process group; returns the device to run on (this rank's card)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return str(init_distributed(device))
    return device


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def refuse_unported(cfg, tc) -> None:
    """Raise, before anything is loaded, on what the trainer would refuse:
    a mesh that needs more devices than the process group has (ValueError;
    JAX's), a bad ``fsdp_strategy`` (ValueError) and the multi-device mode
    not ported yet, training over the ``tensor`` axis (NotImplementedError
    naming ROADMAP Queue 1 item 10)."""
    from ..parallel.fsdp import check_strategy
    from ..parallel.mesh import resolve_axis_sizes

    mesh = mesh_config(cfg)
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = dict(zip(MESH_AXES, resolve_axis_sizes(mesh, world)))
    if sizes["tensor"] > 1:
        raise NotImplementedError(
            f"mesh tensor={sizes['tensor']}: training over the tensor axis is not ported "
            "(ROADMAP Queue 1 item 10)")
    check_strategy(tc.get("fsdp_strategy", "full"))
