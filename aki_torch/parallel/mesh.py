"""The device mesh over ``torch.distributed`` (counterpart of
``aki_tpu/parallel/mesh.py``).

One process per card (``torchrun``), one ``DeviceMesh`` over all of them
with the JAX package's six named axes:

- ``data``   — replicated parameters, the batch split (with ``fsdp``: FSDP2's
               HSDP, replicate over ``data``, shard over ``fsdp``);
- ``fsdp``   — ZeRO-3 / ZeRO-2 parameter sharding (FSDP2 ``fully_shard``);
- ``tensor`` — Megatron heads and MLP columns (:mod:`aki_torch.parallel.tensor`);
- ``seq``    — decoder activations split along T, attention by the ring
               (:mod:`aki_torch.ops.ring_attention`) or the K/V all-gather;
- ``pipe``   — GPipe stages (:mod:`aki_torch.parallel.pipeline`);
- ``expert`` — the MoE experts (:mod:`aki_torch.parallel.expert`).

The batch is split the way JAX's ``batch_sharding`` splits one global
array: every rank builds the same global batch from the seed and keeps its
``(data, fsdp)`` rows (:func:`batch_rows`). That costs each rank the host
work of the whole batch, and gives exactly the rows JAX gives each device.

NCCL runs on the cards and gloo on the CPU, and the CPU only when the
caller asks for it (``device="cpu"``). The mesh covers the whole world:
JAX may take a sub-mesh of the first prod(sizes) devices, torch's
``init_device_mesh`` may not, so a mesh smaller than the world raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)

BATCH_AXES = (DATA_AXIS, FSDP_AXIS)  # activation batch dim spans both


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """-1 means "absorb remaining devices" (exactly one axis may be -1)."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    data_on_dcn: bool = False   # data outermost across slices; one host has none


def resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> tuple[int, ...]:
    sizes = [cfg.data, cfg.fsdp, cfg.tensor, cfg.seq, cfg.pipe, cfg.expert]
    n_auto = sum(1 for s in sizes if s == -1)
    if n_auto > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = int(np.prod([s for s in sizes if s != -1]))
    if n_auto == 1:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by {fixed}")
        sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) > n_devices:
        raise ValueError(f"mesh {sizes} needs more than {n_devices} devices")
    return tuple(sizes)


def init_distributed(device="cuda", timeout_s: float = 600.0) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL
    for ``"cuda"``, after ``torch.cuda.set_device(LOCAL_RANK)``, gloo for
    ``"cpu"``. Returns this rank's device. Without torchrun's environment
    it raises rather than run as one rank."""
    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("init_distributed: RANK/WORLD_SIZE not set; run under torchrun")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("aki_torch: no CUDA device; pass device='cpu' to run on "
                               "the CPU")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=timeout_s),
                                **({"device_id": device} if device.type == "cuda" else {}))
    return device


class Mesh:
    """The ``DeviceMesh`` of :data:`AXES` over the world
    (``init_device_mesh(device_type, sizes, mesh_dim_names=AXES)``: the
    counterpart of JAX's ``create_mesh``), and the process groups of the
    axis combinations the modes reduce over, taken from it. ``device_type`` is
    ``"cuda"`` under NCCL, ``"cpu"`` under gloo."""

    def __init__(self, cfg: MeshConfig, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("Mesh: no process group; call init_distributed() first")
        world = dist.get_world_size()
        sizes = resolve_axis_sizes(cfg, world)
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(zip(AXES, sizes))} covers {math.prod(sizes)} of "
                             f"{world} ranks: the mesh must cover the world")
        self.cfg = cfg
        self.sizes = dict(zip(AXES, sizes))
        self.device_mesh = init_device_mesh(device_type, sizes, mesh_dim_names=AXES)
        self.rank = dist.get_rank()
        self._groups: dict[tuple[str, ...], dist.ProcessGroup] = {}

    @property
    def shape(self) -> dict[str, int]:
        return self.sizes

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's index in the flattened ``axes`` (the first axis major,
        as JAX flattens ``P(("data", "fsdp"))``)."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coord(a)
        return i

    def group(self, *axes: str) -> dist.ProcessGroup:
        """The process group of the ranks that share this rank's coordinates
        on every axis but ``axes`` (given in :data:`AXES` order; their group
        rank is the flattened index, the first axis major). The mesh's own
        groups: one axis is its dimension's, several are the flattened
        sub-mesh's (made once, on first use; every rank must ask for the
        same ones in the same order)."""
        key = tuple(axes)
        if key not in self._groups:
            sub = (self.device_mesh[key[0]] if len(key) == 1
                   else self.device_mesh[key]._flatten("_".join(key)))
            self._groups[key] = sub.get_group()
        return self._groups[key]

    def sub_mesh(self, *axes: str):
        """The ``DeviceMesh`` of ``axes`` through this rank."""
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]


def batch_rows(x, mesh: Mesh | None, stacked: bool = False):
    """This rank's ``(data, fsdp)`` rows of a global batch: ``x`` an array,
    a tensor, a dataclass of them (``Batch``) or a tuple of such; the batch
    axis is 0, or 1 when ``stacked`` (grad accumulation's leading
    micro-batch axis). ``None`` mesh: ``x`` as it is."""
    if mesh is None or x is None:
        return x
    if isinstance(x, tuple):
        return tuple(batch_rows(b, mesh, stacked) for b in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: batch_rows(getattr(x, f.name), mesh, stacked)
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), (np.ndarray, torch.Tensor))})
    n, i = mesh.size(*BATCH_AXES), mesh.index(*BATCH_AXES)
    axis = 1 if stacked else 0
    b = x.shape[axis]
    if b % n:
        raise ValueError(f"batch {b} must divide data*fsdp={n}")
    rows = b // n
    sl = (slice(None),) * axis + (slice(i * rows, (i + 1) * rows),)
    return x[sl]
