"""Tensor parallelism of the decoder for serving (counterpart of the JAX
package's ``tp_mesh`` routes: ``aki_tpu/models/phi3.py:387-410``,
``aki_tpu/infer/server.py:285-305``).

:func:`shard_tensor_parallel` cuts each decoder weight to this rank's
block along the ``tensor`` dim that :mod:`aki_torch.parallel.sharding`
gives it (Megatron: q/k/v and gate/up by rows, part by part; o_proj and
down_proj by columns; the LM head by vocab rows), and makes the decoder's
``cfg`` the local head and column counts, so that the layer code, the KV
caches and the kernels see local heads only: attention runs on them with
no collective, by the layer's own :func:`~aki_torch.ops.flash_mma.flash_mma_attention`
(the JAX package's ``flash_mma_attention_tp``,
``aki_tpu/ops/flash_mma.py:871-913``, is that call inside a ``shard_map``
over the heads; here the heads are already local), the int8 KV cache holds them on its head-major last dim, and the two
row-parallel products are summed over the group. The head's logits are
gathered along the vocab.

The weights are plain local tensors, not DTensors: the port's layers call
``F.linear`` (and the int8 ``mm``) on the weights themselves, which module
hooks such as ``parallelize_module``'s would not see. The vision tower,
the Perceiver and the embedding tables stay whole on every rank.
Inference only: the all-reduce is not differentiable here, and the
trainer refuses ``tensor`` > 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .sharding import fit_spec, local_slice, parts_for_path, spec_for_path


@dataclasses.dataclass
class TensorParallel:
    group: dist.ProcessGroup
    rank: int
    size: int

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("tensor parallelism is inference-only in the port")
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate the ranks' ``x`` along the last dim, in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)


def shard_tensor_parallel(model, mesh):
    """Cut ``model``'s decoder and head to this rank's ``tensor`` block, in
    place; returns the model. Heads, KV heads and MLP columns must divide
    the axis (``ValueError``); the MoE decoder and quantized weights raise
    ``NotImplementedError`` (ROADMAP Queue 1 item 10)."""
    from ..models.quant import is_quantized

    n, rank = mesh.shape["tensor"], mesh.coord("tensor")
    cfg = model.cfg
    p = cfg.phi3
    if p.moe is not None:
        raise NotImplementedError("tensor parallelism of the MoE decoder is not ported "
                                  "(ROADMAP Queue 1 item 10)")
    for what, count in (("num_heads", p.num_heads), ("num_kv_heads", p.num_kv_heads),
                        ("intermediate_size", p.intermediate_size)):
        if count % n:
            raise ValueError(f"{what}={count} must divide the 'tensor' axis ({n})")
    lm = model.lang_model
    if any(is_quantized(m) for layer in lm.model.layers for m in layer.self_attn.values()):
        raise NotImplementedError(
            "W8A8 weights under tensor parallelism are not ported: JAX's $-anchored rules "
            "replicate a quantized tree (ROADMAP Queue 1 item 10)")
    tp = TensorParallel(mesh.group("tensor"), rank, n)
    with torch.no_grad():
        for name, param in lm.named_parameters(prefix="lang_model"):
            parts = parts_for_path(name, cfg)
            spec = fit_spec(spec_for_path(name), param.shape, mesh.shape, parts)
            if name.endswith("embed_tokens.weight") or "additional" in name:
                continue  # the tables and the extra head stay whole
            local = local_slice(param.data, spec, "tensor", rank, n, parts)
            if local is not param.data:
                param.data = local.contiguous()
    lm.model.cfg = dataclasses.replace(p, num_heads=p.num_heads // n,
                                       num_kv_heads=p.num_kv_heads // n,
                                       intermediate_size=p.intermediate_size // n)
    lm.model.tp = tp
    head_spec = fit_spec(spec_for_path("lang_model.lm_head.weight"),
                         (p.vocab_size, p.hidden_size), mesh.shape)
    lm.lm_head.tp = tp if head_spec and head_spec[0] == "tensor" else None
    return model
