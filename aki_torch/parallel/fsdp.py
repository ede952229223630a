"""ZeRO-3 / ZeRO-2 with FSDP2 (counterpart of the ``fsdp`` axis and
``fsdp_strategy`` of ``aki_tpu/train/runner.py:114-156``).

:func:`shard_model` makes each SigLIP layer, each Perceiver block and each
decoder layer an FSDP2 unit (``fully_shard``), then the tower, the
Perceiver and the whole model (the embeddings, the head, the final norm):
a unit's parameters are all-gathered around its forward and its gradients
reduce-scattered after its backward.

- ``"full"`` (ZeRO-3): ``reshard_after_forward=True``, the weights are
  gathered again for the backward;
- ``"grad_op"`` (ZeRO-2, the reference's ``SHARD_GRAD_OP``):
  ``reshard_after_forward=False``, the gathered weights stay from the
  forward to the backward; gradients and AdamW moments stay sharded;
- with ``data`` > 1 the mesh is 2-D, FSDP2's HSDP: replicate over
  ``data``, shard over ``fsdp`` (JAX's rules never name ``data``).

FSDP2 averages the gradients over the batch ranks; the trainer's loss is
each rank's share of the global mean times their number
(:func:`aki_torch.models.aki.shard_token_loss`), so the average is the
global gradient. Between steps FSDP2 keeps the parameters sharded under
both strategies (JAX's ZeRO-2 keeps them replicated over ``fsdp``): what
``grad_op`` saves is the second gather.
"""

from __future__ import annotations

import torch

from .mesh import Mesh

FSDP_STRATEGIES = ("full", "grad_op")


def check_strategy(strategy: str) -> None:
    if strategy not in FSDP_STRATEGIES:
        raise ValueError(f"fsdp_strategy must be 'full' or 'grad_op', got {strategy!r}")


def batch_mesh(mesh: Mesh):
    """The ``DeviceMesh`` FSDP2 shards over: ``fsdp``, or (``data``,
    ``fsdp``) for HSDP."""
    if mesh.shape["data"] > 1:
        return mesh.sub_mesh("data", "fsdp")
    return mesh.sub_mesh("fsdp")


def units(model) -> list[torch.nn.Module]:
    """The modules made FSDP2 units, innermost first, the root last."""
    out = list(model.vision_encoder.encoder["layers"])
    out.append(model.vision_encoder)
    out.extend(model.vision_tokenizer.layers)
    out.append(model.vision_tokenizer)
    from .pipeline import decoder_layers

    out.extend(decoder_layers(model.lang_model.model))
    out.append(model)
    return out


def shard_model(model, mesh: Mesh, strategy: str = "full",
                compute_dtype: torch.dtype = torch.float32):
    """Apply FSDP2 to ``model`` (an :class:`~aki_torch.models.aki.AKIModel`
    built identically on every rank) in place; returns it.

    With a bf16 ``compute_dtype`` the units gather their weights in bf16
    and reduce their gradients in f32 (``MixedPrecisionPolicy``): every
    use of a weight casts it to the compute dtype anyway, and a weight's
    f32 gradient is its bf16 gradient cast up, so the numbers are those of
    the unsharded step, for half the gathered bytes. The units' inputs are
    not cast."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    check_strategy(strategy)
    dm = batch_mesh(mesh)
    mp = (MixedPrecisionPolicy(param_dtype=compute_dtype, reduce_dtype=torch.float32,
                               cast_forward_inputs=False)
          if compute_dtype != torch.float32 else MixedPrecisionPolicy())
    *inner, root = units(model)
    for unit in inner:
        fully_shard(unit, mesh=dm, reshard_after_forward=strategy == "full", mp_policy=mp)
    # the root's weights (the embeddings, the head, the final norm) stay
    # gathered until its backward: its output is an AKIOutput, on which
    # FSDP2 hooks no gather before the backward
    fully_shard(root, mesh=dm, reshard_after_forward=False, mp_policy=mp)
    return model
