"""Modality-mutual attention (MMA) mask specification
(counterpart of ``aki_tpu/ops/masks.py``).

The mask is three integers per (sample, image), never a dense tensor
outside the plain versions:

    attend(q, k) = valid_k  AND  ( k <= q
                                   OR (img_start <= q < txt_start
                                       AND txt_start <= k < txt_end) )

unioned over images. ``causal`` is a spec with an empty block.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MMASpec:
    """Block-mask coordinates: int32 tensors of shape ``(B,)`` (one image)
    or ``(B, N_img)`` (the mask is the union over images), in spliced
    coordinates."""

    img_start: torch.Tensor
    txt_start: torch.Tensor
    txt_end: torch.Tensor

    @property
    def batch(self) -> int:
        return self.img_start.shape[0]

    def with_batch_dim(self) -> "MMASpec":
        """Normalize to ``(B, N_img)`` shape."""
        if self.img_start.dim() == 1:
            return MMASpec(
                img_start=self.img_start[:, None],
                txt_start=self.txt_start[:, None],
                txt_end=self.txt_end[:, None],
            )
        return self


def causal_spec(batch: int, device="cpu") -> MMASpec:
    """A spec whose MMA block is empty — plain causal attention."""
    z = torch.zeros((batch,), dtype=torch.int32, device=device)
    return MMASpec(img_start=z, txt_start=z, txt_end=z)


def allowed_mask(
    spec: MMASpec,
    q_len: int,
    kv_len: int,
    kv_valid: torch.Tensor | None = None,
    q_offset: torch.Tensor | int = 0,
    kv_offset: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Dense boolean mask ``(B, q_len, kv_len)``; True = may attend.

    ``q_offset`` (scalar or ``(B,)``) is the absolute position of query row
    0, ``kv_offset`` that of key 0 (a block of a sharded sequence);
    ``kv_valid`` is an optional ``(B, kv_len)`` 0/1 key validity.
    """
    spec = spec.with_batch_dim()
    b, dev = spec.batch, spec.img_start.device
    q_pos = (torch.arange(q_len, device=dev)[None, :, None]
             + torch.as_tensor(q_offset, device=dev).to(torch.int64).expand(b)[:, None, None])
    k_pos = (torch.arange(kv_len, device=dev)[None, None, :]
             + torch.as_tensor(kv_offset, device=dev).to(torch.int64).expand(b)[:, None, None])
    out = k_pos <= q_pos

    # union of per-image MMA blocks: (B, N, 1, 1) against (B, 1, q, k)
    i0 = spec.img_start[:, :, None, None]
    t0 = spec.txt_start[:, :, None, None]
    t1 = spec.txt_end[:, :, None, None]
    qp, kp = q_pos[:, None], k_pos[:, None]
    blocks = (qp >= i0) & (qp < t0) & (kp >= t0) & (kp < t1)
    out = out | blocks.any(dim=1)
    if kv_valid is not None:
        out = out & (kv_valid[:, None, :] != 0)
    return out
