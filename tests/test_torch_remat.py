"""The recompute policies of the port (``aki_torch.models.common
.REMAT_POLICIES``, counterpart of ``aki_tpu/models/phi3.py _remat_policy``)
and the JAX step's ``host_offload`` at aki_tiny in fp32: every policy gives
the loss and gradients of the step without recompute (within 1e-6; the
same operations on the same inputs); what each keeps between the forward
and the backward, counted where a region keeps it (``common._keep``):
``full`` nothing, ``dots`` every product's output in place, ``dots_nowide``
none of the MLP's wide gate/up product, ``host_offload`` nothing (it is
``full``); the attention forward is recomputed under each (its calls
counted); and the CLIs' ``AKI_REMAT_POLICY``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aki_torch.models import common
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny
from aki_torch.ops import flash_mma
from aki_torch.train.step import Batch, make_loss_fn

CFG = aki_tiny()
POLICIES = ("full", "dots", "dots_nowide", "host_offload")


def batch(cfg, rng, b=2, t=16):
    ids = rng.randint(5, cfg.initial_tokenizer_len - 1, size=(b, t)).astype(np.int32)
    ids[:, 1] = cfg.media_token_id
    ids[:, 9] = cfg.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, t - 4:] = 0
    labels = np.where((np.arange(t)[None] > 9) & (valid == 1), ids, -100).astype(np.int32)
    s = cfg.siglip.image_size
    return Batch(ids, rng.randn(b, s, s, 3).astype(np.float32), valid, labels)


def run(cfg, policy, monkeypatch, b=None):
    """Loss, gradients, the tensors the regions kept (shape, device, shares
    the forward output's storage) and the attention forward's calls."""
    kept, calls = [], []
    keep, plain = common._keep, flash_mma.flash_mma_attention_reference

    def spy_keep(out):
        k = keep(out)
        kept.append((tuple(out.shape), k.device.type,
                     k.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()))
        return k

    def spy_plain(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)
    monkeypatch.setattr(common, "_keep", spy_keep)
    monkeypatch.setattr(flash_mma, "flash_mma_attention_reference", spy_plain)
    model = AKIModel(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.vision_encoder.requires_grad_(False)
    offload = policy == "host_offload"
    loss_fn = make_loss_fn(cfg, F32, remat=policy is not None, use_flash=True,
                           remat_policy="full" if policy is None or offload else policy,
                           device="cpu", host_offload=offload)
    loss = loss_fn(model, b or batch(cfg, np.random.RandomState(0)))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    monkeypatch.undo()
    return loss.item(), grads, kept, len(calls)


@pytest.fixture(scope="module")
def no_remat():
    with pytest.MonkeyPatch.context() as mp:
        return run(CFG, None, mp)


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_keep_loss_and_grads(no_remat, monkeypatch, policy):
    loss, grads, kept, calls = run(CFG, policy, monkeypatch)
    want_loss, want_grads, _, plain_calls = no_remat
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    assert grads.keys() == want_grads.keys() and len(grads) > 20
    for n, g in grads.items():
        torch.testing.assert_close(g, want_grads[n], rtol=1e-6, atol=1e-8, msg=n)
    # the attention forward runs again in every recompute: the tower's
    # layers once (no gradient, no recompute), each decoder layer twice
    p = CFG.phi3
    assert plain_calls == CFG.siglip.num_layers + p.num_layers
    assert calls == CFG.siglip.num_layers + 2 * p.num_layers
    n_products = 5 * CFG.perceiver.depth + 4 * p.num_layers
    if policy in ("full", "host_offload"):
        assert kept == []
    else:
        assert len(kept) == n_products          # every product of every region
        widths = {s[-1] for s, *_ in kept}
        assert {(p.num_heads + 2 * p.num_kv_heads) * p.head_dim,
                2 * p.intermediate_size} <= widths
        assert all(shared for *_, shared in kept)    # kept in place, no copy


def test_dots_nowide_drops_the_wide_mlp_product(monkeypatch):
    """At AKI-4B's MLP width (8,192 for gate and for up, one fused product of
    16,384 here) dots keeps the fused product and dots_nowide does not; it
    keeps the rest (qkv 3 x 64 at this width, o, down, the perceiver's)."""
    cfg = dataclasses.replace(CFG, phi3=dataclasses.replace(CFG.phi3, intermediate_size=8192))
    b = batch(cfg, np.random.RandomState(1))
    dots = run(cfg, "dots", monkeypatch, b)
    nowide = run(cfg, "dots_nowide", monkeypatch, b)
    wide = 2 * 8192
    assert sum(s[-1] == wide for s, *_ in dots[2]) == cfg.phi3.num_layers
    assert not any(s[-1] > common.WIDE_PRODUCT for s, *_ in nowide[2])
    assert len(nowide[2]) == len(dots[2]) - cfg.phi3.num_layers
    assert dots[0] == nowide[0]
    for n, g in dots[1].items():
        torch.testing.assert_close(nowide[1][n], g, rtol=1e-6, atol=1e-8, msg=n)


def test_every_product_of_a_region_is_kept(monkeypatch):
    """The regions keep products where ``common.linear`` computes them:
    every matrix product without batch dims that a region's forward runs
    (counted at dispatch) is one of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in common._PRODUCTS and getattr(common._REGION, "mode", None) is not None:
                CountProducts.n += 1
            return func(*args, **(kwargs or {}))

    kept = []
    keep = common._keep
    monkeypatch.setattr(common, "_keep", lambda out: kept.append(out.shape) or keep(out))
    model = AKIModel(CFG, device="cpu", generator=torch.Generator().manual_seed(1))
    model.vision_encoder.requires_grad_(False)
    loss_fn = make_loss_fn(CFG, F32, remat=True, use_flash=True, remat_policy="dots",
                           device="cpu")
    with CountProducts():
        loss = loss_fn(model, batch(CFG, np.random.RandomState(2)))
    assert CountProducts.n == len(kept) == 5 * CFG.perceiver.depth + 4 * CFG.phi3.num_layers
    loss.backward()


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat policy"):
        common.remat_call(True, "everything", lambda x: x, torch.ones(1, requires_grad=True))


def test_cli_reads_aki_remat_policy(monkeypatch):
    from aki_torch.train.cli import remat_policy

    monkeypatch.delenv("AKI_REMAT_POLICY", raising=False)
    assert remat_policy() == "dots"
    for name in ("dots_nowide", "full"):
        monkeypatch.setenv("AKI_REMAT_POLICY", name)
        assert remat_policy() == name
    for name in ("host_offload", "dotz"):
        monkeypatch.setenv("AKI_REMAT_POLICY", name)
        with pytest.raises(ValueError, match="AKI_REMAT_POLICY"):
            remat_policy()
