"""The multi-image (interleaved) route of the port against ``aki_tpu`` at
aki_tiny in fp32: ``splice_vision_tokens_multi`` output for output (images
present, missing and parked, ``<|assistant|>`` before, between and after
the images, or absent), ``aki_forward`` on 5-D images (logits and loss
within 1e-5), one train step on an interleaved batch under ``dots``,
``dots_nowide`` and ``host_offload`` (gradients within 1e-5 of each
tensor's norm against ``jax.grad`` of the JAX loss on one device, no mesh,
under the same setting; loss and grad_norm of the JAX ``make_train_step``
within 1e-5 relative), and the 16-image limit of the card's kernels.

Inputs come from a numpy seed; weights move through
``aki_torch.convert.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.aki import aki_forward as jax_aki_forward
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.models.fusion import splice_vision_tokens_multi as jax_splice_multi
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import Batch as JaxBatch
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel, aki_forward
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny
from aki_torch.models.fusion import splice_vision_tokens_multi
from aki_torch.train import optim
from aki_torch.train.step import Batch, TrainState, make_loss_fn, make_train_step

from ._jax_tiny import tiny_params

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
MEDIA, ASSIST = 900, 901
TOL = 1e-5


def multi_ids(rng, b, t, layouts, media=MEDIA, assist=ASSIST, low=5, high=800):
    """Rows of random ids with ``<image>`` at the positions of each layout
    and ``<|assistant|>`` at its ``asst`` (None: absent)."""
    ids = rng.randint(low, high, size=(b, t)).astype(np.int32)
    for row, (imgs, asst) in enumerate(layouts):
        for p in imgs:
            ids[row, p] = media
        if asst is not None:
            ids[row, asst] = assist
    return ids


SPLICE_CASES = {
    # (text length, n_img, n_vis, per-row (image positions, assistant position))
    "all_present": (14, 2, 3, [([1, 6], 10), ([2, 4], 12)]),
    "missing_and_parked": (16, 3, 4, [([1, 7, 9], 12), ([3], 10), ([], 5)]),
    "assistant_before_between_after": (18, 3, 3, [([5, 9, 12], 2), ([1, 11, 15], 8),
                                                  ([2, 4, 6], 16)]),
    "no_assistant_more_media_than_slots": (12, 2, 5, [([1, 3, 8], None), ([0], None)]),
}


@pytest.mark.parametrize("case", list(SPLICE_CASES))
def test_splice_multi_matches_jax(case):
    t_txt, n_img, n_vis, layouts = SPLICE_CASES[case]
    rng = np.random.RandomState(sorted(SPLICE_CASES).index(case))
    b, d = len(layouts), 5
    ids = multi_ids(rng, b, t_txt, layouts)
    valid = np.ones((b, t_txt), np.int32)
    valid[-1, t_txt - 3:] = 0
    labels = np.where(rng.rand(b, t_txt) < 0.7, ids, -100).astype(np.int32)
    embeds = rng.randn(b, t_txt, d).astype(np.float32)
    vis = rng.randn(b, n_img, n_vis, d).astype(np.float32)

    want = jax.jit(jax_splice_multi, static_argnums=(4, 5))(
        jnp.asarray(embeds), jnp.asarray(vis), jnp.asarray(ids), jnp.asarray(valid),
        MEDIA, ASSIST, labels=jnp.asarray(labels))
    got = splice_vision_tokens_multi(torch.from_numpy(embeds), torch.from_numpy(vis),
                                     torch.from_numpy(ids), torch.from_numpy(valid),
                                     MEDIA, ASSIST, labels=torch.from_numpy(labels))
    assert got.embeds.shape == (b, t_txt + n_img * (n_vis - 1), d)
    np.testing.assert_array_equal(got.embeds.numpy(), np.asarray(want.embeds))
    for name in ("attn_valid", "labels", "text_pos", "positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("img_start", "txt_start", "txt_end"):
        g, w = getattr(got.spec, name), np.asarray(getattr(want.spec, name))
        assert g.dtype == torch.int32 and g.shape == (b, n_img), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "missing_and_parked":
        # a parked image: an empty block and invalid positions past the text
        assert got.spec.img_start[1, 1:].tolist() == [0, 0]
        assert got.spec.txt_end[2].tolist() == [0, 0, 0]
        assert got.attn_valid[2, t_txt:].sum() == 0


@pytest.fixture(scope="module")
def params():
    return tiny_params(0)


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


def interleaved_batch(rng, b=3, t=24, n_img=3):
    """Interleaved rows as the MMC4 loader gives them: up to ``n_img``
    images per row (missing ones zero), one row with one image (two blocks
    parked), labels on every valid position."""
    layouts = [([1, 9, 15], 20), ([2], 11), ([1, 5], None)][:b]
    ids = multi_ids(rng, b, t, layouts, CFG.media_token_id, CFG.assistant_token_id,
                    high=CFG.initial_tokenizer_len - 1)
    valid = np.ones((b, t), np.int32)
    valid[1, t - 5:] = 0
    labels = np.where(valid == 1, ids, -100).astype(np.int32)
    s = CFG.siglip.image_size
    images = rng.randn(b, n_img, s, s, 3).astype(np.float32)
    for row, (imgs, _) in enumerate(layouts):
        images[row, len(imgs):] = 0
    return Batch(ids, images, valid, labels)


def test_aki_forward_5d_matches_jax(params):
    batch = interleaved_batch(np.random.RandomState(3))
    def forward(p, ids, images, valid, labels):
        out = jax_aki_forward(p, CFG_J, ids, images, valid, labels=labels, policy=JAX_F32,
                              use_flash=False)
        return out.logits, out.loss

    want_logits, want_loss = jax.jit(forward)(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(x) for x in (
            batch.input_ids, batch.images, batch.attn_valid, batch.labels)))
    model = port_model(params)
    with torch.no_grad():
        got = aki_forward(model, batch.input_ids, batch.images, batch.attn_valid,
                          labels=batch.labels, policy=F32, device="cpu")
    assert got.spliced.spec.img_start.shape == (3, 3)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.loss.item(), float(want_loss), rtol=TOL)


@pytest.mark.parametrize("policy", ["dots", "dots_nowide", "host_offload"])
def test_interleaved_train_step_matches_jax(params, policy, monkeypatch):
    """Each side under the same policy: the JAX decoder reads
    ``AKI_REMAT_POLICY`` when it traces; ``host_offload`` is the step's flag
    on both (pinned host memory in JAX, the ``full`` policy in the port)."""
    offload = policy == "host_offload"
    remat_policy = "full" if offload else policy
    monkeypatch.setenv("AKI_REMAT_POLICY", "dots" if offload else policy)
    batch = interleaved_batch(np.random.RandomState(4))
    jb = JaxBatch(*(jnp.asarray(x) for x in (batch.input_ids, batch.images,
                                             batch.attn_valid, batch.labels)))
    jparams = jax.tree.map(jnp.asarray, params)
    jgrads = jax.jit(jax.grad(jax_make_loss_fn(CFG_J, JAX_F32, True, False,
                                               host_offload=offload)))(jparams, jb)
    want_grads = from_jax_params(jax.tree.map(np.asarray, jgrads), CFG)
    opt = jax_optim.make_optimizer(params, 1e-3, weight_decay=0.1, grad_clip=1.0)
    jstep = jax.jit(jax_make_train_step(CFG_J, opt, policy=JAX_F32, remat=True,
                                        use_flash=False, host_offload=offload))
    _, m = jstep(JaxTrainState.create(jparams, opt), jb)

    model = port_model(params)
    make_loss_fn(CFG, F32, remat=True, use_flash=True, remat_policy=remat_policy,
                 device="cpu", host_offload=offload)(model, batch).backward()
    for name, p in model.named_parameters():
        if optim.is_frozen_path(name):
            assert p.grad is None, name
            continue
        want = want_grads[name]
        tol = TOL * max(float(want.norm()), 1e-3)
        assert float((p.grad - want).abs().max()) <= tol, name

    model = port_model(params)
    state = TrainState(model, optim.make_optimizer(model, 1e-3, weight_decay=0.1,
                                                   grad_clip=1.0))
    got = make_train_step(CFG, policy=F32, remat=True, remat_policy=remat_policy,
                          device="cpu", host_offload=offload)(state, batch)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=TOL)


def test_sixteen_image_limit():
    """The kernels take at most MAX_IMAGES rectangles a row: the mask
    marshalling raises above it, and the pretrain CLI refuses such an
    interleaved dataset when it builds its configs for the card (not for
    the CPU, whose plain versions take any number)."""
    from aki_torch.configs.loader import Config
    from aki_torch.ops.flash_mma_args import MAX_IMAGES, kernel_mask_args
    from aki_torch.ops.masks import MMASpec
    from aki_torch.train.pretrain import dataset_configs

    assert MAX_IMAGES == 16
    for n in (16, 17):
        z = torch.zeros((2, n), dtype=torch.int32)
        if n > MAX_IMAGES:
            with pytest.raises(ValueError, match="at most 16 images"):
                kernel_mask_args(MMASpec(z, z, z), None, 0, 2, 40, "cpu")
        else:
            assert kernel_mask_args(MMASpec(z, z, z), None, 0, 2, 40, "cpu")[3] == n

    def cfg(n):
        return Config(datasets={"mmc4": {"shards": "x.tar", "max_num_images": n}})
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with pytest.raises(ValueError, match="flash_mma_args.MAX_IMAGES = 16"):
        dataset_configs(cfg(17), CFG, 0, cuda)
    assert dataset_configs(cfg(16), CFG, 0, cuda)[0][0].max_num_images == 16
    assert dataset_configs(cfg(17), CFG, 0, cpu)[0][0].max_num_images == 17
