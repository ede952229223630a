"""ZeRO-3, ZeRO-2 and data parallelism (FSDP2 on a 2-rank gloo group),
host offload of the state, and checkpoints across meshes, against the JAX
package's ``make_train_step`` on the global batch at aki_tiny in fp32.

One group runs every sharded case (``tests/_torch_dist_cases.py:zero_cases``);
the JAX side runs its unsharded step on one device (its own tests hold the
sharded JAX step to it: ``tests/test_zero2.py``,
``test_sharding_consistency.py``). Tolerances: gradients within 1e-5 of
each tensor's norm; 3 AdamW steps' loss and grad_norm within 1e-4;
checkpoints restore bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import Batch as JaxBatch
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.aki import AKIModel
from aki_torch.models.configs import aki_tiny
from aki_torch.train import optim
from aki_torch.train.step import Batch

from ._jax_tiny import tiny_params
from ._torch_dist import run_group
from ._torch_dist_cases import NoMetrics, run_config, state_numpy, train

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-4


def make_batch(rng, b=4, t=12):
    """Rows 0-1 (rank 0's under a 2-way batch split) carry labels from
    token 4, rows 2-3 from token 9: the ranks hold 14 and 4 labels."""
    ids = rng.randint(5, CFG.initial_tokenizer_len - 1, size=(b, t)).astype(np.int32)
    ids[:, 1] = CFG.media_token_id
    ids[:, 3] = CFG.assistant_token_id
    valid = np.ones((b, t), np.int32)
    valid[1, t - 3:] = 0
    start = np.array([3, 3, 8, 8])[:, None]
    labels = np.where(np.arange(t)[None] > start, ids, -100).astype(np.int32)
    labels[valid == 0] = -100
    imgs = rng.randn(b, CFG.siglip.image_size, CFG.siglip.image_size, 3).astype(np.float32)
    return Batch(ids, imgs, valid, labels)


def to_jax(batch: Batch) -> JaxBatch:
    return JaxBatch(input_ids=jnp.asarray(batch.input_ids), images=jnp.asarray(batch.images),
                    attn_valid=jnp.asarray(batch.attn_valid), labels=jnp.asarray(batch.labels))


def rows(batch: Batch, sl) -> Batch:
    return Batch(batch.input_ids[sl], batch.images[sl], batch.attn_valid[sl], batch.labels[sl])


def port_model(params) -> AKIModel:
    model = AKIModel(CFG, device="cpu")
    model.load_state_dict(from_jax_params(params, CFG), strict=True)
    return model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    params = tiny_params(0)
    batch = make_batch(np.random.RandomState(11))
    jb = to_jax(batch)
    loss_fn = jax_make_loss_fn(CFG_J, JAX_F32, False, False)
    jparams = jax.tree.map(jnp.asarray, params)
    grads = jax.jit(jax.grad(loss_fn))(jparams, jb)
    halves = [float(loss_fn(jparams, to_jax(rows(batch, sl))))
              for sl in (slice(0, 2), slice(2, 4))]
    opt = jax_optim.make_optimizer(params, 1e-3, weight_decay=0.1, grad_clip=1.0)
    state = JaxTrainState.create(jparams, opt)
    step = jax.jit(jax_make_train_step(CFG_J, opt, policy=JAX_F32, remat=True,
                                       use_flash=False))
    metrics = []
    for _ in range(3):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})

    weights = tmp / "weights.pt"
    torch.save(from_jax_params(params, CFG), weights)
    # a run dir written on one device after 3 steps, for the fsdp=2 restore
    from aki_torch.train.runner import Trainer

    single = Trainer(CFG, run_config(str(tmp / "single")), model=port_model(params),
                     device="cpu", metrics=NoMetrics())
    train(single, batch)
    single.ckpt.save(single.state, epoch=0)
    ranks = run_group("_torch_dist_cases:zero_cases", 2, tmp / "group", timeout=300,
                      weights=str(weights), batch=batch, run_dir=str(tmp / "runs"),
                      restore_dir=str(tmp / "single"))
    return dict(params=params, batch=batch, metrics=metrics, halves=halves,
                grads=from_jax_params(jax.tree.map(np.asarray, grads), CFG),
                single=single, single_state=state_numpy(single), ranks=ranks, tmp=tmp)


@pytest.mark.parametrize("case", ["full", "grad_op", "data"])
def test_sharded_steps_match_jax(run, case):
    """fsdp=2 ZeRO-3 and ZeRO-2, and data=2: each rank keeps 2 of the 4
    rows, the weights are sharded, and the first step's gradients and 3
    steps' loss and grad_norm are JAX's on the global batch."""
    r0, r1 = (r[case] for r in run["ranks"])
    assert r0["local_rows"] == r1["local_rows"] == 2
    assert r0["is_main"] and not r1["is_main"]
    if case == "data":
        assert r0["sharded"] == 0          # replicated over data
    else:
        assert r0["sharded"] > 0.9 * r0["n_params"]
    for got in (r0["metrics"], r1["metrics"]):
        for g, want in zip(got, run["metrics"]):
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    jnorm = run["metrics"][0]["grad_norm"]
    factor = min(1.0, 1.0 / jnorm)            # the grads are read after the clip
    grads = r0["grads"]
    assert set(grads) == {n for n in run["grads"] if not optim.is_frozen_path(n)}
    for name, g in grads.items():
        want = run["grads"][name].numpy() * factor
        tol = GRAD_TOL * max(float(np.linalg.norm(want)), 1e-3)
        assert float(np.abs(g - want).max()) <= tol, name


def test_loss_counts_labels_globally(run):
    """The ranks hold 14 and 4 labels: the mean of their own means is not
    the global mean; the sharded loss is."""
    want = run["metrics"][0]["loss"]
    assert abs(np.mean(run["halves"]) - want) > 1e-2
    np.testing.assert_allclose(run["ranks"][0]["full"]["metrics"][0]["loss"], want,
                               rtol=LOSS_RTOL)


def test_bad_strategy_raises():
    from aki_torch.train.runner import Trainer

    with pytest.raises(ValueError, match="fsdp_strategy"):
        Trainer(CFG, run_config("unused", fsdp_strategy="hybrid"), device="cpu")


def test_host_offload_round_trip(run, tmp_path):
    """host_offload_params: between steps every parameter and moment is a
    separate host tensor (pinned on a card), and the loss and grad_norm
    are bitwise those of the plain run."""
    from aki_torch.train.runner import Trainer

    plain = Trainer(CFG, run_config(str(tmp_path / "plain")), model=port_model(run["params"]),
                    device="cpu", metrics=NoMetrics())
    off = Trainer(CFG, run_config(str(tmp_path / "off"), host_offload_params=True),
                  model=port_model(run["params"]), device="cpu", metrics=NoMetrics())
    before = [p.data for p in off.model.parameters()]   # kept alive: no address reuse
    for _ in range(3):
        want = plain.step_fn(plain.state, plain.put_batch(run["batch"]))
        got = off.step_fn(off.state, off.put_batch(run["batch"]))
        assert float(got["loss"]) == float(want["loss"])
        assert float(got["grad_norm"]) == float(want["grad_norm"])
    assert len(off.offload_ms) == 3
    after = [p.data.data_ptr() for p in off.model.parameters()]
    assert not {t.data_ptr() for t in before} & set(after)    # every tensor was moved
    moments = [v for st in off.state.optimizer.opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.dim()]
    assert moments and all(v.device.type == "cpu" for v in moments)
    for a, b in zip(plain.model.parameters(), off.model.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_fsdp2_restores_on_one_device(run):
    """Written at fsdp=2 (gathered, rank 0 writes), restored on one device
    bitwise; the next step matches the sharded run's 4th."""
    from aki_torch.train.runner import Trainer

    r0 = run["ranks"][0]["full"]
    ckpt = r0["ckpt"]
    run_dir = ckpt.rsplit("/", 1)[0]
    t = Trainer(CFG, run_config(run_dir, training_mode="resume"),
                model=port_model(run["params"]), device="cpu", metrics=NoMetrics())
    got, want = state_numpy(t), r0["saved"]
    assert got["step"] == want["step"] == 3
    for kind in ("weights", "moments"):
        assert set(got[kind]) == set(want[kind])
        for k in want[kind]:
            assert np.array_equal(got[kind][k], want[kind][k]), k
    m = t.step_fn(t.state, t.put_batch(run["batch"]))
    np.testing.assert_allclose(float(m["loss"]), r0["step4"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), r0["step4"]["grad_norm"],
                               rtol=LOSS_RTOL)


def test_checkpoint_one_device_restores_at_fsdp2(run):
    """A run dir written on one device restores at fsdp=2 bitwise, and the
    next step is the single-device run's."""
    got, want = run["ranks"][0]["restored"], run["single_state"]
    assert got["step"] == want["step"] == 3 == run["ranks"][1]["restored"]["step"]
    for kind in ("weights", "moments"):
        assert set(got[kind]) == set(want[kind])
        for k in want[kind]:
            assert np.array_equal(got[kind][k], want[kind][k]), k
    single = run["single"]
    m = single.step_fn(single.state, single.put_batch(run["batch"]))
    for r in run["ranks"]:
        np.testing.assert_allclose(r["restored_step4"]["loss"], float(m["loss"]),
                                   rtol=LOSS_RTOL)
