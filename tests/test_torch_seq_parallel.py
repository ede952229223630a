"""Sequence parallelism on a 2-rank gloo group at aki_tiny in fp32: the
ring (``aki_torch.ops.ring_attention``) and the K/V all-gather route
(``flash_mma_attention_sp``, on the plain path on the CPU) against the JAX
ring on a 2-device ``seq`` mesh and JAX's dense attention, and 3 train
steps at seq=2 by each route against JAX's unsharded ``make_train_step``.

One group runs every case (``tests/_torch_dist_cases.py:seq_cases``).
Tolerances: outputs within 1e-5; gradients within 1e-5 of each tensor's
norm; losses and grad norms within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.models import configs as jax_configs
from aki_tpu.models.common import F32 as JAX_F32
from aki_tpu.ops.attention import dense_attention as jax_dense
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_tpu.ops.ring_attention import ring_mma_attention_sp as jax_ring
from aki_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from aki_tpu.parallel.mesh import create_mesh as jax_create_mesh
from aki_tpu.train import optim as jax_optim
from aki_tpu.train.step import TrainState as JaxTrainState
from aki_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aki_tpu.train.step import make_train_step as jax_make_train_step
from aki_torch.convert import from_jax_params
from aki_torch.models.configs import aki_tiny
from aki_torch.ops.masks import MMASpec

from ._jax_tiny import tiny_params
from ._torch_dist import run_group
from .test_torch_zero import make_batch, to_jax

CFG_J, CFG = jax_configs.aki_tiny(), aki_tiny()
TOL = 1e-5
LOSS_RTOL = 1e-4


def attention_inputs(rng, b=2, t=16, h=2, d=8):
    """Row 0's MMA rectangle reaches from shard 0's rows into shard 1's keys
    (vision rows 2-5 attend to the question at 6-11); row 1 is padded."""
    q, k, v, g = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    kvv = np.ones((b, t), np.int32)
    kvv[1, t - 3:] = 0
    return dict(q=q, k=k, v=v, g=g, kv_valid=kvv, img_start=np.array([2, 0], np.int32),
                txt_start=np.array([6, 0], np.int32), txt_end=np.array([12, 0], np.int32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    attn = attention_inputs(np.random.RandomState(21))
    jq, jk, jv, jg = (jnp.asarray(attn[n]) for n in ("q", "k", "v", "g"))
    spec = JaxSpec(*(jnp.asarray(attn[n]) for n in ("img_start", "txt_start", "txt_end")))
    kvv = jnp.asarray(attn["kv_valid"])
    mesh = jax_create_mesh(JaxMeshConfig(data=1, fsdp=1, tensor=1, seq=2))

    def ring_loss(q, k, v):
        out = jax_ring(q, k, v, mesh=mesh, spec=spec, kv_valid=kvv)
        return jnp.sum(out * jg), out

    def dense_loss(q, k, v):
        out = jax_dense(q, k, v, spec=spec, kv_valid=kvv)
        return jnp.sum(out * jg), out

    ref = {}
    for name, fn in (("jax_ring", ring_loss), ("jax_dense", dense_loss)):
        (_, out), grads = jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
        ref[name] = dict(out=np.asarray(out), dq=np.asarray(grads[0]),
                         dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))

    # 4 rows of 13 tokens: 18 spliced rows, 9 a rank
    params = tiny_params(0)
    batch = make_batch(np.random.RandomState(12), t=13)
    jb = to_jax(batch)
    jparams = jax.tree.map(jnp.asarray, params)
    grads = jax.jit(jax.grad(jax_make_loss_fn(CFG_J, JAX_F32, False, False)))(jparams, jb)
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
    ranks = run_group("_torch_dist_cases:seq_cases", 2, tmp / "group", timeout=300,
                      weights=str(weights), batch=batch, attn=attn, run_dir=str(tmp / "runs"))
    return dict(attn=attn, ref=ref, metrics=metrics, ranks=ranks,
                grads=from_jax_params(jax.tree.map(np.asarray, grads), CFG))


def _close(got, want, what):
    tol = TOL * max(float(np.linalg.norm(want)), 1.0)
    assert float(np.abs(got - want).max()) <= tol, what


@pytest.mark.parametrize("impl", ["ring", "allgather"])
@pytest.mark.parametrize("ref", ["jax_ring", "jax_dense"])
def test_sp_attention_matches_jax(run, impl, ref):
    """Each rank's rows of the output and of dq, and its block's dk, dv,
    concatenated over the ranks, are JAX's ring's and dense attention's."""
    want = run["ref"][ref]
    for key in ("out", "dq", "dk", "dv"):
        got = np.concatenate([r[impl][key] for r in run["ranks"]], axis=1)
        _close(got, want[key], f"{impl} {key} vs {ref}")


def test_ring_never_holds_more_than_its_block(run):
    """The ring's K/V on a rank are T/n rows at every hop; the all-gather
    route holds all T (it shards activations, not the attention's K/V), and
    hands the flash attention contiguous q, K and V (the card's kernels
    take no other)."""
    t = run["attn"]["q"].shape[1]
    for r in run["ranks"]:
        assert r["ring"]["kv_rows"] and set(r["ring"]["kv_rows"]) == {t // 2}
        assert set(r["allgather"]["kv_rows"]) == {t}
        assert r["allgather_contiguous"] == [True]


def test_liveness_from_the_host_spec(run):
    """The block table: rank 0's vision rows attend to shard 1's question
    keys, so a block ahead of the causal frontier is live; under a causal
    spec that block is dead."""
    from aki_torch.ops.masks import allowed_mask

    assert run["ranks"][0]["ring"]["live"].tolist() == [[True, True], [True, True]]
    causal = MMASpec(*(torch.zeros(2, dtype=torch.int32) for _ in range(3)))
    ok = allowed_mask(causal, 16, 16, torch.as_tensor(run["attn"]["kv_valid"])).numpy()
    assert ok.reshape(2, 2, 8, 2, 8).any(axis=(0, 2, 4)).tolist() == [[True, False],
                                                                       [True, True]]


@pytest.mark.parametrize("impl", ["ring", "allgather"])
def test_sp_train_step_matches_jax(run, impl):
    """seq=2: the splice and the label shift on the whole 18-row sequence,
    9 rows a rank; the first step's gradients and 3 steps' loss and
    grad_norm are JAX's unsharded step's."""
    res = [r[f"step_{impl}"] for r in run["ranks"]]
    for got in (res[0]["metrics"], res[1]["metrics"]):
        for g, want in zip(got, run["metrics"]):
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    factor = min(1.0, 1.0 / run["metrics"][0]["grad_norm"])
    for name, g in res[0]["grads"].items():
        want = run["grads"][name].numpy() * factor
        tol = TOL * max(float(np.linalg.norm(want)), 1e-3)
        assert float(np.abs(g - want).max()) <= tol, name
