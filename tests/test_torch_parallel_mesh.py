"""The port's mesh arithmetic and placement rules against the JAX
package's: ``resolve_axis_sizes`` on a table of cases (its errors
included), and the rule table: every port parameter is placed, element by
element, where JAX places its counterpart (the fused q|k|v and gate|up
weights part by part), and ``strip_axis_rules`` strips as JAX's does.
``batch_rows`` gives each rank the rows JAX's ``batch_sharding`` gives it.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

from aki_tpu.models import configs as jax_configs
from aki_tpu.parallel import mesh as jax_mesh
from aki_tpu.parallel import sharding as jax_sharding
from aki_torch.convert import from_jax_params
from aki_torch.models.configs import MoEConfig, aki_tiny
from aki_torch.parallel import mesh, sharding

from ._jax_tiny import cfg_params

SIZES = {"data": 1, "fsdp": 2, "tensor": 2, "seq": 1, "pipe": 1, "expert": 2}
MOE = dict(num_experts=4, top_k=2, intermediate_size=32, capacity_factor=1.25)


@pytest.mark.parametrize("sizes,n", [
    ((1, -1, 1, 1, 1, 1), 8), ((2, -1, 1, 1, 1, 1), 8), ((1, 2, 2, 2, 1, 1), 8),
    ((1, 1, 1, 1, 1, 1), 8), ((1, -1, 2, 1, 1, 1), 4), ((-1, 2, 1, 1, 1, 1), 4),
    ((1, -1, -1, 1, 1, 1), 8), ((1, -1, 3, 1, 1, 1), 8), ((1, 4, 4, 1, 1, 1), 8),
    ((1, 1, 1, 1, 4, 1), 4), ((1, 1, 1, 1, 1, 2), 1),
])
def test_resolve_axis_sizes_matches_jax(sizes, n):
    kw = dict(zip(jax_mesh.AXES, sizes))
    try:
        want = jax_mesh.resolve_axis_sizes(jax_mesh.MeshConfig(**kw), n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            mesh.resolve_axis_sizes(mesh.MeshConfig(**kw), n)
        return
    assert mesh.resolve_axis_sizes(mesh.MeshConfig(**kw), n) == want
    assert mesh.AXES == jax_mesh.AXES and mesh.BATCH_AXES == jax_mesh.BATCH_AXES


def _block_ids(shape, spec, axis, n, parts=None):
    """Per element: 1 + its block's index along the dim ``spec`` gives
    ``axis`` (split part by part on a fused dim 0), 0 where no dim does."""
    ids = np.zeros(shape, np.float32)
    for d, part in enumerate(spec):
        if part != axis:
            continue
        lens = parts if parts is not None and d == 0 else (shape[d],)
        idx = np.concatenate([np.arange(m) // (m // n) for m in lens]) + 1
        ids = ids + idx.reshape([-1 if i == d else 1 for i in range(len(shape))])
    return ids


def _configs():
    tiny, tiny_j = aki_tiny(), jax_configs.aki_tiny()
    moe = dataclasses.replace(tiny, phi3=dataclasses.replace(tiny.phi3, moe=MoEConfig(**MOE)))
    moe_j = dataclasses.replace(tiny_j, phi3=dataclasses.replace(
        tiny_j.phi3, moe=jax_configs.MoEConfig(**MOE)))
    return {"dense": (tiny, tiny_j), "moe": (moe, moe_j)}


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("axis", ["fsdp", "tensor", "expert"])
def test_rules_place_each_parameter_as_jax(kind, axis, strip):
    """Tag every element of every JAX leaf with its block along ``axis``
    under JAX's rules (``strip``: ZeRO-2's, fsdp stripped), carry the tags
    through the weight bridge, and compare with the port's rules on the
    port's names and layout. The SigLIP patch kernel (kh*kw*c, out) is a
    conv weight (out, c, kh, kw) here: its input dim is three dims, so its
    fsdp block is not compared."""
    cfg, cfg_j = _configs()[kind]
    params = cfg_params(cfg_j, 0)
    fake = types.SimpleNamespace(shape=SIZES)
    n = SIZES[axis]
    jrules = jax_sharding.strip_axis_rules("fsdp") if strip else None
    rules = sharding.strip_axis_rules("fsdp") if strip else None

    def tag(path, leaf):
        spec = jax_sharding.spec_for_path(jax_sharding._path_str(path), jrules)
        spec = jax_sharding._fit_spec(spec, leaf.ndim, fake, leaf.shape)
        return _block_ids(leaf.shape, tuple(spec), axis, n)

    want = from_jax_params(jax.tree_util.tree_map_with_path(tag, params), cfg)
    checked = 0
    for name, tensor in want.items():
        parts = sharding.parts_for_path(name, cfg)
        spec = sharding.fit_spec(sharding.spec_for_path(name, rules), tensor.shape, SIZES,
                                 parts)
        got = _block_ids(tuple(tensor.shape), spec, axis, n, parts)
        if axis == "fsdp" and name.endswith("patch_embedding.weight"):
            continue
        assert np.array_equal(got, tensor.numpy()), (name, spec)
        checked += int(got.any())
    placed = not (axis == "expert" and kind == "dense") and not (strip and axis == "fsdp")
    assert (checked > 0) == placed


def test_batch_rows_is_jax_batch_split():
    """Rank (data d, fsdp f) keeps rows [(d*F + f)*b, ...): JAX's
    P(("data", "fsdp")) order; stacked batches split their axis 1."""
    x = np.arange(8 * 3).reshape(8, 3)

    class FakeMesh:
        def __init__(self, d, f):
            self.sizes, self.c = {"data": 2, "fsdp": 2}, {"data": d, "fsdp": f}

        def size(self, *axes):
            return int(np.prod([self.sizes[a] for a in axes]))

        def index(self, *axes):
            i = 0
            for a in axes:
                i = i * self.sizes[a] + self.c[a]
            return i

    for d in range(2):
        for f in range(2):
            got = mesh.batch_rows(x, FakeMesh(d, f))
            assert np.array_equal(got, x[(d * 2 + f) * 2:(d * 2 + f + 1) * 2])
            stacked = mesh.batch_rows(np.stack([x, x]), FakeMesh(d, f), stacked=True)
            assert stacked.shape == (2, 2, 3)
    with pytest.raises(ValueError, match="must divide"):
        mesh.batch_rows(x[:6], FakeMesh(0, 0))


def test_mesh_needs_a_group_and_the_whole_world():
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.Mesh(mesh.MeshConfig(), "cpu")
