"""JAX reference weights at aki_tiny for the port's tests, made once per
process: one jitted ``init_aki`` serves every seed (eager init takes
seconds per call on the CPU)."""

import functools

import jax
import numpy as np

from aki_tpu.models import configs
from aki_tpu.models.aki import init_aki

_init = jax.jit(init_aki, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _params(seed: int):
    return jax.tree.map(np.asarray, _init(jax.random.PRNGKey(seed), configs.aki_tiny()))


def tiny_params(seed: int):
    """``init_aki(PRNGKey(seed), aki_tiny())`` as a tree of numpy arrays,
    a fresh copy on every call."""
    return jax.tree.map(np.copy, _params(seed))
