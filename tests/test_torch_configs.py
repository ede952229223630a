"""The port's configs equal the JAX package's, field for field."""

import dataclasses

import pytest

from aki_tpu.models import configs as jax_configs
from aki_torch.models import configs as torch_configs


@pytest.mark.parametrize("name", ["aki_4b", "aki_tiny"])
def test_configs_match_jax(name):
    want = getattr(jax_configs, name)()
    got = getattr(torch_configs, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.phi3.rope) == dataclasses.asdict(want.phi3.rope)
    assert got.phi3.rope.attention_scaling == want.phi3.rope.attention_scaling
    assert got.siglip.num_patches == want.siglip.num_patches
    assert got.siglip.head_dim == want.siglip.head_dim
    assert got.output_vocab == want.output_vocab


def test_longrope_factors_match_jax():
    assert torch_configs.PHI35_MINI_SHORT_FACTOR == jax_configs.PHI35_MINI_SHORT_FACTOR
    assert torch_configs.PHI35_MINI_LONG_FACTOR == jax_configs.PHI35_MINI_LONG_FACTOR
    rope = torch_configs.aki_4b().phi3.rope
    assert len(rope.short_factor) == rope.head_dim // 2
    assert rope.attention_scaling > 1.0
