"""Model configurations (counterpart of ``aki_tpu/models/configs.py``).

The port keeps its own copy: the JAX module imports ``ops/rope.py``, which
imports jax. Field for field the same dataclasses and the same two
geometries — ``aki_4b()`` (SigLIP-SO400M-patch14-384 + 144-latent Perceiver
+ Phi-3.5-mini-instruct) and ``aki_tiny()`` for tests.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """Rotary embedding geometry with optional LongRoPE factors."""

    head_dim: int
    theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    # LongRoPE per-frequency factors, length head_dim // 2 (None = plain RoPE)
    short_factor: tuple[float, ...] | None = None
    long_factor: tuple[float, ...] | None = None

    @property
    def attention_scaling(self) -> float:
        if self.short_factor is None:
            return 1.0
        scale = self.max_position_embeddings / self.original_max_position_embeddings
        if scale <= 1.0:
            return 1.0
        return math.sqrt(
            1.0 + math.log(scale) / math.log(self.original_max_position_embeddings)
        )


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts MLP option (carried for config parity; the MoE
    decoder itself is not ported yet)."""

    num_experts: int = 8
    top_k: int = 2
    intermediate_size: int = 128
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Phi3Config:
    """Phi-3-family decoder (HF Phi3ForCausalLM geometry)."""

    vocab_size: int = 32064          # padded embedding rows
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 96
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    rope_short_factor: tuple[float, ...] | None = None
    rope_long_factor: tuple[float, ...] | None = None
    initializer_range: float = 0.02
    moe: MoEConfig | None = None

    @property
    def rope(self) -> RopeConfig:
        return RopeConfig(
            head_dim=self.head_dim,
            theta=self.rope_theta,
            max_position_embeddings=self.max_position_embeddings,
            original_max_position_embeddings=self.original_max_position_embeddings,
            short_factor=self.rope_short_factor,
            long_factor=self.rope_long_factor,
        )


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    """SigLIP vision transformer (HF SiglipVisionModel geometry)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    num_channels: int = 3

    @property
    def num_patches(self) -> int:
        # conv-valid: 384/14 -> 27 patches/side (378 px used)
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler."""

    dim: int = 1152                  # incoming vision feature dim
    dim_inner: int = 3072            # projection target (LM width)
    depth: int = 6
    dim_head: int = 64
    heads: int = 8
    num_latents: int = 144
    ff_mult: int = 4


@dataclasses.dataclass(frozen=True)
class AKIConfig:
    """Full AKI model: vision encoder + resampler + decoder + decoupled vocab.

    ``initial_tokenizer_len`` is the tokenizer size before the two framework
    tokens ``<image>`` and ``<|endofchunk|>``; ids at or above it route to
    the decoupled extra embedding and head.
    """

    phi3: Phi3Config = Phi3Config()
    siglip: SigLIPVisionConfig = SigLIPVisionConfig()
    perceiver: PerceiverConfig = PerceiverConfig()
    initial_tokenizer_len: int = 32011
    num_extra_tokens: int = 2
    pad_token_id: int = 32000        # <|endoftext|> used as pad
    media_token_id: int = 32011      # <image>
    end_of_chunk_token_id: int = 32012  # <|endofchunk|>
    assistant_token_id: int = 32001  # <|assistant|>

    @property
    def output_vocab(self) -> int:
        return self.initial_tokenizer_len + self.num_extra_tokens


# LongRoPE factors of microsoft/Phi-3.5-mini-instruct (public HF config.json,
# rope_scaling.type = "longrope", head_dim/2 = 48 entries each). The short
# factors apply at every sequence length.
PHI35_MINI_SHORT_FACTOR: tuple[float, ...] = (
    1.0, 1.0199999809265137, 1.0299999713897705, 1.0299999713897705,
    1.0499999523162842, 1.0499999523162842, 1.0499999523162842,
    1.0499999523162842, 1.0499999523162842, 1.0699999332427979,
    1.0999999046325684, 1.1099998950958252, 1.1599998474121094,
    1.1599998474121094, 1.1699998378753662, 1.2899998426437378,
    1.339999794960022, 1.679999828338623, 1.7899998426437378,
    1.8199998140335083, 1.8499997854232788, 1.8799997568130493,
    1.9099997282028198, 1.9399996995925903, 1.9899996519088745,
    2.0199997425079346, 2.0199997425079346, 2.0199997425079346,
    2.0199997425079346, 2.0199997425079346, 2.0199997425079346,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0299997329711914, 2.0299997329711914, 2.0299997329711914,
    2.0799996852874756, 2.0899996757507324, 2.189999580383301,
    2.2199995517730713, 2.5899994373321533, 2.729999542236328,
    2.749999523162842, 2.8399994373321533,
)
PHI35_MINI_LONG_FACTOR: tuple[float, ...] = (
    1.0800000429153442, 1.1100000143051147, 1.1399999856948853,
    1.340000033378601, 1.5899999141693115, 1.600000023841858,
    1.6200000047683716, 2.620000123977661, 3.2300000190734863,
    3.2300000190734863, 4.789999961853027, 7.400000095367432,
    7.700000286102295, 9.09000015258789, 12.199999809265137,
    17.670000076293945, 24.46000099182129, 28.57000160217285,
    30.420001983642578, 30.840002059936523, 32.590003967285156,
    32.93000411987305, 42.320003509521484, 44.96000289916992,
    50.340003967285156, 50.45000457763672, 57.55000305175781,
    57.93000411987305, 58.21000289916992, 60.1400032043457,
    62.61000442504883, 62.62000274658203, 62.71000289916992,
    63.1400032043457, 63.1400032043457, 63.77000427246094,
    63.93000411987305, 63.96000289916992, 63.970001220703125,
    64.02999877929688, 64.06999969482422, 64.08000183105469,
    64.12000274658203, 64.41000366210938, 64.4800033569336,
    64.51000213623047, 64.52999877929688, 64.83999633789062,
)


def aki_4b() -> AKIConfig:
    """Released AKI-4B geometry (Sony/AKI-4B-phi-3.5-mini) with its LongRoPE
    factors."""
    return AKIConfig(phi3=Phi3Config(
        rope_short_factor=PHI35_MINI_SHORT_FACTOR,
        rope_long_factor=PHI35_MINI_LONG_FACTOR,
    ))


def config_for_tokenizer(base: AKIConfig, info) -> AKIConfig:
    """Rebind the token-id layout from a ``TokenizerInfo`` (single source of
    truth — mismatched layouts silently break splice/routing)."""
    vocab_rows = max(base.phi3.vocab_size, info.vocab_size)
    return dataclasses.replace(
        base,
        phi3=dataclasses.replace(base.phi3, vocab_size=vocab_rows),
        initial_tokenizer_len=info.initial_len,
        num_extra_tokens=info.vocab_size - info.initial_len,
        pad_token_id=info.pad_id,
        media_token_id=info.media_id,
        end_of_chunk_token_id=info.end_of_chunk_id,
        assistant_token_id=info.assistant_id,
    )


def aki_tiny(vocab: int = 128) -> AKIConfig:
    """Tiny geometry for tests: same wiring, toy dims."""
    phi3 = Phi3Config(
        vocab_size=vocab,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
    )
    siglip = SigLIPVisionConfig(
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=2,
        image_size=28,
        patch_size=14,
    )
    perceiver = PerceiverConfig(
        dim=32, dim_inner=64, depth=2, dim_head=8, heads=2, num_latents=6,
        ff_mult=2,
    )
    return AKIConfig(
        phi3=phi3,
        siglip=siglip,
        perceiver=perceiver,
        initial_tokenizer_len=vocab - 8,
        num_extra_tokens=2,
        pad_token_id=0,
        media_token_id=vocab - 8,
        end_of_chunk_token_id=vocab - 7,
        assistant_token_id=vocab - 10,
    )
