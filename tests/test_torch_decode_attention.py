"""The port's int8-KV decode attention and the bf16-probability prefill
attentions against the JAX package, on the CPU.

- ``quantize_kv_flat`` gives JAX's int8 rows and scales exactly;
- the plain decode (``decode_attention_flat`` on CPU tensors) against
  ``decode_attention_flat_xla``: layer select, ragged lengths, live_width,
  GQA. Both round q and p * vs to bf16 and sum in f32 in different orders,
  which can flip one bf16 rounding of a p * vs term: within 1e-5 absolute
  plus 2e-3 of the largest output;
- ``decoder_attention_bf16p`` / ``encoder_attention_bf16p`` against
  ``decoder_attention_xla`` / ``encoder_attention_xla``, the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.ops import attention as jax_attention
from aki_tpu.ops import decode_attention as jax_da
from aki_tpu.ops.masks import MMASpec as JaxSpec
from aki_torch.ops import attention, decode_attention as da
from aki_torch.ops.masks import MMASpec


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5 + 2e-3 * np.abs(want).max(), rtol=0)


def test_quantize_kv_flat_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    x[1, 2, 1] = 0.0                                  # an all-zero head
    qj, sj = jax_da.quantize_kv_flat(jnp.asarray(x))
    qt, st = da.quantize_kv_flat(torch.from_numpy(x))
    assert qt.shape == (2, 5, 48) and qt.dtype == torch.int8 and st.shape == (2, 5, 3)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[1, 2, 1].item() == 1.0


def _cache(rng, n_layers, b, s, hkv, d):
    k = rng.randint(-127, 128, (n_layers, b, s, hkv * d)).astype(np.int8)
    v = rng.randint(-127, 128, (n_layers, b, s, hkv * d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (n_layers, b, s, hkv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (n_layers, b, s, hkv)).astype(np.float32)
    return k, ks, v, vs


@pytest.mark.parametrize("h,hkv,layer,live_width", [(4, 4, 2, None), (4, 4, 0, 3),
                                                    (8, 2, 1, None)])
def test_decode_attention_plain_matches_jax_xla(h, hkv, layer, live_width):
    rng = np.random.RandomState(h + layer)
    b, s, d = 5, 40, 16
    k, ks, v, vs = _cache(rng, 3, b, s, hkv, d)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    lengths = np.array([1, 17, 40, 33, 8], np.int32)
    want = jax.jit(jax_da.decode_attention_flat_xla, static_argnames="live_width")(
        jnp.asarray(q), *(jnp.asarray(a) for a in (k, ks, v, vs)), jnp.asarray(lengths),
        layer, live_width=live_width)
    got = da.decode_attention_flat(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (k, ks, v, vs)),
        torch.from_numpy(lengths), layer, live_width=live_width)
    assert got.shape == (b, 1, h, d) and got.dtype == torch.float32
    _close(got.numpy(), want)
    if live_width is not None:
        assert not got[live_width:].any()


def test_decode_attention_empty_row_is_zero():
    rng = np.random.RandomState(3)
    k, ks, v, vs = _cache(rng, 1, 2, 8, 2, 16)
    q = torch.randn(2, 1, 2, 16)
    out = da.decode_attention_flat(q, *(torch.from_numpy(a) for a in (k, ks, v, vs)),
                                   torch.tensor([0, 5]), 0)
    assert not out[0].any() and out[1].abs().sum() > 0


def test_decode_attention_raises_for_other_devices():
    k, ks, v, vs = (torch.from_numpy(a) for a in _cache(np.random.RandomState(4), 1, 1, 4, 1, 16))
    with pytest.raises(ValueError, match="no kernel"):
        da.decode_attention_flat(torch.zeros(1, 1, 1, 16, device="meta"), k, ks, v, vs,
                                 torch.ones(1, dtype=torch.int32), 0)


def _spec(rows):
    return [np.array(x, np.int32) for x in zip(*rows)]


@pytest.mark.parametrize("hkv", [4, 2])
def test_decoder_attention_bf16p_matches_jax(hkv):
    rng = np.random.RandomState(hkv)
    b, t, s, h, d = 2, 12, 16, 4, 16
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    img, txt, end = _spec([(1, 5, 9), (0, 0, 0)])
    valid = np.ones((b, s), np.int32)
    valid[1, :2] = 0                                  # query row 0 of batch row 1: no key
    q_offset = np.array([0, 1], np.int32)
    want = jax.jit(jax_attention.decoder_attention_xla)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        spec=JaxSpec(*(jnp.asarray(x) for x in (img, txt, end))),
        kv_valid=jnp.asarray(valid), q_offset=jnp.asarray(q_offset))
    got = attention.decoder_attention_bf16p(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        spec=MMASpec(*(torch.from_numpy(x) for x in (img, txt, end))),
        kv_valid=torch.from_numpy(valid), q_offset=torch.from_numpy(q_offset))
    _close(got.numpy(), want)
    assert not got[1, :1].any()
    # causal without a spec, bf16 inputs
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = jax.jit(jax_attention.decoder_attention_xla)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _close(attention.decoder_attention_bf16p(qb, kb, vb).float().numpy(),
           np.asarray(want, np.float32))


def test_encoder_attention_bf16p_matches_jax():
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(2, 10, 2, 16).astype(np.float32) for _ in range(3))
    want = jax.jit(jax_attention.encoder_attention_xla)(*(jnp.asarray(x) for x in (q, k, v)))
    got = attention.encoder_attention_bf16p(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got.numpy(), want)


# The kernel's split over a cluster of blocks (decode_attention.cu): the
# plan functions, and the same function summed in the kernel's order.

@pytest.mark.parametrize("c", da.CLUSTER_SIZES)
def test_key_range_covers_every_live_key_once(c):
    s = 704
    for n in sorted({0, 1, max(c - 1, 0), c + 1, 64 * c + 1, 65 * c - 1, s - 1, s}):
        spans = [da.key_range(n, c, r) for r in range(c)]
        keys = [j for j0, j1 in spans for j in range(j0, j1)]
        assert keys == list(range(n)), (n, spans)
        assert all(j0 <= j1 for j0, j1 in spans)
        assert max(j1 - j0 for j0, j1 in spans) == -(-n // c)   # a share is ceil(n / C)


def test_cluster_size_gives_two_waves_within_shared_memory():
    sms, d = 132, 96
    assert [da.cluster_size(b * 32, sms, 704, d) for b in (1, 2, 3, 5, 8, 9, 48)] == \
        [8, 8, 4, 2, 2, 1, 1]
    for pairs in (1, 32, 100, 264, 1536):
        c = da.cluster_size(pairs, sms, 704, d)
        assert pairs * c >= 2 * sms or c == da.CLUSTER_SIZES[-1]
        assert c == da.CLUSTER_SIZES[0] or pairs * (c // 2) < 2 * sms
    # a row too long for one block's shared memory splits further
    s_long = 30000
    assert da.smem_bytes(s_long, 1, d) > da.SMEM_LIMIT
    c = da.cluster_size(1536, sms, s_long, d)
    assert c > 1 and da.smem_bytes(s_long, c, d) <= da.SMEM_LIMIT
    with pytest.raises(ValueError, match="do not fit"):
        da.cluster_size(1, sms, 10 ** 6, d)
    # the ring of 4 tiles and two arrays of a tile-rounded share
    assert da.smem_bytes(704, 1, 96) == 4 * 64 * 96 + 2 * 704 * 4
    assert da.smem_bytes(1280, 8, 96) == 4 * 64 * 96 + 2 * 192 * 4
    assert da.smem_bytes(40, 2, 80) == 4 * 128 * 80 + 2 * 128 * 4


@pytest.mark.parametrize("c", da.CLUSTER_SIZES)
@pytest.mark.parametrize("h,hkv,live_width", [(4, 4, None), (4, 2, 4)])
def test_split_order_mirror_matches_jax_xla(c, h, hkv, live_width):
    rng = np.random.RandomState(10 + c + h + hkv)
    b, s, d, layer = 6, 70, 16, 1
    k, ks, v, vs = _cache(rng, 2, b, s, hkv, d)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    lengths = np.array([1, c + 1, 70, 0, 64 + 1, 33], np.int32)
    want = np.asarray(jax.jit(jax_da.decode_attention_flat_xla, static_argnames="live_width")(
        jnp.asarray(q), *(jnp.asarray(a) for a in (k, ks, v, vs)), jnp.asarray(lengths),
        layer, live_width=live_width))
    args = (torch.from_numpy(q), *(torch.from_numpy(a) for a in (k, ks, v, vs)),
            torch.from_numpy(lengths), layer)
    got = da.decode_attention_flat_split_reference(*args, live_width=live_width, cluster=c)
    plain = da.decode_attention_flat_reference(*args, live_width=live_width)
    assert got.shape == (b, 1, h, d) and got.dtype == torch.float32
    rows = b if live_width is None else live_width
    live = [i for i in range(rows) if lengths[i] > 0]     # JAX averages an empty row
    _close(got.numpy()[live], want[live])
    _close(got.numpy(), plain.numpy())
    assert not got[3].any() and not got[rows:].any()
