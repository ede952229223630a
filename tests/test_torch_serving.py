"""The port's continuous-batching server (``aki_torch.infer.server``) against
the port's one-shot ``generate`` on the same weights, on the CPU, at
``aki_tiny`` in fp32 (the JAX server is not run here: ``generate`` itself is
held to the JAX engine in ``test_torch_engine.py`` and
``test_torch_quant.py``).

Greedy tokens must be identical: the server's padded, batched admission and
its chunked decode over the slot cache compute each row as the one-shot
path does.
"""

import sys
import time

import numpy as np
import pytest
import torch

from aki_torch.convert import from_jax_params
from aki_torch.infer import engine
from aki_torch.infer.engine import prefill
from aki_torch.infer.server import ServingEngine
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny

from ._jax_tiny import tiny_params

CFG = aki_tiny()
MAX_LEN, BUCKET = 48, 12


@pytest.fixture(scope="module")
def model():
    m = AKIModel(CFG, device="cpu")
    m.load_state_dict(from_jax_params(tiny_params(0), CFG), strict=True)
    return m


def make_prompt(rng, t=12):
    ids = rng.randint(5, CFG.initial_tokenizer_len - 1, size=(t,))
    ids[1] = CFG.media_token_id
    ids[8] = CFG.assistant_token_id
    s = CFG.siglip.image_size
    return list(ids), rng.randn(s, s, 3).astype(np.float32)


def one_shot(model, ids, img, m, **kw):
    toks, num = engine.generate(model, np.array([ids], np.int32), img[None],
                                np.ones((1, len(ids)), np.int32), m, MAX_LEN, policy=F32,
                                device="cpu", **kw)
    return toks[0, : int(num[0])].tolist()


def serve(model, requests, **kw):
    """Submit (ids, image, budget[, eos]) requests, drain, and return the
    engine and each request's tokens."""
    eng = ServingEngine(model, max_len=MAX_LEN, prompt_bucket=BUCKET, policy=F32,
                        device="cpu", **kw)
    try:
        reqs = [eng.submit(*r[:2], max_new_tokens=r[2], eos_id=(r[3] if len(r) > 3 else None))
                for r in requests]
        eng.run_until_drained()
        return eng, [r.result(timeout=5) for r in reqs]
    finally:
        eng.close()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_server_matches_one_shot(model, kv_int8):
    # prompts shorter than the bucket are padded in the admission batch
    prompts = [make_prompt(np.random.RandomState(100 + i), t)
               for i, t in enumerate([12, 10, 9, 12])]
    # more requests than slots: slots free and refill
    _, got = serve(model, [(ids, img, 5) for ids, img in prompts], num_slots=2,
                   kv_int8=kv_int8)
    for (ids, img), toks in zip(prompts, got):
        assert toks == one_shot(model, ids, img, 5, kv_int8=kv_int8)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_server_compact_tail_matches_one_shot(model, kv_int8):
    """Staggered budgets take the drain tail through the move-to-front and
    live-width path (4 slots -> live 2 -> live 1); a second wave re-expands
    to the full pool. kv_int8=True reads the cache prefix in the decode;
    kv_int8=False ignores the hint. A warmup first must change no token."""
    eng = ServingEngine(model, num_slots=4, max_len=MAX_LEN, prompt_bucket=BUCKET,
                        policy=F32, decode_chunk=2, compact_tail=True, kv_int8=kv_int8,
                        device="cpu")
    assert eng._compact_widths == [1, 2]
    try:
        eng.warmup()                        # runs every device call; admits nothing
        assert not eng.has_work() and eng.decode_dispatches == 0
        done = []
        for seed0, budgets in ((300, [2, 2, 6, 10]), (310, [3, 3, 3, 3])):
            wave = [(*make_prompt(np.random.RandomState(seed0 + i)), m)
                    for i, m in enumerate(budgets)]
            reqs = [eng.submit(ids, img, max_new_tokens=m) for ids, img, m in wave]
            eng.run_until_drained()
            if seed0 == 300:
                assert eng._live == 1               # the tail ended fully compacted
            done += list(zip(wave, reqs))
        assert eng._live in (4, *eng._compact_widths)
        for (ids, img, m), req in done:
            assert req.result(timeout=5) == one_shot(model, ids, img, m, kv_int8=kv_int8)
    finally:
        eng.close()


def test_server_eos_frees_slot_early(model):
    ids, img = make_prompt(np.random.RandomState(1))
    eos = one_shot(model, ids, img, 1)[0]
    ids2, img2 = make_prompt(np.random.RandomState(7))
    eng, (first, second) = serve(model, [(ids, img, 8, eos), (ids2, img2, 3)], num_slots=1)
    assert first == []                  # stopped at eos at once
    assert second == one_shot(model, ids2, img2, 3)
    # the second request refills the slot at a chunk boundary: a few
    # chunks, not 8 + 3 sequential steps
    assert eng.decode_dispatches <= 4, eng.decode_dispatches


def test_server_uint8_ingress_matches_float(model):
    s = CFG.siglip.image_size
    rng = np.random.RandomState(3)
    prompts = [(make_prompt(np.random.RandomState(300 + i))[0],
                rng.randint(0, 256, (s, s, 3)).astype(np.uint8)) for i in range(3)]
    _, got_u8 = serve(model, [(ids, px, 4) for ids, px in prompts], num_slots=2,
                      image_uint8=True)
    _, got_f = serve(model, [(ids, (px.astype(np.float32) / 255.0 - 0.5) / 0.5, 4)
                             for ids, px in prompts], num_slots=2)
    assert got_u8 == got_f


@pytest.mark.parametrize("kv_int8", [False, True])
def test_fused_admission_matches_split_insert(model, kv_int8):
    """The admission prefill (K/V written straight into the slot cache) and
    the split oracle (a batch-sized prefill, then ``_insert``) leave the
    same state; row 1 drops (slot == num_slots)."""
    kw = dict(num_slots=3, max_len=MAX_LEN, prompt_bucket=BUCKET, policy=F32,
              kv_int8=kv_int8, device="cpu")
    eng_a, eng_b = ServingEngine(model, **kw), ServingEngine(model, **kw)
    rng = np.random.RandomState(7)
    rows = [make_prompt(rng) for _ in range(2)]
    ids = np.array([r[0] for r in rows], np.int32)
    imgs = torch.from_numpy(np.stack([r[1] for r in rows]))
    valid = np.ones((2, BUCKET), np.int32)
    slots = np.array([2, 3])
    eng_a._prefill_batch(ids, imgs, valid, slots)
    new = prefill(model, ids, imgs, valid, MAX_LEN, policy=F32, kv_int8=kv_int8, device="cpu")
    eng_b._insert(new, slots)
    for xa, xb in zip(eng_a._state_rows(eng_a.state), eng_b._state_rows(eng_b.state)):
        torch.testing.assert_close(xa, xb, rtol=1e-6, atol=1e-6)
    assert eng_a.state.lengths.tolist() == [0, 0, int(new.lengths[0])]
    for e in (eng_a, eng_b):
        e.close()


def test_server_batched_admission_drains(model):
    """admit_policy "batched" with small upload chunks: every request
    completes, and idle ticks (waiting on uploads) do not count."""
    prompts = [make_prompt(np.random.RandomState(400 + i)) for i in range(6)]
    eng, got = serve(model, [(ids, img, 3) for ids, img in prompts], num_slots=4,
                     admit_batch=4, admit_policy="batched", upload_chunk=2)
    assert [len(t) for t in got] == [3] * 6
    assert len(eng.completion_log) == 6
    assert {k for k, _, _ in eng.dispatch_log} == {"prefill", "decode"}
    assert eng.dispatch_log.maxlen == eng.completion_log.maxlen == 65536


def test_server_rejects_tp_mesh(model):
    """Tensor-parallel serving is ported (tests/test_torch_tp.py); W8A8
    weights under it are not, and raise naming the ROADMAP item."""
    import copy
    import types

    from aki_torch.models.quant import quantize_params

    quant = quantize_params(copy.deepcopy(model), "w8a8")
    mesh = types.SimpleNamespace(shape={"tensor": 2}, coord=lambda axis: 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ServingEngine(quant, tp_mesh=mesh, device="cpu")


def test_server_drains_under_uploader_contention(model):
    """More uploader threads than cores, one-row uploads that take
    milliseconds, a short switch interval, and a scheduler that is slow to
    read the uploads in flight (as if preempted there): every request
    completes. A drain that looked at the admission queue before the
    uploads would see the queue still empty and, after the uploads landed,
    none in flight, and end before serving anything."""
    prompts = [make_prompt(np.random.RandomState(500 + i)) for i in range(12)]
    eng = ServingEngine(model, num_slots=4, max_len=MAX_LEN, prompt_bucket=BUCKET,
                        policy=F32, device="cpu", upload_threads=8, upload_chunk=1)
    put, pending = eng._put, eng._pending_uploads

    def slow_put(x):
        time.sleep(0.003)
        return put(x)

    def slow_pending():
        time.sleep(0.02)
        return pending()

    eng._put, eng._pending_uploads = slow_put, slow_pending
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reqs = [eng.submit(ids, img, max_new_tokens=1) for ids, img in prompts]
        eng.run_until_drained()
        assert all(r._result.qsize() == 1 for r in reqs)
    finally:
        sys.setswitchinterval(interval)
        eng.close()
