"""The port's tracer (``aki_torch.trace``) and the spans and request records
of the serving engine and the train step, on the CPU.

The tracer: spans nest per thread, the ring keeps its bound and counts what
it drops, the off path opens no profiler range and records no CUDA event,
and under a ``torch.profiler`` session every span is in the profiler's
events. The engine: every answered request's timeline is in order and is
one request record. The train step: one ``train.step`` holding the
forward, backward and optimizer spans.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aki_torch import trace
from aki_torch.infer.server import ServingEngine
from aki_torch.models.common import F32
from aki_torch.train.metrics import MetricsLogger
from aki_torch.train.runner import RunnerConfig, Trainer

from .test_torch_serving import BUCKET, MAX_LEN, make_prompt, model  # noqa: F401 (fixture)
from .test_torch_train import CFG, make_batch, params, port_model  # noqa: F401 (fixture)

TIMEOUT_S = 30


def test_spans_nest_per_thread():
    """A span's parent is the span open around it on its own thread: a
    thread's outermost span has none (0), whatever other threads hold
    open; ids are unique over threads."""
    tr = trace.Tracer()
    inside = threading.Barrier(3, timeout=TIMEOUT_S)

    def worker(k):
        with tr.span("outer", k=k):
            inside.wait()
            with tr.span("inner", k=k):
                with tr.span("leaf", k=k):
                    pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    with tr.span("main"):
        for t in threads:
            t.start()
        inside.wait()
        with tr.span("main.child"):
            pass
    for t in threads:
        t.join(TIMEOUT_S)
        assert not t.is_alive()
    spans = tr.spans()
    assert len(spans) == 8 and len({s.id for s in spans}) == 8
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("main", "outer"):
            assert s.parent == 0
        else:
            parent = by_id[s.parent]
            assert parent.thread == s.thread
            assert parent.name == {"main.child": "main", "inner": "outer", "leaf": "inner"}[s.name]
            assert parent.attrs.get("k") == s.attrs.get("k")
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    assert len({s.thread for s in spans}) == 3
    assert not any(s.profiled for s in spans)


def test_ring_keeps_its_bound_and_counts_drops():
    tr = trace.Tracer(entries=4)
    for i in range(10):
        with tr.span("s", i=i):
            pass
    spans = tr.spans()
    assert [s.attrs["i"] for s in spans] == [6, 7, 8, 9] and tr.dropped == 6
    # what closed after the oldest kept record is all there; before it, not
    assert tr.kept_since(spans[0].t1 + 1) and not tr.kept_since(spans[0].t1)
    tr = trace.Tracer()
    assert tr.kept_since(0)
    tr.record(trace.RequestRecord(7, 1, 2, 3, 4, 5, 10, 3, False))
    assert tr.requests()[0].id == 7 and tr.spans() == [] and tr.kept_since(0)


class _Recorder:
    """Stands in for ``record_function`` and ``torch.cuda.Event``: counts
    what is made and entered."""

    def __init__(self):
        self.ranges, self.events = [], []

    def record_function(self, name):
        rec = self

        class Range:
            def __enter__(self):
                rec.ranges.append(name)

            def __exit__(self, *exc):
                pass

        return Range()

    def event(self, enable_timing=False):
        rec = self

        class Event:
            def __init__(self):
                self.recorded = 0
                rec.events.append(self)

            def record(self, stream=None):
                self.recorded += 1

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return 1.5

        return Event()


def test_off_path_opens_no_range_and_records_no_event(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec.record_function)
    monkeypatch.setattr(torch.cuda, "Event", rec.event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    tr = trace.Tracer()
    with tr.span("off"):
        pass
    assert rec.ranges == [] and rec.events == []
    off = tr.spans()[0]
    assert not off.profiled and off.device_ms() is None
    tr.enabled = True
    with tr.span("on"):
        pass
    on = tr.spans()[1]
    assert rec.ranges == ["on"] and [e.recorded for e in rec.events] == [1, 1]
    assert on.profiled and on.device_ms() == 1.5
    # the module's switch acts on the process's tracer
    trace.enable()
    try:
        assert trace.on() and trace.TRACER.enabled
    finally:
        trace.disable()
    assert not trace.on()


def test_spans_are_in_the_profilers_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        with trace.span("test.outer") as outer:
            with trace.span("test.inner") as inner:
                torch.ones(4) + 1
    assert outer.profiled and inner.profiled and inner.parent == outer.id
    names = {e.name for e in prof.events()}
    assert {"test.outer", "test.inner"} <= names
    assert not trace.on()


def test_served_requests_keep_their_timeline(model):  # noqa: F811 (fixture)
    """Every answered request's stamps are in order (submitted, on the card,
    admitted, first token, answered), and each is one request record; a
    request is admitted inside its ``serve.admit`` before the prefill is
    issued, and the dispatch spans carry ``dispatch_log``'s keys."""
    rng = np.random.RandomState(900)
    prompts = [make_prompt(rng) for _ in range(6)]
    t_start = time.perf_counter_ns()
    eng = ServingEngine(model, num_slots=4, max_len=MAX_LEN, prompt_bucket=BUCKET, policy=F32,
                        admit_batch=2, upload_chunk=2, device="cpu")
    try:
        reqs = [eng.submit(ids, img, max_new_tokens=3 + i % 3)
                for i, (ids, img) in enumerate(prompts)]
        eng.run_until_drained()
        got = [r.result(timeout=TIMEOUT_S) for r in reqs]
    finally:
        eng.close()
    records = {r.id: r for r in trace.TRACER.requests() if r.t_submit >= t_start}
    assert sorted(records) == sorted(r.id for r in reqs)
    for req, toks in zip(reqs, got):
        assert req.t_submit <= req.t_on_card <= req.t_admitted <= req.t_first <= req.t_done
        r = records[req.id]
        assert (r.t_submit, r.t_on_card, r.t_admitted, r.t_first, r.t_done) == (
            req.t_submit, req.t_on_card, req.t_admitted, req.t_first, req.t_done)
        assert (r.prompt_tokens, r.served_tokens) == (len(req.input_ids), len(toks))
        assert not r.profiled
    spans = [s for s in trace.TRACER.spans() if s.t0 >= t_start]
    by_id = {s.id: s for s in spans}
    main = threading.get_ident()
    assert all(s.thread == main for s in spans)
    for s in spans:
        if s.name == "serve.tick":
            assert s.parent == 0
        elif s.name == "serve.prefill":
            assert by_id[s.parent].name == "serve.admit"
        else:
            assert by_id[s.parent].name in ("serve.tick", "serve.admit")
    # a request is admitted inside its admission's span, before the prefill
    # is issued
    prefills = [s for s in spans if s.name == "serve.prefill"]
    for req in reqs:
        pf = [p for p in prefills if by_id[p.parent].t0 <= req.t_admitted <= p.t0]
        assert len(pf) == 1
    # the dispatches are dispatch_log's, key for key
    keys = [(k, key) for k, key, _ in eng.dispatch_log]
    assert [("prefill", (s.attrs["b"], s.attrs["t"])) for s in prefills] == [
        x for x in keys if x[0] == "prefill"]
    chunks = [s for s in spans if s.name == "serve.decode_chunk"]
    assert [("decode", (s.attrs["n"], s.attrs["live"])) for s in chunks] == [
        x for x in keys if x[0] == "decode"]
    assert len(chunks) == eng.decode_dispatches
    assert all(p.attrs["t"] == BUCKET for p in prefills)
    assert any(s.name == "serve.read_chunk" for s in spans)

def test_train_step_spans(params, tmp_path):  # noqa: F811 (fixture)
    """One step over two datasets: one ``train.step`` holding a forward and a
    backward a dataset and one ``train.optimizer``; ``train.put_batch`` sits
    beside it."""
    trainer = Trainer(CFG, RunnerConfig(run_dir=str(tmp_path), warmup_steps=0,
                                        precision="fp32"),
                      model=port_model(params), device="cpu",
                      metrics=MetricsLogger(str(tmp_path), use_tensorboard=False))
    rng = np.random.RandomState(3)
    t_start = time.perf_counter_ns()
    batch = trainer.put_batch((make_batch(rng), make_batch(rng, t=16)))
    trainer.step_fn(trainer.state, batch)
    spans = [s for s in trace.TRACER.spans() if s.t0 >= t_start]
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 1
    inside = [s.name for s in spans if s.parent == steps[0].id]
    assert sorted(inside) == sorted(["train.forward", "train.backward"] * 2
                                    + ["train.optimizer"])
    puts = [s for s in spans if s.name == "train.put_batch"]
    assert len(puts) == 1 and puts[0].parent == 0 and puts[0].t1 <= steps[0].t0
    assert all(s.t0 >= steps[0].t0 and s.t1 <= steps[0].t1 for s in spans
               if s.parent == steps[0].id)


@pytest.mark.parametrize("enabled", [False, True])
def test_a_span_does_not_leak_its_stack_on_error(enabled):
    tr = trace.Tracer()
    tr.enabled = enabled
    with pytest.raises(ValueError):
        with tr.span("fails"):
            raise ValueError("inside")
    with tr.span("next") as nxt:
        pass
    assert nxt.parent == 0 and [s.name for s in tr.spans()] == ["fails", "next"]
