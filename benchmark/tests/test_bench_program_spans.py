"""The readers of the program's own spans and request records
(``metrics/*.py`` with ``source: program_span`` that read ``aki_torch.trace``)
on synthetic records: what each reads, which records it leaves out, and that
it reads nothing where the ring dropped a record it needed or the program
has no tracer."""

from __future__ import annotations

import itertools

import pytest

from benchmark import harness, program_spans

SERVE = ["upload_ms.serve", "queue_wait_ms.serve", "first_token_ms.serve", "prefill_ms.serve",
         "decode_chunk_ms.serve"]
TRAIN = ["step_issue_ms.train", "optimizer_ms.train"]
MS = 1_000_000          # ns
S = 1_000_000_000
IDS = itertools.count(1)


def reader(name: str):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


class _Events:
    """A span's two CUDA events, ``ms`` apart on the stream."""

    def __init__(self, ms: float):
        self.ms = ms

    def __getitem__(self, i):
        return self

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return self.ms


def add_span(tr, name: str, t0: int, t1: int, parent: int = 0, device: float | None = None,
             sid: int | None = None):
    """A closed span into ``tr``; profiled when ``device`` (its device ms) is
    given."""
    from aki_torch import trace

    s = trace.Span(tr, name, {})
    s.id = next(IDS) if sid is None else sid
    s.parent, s.thread, s.t0, s.t1 = parent, 1, t0, t1
    if device is not None:
        s.profiled, s._events = True, _Events(device)
    tr.record(s)
    return s


def add_request(tr, rid: int, stamps_ms: list[float], profiled: bool = False):
    from aki_torch import trace

    t = [round(x * MS) for x in stamps_ms]
    tr.record(trace.RequestRecord(rid, *t, 300, 16, profiled))


@pytest.fixture
def tracer(monkeypatch):
    from aki_torch import trace

    tr = trace.Tracer()
    monkeypatch.setattr(program_spans, "tracer", lambda: tr)
    return tr


def serve_ctx():
    """A window whose ticks outside the slice run from 1 s to 3 s."""
    return {"ticks": [(1.0, 1.2, 48), (1.5, 1.9, 0), (2.7, 3.0, 40)]}


def test_serving_readers_split_the_answered_requests(tracer):
    add_request(tracer, 0, [900, 950, 990, 995, 999])              # answered before the window
    add_request(tracer, 1, [1000, 1010, 1100, 1500, 2000])
    add_request(tracer, 2, [1200, 1230, 1300, 1900, 2500])
    add_request(tracer, 3, [1400, 1500, 1600, 2000, 2200], profiled=True)
    add_request(tracer, 4, [2900, 2950, 3000, 3010, 3100])         # answered after it
    ctx = serve_ctx()
    assert reader("upload_ms.serve")(ctx) == pytest.approx((10 + 30) / 2)
    assert reader("queue_wait_ms.serve")(ctx) == pytest.approx((90 + 70) / 2)
    assert reader("first_token_ms.serve")(ctx) == pytest.approx((400 + 600) / 2)


def test_serving_device_readers_take_the_profiled_spans_of_the_window(tracer):
    add_span(tracer, "serve.prefill", 500 * MS, 510 * MS, device=99.0)   # warm-up
    add_span(tracer, "serve.prefill", 1 * S, 1 * S + 50 * MS)             # not profiled
    add_span(tracer, "serve.prefill", 2 * S, 2 * S + 50 * MS, device=40.0)
    add_span(tracer, "serve.prefill", 2 * S + 100 * MS, 2 * S + 150 * MS, device=44.0)
    add_span(tracer, "serve.decode_chunk", 2 * S + 200 * MS, 2 * S + 300 * MS, device=120.0)
    add_span(tracer, "serve.decode_chunk", 2 * S + 300 * MS, 2 * S + 400 * MS)
    ctx = serve_ctx()
    assert reader("prefill_ms.serve")(ctx) == pytest.approx(42.0)
    assert reader("decode_chunk_ms.serve")(ctx) == pytest.approx(120.0)
    # the requests' readers find no answered request
    assert all(reader(n)(ctx) is None for n in SERVE[:3])


def test_serving_readers_read_nothing_after_a_drop_in_the_window(monkeypatch):
    from aki_torch import trace

    tr = trace.Tracer(entries=3)
    monkeypatch.setattr(program_spans, "tracer", lambda: tr)
    add_request(tr, 1, [1000, 1010, 1100, 1500, 2000])
    add_span(tr, "serve.prefill", 2 * S, 2 * S + 50 * MS, device=40.0)
    add_request(tr, 2, [1200, 1230, 1300, 1900, 2500])
    add_request(tr, 3, [1300, 1330, 1400, 2000, 2600])
    assert tr.dropped == 1
    assert all(reader(n)(serve_ctx()) is None for n in SERVE)
    # a drop before the window loses nothing the readers need
    tr = trace.Tracer(entries=3)
    monkeypatch.setattr(program_spans, "tracer", lambda: tr)
    add_request(tr, 0, [100, 110, 120, 130, 140])
    add_request(tr, 1, [150, 160, 170, 180, 190])
    add_request(tr, 2, [1200, 1230, 1300, 1900, 2500])
    add_request(tr, 3, [1300, 1330, 1400, 2000, 2600])
    assert tr.dropped == 1 and reader("upload_ms.serve")(serve_ctx()) == pytest.approx(30.0)


def train_ctx(outside: int, inside: int) -> dict:
    return {"steps": [[]] * outside, "slice_steps": [[]] * inside}


def steps(tr, spec: list[tuple[float, float | None]]):
    """``train.step`` spans of (host ms, the optimizer's device ms or None when
    not profiled), one after another, each closing after what it holds."""
    t = 0
    for ms, opt in spec:
        step_id = next(IDS)
        for k, name in enumerate(("train.forward", "train.backward", "train.optimizer")):
            add_span(tr, name, t + k * MS, t + (k + 1) * MS, parent=step_id,
                     device=None if opt is None else (opt if k == 2 else 1.0))
        add_span(tr, "train.step", t, t + round(ms * MS), device=opt, sid=step_id)
        t += round(ms * MS) + MS


def test_training_readers_take_the_windows_steps(tracer):
    # three check steps (long, the first one profiled), then the window: two
    # steps outside the slice and two in it, then one outside again
    steps(tracer, [(900.0, 70.0), (800.0, None), (700.0, None),
                   (10.0, None), (20.0, None), (50.0, 3.0), (60.0, 5.0), (30.0, None)])
    ctx = train_ctx(outside=3, inside=2)
    assert reader("step_issue_ms.train")(ctx) == pytest.approx((10 + 20 + 30) / 3)
    assert reader("optimizer_ms.train")(ctx) == pytest.approx(4.0)


def test_training_readers_read_nothing_without_the_windows_steps(tracer):
    steps(tracer, [(10.0, None), (20.0, 3.0)])
    ctx = train_ctx(outside=2, inside=1)
    assert all(reader(n)(ctx) is None for n in TRAIN)
    assert all(reader(n)({}) is None for n in TRAIN)


def test_the_readers_read_nothing_from_a_program_without_the_tracer(monkeypatch):
    """As on a program that predates the tracer: its import fails."""
    import sys

    import aki_torch

    monkeypatch.delattr(aki_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "aki_torch.trace", None)
    assert program_spans.tracer() is None
    ctx = dict(serve_ctx(), **train_ctx(outside=1, inside=1))
    assert all(reader(n)(ctx) is None for n in SERVE + TRAIN)


def test_the_manifest_lists_each_reader():
    per_layer = {p["name"]: p for p in harness.manifest()["per_layer"]}
    for name in SERVE + TRAIN:
        p = per_layer[name]
        assert p["source"] == "program_span" and p["unit"] == "ms" and p["better"] == "lower"
        assert p["workloads"] == (["serve_w8a8_vqa"] if name in SERVE
                                  else ["train_bf16_pretrain"])
