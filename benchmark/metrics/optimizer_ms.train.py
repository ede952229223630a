"""Mean device-stream ms of a step's gradient clip and AdamW update: the CUDA
events at the ends of the program's profiled ``train.optimizer`` spans
inside the window's steps (those of the profiled slice)."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    steps = program_spans.train_steps(ctx)
    tr = program_spans.tracer()
    if steps is None or tr is None:
        return None
    ids = {s.id for s in steps}
    return program_spans.device_ms([s for s in tr.spans("train.optimizer") if s.parent in ids])
