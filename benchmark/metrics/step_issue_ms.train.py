"""Mean host ms of a training step's call (the program's ``train.step`` span:
the forward, backward and optimizer as the host issues them), over the
window's steps outside the profiled slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    steps = program_spans.train_steps(ctx)
    return None if steps is None else program_spans.mean_ms([s.t1 - s.t0 for s in steps
                                                             if not s.profiled])
