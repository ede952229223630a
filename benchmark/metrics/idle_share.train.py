"""Share of the profiled slice of the window in which no operation ran on
the device (the union of its activity intervals in the trace), in %."""

from benchmark import harness


def read(ctx: dict) -> float | None:
    return harness.idle_share(ctx)
