"""Mean device-stream ms of an admission prefill: the CUDA events at the ends
of the program's profiled ``serve.prefill`` spans, those of the profiled
slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    spans = program_spans.window_spans(ctx, "serve.prefill")
    return None if spans is None else program_spans.device_ms(spans)
