"""Mean device-stream ms of a decode chunk (``decode_chunk`` steps of every
slot): the CUDA events at the ends of the program's profiled
``serve.decode_chunk`` spans, those of the profiled slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    spans = program_spans.window_spans(ctx, "serve.decode_chunk")
    return None if spans is None else program_spans.device_ms(spans)
