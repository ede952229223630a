"""Mean host ms from a request's admission, taken before its prefill is
issued, to its first token read on the host (the prefill's issue and run,
the first decode chunk and the read one chunk late: ``t_first -
t_admitted`` of the program's request records), over the requests answered
in the window outside the profiled slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    recs = program_spans.answered(ctx)
    return None if recs is None else program_spans.mean_ms([r.t_first - r.t_admitted
                                                            for r in recs])
