"""Mean host ms from a request's pixels on the card to its admission, taken
before its prefill is issued (the scheduler's wait for free slots and, under
``admit_policy="batched"``, for a full batch: ``t_admitted - t_on_card``
of the program's request records), over the requests answered in the
window outside the profiled slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    recs = program_spans.answered(ctx)
    return None if recs is None else program_spans.mean_ms([r.t_admitted - r.t_on_card
                                                            for r in recs])
