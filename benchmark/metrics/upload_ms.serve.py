"""Mean host ms from a request's submission to its pixels on the card (the
uploader threads' wait and transfer: ``t_on_card - t_submit`` of the
program's request records), over the requests answered in the window
outside the profiled slice."""

from benchmark import program_spans


def read(ctx: dict) -> float | None:
    recs = program_spans.answered(ctx)
    return None if recs is None else program_spans.mean_ms([r.t_on_card - r.t_submit
                                                            for r in recs])
