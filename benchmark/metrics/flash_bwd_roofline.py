"""The flash backward kernels (``flash_mma_dq_kernel`` and
``flash_mma_dkv_kernel``) against their roofline over the profiled slice's
steps: the least time their launches could take (``backward_work``: dq 6*d
and dkv 8*d FLOPs a head and allowed pair, each over the bf16 peak or its
bytes over HBM's, whichever is larger) over their device time, in %. One
dq and one dkv launch a decoder layer, a dataset and a step, under the
batch's MMA mask and key validity."""

from benchmark import harness, yardstick


def read(ctx: dict) -> float | None:
    tr, steps = ctx.get("trace"), ctx.get("slice_steps")
    if tr is None or not steps:
        return None
    ph = ctx["model"]["phi3"]
    bound, issued = 0.0, 0
    for step in steps:
        for rows in step:
            mask = yardstick.attention_masks(rows, ctx["model"])
            b, t = mask.shape[0], mask.shape[1]
            dq, dkv, _ = yardstick.backward_work(b, t, t, ph["num_heads"], ph["num_kv_heads"],
                                                 ph["head_dim"], mask)
            bound += (yardstick.bound_s(*dq) + yardstick.bound_s(*dkv)) * ph["num_layers"]
            issued += ph["num_layers"]
    dq_s = harness.issued_time(tr, "flash_mma_dq", issued)
    dkv_s = harness.issued_time(tr, "flash_mma_dkv", issued)
    if dq_s is None or dkv_s is None:
        return None
    return bound / (dq_s + dkv_s) * 100.0
