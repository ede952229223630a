"""The flash forward kernel (``flash_mma_fwd_kernel``: K1, and K2 on the
interleaved rows) against its roofline over the profiled slice's steps:
the least time its launches could take (each launch's FLOPs over the bf16
peak or its bytes over HBM's, whichever is larger, ``allowed_work``) over
their device time, in %. Per step and dataset: the tower's layers over all
image slots (every pair, no key validity), then the decoder's forward and
its recompute in the backward, a launch each a layer, under the batch's
MMA mask and key validity."""

from benchmark import harness, yardstick


def launches(rows: dict, model: dict) -> list[tuple[float, int]]:
    """(bound seconds, launches) of one dataset's batch in one step."""
    sg, ph = model["siglip"], model["phi3"]
    patches = (sg["image_size"] // sg["patch_size"]) ** 2
    n_img = rows["input_ids"].shape[0] * rows["slots"]
    hs, nh = sg["hidden_size"], sg["num_heads"]
    tower = yardstick.allowed_work(n_img, patches, patches, nh, nh, hs // nh, None, 0)
    mask = yardstick.attention_masks(rows, model)
    b, t = mask.shape[0], mask.shape[1]
    dec = yardstick.allowed_work(b, t, t, ph["num_heads"], ph["num_kv_heads"], ph["head_dim"],
                                 mask, 1)
    return [(yardstick.bound_s(*tower), sg["num_layers"]),
            (yardstick.bound_s(*dec), 2 * ph["num_layers"])]


def read(ctx: dict) -> float | None:
    tr, steps = ctx.get("trace"), ctx.get("slice_steps")
    if tr is None or not steps:
        return None
    bound, issued = 0.0, 0
    for step in steps:
        for rows in step:
            for sec, n in launches(rows, ctx["model"]):
                bound += sec * n
                issued += n
    device_s = harness.issued_time(tr, "flash_mma_fwd", issued)
    return None if device_s is None else bound / device_s * 100.0
