"""K5, the fused "norm or activation + int8 quantize" kernel
(``fused_quant_kernel``), against its roofline over the profiled slice: the
least time its launches could take (each launch's operations over the f32
peak or its bytes over HBM's, whichever is larger) over their device time,
in %. The launches are those of the admission prefills the slice
dispatched: per prefill of b rows at text bucket t, rms before every
decoder projection that reads a norm (2 a layer) and silu before down_proj
(1 a layer) on b x (t + latents - 1) rows, ln (2 a tower layer) and gelu (1
a tower layer, over the width padded to 128) on b x patches rows."""

from benchmark import harness, yardstick


def launches(model: dict, b: int, t: int, n_vis: int) -> list[tuple[str, int, int, int]]:
    """(op, rows, width, launches) of one admission prefill."""
    ph, sg = model["phi3"], model["siglip"]
    dec_rows = b * (t + n_vis - 1)
    img_rows = b * (sg["image_size"] // sg["patch_size"]) ** 2
    gelu_d = -(-sg["intermediate_size"] // 128) * 128
    return [("rms", dec_rows, ph["hidden_size"], 2 * ph["num_layers"]),
            ("silu", dec_rows, ph["intermediate_size"], ph["num_layers"]),
            ("ln", img_rows, sg["hidden_size"], 2 * sg["num_layers"]),
            ("gelu", img_rows, gelu_d, sg["num_layers"])]


def read(ctx: dict) -> float | None:
    tr, prefills = ctx.get("trace"), ctx.get("slice_prefills")
    if tr is None or not prefills:
        return None
    bound, issued = 0.0, 0
    for b, t in prefills:
        for op, rows, d, n in launches(ctx["model"], b, t, ctx["n_vis"]):
            flops, nbytes = yardstick.fused_quant_work(op, rows, d)
            bound += n * yardstick.bound_s(flops, nbytes, yardstick.PEAK_F32_FLOPS)
            issued += n
    device_s = harness.issued_time(tr, "fused_quant_kernel", issued)
    if device_s is None:
        return None
    return bound / device_s * 100.0
