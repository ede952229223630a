"""The training steps' model work as a share of the chip's bf16 peak, in %:
the operations the window's steps needed, counted from shapes, over the
window's length times 989 TFLOP/s a chip. A step's work: 6 x the decoder's
projection and head weights x its valid spliced tokens; the decoder's
attention, 12 x heads x head_dim a layer for each allowed (query, key)
pair of valid positions (forward 4, backward 8); for each image present,
the Perceiver's forward and backward (6 x each product's weights x its
rows, 12 x a layer's attention pairs) and the frozen tower's forward (2 x
weights x patches, 4 x patches^2 x width a layer, the patch embedding).
Recompute is not counted; padding and absent image slots are not."""

from benchmark import yardstick


def image_ops(model: dict) -> float:
    sg, pc = model["siglip"], model["perceiver"]
    patches = (sg["image_size"] // sg["patch_size"]) ** 2
    hs, inter = sg["hidden_size"], sg["intermediate_size"]
    tower = 2 * patches * (4 * hs * hs + 2 * hs * inter) * sg["num_layers"]
    tower += 4 * patches * patches * hs * sg["num_layers"]
    tower += 2 * patches * sg["patch_size"] ** 2 * sg["num_channels"] * hs
    n, d, inner = pc["num_latents"], pc["dim"], pc["dim_head"] * pc["heads"]
    kv = patches + n
    block = n * d * inner + kv * d * 2 * inner + n * inner * d + 2 * n * d * d * pc["ff_mult"]
    perceiver = 6 * block * pc["depth"] + 12 * n * kv * inner * pc["depth"]
    perceiver += 6 * n * d * pc["dim_inner"]
    return tower + perceiver


def step_ops(step: list[dict], model: dict) -> float:
    ph = model["phi3"]
    dd, nh, nkv, dh, di = (ph["hidden_size"], ph["num_heads"], ph["num_kv_heads"],
                           ph["head_dim"], ph["intermediate_size"])
    weights = ph["num_layers"] * (dd * (nh + 2 * nkv) * dh + nh * dh * dd + 3 * dd * di)
    weights += dd * (model["initial_tokenizer_len"] + model["num_extra_tokens"])
    n_vis = model["perceiver"]["num_latents"]
    ops = 0.0
    for rows in step:
        ids = rows["input_ids"]
        valid = rows["attn_valid"] != 0
        images = int(((ids == model["media_token_id"]) & valid).sum(axis=1)
                     .clip(max=rows["slots"]).sum())
        tokens = int(valid.sum()) + images * (n_vis - 1)
        mask = yardstick.attention_masks(rows, model)
        ops += 6 * weights * tokens + images * image_ops(model)
        ops += 12 * nh * dh * yardstick.valid_pairs(mask) * ph["num_layers"]
    return ops


def read(ctx: dict) -> float | None:
    steps = ctx.get("steps")
    if not steps:
        return None
    ops = sum(step_ops(step, ctx["model"]) for step in steps)
    return ops / (ctx["window_s"] * yardstick.PEAK_BF16_FLOPS * ctx["chips"]) * 100.0
