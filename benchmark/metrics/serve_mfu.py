"""The served model work's share of the chip's peak, in %: for every request
answered in the window, the operations its answer needed, counted from
shapes, each at the peak of its type (int8 products at 1,979 TOP/s, bf16 at
989 TFLOP/s), over the window's length.

A request's work: the tower over its image (int8 projections; bf16 patch
embedding and attention), the Perceiver (bf16), its prompt's prefill
(int8 projections over the spliced prompt; bf16 attention over the pairs
the MMA mask allows), the head at the prompt's last position and each
decoded token's step (the products of a decode step read the int8 weight
alone, converted: bf16; attention over the tokens before it). Only the
work a request needs is counted: no padding, no dummy rows, no inactive
slot."""

from benchmark import yardstick


def request_ops(model: dict, text: int, served: int, media_at: int = 1,
                assistant_at: int = 40) -> tuple[float, float]:
    """(int8 ops, bf16 FLOPs) of one answered request of ``text`` prompt
    tokens (one image) and ``served`` tokens."""
    sg, pc, ph = model["siglip"], model["perceiver"], model["phi3"]
    n_vis = pc["num_latents"]
    patches = (sg["image_size"] // sg["patch_size"]) ** 2
    hs, inter = sg["hidden_size"], sg["intermediate_size"]
    tower_w = 4 * hs * hs + 2 * hs * inter
    int8 = 2 * patches * tower_w * sg["num_layers"]
    bf16 = 2 * patches * (sg["patch_size"] ** 2 * sg["num_channels"]) * hs
    bf16 += 4 * patches * patches * hs * sg["num_layers"]
    # Perceiver: q and the feed-forward on the latents, k|v on media and latents
    d, inner, kv = pc["dim"], pc["dim_head"] * pc["heads"], patches + n_vis
    per_block = (n_vis * d * inner + kv * d * 2 * inner + n_vis * inner * d
                 + 2 * n_vis * d * d * pc["ff_mult"])
    bf16 += 2 * per_block * pc["depth"] + 4 * n_vis * kv * inner * pc["depth"]
    bf16 += 2 * n_vis * d * pc["dim_inner"]
    # the decoder
    dd, nh, nkv, dh, di = (ph["hidden_size"], ph["num_heads"], ph["num_kv_heads"],
                           ph["head_dim"], ph["intermediate_size"])
    layer_w = dd * (nh + 2 * nkv) * dh + nh * dh * dd + dd * 2 * di + di * dd
    head_w = dd * (model["initial_tokenizer_len"] + model["num_extra_tokens"])
    t = text + n_vis - 1
    int8 += 2 * t * layer_w * ph["num_layers"]
    asst = assistant_at + n_vis - 1
    pairs = t * (t + 1) // 2 + n_vis * max(0, asst + 1 - (media_at + n_vis))
    bf16 += 4 * nh * dh * pairs * ph["num_layers"]
    bf16 += 2 * head_w
    for k in range(1, served):
        bf16 += 2 * layer_w * ph["num_layers"] + 2 * head_w
        bf16 += 4 * nh * dh * (t + k) * ph["num_layers"]
    return int8, bf16


def read(ctx: dict) -> float | None:
    done = ctx.get("finished")
    if not done:
        return None
    busy = 0.0
    for text, served in done:
        int8, bf16 = request_ops(ctx["model"], text, served, ctx["media_at"],
                                 ctx["assistant_at"])
        busy += int8 / yardstick.PEAK_INT8_OPS + bf16 / yardstick.PEAK_BF16_FLOPS
    return busy / ctx["window_s"] * 100.0
