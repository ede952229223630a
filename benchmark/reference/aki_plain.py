"""AKI in plain float32 PyTorch, from the published description and the
model configuration's file alone.

SigLIP-so400m (patch embedding, learned positions, pre-norm blocks with
biased projections, tanh-GELU MLP, post-LN), the Perceiver resampler (latent
cross-attention over media and latents, exact-GELU feed-forward, final norm
and projection), the splice of each image's latents at its ``<image>``
token, and Phi-3.5-mini (RMSNorm, fused q|k|v, neox RoPE with the LongRoPE
short factors and their attention scaling, SiLU-gated MLP) under
modality-mutual attention (MMA): a query may attend a valid key at or
before it, and the latents of an image may also attend forward to the text
after it up to and including ``<|assistant|>``. The head is the decoupled
head: the base vocabulary cut to ``initial_tokenizer_len`` plus the extra
head.

Every product is float32 with TF32 off; attention is the dense softmax.
Two departures serve the serving check, each a statement of the deployed
arithmetic and not a kernel, taken from the configuration's ``serving``
block by :class:`Served`: the quantized products (per output channel int8
or int4 weights with their scale rounded to bf16; under a8, per-row int8
activations in the products of many rows, the weight alone where a product
has fewer) and the int8 KV cache (per token and head).
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = torch.finfo(torch.float32).min


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- int8 arithmetic of the deployment ----------------------------------------

def quant_weight(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-output-channel quantization of an (out, in) weight,
    given back as float32 values: q * s with s = max|row| / maxq (1 for a
    zero row) rounded to bf16, q = clip(round(w / s_f32))."""
    maxq = 127.0 if bits == 8 else 7.0
    w32 = w.float()
    amax = w32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / maxq)
    q = torch.clamp(torch.round(w32 / scale), -maxq, maxq)
    return q * scale.to(torch.bfloat16).float()


def quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-row int8 of f32 rows over the last dim, as values."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0, 1.0, amax / 127.0)
    return torch.clamp(torch.round(x / s), -127, 127) * s


class Served:
    """The served arithmetic that a configuration's ``serving`` block states:
    ``quant`` (w8, w8a8, w4, w4a8: the decoder's and the head's weight bits,
    and whether a product of at least ``A8_MIN_ROWS`` rows, the prefill's
    and the tower's, takes int8 activations; fewer rows, the decode's and
    the head's over the last rows, take the weight alone), ``vision_quant``
    (the tower's projections int8 too, whatever the decoder's bits) and
    ``kv_int8`` (the KV cache int8 per token and head, else float)."""

    A8_MIN_ROWS = 64
    MODES = ("w8", "w8a8", "w4", "w4a8")

    def __init__(self, quant: str, vision_quant: bool, kv_int8: bool):
        if quant not in self.MODES:
            raise ValueError(f"serving quant {quant!r} is not one of {self.MODES}")
        self.bits = 4 if quant.startswith("w4") else 8
        self.a8 = quant.endswith("a8")
        self.vision_quant = bool(vision_quant)
        self.kv_int8 = bool(kv_int8)

    @classmethod
    def of(cls, serving: dict) -> "Served":
        return cls(serving["quant"], serving["vision_quant"], serving["kv_int8"])

    def product(self, x: torch.Tensor, w: torch.Tensor, rows: int, bits: int | None = None
                ) -> torch.Tensor:
        wq = quant_weight(w, self.bits if bits is None else bits)
        if self.a8 and rows >= self.A8_MIN_ROWS:
            x = quant_rows(x)
        return x @ wq.t()

    def tower_product(self, x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
        if not self.vision_quant:
            return x @ w.float().t()
        return self.product(x, w, rows, bits=8)

    def cache(self, x: torch.Tensor) -> torch.Tensor:
        return quant_kv(x) if self.kv_int8 else x


def quant_kv(x: torch.Tensor) -> torch.Tensor:
    """Per (token, head) symmetric int8 over the head dim, as values."""
    return quant_rows(x)


# -- pieces --------------------------------------------------------------------

def layernorm(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope_tables(phi3: dict, positions: torch.Tensor):
    """cos, sin (..., T, head_dim) for int positions: neox rotary with the
    LongRoPE short factors and their scaling."""
    dh = phi3["head_dim"]
    half = dh // 2
    inv = 1.0 / (phi3["rope_theta"] ** (2.0 * torch.arange(half, dtype=torch.float32,
                                                           device=positions.device) / dh))
    if phi3.get("rope_short_factor"):
        inv = inv / torch.tensor(phi3["rope_short_factor"], dtype=torch.float32,
                                 device=positions.device)
    scale = phi3["max_position_embeddings"] / phi3["original_max_position_embeddings"]
    att = 1.0
    if phi3.get("rope_short_factor") and scale > 1.0:
        att = math.sqrt(1.0 + math.log(scale) / math.log(phi3["original_max_position_embeddings"]))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang) * att, torch.sin(ang) * att


def rope(x, cos, sin):
    """x (B, T, H, D); tables (B, T, D)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None] + rot * sin[:, :, None]


def attend(q, k, v, ok):
    """Dense softmax attention, q (B, T, H, D), k, v (B, S, Hkv, D), ok
    (B, T, S) bool or None; a row with no allowed key gives 0."""
    h, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * d ** -0.5
    if ok is not None:
        s = s.masked_fill(~ok[:, None], NEG)
    p = torch.softmax(s, dim=-1)
    if ok is not None:
        p = p * ok.any(dim=-1)[:, None, :, None]
    return torch.einsum("bhts,bshd->bthd", p, v)


# -- the vision tower and the resampler ------------------------------------------

def keep(t: torch.Tensor) -> torch.Tensor:
    """A stored activation as the reference keeps it: float32, unchanged.
    The ``store`` argument of the functions below takes another rounding
    (the check's control)."""
    return t


def tower(w: dict, cfg: dict, images: torch.Tensor, q: Served | None = None,
          store=keep) -> torch.Tensor:
    """Pixels (N, H, W, C) in [-1, 1] -> (N, patches, hidden)."""
    s = cfg["siglip"]
    ps, hs, nh, eps = s["patch_size"], s["hidden_size"], s["num_heads"], s["layer_norm_eps"]
    pre = "vision_encoder"
    n, hgt, wid, c = images.shape
    gh, gw = hgt // ps, wid // ps
    x = images[:, : gh * ps, : gw * ps].reshape(n, gh, ps, gw, ps, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, gh * gw, ps * ps * c)
    conv = w[f"{pre}.embeddings.patch_embedding.weight"].float()
    x = x @ conv.permute(2, 3, 1, 0).reshape(-1, hs) + w[f"{pre}.embeddings.patch_embedding.bias"]
    x = store(x + w[f"{pre}.embeddings.position_embedding.weight"].float())
    rows = n * x.shape[1]

    def lin(h, name):
        wt, b = w[f"{name}.weight"], w[f"{name}.bias"].float()
        y = h @ wt.float().t() if q is None else q.tower_product(h, wt, rows)
        return store(y + b)

    for i in range(s["num_layers"]):
        li = f"{pre}.encoder.layers.{i}"
        h = store(layernorm(x, w[f"{li}.layer_norm1.weight"].float(),
                            w[f"{li}.layer_norm1.bias"].float(), eps))
        qkv = [lin(h, f"{li}.self_attn.{p}").reshape(n, -1, nh, hs // nh)
               for p in ("q_proj", "k_proj", "v_proj")]
        o = store(attend(*qkv, None).reshape(n, -1, hs))
        x = store(x + lin(o, f"{li}.self_attn.out_proj"))
        h = store(layernorm(x, w[f"{li}.layer_norm2.weight"].float(),
                            w[f"{li}.layer_norm2.bias"].float(), eps))
        h = store(F.gelu(lin(h, f"{li}.mlp.fc1"), approximate="tanh"))
        x = store(x + lin(h, f"{li}.mlp.fc2"))
    return layernorm(x, w[f"{pre}.post_layernorm.weight"].float(),
                     w[f"{pre}.post_layernorm.bias"].float(), eps)


def resampler(w: dict, cfg: dict, feats: torch.Tensor, store=keep) -> torch.Tensor:
    """Features (N, patches, dim) -> (N, latents, LM width)."""
    p = cfg["perceiver"]
    h, dh = p["heads"], p["dim_head"]
    pre = "vision_tokenizer"
    g = lambda k: w[f"{pre}.{k}"].float()  # noqa: E731
    n = feats.shape[0]
    lat = g("latents").expand(n, -1, -1)
    for i in range(p["depth"]):
        b = f"layers.{i}"
        xm = store(layernorm(feats, g(f"{b}.0.norm_media.weight"), g(f"{b}.0.norm_media.bias"),
                             1e-5))
        ll = store(layernorm(lat, g(f"{b}.0.norm_latents.weight"),
                             g(f"{b}.0.norm_latents.bias"), 1e-5))
        qq = store(ll @ g(f"{b}.0.to_q.weight").t()).reshape(n, -1, h, dh)
        k, v = store(torch.cat([xm, ll], dim=1) @ g(f"{b}.0.to_kv.weight").t()).chunk(2, dim=-1)
        o = store(attend(qq, k.reshape(n, -1, h, dh), v.reshape(n, -1, h, dh), None))
        lat = store(lat + o.reshape(n, -1, h * dh) @ g(f"{b}.0.to_out.weight").t())
        f = store(layernorm(lat, g(f"{b}.1.0.weight"), g(f"{b}.1.0.bias"), 1e-5))
        f = store(F.gelu(f @ g(f"{b}.1.1.weight").t()))
        lat = store(lat + f @ g(f"{b}.1.3.weight").t())
    lat = store(layernorm(lat, g("norm.weight"), g("norm.bias"), 1e-5))
    return store(lat @ g("projection.weight").t() + g("projection.bias"))


# -- the splice and the mask -------------------------------------------------------

def embed(w: dict, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """The decoupled embedding: ids at or past ``initial_tokenizer_len``
    read the extra table."""
    base = w["lang_model.model.embed_tokens.weight"].float()
    extra = w["lang_model.model.embed_tokens.additional_embedding.weight"].float()
    n0 = cfg["initial_tokenizer_len"]
    is_extra = ids >= n0
    out = base[torch.where(is_extra, 0, ids)]
    return torch.where(is_extra[..., None], extra[torch.where(is_extra, ids - n0, 0)], out)


def splice(cfg: dict, text: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
           vision: torch.Tensor, labels: torch.Tensor | None = None):
    """One row: text embeddings (T, D), ids and validity (T,), vision tokens
    (N_img, n_vis, D). Image j replaces the j-th ``<image>``; an image slot
    the row has no ``<image>`` for is parked after all the text, invalid.
    Returns embeds (T_full, D), validity (T_full,) bool, labels or None,
    and the MMA blocks [(latents start, keys start, keys end)]."""
    media, asst = cfg["media_token_id"], cfg["assistant_token_id"]
    n_img, n_vis = vision.shape[0], vision.shape[1]
    dev = text.device
    parts, vparts, lparts, starts = [], [], [], []
    pos, j, t0, asst_at = 0, 0, 0, None
    ids_l = ids.tolist()
    for t, tok in enumerate(ids_l):
        if tok == media and j < n_img:
            if t > t0:
                parts.append(text[t0:t])
                vparts.append(valid[t0:t] != 0)
                if labels is not None:
                    lparts.append(labels[t0:t])
                pos += t - t0
            parts.append(vision[j])
            vparts.append(torch.ones(n_vis, dtype=torch.bool, device=dev))
            if labels is not None:
                lparts.append(torch.full((n_vis,), -100, dtype=labels.dtype, device=dev))
            starts.append(pos)
            pos += n_vis
            j += 1
            t0 = t + 1
        elif tok == asst and asst_at is None:
            asst_at = pos + (t - t0)
    parts.append(text[t0:])
    vparts.append(valid[t0:] != 0)
    if labels is not None:
        lparts.append(labels[t0:])
    for jj in range(j, n_img):
        parts.append(vision[jj])
        vparts.append(torch.zeros(n_vis, dtype=torch.bool, device=dev))
        if labels is not None:
            lparts.append(torch.full((n_vis,), -100, dtype=labels.dtype, device=dev))
    end = -1 if asst_at is None else asst_at + 1
    blocks = [(s, s + n_vis, end) for s in starts]
    # parked slots past the row's length are cut: every row is
    # T + N_img * (n_vis - 1) long, its valid positions a prefix
    t_full = text.shape[0] + n_img * (n_vis - 1)
    return (torch.cat(parts)[:t_full], torch.cat(vparts)[:t_full],
            None if labels is None else torch.cat(lparts)[:t_full], blocks)


def mma_mask(t: int, valid: torch.Tensor, blocks, device) -> torch.Tensor:
    """(T, T) bool: a valid key at or before the query, or a key of an
    image's block for its latents."""
    qp = torch.arange(t, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    ok = kp <= qp
    for s, k0, k1 in blocks:
        ok = ok | ((qp >= s) & (qp < k0) & (kp >= k0) & (kp < k1))
    return ok & valid[None, :]


# -- the decoder ---------------------------------------------------------------------

def decoder_layer(w: dict, cfg: dict, i: int, x, cos, sin, ok, product, store=keep):
    """One decoder layer over x (B, T, D) under mask ok (B, T, T);
    ``product(h, weight name)`` is a layer's projection, ``store`` rounds
    what the layer keeps."""
    d = cfg["phi3"]
    nh, nkv, dh, eps = d["num_heads"], d["num_kv_heads"], d["head_dim"], d["rms_norm_eps"]
    b, t, _ = x.shape
    li = f"lang_model.model.layers.{i}"
    h = store(rmsnorm(x, w[f"{li}.input_layernorm.weight"].float(), eps))
    qkv = store(product(h, f"{li}.self_attn.qkv_proj.weight"))
    q = store(rope(qkv[..., : nh * dh].reshape(b, t, nh, dh), cos, sin))
    k = store(rope(qkv[..., nh * dh: (nh + nkv) * dh].reshape(b, t, nkv, dh), cos, sin))
    v = qkv[..., (nh + nkv) * dh:].reshape(b, t, nkv, dh)
    o = store(attend(q, k, v, ok).reshape(b, t, nh * dh))
    x = store(x + product(o, f"{li}.self_attn.o_proj.weight"))
    h = store(rmsnorm(x, w[f"{li}.post_attention_layernorm.weight"].float(), eps))
    gate, up = store(product(h, f"{li}.mlp.gate_up_proj.weight")).chunk(2, dim=-1)
    return store(x + product(store(F.silu(gate) * up), f"{li}.mlp.down_proj.weight"))


def head(w: dict, cfg: dict, h: torch.Tensor, product) -> torch.Tensor:
    """The decoupled head over final-normed rows h (..., D)."""
    n0 = cfg["initial_tokenizer_len"]
    base = product(h, "lang_model.lm_head.weight")[..., :n0]
    base = base + w["lang_model.lm_head.bias"].float()[:n0]
    extra = h @ w["lang_model.lm_head.additional_fc.weight"].float().t()
    return torch.cat([base, extra + w["lang_model.lm_head.additional_fc.bias"].float()], dim=-1)


def float_product(w: dict) -> Callable:
    return lambda h, name: h @ w[name].float().t()


# -- training: loss, gradients, AdamW ------------------------------------------------

def batch_loss(w: dict, cfg: dict, batch: dict, product=None, remat: bool = True,
               rows: slice | None = None, store=keep) -> torch.Tensor:
    """Mean next-token cross-entropy of one batch (the loader's dict:
    input_ids, attn_valid, labels (B, T), images (B, H, W, C) or
    (B, N_img, H, W, C)); ``rows`` keeps some rows only. The tower runs
    without gradient; each decoder layer is recomputed in the backward
    under ``remat``."""
    product = product or float_product(w)
    ids, valid, labels, images = (torch.as_tensor(batch[k]) for k in
                                  ("input_ids", "attn_valid", "labels", "images"))
    if rows is not None:
        ids, valid, labels, images = ids[rows], valid[rows], labels[rows], images[rows]
    ids, labels = ids.long(), labels.long()
    b = ids.shape[0]
    imgs = images if images.dim() == 5 else images[:, None]
    n_img = imgs.shape[1]
    with torch.no_grad():
        feats = tower(w, cfg, imgs.reshape(-1, *imgs.shape[2:]).float(), store=store)
    vis = resampler(w, cfg, feats, store).reshape(b, n_img, -1, cfg["phi3"]["hidden_size"])
    text = store(embed(w, cfg, ids))
    rows_out = [splice(cfg, text[r], ids[r], valid[r], vis[r], labels[r]) for r in range(b)]
    x = torch.stack([r[0] for r in rows_out])
    ok = torch.stack([mma_mask(x.shape[1], r[1], r[3], x.device) for r in rows_out])
    lab = torch.stack([r[2] for r in rows_out])
    pos = torch.arange(x.shape[1], device=x.device).expand(b, -1)
    cos, sin = rope_tables(cfg["phi3"], pos)
    for i in range(cfg["phi3"]["num_layers"]):
        if remat:
            x = checkpoint(decoder_layer, w, cfg, i, x, cos, sin, ok, product, store,
                           use_reentrant=False)
        else:
            x = decoder_layer(w, cfg, i, x, cos, sin, ok, product, store)
    x = store(rmsnorm(x, w["lang_model.model.norm.weight"].float(),
                      cfg["phi3"]["rms_norm_eps"]))
    logits = head(w, cfg, x, product)[:, :-1]
    tgt = lab[:, 1:]
    keep = tgt != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(keep, tgt, 0)[..., None])[..., 0]
    return torch.where(keep, nll, 0.0).sum() / keep.sum().clamp(min=1)


def schedule(tc: dict) -> Callable[[int], float]:
    """Linear warmup from 0 for ``warmup_steps`` updates, then cosine to
    ``min_lr`` at ``total_steps`` (the update count n from 0)."""
    peak, lo, wu, tot = tc["learning_rate"], tc["min_lr"], tc["warmup_steps"], tc["total_steps"]

    def lr(n):
        if n < wu:
            return peak * min(max(n, 0), wu) / max(wu, 1)
        m = min(n - wu, max(tot - wu, 1))
        cos = 0.5 * (1 + math.cos(math.pi * m / max(tot - wu, 1)))
        alpha = lo / peak
        return peak * ((1 - alpha) * cos + alpha)
    return lr


def is_trainable(name: str, frozen_tower: bool = True) -> bool:
    return not (frozen_tower and name.startswith("vision_encoder."))


def train_steps(w: dict, cfg: dict, tc: dict, steps: list, product=None,
                half: bool = False, store=keep) -> dict:
    """Follow ``len(steps)`` optimizer steps from the weights ``w`` (float32,
    updated in place): each step a tuple of batches (one per dataset) whose
    gradients sum, clipped by the global norm at ``grad_clip``, then AdamW
    (bias-corrected moments, decoupled decay lr * wd * p on every trainable
    parameter). ``half`` keeps the first half of each batch's rows;
    ``product`` and ``store`` compute the products and round the kept
    activations another way (the check's control).
    Returns each step's loss (the mean over its datasets), each leaf's
    clipped first gradient's norm and, per leaf, the norm of its change
    after the last step (``start`` norms of the weights minus the start
    state are taken by the caller)."""
    lr_of = schedule(tc)
    b1, b2, eps, wd, clip = tc["b1"], tc["b2"], tc["eps"], tc["weight_decay"], tc["grad_clip"]
    params = {n: t.detach().requires_grad_(True) for n, t in w.items()
              if is_trainable(n, tc["frozen_tower"])}
    w.update(params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], {}
    for k, step in enumerate(steps):
        total = []
        for batch in step:
            rows = slice(0, batch["input_ids"].shape[0] // 2) if half else None
            loss = batch_loss(w, cfg, batch, product, rows=rows, store=store)
            loss.backward()
            total.append(loss.detach())
        losses.append(float(sum(total) / len(total)))
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items() if p.grad is not None}
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            factor = 1.0 if float(norm) < clip else clip / float(norm)
            lr = lr_of(k)
            t = k + 1
            for n, p in params.items():
                g = grads.get(n)
                if g is None:
                    continue
                g.mul_(factor)
                if k == 0:
                    first[n] = float(torch.linalg.vector_norm(g))
                p.mul_(1 - lr * wd)
                m[n].lerp_(g, 1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p.grad = None
            del grads, g
    for p in params.values():
        p.requires_grad_(False)
    return dict(losses=losses, first_grad=first)


# -- serving: the served tokens under teacher forcing ------------------------------------

def served_logits(w: dict, cfg: dict, prompts: list, quant: Served) -> list[torch.Tensor]:
    """For each (ids, uint8 pixels (H, W, C), served tokens) the logits the
    deployment gives each served token: the prompt's prefill (int8
    activations under a8), then each earlier served token decoded over the
    cache (the weight alone), teacher-forced. Returns a (n, V) tensor a
    prompt. Runs layer by layer over all prompts, so that each layer's
    weights are quantized once."""
    dev = next(iter(w.values())).device
    d = cfg["phi3"]
    nh, nkv, dh, eps = d["num_heads"], d["num_kv_heads"], d["head_dim"], d["rms_norm_eps"]
    imgs = torch.stack([torch.as_tensor(px, device=dev) for _, px, _ in prompts])
    vis = resampler(w, cfg, tower(w, cfg, imgs.float() / 127.5 - 1.0, quant))
    state = []
    for r, (ids, _, served) in enumerate(prompts):
        ids_t = torch.as_tensor(ids, device=dev).long()
        x, valid, _, blocks = splice(cfg, embed(w, cfg, ids_t), ids_t,
                                     torch.ones_like(ids_t), vis[r:r + 1])
        t = x.shape[0]
        dec_ids = torch.as_tensor(served[:-1], device=dev).long()
        n = dec_ids.shape[0]
        pos = torch.arange(t + n, device=dev)[None]
        cos, sin = rope_tables(d, pos)
        state.append(dict(x=x[None], y=embed(w, cfg, dec_ids)[None], t=t, n=n, cos=cos,
                          sin=sin, ok=mma_mask(t, valid, blocks, dev)[None]))
    for i in range(d["num_layers"]):
        li = f"lang_model.model.layers.{i}"
        wq = {k: quant_weight(w[f"{li}.{k}.weight"], quant.bits)
              for k in ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj",
                        "mlp.down_proj")}
        for st in state:
            t, n = st["t"], st["n"]
            kv = []
            for part, (x, a8) in enumerate(((st["x"], True), (st["y"], False))):
                if part == 1 and n == 0:
                    kv.append(None)
                    continue
                rows = slice(0, t) if part == 0 else slice(t, t + n)
                cos, sin = st["cos"][:, rows], st["sin"][:, rows]
                prod = (lambda h, k: quant_rows(h) @ wq[k].t()) if a8 and quant.a8 else (
                    lambda h, k: h @ wq[k].t())
                b, tt, _ = x.shape
                h = rmsnorm(x, w[f"{li}.input_layernorm.weight"].float(), eps)
                qkv = prod(h, "self_attn.qkv_proj")
                q = rope(qkv[..., : nh * dh].reshape(b, tt, nh, dh), cos, sin)
                k = rope(qkv[..., nh * dh: (nh + nkv) * dh].reshape(b, tt, nkv, dh), cos, sin)
                v = qkv[..., (nh + nkv) * dh:].reshape(b, tt, nkv, dh)
                if part == 0:
                    # the prompt attends over its own float K/V; the cache
                    # keeps them as the deployment does
                    o = attend(q, k, v, st["ok"])
                    kv.append((quant.cache(k), quant.cache(v)))
                else:
                    kc = torch.cat([kv[0][0], quant.cache(k)], dim=1)
                    vc = torch.cat([kv[0][1], quant.cache(v)], dim=1)
                    ok = torch.ones(n, t + n, dtype=torch.bool, device=dev).tril(t)[None]
                    o = attend(q, kc, vc, ok)
                x = x + prod(o.reshape(b, tt, nh * dh), "self_attn.o_proj")
                h = rmsnorm(x, w[f"{li}.post_attention_layernorm.weight"].float(), eps)
                gate, up = prod(h, "mlp.gate_up_proj").chunk(2, dim=-1)
                x = x + prod(F.silu(gate) * up, "mlp.down_proj")
                st["x" if part == 0 else "y"] = x
        del wq
    head_w = {"lang_model.lm_head.weight": quant_weight(w["lang_model.lm_head.weight"],
                                                        quant.bits)}
    out = []
    for st in state:
        last = st["x"][:, st["t"] - 1: st["t"]]
        h = torch.cat([last, st["y"]], dim=1)[0]
        h = rmsnorm(h, w["lang_model.model.norm.weight"].float(), eps)
        out.append(head(w, cfg, h, lambda hh, k: hh @ head_w[k].t()))
    return out


def widest_gap(logits: torch.Tensor, tokens) -> tuple[float, int]:
    """The widest gap, over the std of the row, by which a served token's
    logit lies below the row's best; and where it is."""
    tok = torch.as_tensor(tokens, device=logits.device).long()
    top = logits.max(dim=-1).values
    gap = (top - logits.gather(1, tok[:, None])[:, 0]) / logits.std(dim=-1)
    i = int(gap.argmax())
    return float(gap[i]), i
