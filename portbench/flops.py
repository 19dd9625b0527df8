"""Analytic operations and bytes of the model, and the H100's peaks.

The module walk is `benchmarks/flop_count.py`'s (U-Net forward, kl-f8
decode and encode, a training image as the encode and three U-Net
forwards), read from a configuration file's sizes instead of a table, with
the bytes a call must move added for each layer a roofline reads. A
multiply-add is 2 FLOPs. GroupNorm, softmax and elementwise work are not
counted as operations. Bytes count each input, weight and output once,
from the shapes, whatever an implementation reads again.

Peaks: NVIDIA H100 SXM5 data sheet, dense, at the 700 W board limit:
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for one call."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def conv(h, w, cin, cout, k=3):
    return 2 * h * w * k * k * cin * cout


def dense(rows, cin, cout):
    return 2 * rows * cin * cout


def _ctx_tokens(cfg: dict) -> int:
    return cfg["text_tokens"] + cfg["style_tokens"] + (
        1 if cfg.get("pose_input_dim") else 0)


# ------------------------------------------------------------ layers


def transformer(b, t, c, tk):
    """A SpatialTransformer call over (b, t, c) tokens with tk context
    tokens whose cross K/V are projected outside it: (flops, bytes)."""
    f = dense(t, c, c) * 2              # proj_in, proj_out
    f += dense(t, c, 3 * c)             # self q, k, v
    f += 2 * 2 * t * t * c              # scores and the value product
    f += dense(t, c, c)                 # self out
    f += dense(t, c, c)                 # cross q
    f += 2 * 2 * t * tk * c             # cross scores and value product
    f += dense(t, c, c)                 # cross out
    f += dense(t, c, 8 * c) + dense(t, 4 * c, c)  # GEGLU
    nbytes = BF16 * (2 * b * t * c + 2 * b * tk * c + 20 * c * c + 21 * c)
    return b * f, nbytes


def transformer_with_context(b, t, c, tk, ctx_dim):
    """The same with the context's K/V projected inside the call (the
    training path): (flops, bytes)."""
    f, nbytes = transformer(b, t, c, tk)
    f += b * dense(tk, ctx_dim, 2 * c)
    nbytes += BF16 * (b * tk * ctx_dim + 2 * c * ctx_dim - 2 * b * tk * c)
    return f, nbytes


def resblock(b, h, w, cin, cout, emb):
    """A U-Net ResBlock call: (flops, bytes)."""
    f = conv(h, w, cin, cout) + conv(h, w, cout, cout) + dense(1, emb, cout)
    weights = 9 * cin * cout + 9 * cout * cout + emb * cout
    vectors = 2 * cin + 5 * cout
    if cin != cout:
        f += conv(h, w, cin, cout, k=1)
        weights += cin * cout
        vectors += cout
    nbytes = BF16 * (b * h * w * (cin + cout) + b * emb + weights + vectors)
    return b * f, nbytes


# ------------------------------------------------------------ walks


def unet_layers(cfg: dict) -> List[Tuple[str, float]]:
    """(kind, FLOPs) of every part of one U-Net forward of one image, in
    call order: conv_in, res, attn, down, up, out."""
    u = cfg["unet"]
    mc, mult, nres = u["model_channels"], u["channel_mult"], u["num_res_blocks"]
    attn_ds, tk = u["attention_resolutions"], _ctx_tokens(cfg)
    emb = 4 * mc
    h, w = cfg["latent_size"]
    out = [("conv_in", conv(h, w, u["in_channels"], mc))]
    skips, ch, ds = [mc], mc, 1
    for i, m in enumerate(mult):
        for _ in range(nres):
            out.append(("res", resblock(1, h, w, ch, m * mc, emb)[0]))
            ch = m * mc
            if ds in attn_ds:
                out.append(("attn", transformer(1, h * w, ch, tk)[0]))
            skips.append(ch)
        if i != len(mult) - 1:
            out.append(("down", conv(h // 2, w // 2, ch, ch)))
            h, w, ds = h // 2, w // 2, ds * 2
            skips.append(ch)
    out.append(("res", resblock(1, h, w, ch, ch, emb)[0]))
    out.append(("attn", transformer(1, h * w, ch, tk)[0]))
    out.append(("res", resblock(1, h, w, ch, ch, emb)[0]))
    for i in reversed(range(len(mult))):
        for j in range(nres + 1):
            out.append(("res", resblock(1, h, w, ch + skips.pop(),
                                        mc * mult[i], emb)[0]))
            ch = mc * mult[i]
            if ds in attn_ds:
                out.append(("attn", transformer(1, h * w, ch, tk)[0]))
            if i and j == nres:
                out.append(("up", conv(h * 2, w * 2, ch, ch)))
                h, w, ds = h * 2, w * 2, ds // 2
    out.append(("out", conv(h, w, ch, u["out_channels"])))
    return out


def unet_flops(cfg: dict) -> float:
    """One U-Net forward of one image."""
    return float(sum(f for _, f in unet_layers(cfg)))


def _vae_resblock(h, w, cin, cout):
    f = conv(h, w, cin, cout) + conv(h, w, cout, cout)
    return f + (conv(h, w, cin, cout, k=1) if cin != cout else 0)


def decoder_flops(cfg: dict) -> float:
    """The kl decoder of one image: post_quant_conv, conv_in, mid
    res + attention + res, the levels, conv_out."""
    v = cfg["vae"]
    ch, mult, nres, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    h, w = cfg["latent_size"]
    c = ch * mult[-1]
    t = h * w
    total = conv(h, w, z, z, k=1) + conv(h, w, z, c)
    total += _vae_resblock(h, w, c, c) + dense(t, c, c) * 4 + 4 * t * t * c
    total += _vae_resblock(h, w, c, c)
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        for _ in range(nres + 1):
            total += _vae_resblock(h, w, c, cout)
            c = cout
        if i:
            h, w = 2 * h, 2 * w
            total += conv(h, w, c, c)
    return float(total + conv(h, w, c, v["out_ch"]))


def encoder_flops(cfg: dict) -> float:
    """The kl encoder of one image, quant_conv included."""
    v = cfg["vae"]
    ch, mult, nres, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    h, w = cfg["image_size"]
    total = conv(h, w, v["in_channels"], ch)
    c = ch
    for i, m in enumerate(mult):
        for _ in range(nres):
            total += _vae_resblock(h, w, c, ch * m)
            c = ch * m
        if i != len(mult) - 1:
            h, w = h // 2, w // 2
            total += conv(h, w, c, c)
    t = h * w
    total += 2 * _vae_resblock(h, w, c, c) + dense(t, c, c) * 4 + 4 * t * t * c
    return float(total + conv(h, w, c, 2 * z) + conv(h, w, 2 * z, 2 * z, k=1))


def decoder_bytes(cfg: dict, b: int, weights: int) -> float:
    """A decode of b images: float32 latents in, float32 images out, the
    decoder's `weights` parameters in bf16."""
    h, w = cfg["latent_size"]
    hi, wi = cfg["image_size"]
    return float(F32 * b * (h * w * cfg["vae"]["z_channels"] + hi * wi * 3)
                 + BF16 * weights)


def sample_flops(cfg: dict, evals: int) -> float:
    """One generated image: `evals` U-Net forwards and a decode."""
    return evals * unet_flops(cfg) + decoder_flops(cfg)


def train_flops(cfg: dict) -> float:
    """One training image: the frozen encode and the U-Net's forward and
    backward (twice the forward)."""
    return encoder_flops(cfg) + 3 * unet_flops(cfg)
