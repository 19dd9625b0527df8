"""Plain PyTorch reference of the UPGPT latent diffusion model.

The yardstick that decides `correct`: an independent, plain restatement of
the published model (soon-yau/upgpt, the CompVis LDM code it builds on:
openaimodel.py's U-Net with SpatialTransformers, model.py's kl-f8
autoencoder, poses.py's LinearProject, ddim.py, the UniPC-2 bh2 solver of
arXiv:2302.04867 on the karras grid of arXiv:2206.00364, ddpm.py's eps
loss, AdamW and LitEma). It reads only a configuration file's sizes, a
name -> tensor weight mapping and the inputs the benchmark made; it
imports nothing of the program.

Tensors are NHWC at the boundaries, as the program's are. Every product
(linear, convolution, the two attention products) goes through
`Precision.q`, which is the identity for the float32 reference and a
per-tensor fake quantisation to float8 e4m3 for the control
(`Precision("fp8")`). Run it with TF32 off (`float32_exact`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


class Precision:
    """The arithmetic of the products: "fp32" or "fp8" (e4m3, a per-tensor
    scale to its largest finite value 448, float32 accumulation)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: fp32 or fp8")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "fp32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


FP32 = Precision("fp32")
FP8 = Precision("fp8")


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the block (cuBLAS and cuDNN), restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ------------------------------------------------------------ parameters


def _lin(name: str, o: int, i: int, bias: bool = True):
    out = [(f"{name}.weight", (o, i))]
    return out + [(f"{name}.bias", (o,))] if bias else out


def _conv(name: str, o: int, i: int, k: int):
    return [(f"{name}.weight", (o, i, k, k)), (f"{name}.bias", (o,))]


def _norm(name: str, c: int):
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _unet_plan(u: dict):
    """The U-Net's modules in call order: ("res", name, cin, cout),
    ("attn", name, ch), ("down", name, ch), ("up", name, ch), ("push",)
    and ("pop",) for the skip stack."""
    mc, mult, nres = u["model_channels"], u["channel_mult"], u["num_res_blocks"]
    plan, skips = [], [mc]
    ch, ds = mc, 1
    for level, m in enumerate(mult):
        for i in range(nres):
            plan.append(("res", f"down_{level}_{i}_res", ch, m * mc))
            ch = m * mc
            if ds in u["attention_resolutions"]:
                plan.append(("attn", f"down_{level}_{i}_attn", ch))
            skips.append(ch)
            plan.append(("push",))
        if level != len(mult) - 1:
            plan.append(("down", f"down_{level}_downsample", ch))
            plan.append(("push",))
            skips.append(ch)
            ds *= 2
    plan.append(("res", "mid_res1", ch, ch))
    plan.append(("attn", "mid_attn", ch))
    plan.append(("res", "mid_res2", ch, ch))
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nres + 1):
            plan.append(("pop",))
            plan.append(("res", f"up_{level}_{i}_res", ch + skips.pop(),
                         mc * m))
            ch = mc * m
            if ds in u["attention_resolutions"]:
                plan.append(("attn", f"up_{level}_{i}_attn", ch))
            if level and i == nres:
                plan.append(("up", f"up_{level}_upsample", ch))
                ds //= 2
    return plan, ch


def _unet_params(u: dict, ctx_dim: int):
    mc = u["model_channels"]
    out = (_lin("time_embed_0", 4 * mc, mc) + _lin("time_embed_2", 4 * mc,
                                                    4 * mc)
           + _conv("conv_in", mc, u["in_channels"], 3))
    plan, ch = _unet_plan(u)
    for step in plan:
        kind = step[0]
        if kind == "res":
            _, name, cin, cout = step
            out += (_norm(f"{name}.norm_in", cin)
                    + _conv(f"{name}.conv_in", cout, cin, 3)
                    + _lin(f"{name}.emb_proj", cout, 4 * mc)
                    + _norm(f"{name}.norm_out", cout)
                    + _conv(f"{name}.conv_out", cout, cout, 3))
            if cin != cout:
                out += _conv(f"{name}.skip", cout, cin, 1)
        elif kind == "attn":
            _, name, c = step
            b = f"{name}.block_0"
            out += (_norm(f"{name}.norm", c) + _lin(f"{name}.proj_in", c, c)
                    + _lin(f"{name}.proj_out", c, c))
            for a, src in (("attn1", c), ("attn2", ctx_dim)):
                out += (_lin(f"{b}.{a}.to_q", c, c, False)
                        + _lin(f"{b}.{a}.to_k", c, src, False)
                        + _lin(f"{b}.{a}.to_v", c, src, False)
                        + _lin(f"{b}.{a}.to_out", c, c))
            out += (_lin(f"{b}.ff.proj_in", 8 * c, c)
                    + _lin(f"{b}.ff.proj_out", c, 4 * c))
            for n in ("norm1", "norm2", "norm3"):
                out += _norm(f"{b}.{n}", c)
        elif kind in ("down", "up"):
            _, name, c = step
            out += _conv(f"{name}.conv", c, c, 3)
    out += _norm("out_norm", ch) + _conv("out_conv", u["out_channels"], ch, 3)
    return out


def _resnet_params(name: str, cin: int, cout: int):
    out = (_norm(f"{name}.norm1", cin) + _conv(f"{name}.conv1", cout, cin, 3)
           + _norm(f"{name}.norm2", cout)
           + _conv(f"{name}.conv2", cout, cout, 3))
    return out + (_conv(f"{name}.nin_shortcut", cout, cin, 1)
                  if cin != cout else [])


def _attnblock_params(name: str, c: int):
    out = _norm(f"{name}.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        out += _conv(f"{name}.{n}", c, c, 1)
    return out


def _encoder_plan(v: dict):
    plan, cin = [], v["ch"]
    for lvl, m in enumerate(v["ch_mult"]):
        for j in range(v["num_res_blocks"]):
            plan.append(("res", f"down_{lvl}_block_{j}", cin, v["ch"] * m))
            cin = v["ch"] * m
        if lvl != len(v["ch_mult"]) - 1:
            plan.append(("down", f"down_{lvl}_downsample", cin))
    return plan, cin


def _decoder_plan(v: dict):
    plan, cin = [], v["ch"] * v["ch_mult"][-1]
    for lvl in reversed(range(len(v["ch_mult"]))):
        for j in range(v["num_res_blocks"] + 1):
            plan.append(("res", f"up_{lvl}_block_{j}", cin,
                         v["ch"] * v["ch_mult"][lvl]))
            cin = v["ch"] * v["ch_mult"][lvl]
        if lvl != 0:
            plan.append(("up", f"up_{lvl}_upsample", cin))
    return plan, cin


def _vae_params(v: dict):
    z, e = v["z_channels"], v["embed_dim"]
    out = _conv("encoder.conv_in", v["ch"], v["in_channels"], 3)
    plan, top = _encoder_plan(v)
    for kind, name, *c in plan:
        out += (_resnet_params(f"encoder.{name}", *c) if kind == "res"
                else _conv(f"encoder.{name}.conv", c[0], c[0], 3))
    out += (_resnet_params("encoder.mid_block_1", top, top)
            + _attnblock_params("encoder.mid_attn_1", top)
            + _resnet_params("encoder.mid_block_2", top, top)
            + _norm("encoder.norm_out", top)
            + _conv("encoder.conv_out", 2 * z, top, 3))
    top = v["ch"] * v["ch_mult"][-1]
    out += (_conv("decoder.conv_in", top, z, 3)
            + _resnet_params("decoder.mid_block_1", top, top)
            + _attnblock_params("decoder.mid_attn_1", top)
            + _resnet_params("decoder.mid_block_2", top, top))
    plan, last = _decoder_plan(v)
    for kind, name, *c in plan:
        out += (_resnet_params(f"decoder.{name}", *c) if kind == "res"
                else _conv(f"decoder.{name}.conv", c[0], c[0], 3))
    out += (_norm("decoder.norm_out", last)
            + _conv("decoder.conv_out", v["out_ch"], last, 3)
            + _conv("quant_conv", 2 * e, 2 * z, 1)
            + _conv("post_quant_conv", z, e, 1))
    return out


def param_table(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the configuration, named as
    the model's published parameter tree is, in a fixed order."""
    out = [(f"unet.{n}", s) for n, s in _unet_params(cfg["unet"],
                                                     cfg["context_dim"])]
    out += [(f"vae.{n}", s) for n, s in _vae_params(cfg["vae"])]
    if cfg.get("pose_input_dim"):
        out += [(f"pose.{n}", s) for n, s in _lin(
            "proj", cfg["context_dim"], cfg["pose_input_dim"])]
    return out


def trainable(name: str) -> bool:
    """The trainable set: the U-Net and the pose projection (the VAE is
    frozen, ddpm.py:1501-1509)."""
    return name.startswith(("unet.", "pose."))


# ------------------------------------------------------------ primitives


def linear(x, W: Weights, name: str, P: Precision, bias: bool = True):
    b = W[f"{name}.bias"].float() if bias else None
    return F.linear(P.q(x), P.q(W[f"{name}.weight"]), b)


def conv(x, W: Weights, name: str, P: Precision, stride: int = 1,
         padding: int = 1):
    """NHWC convolution through the NCHW library call."""
    w = W[f"{name}.weight"]
    y = F.conv2d(P.q(x).permute(0, 3, 1, 2), P.q(w), W[f"{name}.bias"].float(),
                 stride, padding if w.shape[-1] > 1 else 0)
    return y.permute(0, 2, 3, 1)


def group_norm(x, W: Weights, name: str, eps: float, groups: int = 32):
    n, c = x.shape[0], x.shape[-1]
    g = x.float().reshape(n, -1, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return y * W[f"{name}.weight"].float() + W[f"{name}.bias"].float()


def layer_norm(x, W: Weights, name: str, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), W[f"{name}.weight"].float(),
                        W[f"{name}.bias"].float(), eps)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q, k, v, heads: int, P: Precision):
    """softmax(q k^T / sqrt(d)) v over `heads` heads of (B, T, H*D)."""
    b, tq, inner = q.shape
    d = inner // heads
    qh = q.reshape(b, tq, heads, d).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, d).transpose(1, 2)
    s = torch.matmul(P.q(qh), P.q(kh).transpose(-1, -2)) / math.sqrt(d)
    o = torch.matmul(P.q(torch.softmax(s, dim=-1)), P.q(vh))
    return o.transpose(1, 2).reshape(b, tq, inner)


# ------------------------------------------------------------ U-Net


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def resblock(x, emb, W, name, P):
    h = conv(silu(group_norm(x, W, f"{name}.norm_in", 1e-5)), W,
             f"{name}.conv_in", P)
    h = h + linear(silu(emb), W, f"{name}.emb_proj", P)[:, None, None, :]
    h = conv(silu(group_norm(h, W, f"{name}.norm_out", 1e-5)), W,
             f"{name}.conv_out", P)
    if f"{name}.skip.weight" in W:
        x = conv(x, W, f"{name}.skip", P)
    return x + h


def spatial_transformer(x, context, W, name, heads, P):
    b, hh, ww, c = x.shape
    tok = x.reshape(b, hh * ww, c)
    h = group_norm(tok, W, f"{name}.norm", 1e-6)
    h = linear(h, W, f"{name}.proj_in", P)
    blk = f"{name}.block_0"
    z = layer_norm(h, W, f"{blk}.norm1")
    a = attention(linear(z, W, f"{blk}.attn1.to_q", P, False),
                  linear(z, W, f"{blk}.attn1.to_k", P, False),
                  linear(z, W, f"{blk}.attn1.to_v", P, False), heads, P)
    h = h + linear(a, W, f"{blk}.attn1.to_out", P)
    z = layer_norm(h, W, f"{blk}.norm2")
    a = attention(linear(z, W, f"{blk}.attn2.to_q", P, False),
                  linear(context, W, f"{blk}.attn2.to_k", P, False),
                  linear(context, W, f"{blk}.attn2.to_v", P, False), heads, P)
    h = h + linear(a, W, f"{blk}.attn2.to_out", P)
    z = layer_norm(h, W, f"{blk}.norm3")
    xg, gate = linear(z, W, f"{blk}.ff.proj_in", P).chunk(2, dim=-1)
    h = h + linear(xg * gelu(gate), W, f"{blk}.ff.proj_out", P)
    out = linear(h, W, f"{name}.proj_out", P) + tok.float()
    return out.reshape(b, hh, ww, c)


def unet(x, t, context, W: Weights, cfg: dict, P: Precision = FP32):
    """eps of the U-Net: `x` (B, h, w, latent + concat channels), `t`
    (B,) ints, `context` (B, T, 768); float32."""
    u = cfg["unet"]
    Wu = _prefixed(W, "unet.")
    emb = linear(timestep_embedding(t, u["model_channels"]), Wu,
                 "time_embed_0", P)
    emb = linear(silu(emb), Wu, "time_embed_2", P)
    h = conv(x, Wu, "conv_in", P)
    hs = [h]
    plan, _ = _unet_plan(u)
    for step in plan:
        kind = step[0]
        if kind == "res":
            h = resblock(h, emb, Wu, step[1], P)
        elif kind == "attn":
            h = spatial_transformer(h, context, Wu, step[1], u["num_heads"], P)
        elif kind == "down":
            h = conv(h, Wu, f"{step[1]}.conv", P, stride=2)
        elif kind == "up":
            n, hh, ww, c = h.shape
            h = h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(
                n, 2 * hh, 2 * ww, c)
            h = conv(h, Wu, f"{step[1]}.conv", P)
        elif kind == "push":
            hs.append(h)
        else:
            h = torch.cat([h, hs.pop()], dim=-1)
    return conv(silu(group_norm(h, Wu, "out_norm", 1e-5)), Wu, "out_conv", P)


class _prefixed(dict):
    """A view of the weights under one prefix."""

    def __init__(self, W: Weights, prefix: str):
        super().__init__()
        self.W, self.prefix = W, prefix

    def __getitem__(self, key):
        return self.W[self.prefix + key]

    def __contains__(self, key):
        return (self.prefix + key) in self.W


def context(text, style, smpl, W: Weights, P: Precision = FP32):
    """text (77) | style (9) | pose token (1): the 87-token context."""
    pose = linear(smpl.float(), W, "pose.proj", P)
    return torch.cat([text.float(), style.float(), pose], dim=1)


# ------------------------------------------------------------ VAE


def _resnet(x, W, name, P):
    h = conv(silu(group_norm(x, W, f"{name}.norm1", 1e-6)), W,
             f"{name}.conv1", P)
    h = conv(silu(group_norm(h, W, f"{name}.norm2", 1e-6)), W,
             f"{name}.conv2", P)
    if f"{name}.nin_shortcut.weight" in W:
        x = conv(x, W, f"{name}.nin_shortcut", P)
    return x + h


def _attnblock(x, W, name, P):
    b, hh, ww, c = x.shape
    h = group_norm(x, W, f"{name}.norm", 1e-6)
    q, k, v = (conv(h, W, f"{name}.{n}", P).reshape(b, hh * ww, c)
               for n in ("q", "k", "v"))
    o = attention(q, k, v, 1, P).reshape(b, hh, ww, c)
    return x + conv(o, W, f"{name}.proj_out", P)


def decode(z, W: Weights, cfg: dict, P: Precision = FP32):
    """Scaled latent -> float32 NHWC image (unclamped)."""
    v = cfg["vae"]
    Wv = _prefixed(W, "vae.")
    h = conv(z.float() / cfg["scale_factor"], Wv, "post_quant_conv", P)
    h = conv(h, Wv, "decoder.conv_in", P)
    h = _resnet(h, Wv, "decoder.mid_block_1", P)
    h = _attnblock(h, Wv, "decoder.mid_attn_1", P)
    h = _resnet(h, Wv, "decoder.mid_block_2", P)
    plan, _ = _decoder_plan(v)
    for kind, name, *_ in plan:
        if kind == "res":
            h = _resnet(h, Wv, f"decoder.{name}", P)
        else:
            n, hh, ww, c = h.shape
            h = h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(
                n, 2 * hh, 2 * ww, c)
            h = conv(h, Wv, f"decoder.{name}.conv", P)
    return conv(silu(group_norm(h, Wv, "decoder.norm_out", 1e-6)), Wv,
                "decoder.conv_out", P)


def encode(x, noise, W: Weights, cfg: dict, P: Precision = FP32):
    """Image -> scaled posterior sample mean + std * noise."""
    v = cfg["vae"]
    Wv = _prefixed(W, "vae.")
    h = conv(x.float(), Wv, "encoder.conv_in", P)
    plan, _ = _encoder_plan(v)
    for kind, name, *_ in plan:
        if kind == "res":
            h = _resnet(h, Wv, f"encoder.{name}", P)
        else:  # zero pad (0, 1) below and right, VALID stride-2 conv
            h = conv(F.pad(h, (0, 0, 0, 1, 0, 1)), Wv, f"encoder.{name}.conv",
                     P, stride=2, padding=0)
    h = _resnet(h, Wv, "encoder.mid_block_1", P)
    h = _attnblock(h, Wv, "encoder.mid_attn_1", P)
    h = _resnet(h, Wv, "encoder.mid_block_2", P)
    h = conv(silu(group_norm(h, Wv, "encoder.norm_out", 1e-6)), Wv,
             "encoder.conv_out", P)
    moments = conv(h, Wv, "quant_conv", P)
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return cfg["scale_factor"] * (mean + std * noise.float())


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round((torch.clamp(img, -1.0, 1.0) + 1.0) * 127.5)


# ------------------------------------------------------------ schedules


def alphas_cumprod(cfg: dict) -> np.ndarray:
    """float64 cumulative alphas of the linear (sqrt-spaced) betas."""
    betas = np.linspace(cfg["linear_start"] ** 0.5, cfg["linear_end"] ** 0.5,
                        cfg["timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def grid(cfg: dict, steps: int, method: str) -> np.ndarray:
    """Ascending t of the sampler: the uniform DDIM grid (shifted by one,
    util.py:46-60) or the karras sigma grid (rho 7) quantised to the
    trained t."""
    T = cfg["timesteps"]
    if method == "uniform":
        return np.arange(0, T, T // steps) + 1
    if method != "karras":
        raise ValueError(method)
    acp = alphas_cumprod(cfg)
    sig = np.sqrt((1.0 - acp) / acp)
    lo, hi = sig[1] ** (1 / 7), sig[-1] ** (1 / 7)
    s = (hi + np.arange(steps) / (steps - 1) * (lo - hi)) ** 7
    t = np.interp(np.log(s), np.log(sig), np.arange(T, dtype=np.float64))
    return np.unique(np.clip(np.round(t), 1, T - 1)).astype(np.int64)


def ddim(eps_fn, x_T, cfg: dict, steps: int, eta: float,
         noise: Optional[torch.Tensor]):
    """DDIM (ddim.py:166-204) from x_T; `noise` (steps, B, ...) is each
    step's standard normal draw where eta > 0."""
    acp = alphas_cumprod(cfg)
    ts = grid(cfg, steps, "uniform")
    a_all = acp[ts]
    ap_all = np.concatenate([[acp[0]], acp[ts[:-1]]])
    x = x_T.float()
    for i, j in enumerate(reversed(range(len(ts)))):
        a, ap = a_all[j], ap_all[j]
        sig = eta * math.sqrt((1 - ap) / (1 - a) * (1 - a / ap))
        eps = eps_fn(x, int(ts[j]))
        x0 = (x - math.sqrt(1 - a) * eps) / math.sqrt(a)
        x = math.sqrt(ap) * x0 + math.sqrt(max(1 - ap - sig * sig, 0.0)) * eps
        if sig:
            x = x + sig * noise[i].float()
    return x


def unipc(eps_fn, x_T, cfg: dict, steps: int, method: str):
    """UniPC-2 (bh2, data prediction) with its corrector, on the `method`
    grid; the last point is the last predictor's output."""
    acp = alphas_cumprod(cfg)
    ts = grid(cfg, steps, method)[::-1]
    a_cur = acp[ts]
    a_next = np.concatenate([acp[ts[1:]], [acp[0]]])
    lam = lambda a: np.log(np.sqrt(a) / np.maximum(np.sqrt(1 - a), 1e-20))
    lam_c, lam_n = lam(a_cur), lam(a_next)
    x = x_T.float()
    x0_hist: List[torch.Tensor] = []
    base = x
    prev = None  # (h, r, alpha_n, B_h, b1, b2) of the transition into x
    for i, t in enumerate(ts):
        eps = eps_fn(x, int(t))
        x0 = (x - math.sqrt(1 - a_cur[i]) * eps) / math.sqrt(a_cur[i])
        if prev is not None:
            # corrector of the transition that made x, on its model output
            h, r, alpha_n, B_h, b1, b2, term = prev
            d1_t = x0 - x0_hist[-1]
            if term:
                x = base
            elif r is None:
                x = base - alpha_n * B_h * b1 * d1_t
            else:
                d1 = (x0_hist[-2] - x0_hist[-1]) / r
                c0 = (b1 - b2) / (1 - r)
                c1 = (b2 - r * b1) / (1 - r)
                x = base - alpha_n * B_h * (c0 * d1 + c1 * d1_t)
        alpha_n = math.sqrt(a_next[i])
        sigma_n = math.sqrt(1 - a_next[i])
        h = lam_n[i] - lam_c[i]
        phi1 = math.expm1(-h)
        B_h = phi1
        b1 = (phi1 / -h - 1.0) / B_h
        b2 = 2.0 * (phi1 / -h - 1.0 + h / 2.0) / (-h * B_h)
        term = sigma_n <= 1e-10
        r = (lam_c[i - 1] - lam_c[i]) / h if i else None
        if term:
            base = alpha_n * x0
            xn = base
        else:
            base = (sigma_n / math.sqrt(1 - a_cur[i])) * x - alpha_n * phi1 * x0
            xn = base
            if r is not None:
                xn = base - alpha_n * B_h * b1 * (x0_hist[-1] - x0) / r
        x0_hist.append(x0)
        prev = (h, r, alpha_n, B_h, b1, b2, term)
        x = xn
    return x


def generate(inputs: dict, W: Weights, cfg: dict, sampling: dict,
             P: Precision = FP32) -> torch.Tensor:
    """Images in [-1, 1] (unclamped) of a batch: `inputs` holds text_emb,
    style_emb, smpl, person_mask, x_T and, for DDIM with eta > 0, noise
    (steps, B, ...)."""
    ctx = context(inputs["text_emb"], inputs["style_emb"], inputs["smpl"], W, P)
    mask = inputs["person_mask"].float()

    def eps_fn(x, t):
        tb = torch.full((x.shape[0],), t, device=x.device, dtype=torch.int64)
        return unet(torch.cat([x, mask], dim=-1), tb, ctx, W, cfg, P)

    if sampling["sampler"] == "ddim":
        z = ddim(eps_fn, inputs["x_T"], cfg, sampling["steps"],
                 sampling["eta"], inputs.get("noise"))
    else:
        z = unipc(eps_fn, inputs["x_T"], cfg, sampling["steps"],
                  sampling["schedule"])
    return decode(z, W, cfg, P)


# ------------------------------------------------------------ training


def training_loss(batch: dict, draws: dict, W: Weights, cfg: dict,
                  P: Precision = FP32) -> torch.Tensor:
    """The weighted eps loss (ddpm.py:1083-1123) of a batch: the frozen
    VAE's posterior sample, q_sample at t, the U-Net's eps against the
    noise, weighted by loss_w, the mean over each image, then the batch."""
    with torch.no_grad():
        z0 = encode(batch["image"], draws["posterior_noise"], W, cfg, P)
    acp = torch.from_numpy(alphas_cumprod(cfg)).to(z0.device)
    t = draws["t"].long()
    a = acp[t].float().sqrt().reshape(-1, 1, 1, 1)
    s = (1 - acp[t]).float().sqrt().reshape(-1, 1, 1, 1)
    x = a * z0 + s * draws["noise"].float()
    ctx = context(batch["text_emb"], batch["style_emb"], batch["smpl"], W, P)
    eps = unet(torch.cat([x, batch["person_mask"].float()], dim=-1), t, ctx,
               W, cfg, P)
    err = (eps - draws["noise"].float()).square() * batch["loss_w"].float()
    return err.mean(dim=(1, 2, 3)).mean()


def lambda_linear(warm_up: int, f_start: float):
    """LambdaLinearScheduler with one long cycle and f_min = f_max = 1."""
    return lambda n: (f_start + (1.0 - f_start) / max(warm_up, 1) * n
                      if n < warm_up else 1.0)


def ema_decay(n: int, decay: float) -> float:
    """LitEma's decay at its n-th update (ema.py:37-40): min(decay,
    (1 + n) / (10 + n))."""
    return min(decay, (1.0 + n) / (10.0 + n))


def train_steps(W0: Weights, batches: Sequence[dict], draws: Sequence[dict],
                cfg: dict, opt: dict, P: Precision = FP32,
                rows_per_block: int = 12) -> dict:
    """The first len(batches) AdamW + EMA updates from the weights W0.

    Returns each step's loss, the first step's gradient of each trainable
    leaf, and each leaf's change and its EMA shadow's change after the
    last step (float32, on W0's device). The shadow starts at W0 and
    follows LitEma: after each update, shadow = d * shadow + (1 - d) * p
    with d = `ema_decay(k, opt["ema_decay"])` at update k. Gradients are
    summed over blocks of `rows_per_block` rows, each block's loss weighted
    by its share of the batch."""
    names = [n for n in W0 if trainable(n)]
    W = {n: (v.float().clone().requires_grad_(True) if trainable(n)
             else v.float()) for n, v in W0.items()}
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    shadow = {n: W0[n].float().clone() for n in names}
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"]
    sched = lambda_linear(opt["warm_up_steps"], opt["scheduler_f_start"])
    losses, first_grad = [], None
    for step, (batch, dr) in enumerate(zip(batches, draws)):
        n = batch["image"].shape[0]
        total = 0.0
        for lo in range(0, n, rows_per_block):
            rows = slice(lo, min(n, lo + rows_per_block))
            part = {k: x[rows] for k, x in batch.items()}
            pdr = {k: x[rows] for k, x in dr.items()}
            share = (rows.stop - rows.start) / n
            loss = training_loss(part, pdr, W, cfg, P) * share
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        lr = opt["learning_rate"] * sched(step)
        k = step + 1
        with torch.no_grad():
            grads = {nm: W[nm].grad for nm in names}
            if first_grad is None:
                first_grad = {nm: g.clone() for nm, g in grads.items()}
            for nm in names:
                p, g = W[nm], grads[nm]
                p.mul_(1.0 - lr * wd)
                m[nm].mul_(b1).add_(g, alpha=1 - b1)
                v[nm].mul_(b2).addcmul_(g, g, value=1 - b2)
                den = (v[nm] / (1 - b2 ** k)).sqrt_().add_(eps)
                p.addcdiv_(m[nm], den, value=-lr / (1 - b1 ** k))
                p.grad = None
            d = ema_decay(k, opt["ema_decay"])
            for nm in names:
                shadow[nm].mul_(d).add_(W[nm].detach(), alpha=1.0 - d)
    change = {nm: (W[nm].detach() - W0[nm].float()) for nm in names}
    ema_change = {nm: shadow[nm] - W0[nm].float() for nm in names}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "ema_change": ema_change}
