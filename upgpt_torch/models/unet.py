"""SD-style denoising U-Net on NHWC tensors.

Port of `upgpt_tpu.models.unet` (reference openaimodel.py:413-742 and the
SpatialTransformer stack of attention.py:37-261). Submodule names mirror the
JAX parameter tree (`down_{level}_{i}_res`, `mid_attn`, `up_{level}_upsample`,
...), so `convert/from_jax.py` maps keys one to one.

Numerics as in the JAX package: GroupNorm(32) statistics in float32 (eps
1e-5 in resblocks and the out head, 1e-6 at SpatialTransformer entry),
LayerNorm eps 1e-5, exact-erf GELU, float32 softmax, zero-initialised output
projections, cos-first timestep embedding, compute in `UNetConfig.dtype`
(flax semantics, see models/layers.py; None computes in the parameters'
dtype) and a float32 output.

`UNetConfig.use_fused_transformer` routes the SpatialTransformers that
`fused_transformer_qualifies` admits (ds1 and ds2 of the 256px nets) to the
CUDA block kernel; `use_flash_attention` lets long self-attention in the
plain twin (and in the kernel's recompute backward) use the flash kernels;
`use_fused_groupnorm` routes every ResBlock GroupNorm+SiLU and the out head
to the one-pass GroupNorm kernel where `fused_group_norm_qualifies` (the
JAX ResBlock's fused level 1); `use_fused_resblock` (level 2, over level 1)
routes each ResBlock half-step GroupNorm+SiLU+conv that
`fused_resblock_qualifies` admits to the CUDA half-step kernel and runs the
others plain, as the JAX ResBlock does; the out head still follows
`use_fused_groupnorm`. `use_checkpoint` recomputes every ResBlock and
SpatialTransformer in the backward (`torch.utils.checkpoint`,
non-reentrant), so their kernels launch again there.

Each ResBlock and SpatialTransformer call is a span (`unet.resblock`,
`unet.xformer`; `utils/diagnostics.py`), recorded while its recorder is on.
While a pipeline samples on a card (`graphed.sampling()`, no autograd),
each of those calls replays a CUDA graph of its body (`models/graphed.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from upgpt_torch.models import graphed
from upgpt_torch.models.layers import Conv2d, Dense, Norm
from upgpt_torch.ops.attention import multi_head_attention
from upgpt_torch.ops.basic import (
    group_norm, nearest_upsample_2x, silu, timestep_embedding,
)
from upgpt_torch.ops.fused_gn import (
    fused_group_norm, fused_group_norm_qualifies,
)
from upgpt_torch.ops.fused_resblock import (
    fused_gn_silu_conv, fused_resblock_qualifies,
)
from upgpt_torch.ops.fused_transformer import (
    fused_transformer_block, fused_transformer_qualifies, param_tree,
    transformer_block_reference,
)
from upgpt_torch.utils.diagnostics import span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 5
    model_channels: int = 224
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: Optional[int] = 768
    use_flash_attention: bool = True
    # the CUDA GroupNorm+SiLU kernel (ops/fused_gn.py), per qualifying shape
    use_fused_groupnorm: bool = False
    # the CUDA GroupNorm+SiLU+conv3x3 kernel (ops/fused_resblock.py) for the
    # ResBlock half-steps that qualify: the JAX ResBlock's fused level 2
    use_fused_resblock: bool = False
    # the CUDA SpatialTransformer kernel (ops/fused_transformer.py), per
    # qualifying shape
    use_fused_transformer: bool = False
    # rematerialisation (the JAX config's nn.remat over ResBlocks and
    # SpatialTransformers): under autograd each of them keeps only its
    # inputs and runs its forward again in the backward
    use_checkpoint: bool = False
    dtype: Optional[torch.dtype] = None  # compute dtype; None: the params'

    @classmethod
    def interp_256(cls, **overrides) -> "UNetConfig":
        return dataclasses.replace(cls(), **overrides)

    @classmethod
    def upscale_512(cls, **overrides) -> "UNetConfig":
        # models/upgpt/upscale/config.yaml:37-59: 3 latent + 3 lr-image
        # channels in, 3 out, 256 channels, attention at ds 8/4/2
        base = cls(in_channels=6, model_channels=256, out_channels=3,
                   attention_resolutions=(8, 4, 2), channel_mult=(1, 2, 2, 4))
        return dataclasses.replace(base, **overrides)

    @property
    def fused_level(self) -> int:
        """The JAX ResBlock's `fused` level: 2 with the half-step kernel, 1
        with the GroupNorm kernel, 0 plain."""
        return 2 if self.use_fused_resblock else int(self.use_fused_groupnorm)


def group_norm_silu(x: torch.Tensor, norm: Norm, fused: bool,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(32) then SiLU, through the one-pass kernel when `fused` and
    the shape qualifies; a fused call the gate refuses runs plain and is
    counted in `fused_group_norm.plain_routes`."""
    if fused:
        if fused_group_norm_qualifies(x.shape, 32):
            return fused_group_norm(x, norm.weight, norm.bias, 32, eps, True)
        fused_group_norm.plain_routes += 1
    return silu(group_norm(x, norm.weight, norm.bias, 32, eps))


class GroupNorm32(Norm):
    """GroupNorm(32), eps 1e-5, float32 statistics, then SiLU: the U-Net's
    out head (JAX GroupNorm32(with_silu=True, fused=...))."""

    def __init__(self, channels: int, fused: bool = False):
        super().__init__(channels)
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self, self.fused)


class ResBlock(nn.Module):
    """GN->SiLU->conv, + timestep projection, GN->SiLU->zero-conv, residual
    (reference openaimodel.py:163-275, additive-embedding path). `fused` is
    the JAX ResBlock's level: 0 plain; 1 both GN+SiLU through the GroupNorm
    kernel where it qualifies; 2 each half-step GN+SiLU+conv through the
    half-step kernel where `fused_resblock_qualifies`, else plain."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 dtype=None, fused: int = 0):
        super().__init__()
        self.fused = fused
        self.norm_in = Norm(in_channels)
        self.conv_in = Conv2d(in_channels, out_channels, 3, padding=1,
                              dtype=dtype)
        self.emb_proj = Dense(emb_channels, out_channels, dtype=dtype)
        self.norm_out = Norm(out_channels)
        self.conv_out = Conv2d(out_channels, out_channels, 3, padding=1,
                               zero_init=True, dtype=dtype)
        self.skip = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)
        # CUDA graphs of forward's body, dropped whenever the parameters
        # may have been replaced (.to() and friends, loading)
        self._graphs = graphed.GraphCache()
        self.register_load_state_dict_post_hook(graphed.drop)

    def _apply(self, fn, *args, **kwargs):
        self._graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _half_step(self, x: torch.Tensor, norm: Norm,
                   conv: Conv2d) -> torch.Tensor:
        if self.fused >= 2:
            if fused_resblock_qualifies(x.shape, conv.out_channels):
                return fused_gn_silu_conv(x, norm.weight, norm.bias,
                                          conv.weight, conv.bias, 32, 1e-5)
            fused_gn_silu_conv.plain_routes += 1
            return conv(silu(group_norm(x, norm.weight, norm.bias, 32, 1e-5)))
        return conv(group_norm_silu(x, norm, self.fused == 1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        with span("unet.resblock"):
            return graphed.call(self, self._body, x, emb)

    def _body(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self._half_step(x, self.norm_in, self.conv_in)
        h = h + self.emb_proj(silu(emb))[:, None, None, :].to(h.dtype)
        h = self._half_step(h, self.norm_out, self.conv_out)
        if self.skip is not None:
            x = self.skip(x)
        return x + h.to(x.dtype)


class CrossAttention(nn.Module):
    """Bias-free to_q/to_k/to_v and to_out with bias (reference
    attention.py:152-193). Inside a SpatialTransformer it only holds the
    parameters (the block computes them); with `num_heads` it also runs
    plain: q from x, k/v from `context` (x where None), the fp32-softmax
    core of `ops/attention.py`, then to_out, in `dtype` (the JAX
    CrossAttention with use_flash=False)."""

    def __init__(self, query_dim: int, context_dim: int, inner: int,
                 num_heads: Optional[int] = None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        out = multi_head_attention(self.to_q(x), self.to_k(context),
                                   self.to_v(context), self.num_heads)
        return self.to_out(out)


class FeedForward(nn.Module):
    """Parameter holder of the GEGLU MLP: proj_in (d -> 8d, x half first,
    gate half second), proj_out (4d -> d)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_in = Dense(dim, 8 * dim)
        self.proj_out = Dense(4 * dim, dim)


class BasicTransformerBlock(nn.Module):
    """Parameter holder of one pre-LN self-attn / cross-attn / FF block."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, dim)
        self.attn2 = CrossAttention(dim, context_dim, dim)
        self.ff = FeedForward(dim)
        self.norm1 = Norm(dim)
        self.norm2 = Norm(dim)
        self.norm3 = Norm(dim)


class SpatialTransformer(nn.Module):
    """GN(1e-6) -> proj_in -> transformer block(s) -> zero proj_out + res.

    Dispatches the whole block to `fused_transformer_block` when `fused`
    and the shape qualifies, else runs `transformer_block_reference`. Both
    take the parameter tree cast to the compute dtype, made per call (a
    no-op where the parameters already have that dtype).
    """

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 use_flash: bool = False, fused: bool = False, dtype=None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.depth = depth
        self.use_flash = use_flash
        self.fused = fused
        self.compute_dtype = dtype
        self.norm = Norm(channels)
        self.proj_in = Dense(channels, inner)
        self.proj_out = Dense(inner, channels, zero_init=True)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, context_dim or channels))
        # param_tree(self) and the CUDA graphs of forward's body, built at
        # first use and dropped whenever the parameters may have been
        # replaced (.to() and friends, loading)
        self._tree = None
        self._graphs = graphed.GraphCache()
        self.register_load_state_dict_post_hook(self._drop_tree)

    @staticmethod
    def _drop_tree(module, _keys=None):
        module._tree = None
        graphed.drop(module)

    def _apply(self, fn, *args, **kwargs):
        self._drop_tree(self)
        return super()._apply(fn, *args, **kwargs)

    def cast_params(self, dtype: torch.dtype) -> Dict:
        """`param_tree(self)` (built at first use) cast to `dtype`."""
        if self._tree is None:
            self._tree = param_tree(self)
        return _cast_tree(self._tree, dtype)

    def forward(self, x: torch.Tensor, context=None, kv=None) -> torch.Tensor:
        with span("unet.xformer"):
            if kv is not None and all(kv.get(f"block_{i}") is not None
                                      for i in range(self.depth)):
                context = None  # every block has its K/V: no context read
            return graphed.call(self, self._body, x, context, kv)

    def _body(self, x: torch.Tensor, context, kv) -> torch.Tensor:
        b, h, w, c = x.shape
        comp = self.compute_dtype or self.proj_in.weight.dtype
        inner = self.proj_in.weight.shape[0]
        p = self.cast_params(comp)
        tokens = x.reshape(b, h * w, c).to(comp)
        ctx = None if context is None else context.to(comp)
        kv0 = None if kv is None else kv.get("block_0")
        tk = (kv0[0].shape[1] if kv0 is not None
              else (ctx.shape[1] if ctx is not None else h * w))
        if (self.fused and self.depth == 1 and inner == c
                and (kv0 is not None or ctx is not None)
                and fused_transformer_qualifies(h * w, c, self.num_heads,
                                                tk)):
            out = fused_transformer_block(tokens, p, self.num_heads, ctx,
                                          kv0, 1e-6, self.use_flash)
        else:
            out = transformer_block_reference(
                tokens, p, self.num_heads, ctx, kv,
                use_flash=self.use_flash)
        return out.reshape(b, h, w, c)


def _cast_tree(tree, dtype):
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


class Downsample(nn.Module):
    """3x3 stride-2 conv, padding 1 (reference openaimodel.py:134-160)."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """2x nearest + 3x3 conv (reference openaimodel.py:91-119)."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class UNetModel(nn.Module):
    """forward(x_nhwc, timesteps, context, cross_kv=None) -> eps (float32).

    `x` already carries the channel-concat conditioning; `cross_kv` is the
    output of `precompute_cross_kv` for the sampling loop.
    """

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        mc, comp = cfg.model_channels, cfg.dtype
        self.time_embed_0 = Dense(mc, 4 * mc, dtype=comp)
        self.time_embed_2 = Dense(4 * mc, 4 * mc, dtype=comp)
        self.conv_in = Conv2d(cfg.in_channels, mc, 3, padding=1, dtype=comp)
        self._plan = []  # (kind, module name) in call order

        def attn(ch, name):
            self.add_module(name, SpatialTransformer(
                ch, cfg.num_heads, ch // cfg.num_heads,
                depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                use_flash=cfg.use_flash_attention,
                fused=cfg.use_fused_transformer, dtype=comp))
            self._plan.append(("attn", name))

        def res(cin, cout, name):
            self.add_module(name, ResBlock(cin, cout, 4 * mc, comp,
                                           cfg.fused_level))
            self._plan.append(("res", name))

        skips = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                res(ch, mult * mc, f"down_{level}_{i}_res")
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    attn(ch, f"down_{level}_{i}_attn")
                skips.append(ch)
                self._plan.append(("push", None))
            if level != len(cfg.channel_mult) - 1:
                name = f"down_{level}_downsample"
                self.add_module(name, Downsample(ch, comp))
                self._plan += [("call", name), ("push", None)]
                skips.append(ch)
                ds *= 2
        res(ch, ch, "mid_res1")
        attn(ch, "mid_attn")
        res(ch, ch, "mid_res2")
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                self._plan.append(("pop", None))
                res(ch + skips.pop(), mc * mult, f"up_{level}_{i}_res")
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    attn(ch, f"up_{level}_{i}_attn")
                if level and i == cfg.num_res_blocks:
                    name = f"up_{level}_upsample"
                    self.add_module(name, Upsample(ch, comp))
                    self._plan.append(("call", name))
                    ds //= 2
        self.out_norm = GroupNorm32(ch, cfg.use_fused_groupnorm)
        self.out_conv = Conv2d(ch, cfg.out_channels, 3, padding=1,
                               zero_init=True, dtype=comp)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.config.dtype or self.conv_in.weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                cross_kv: Optional[Dict] = None) -> torch.Tensor:
        with graphed.unet_eval(x):
            return self._body(x, timesteps, context, cross_kv)

    def _body(self, x, timesteps, context, cross_kv) -> torch.Tensor:
        cfg = self.config
        comp = self.compute_dtype
        emb = self.time_embed_0(
            timestep_embedding(timesteps, cfg.model_channels).to(comp))
        emb = self.time_embed_2(silu(emb))
        if context is not None:
            context = context.to(comp)
        h = self.conv_in(x.to(comp))
        hs = [h]
        # JAX's nn.remat over the same two modules; outside autograd there
        # is no backward to recompute for
        remat = cfg.use_checkpoint and torch.is_grad_enabled()
        for kind, name in self._plan:
            if kind == "res":
                mod = getattr(self, name)
                h = (checkpoint(mod, h, emb, use_reentrant=False) if remat
                     else mod(h, emb))
            elif kind == "attn":
                kv = None if cross_kv is None else cross_kv.get(name)
                mod = getattr(self, name)
                h = (checkpoint(mod, h, context, kv=kv, use_reentrant=False)
                     if remat else mod(h, context, kv=kv))
            elif kind == "call":
                h = getattr(self, name)(h)
            elif kind == "push":
                hs.append(h)
            else:  # pop: skip concat on the channel axis
                h = torch.cat([h, hs.pop()], dim=-1)
        return self.out_conv(self.out_norm(h)).float()


def cross_attention_layers(cfg: UNetConfig):
    """[(layer_name, channels)] of every SpatialTransformer, in call order."""
    names = []
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for i in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                names.append((f"down_{level}_{i}_attn", ch))
        if level != len(cfg.channel_mult) - 1:
            ds *= 2
    names.append(("mid_attn", ch))
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                names.append((f"up_{level}_{i}_attn", ch))
            if level and i == cfg.num_res_blocks:
                ds //= 2
    return names


def precompute_cross_kv(unet: UNetModel, context: torch.Tensor) -> Dict:
    """Project the fixed cross-attention context through every attn2's
    to_k/to_v once, for reuse across all steps of a sampling loop.

    Returns {layer: {block_i: (k, v)}} matching UNetModel(cross_kv=...).
    These two products stay torch.matmul: the JAX package computes them
    outside any kernel too.
    """
    ctx = context.to(unet.compute_dtype)
    return {name: layer_cross_kv(getattr(unet, name), ctx)
            for name, _ch in cross_attention_layers(unet.config)}


def layer_cross_kv(layer: SpatialTransformer, ctx: torch.Tensor) -> Dict:
    """{block_i: (k, v)} of one SpatialTransformer: `ctx` (in the compute
    dtype) through each block's attn2 to_k/to_v."""
    comp = ctx.dtype
    out = {}
    for d in range(layer.depth):
        a2 = getattr(layer, f"block_{d}").attn2
        out[f"block_{d}"] = (F.linear(ctx, a2.to_k.weight.to(comp)),
                             F.linear(ctx, a2.to_v.weight.to(comp)))
    return out
