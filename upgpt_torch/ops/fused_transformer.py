"""The SpatialTransformer block (depth 1): a CUDA kernel and its twin.

Port of `upgpt_tpu.ops.fused_transformer`. The block is

    GN32(eps 1e-6) -> proj_in -> LN1 -> self-attn -> LN2 -> cross-attn ->
    LN3 -> GEGLU FF -> proj_out -> + input

with float32 GroupNorm/LayerNorm statistics and softmax, exact-erf GELU and
a bf16 residual stream rounded after every sub-block. The kernel is
`csrc/fused_transformer.cu`, which replaces `_fused_forward` /
`_block_kernel`. One TPU program per sample does not fit a Hopper SM, so on
this card the block is eleven launches from one C call: GroupNorm
statistics, seven tiled tensor-core products with norm prologues and
bias/scale/residual/GEGLU epilogues, and two passes of the shared attention
routine over the packed activations. Only the sampling variant with
precomputed cross-attention K/V (`precompute_cross_kv`) is ported; the
in-kernel context projection of the training path raises on CUDA.

`p` is the SpatialTransformer's parameter tree with the JAX package's keys
(`norm`, `proj_in`, `proj_out`, `block_0/{attn1,attn2,ff,norm1..3}`) and
nn.Linear-layout leaves (`weight` (out, in), `bias`), as `param_tree` builds
it from a module.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from upgpt_torch.ops import _build
from upgpt_torch.ops.basic import group_norm

Tree = Mapping[str, object]


def param_tree(module: torch.nn.Module) -> Dict:
    """A module's parameters as a nested dict keyed by module path."""
    tree: Dict = {}
    for name, value in module.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------- twin


def _dense(z: torch.Tensor, tree: Tree) -> torch.Tensor:
    bias = tree.get("bias")
    return F.linear(z, tree["weight"].to(z.dtype),
                    None if bias is None else bias.to(z.dtype))


def _ln_f32(z: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    mu = z.mean(dim=-1, keepdim=True)
    var = (z - mu).square().mean(dim=-1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + eps) * scale + bias


def _ln_tree(z: torch.Tensor, tree: Tree) -> torch.Tensor:
    return _ln_f32(z.float(), tree["weight"].float(),
                   tree["bias"].float()).to(z.dtype)


def _gelu_exact(z: torch.Tensor) -> torch.Tensor:
    return z * 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))


def _basic_block_ref(h, blk, heads, context, kv, use_flash):
    """One BasicTransformerBlock (reference attention.py:196-215)."""
    from upgpt_torch.ops.attention import attention_weight_split
    from upgpt_torch.ops.flash_attention import (
        flash_attention, flash_attention_qualifies,
    )

    comp = h.dtype
    b, tq, c = h.shape
    d = c // heads
    z = _ln_tree(h, blk["norm1"])
    a1 = blk["attn1"]
    if use_flash and flash_attention_qualifies(b, heads, tq, tq, d, comp):
        def headed(w):
            kern = w["weight"].to(comp)
            return torch.einsum("btc,hdc->bhtd", z,
                                kern.reshape(heads, d, kern.shape[-1]))

        o = flash_attention(headed(a1["to_q"]).contiguous(),
                            headed(a1["to_k"]).contiguous(),
                            headed(a1["to_v"]).contiguous())
        wo = a1["to_out"]["weight"].to(comp)
        h = h + (torch.einsum("bhtd,chd->btc", o,
                              wo.reshape(wo.shape[0], heads, d))
                 + a1["to_out"]["bias"].to(comp))
    else:
        h = h + attention_weight_split(z, None, a1, heads)
    z = _ln_tree(h, blk["norm2"])
    src = z if context is None else context.to(comp)
    h = h + attention_weight_split(z, src if kv is None else None,
                                   blk["attn2"], heads, kv=kv)
    z = _ln_tree(h, blk["norm3"])
    g = _dense(z, blk["ff"]["proj_in"])
    xh, gate = g.chunk(2, dim=-1)
    act = (xh.float() * _gelu_exact(gate.float())).to(comp)
    return h + _dense(act, blk["ff"]["proj_out"])


def transformer_block_reference(
    x_tokens: torch.Tensor,
    p: Tree,
    heads: int,
    context: Optional[torch.Tensor] = None,
    kv=None,
    gn_eps: float = 1e-6,
    use_flash: bool = False,
) -> torch.Tensor:
    """Plain PyTorch SpatialTransformer (reference attention.py:218-261).

    `kv` is a (k, v) pair for block_0 or a {block_i: (k, v)} dict.
    """
    comp = x_tokens.dtype
    h = group_norm(x_tokens, p["norm"]["weight"], p["norm"]["bias"],
                   num_groups=32, eps=gn_eps)
    h = _dense(h.to(comp), p["proj_in"])
    names = sorted((k for k in p if k.startswith("block_")),
                   key=lambda s: int(s.split("_")[1]))
    for name in names:
        if isinstance(kv, dict):
            blk_kv = kv.get(name)
        else:
            blk_kv = kv if name == "block_0" else None
        h = _basic_block_ref(h, p[name], heads, context, blk_kv, use_flash)
    return _dense(h, p["proj_out"]) + x_tokens


# ---------------------------------------------------------------- kernel

_MAX_NORM_WIDTH = 512  # csrc: norm prologues stage one row's scale/shift
_MAX_TOKENS = 1024     # keeps the attention score tile at <= 64 KB a block


def fused_transformer_qualifies(t: int, c: int, heads: int, tk: int,
                                depth: int = 1) -> bool:
    """Whether the CUDA kernel takes a block of this shape.

    Re-derived for Hopper's shared memory: the GroupNorm/LayerNorm
    prologues stage a whole row's scale and shift (C <= 512), and the
    attention pass keeps a (16 x T) float32 score tile per block
    (T <= 1024 keeps it at 64 KB, two blocks per SM). ds1 (768, 224) and
    ds2 (192, 448) of the 256px nets qualify; the 896-channel ds4 and mid
    levels do not. The gate is about shape alone, as the JAX one is: a
    qualifying block given a context and no K/V reaches
    `fused_transformer_block`, which raises on CUDA for that unported
    variant.
    """
    if depth != 1 or tk < 1:
        return False
    if c % heads or c % 32 or heads * (c // heads) != c:
        return False
    return t <= _MAX_TOKENS and c <= _MAX_NORM_WIDTH


def _launch(x: torch.Tensor, p: Tree, heads: int, kv, gn_eps: float):
    b, t, c = x.shape
    k, v = kv
    tk = k.shape[1]
    if not fused_transformer_qualifies(t, c, heads, tk):
        raise ValueError(
            f"fused transformer kernel does not take T={t}, C={c}, "
            f"heads={heads}, Tk={tk}")
    if k.shape != (b, tk, c) or v.shape != (b, tk, c):
        raise ValueError(f"cross K/V must be ({b}, Tk, {c}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    blk = p["block_0"]
    a1, a2, ff = blk["attn1"], blk["attn2"], blk["ff"]
    args = [
        p["norm"]["weight"], p["norm"]["bias"],
        p["proj_in"]["weight"], p["proj_in"]["bias"],
        blk["norm1"]["weight"], blk["norm1"]["bias"],
        a1["to_q"]["weight"], a1["to_k"]["weight"], a1["to_v"]["weight"],
        a1["to_out"]["weight"], a1["to_out"]["bias"],
        blk["norm2"]["weight"], blk["norm2"]["bias"],
        a2["to_q"]["weight"], k, v,
        a2["to_out"]["weight"], a2["to_out"]["bias"],
        blk["norm3"]["weight"], blk["norm3"]["bias"],
        ff["proj_in"]["weight"], ff["proj_in"]["bias"],
        ff["proj_out"]["weight"], ff["proj_out"]["bias"],
        p["proj_out"]["weight"], p["proj_out"]["bias"],
    ]
    expect = [(c,), (c,), (c, c), (c,),
              (c,), (c,), (c, c), (c, c), (c, c), (c, c), (c,),
              (c,), (c,), (c, c), (b, tk, c), (b, tk, c), (c, c), (c,),
              (c,), (c,), (8 * c, c), (8 * c,), (c, 4 * c), (c,),
              (c, c), (c,)]
    for i, (a, shape) in enumerate(zip([x] + args, [(b, t, c)] + expect)):
        if tuple(a.shape) != shape:
            raise ValueError(f"fused transformer argument {i}: shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if a.dtype != torch.bfloat16:
            raise TypeError(f"fused transformer kernel takes bf16, argument "
                            f"{i} is {a.dtype}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"fused transformer argument {i} must be a "
                             f"contiguous tensor on {x.device}")
        if a.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "fused transformer backward: training slice")
    out = torch.empty_like(x)
    ws = torch.empty(10 * b * t * c, dtype=torch.bfloat16, device=x.device)
    stats = torch.empty(b * 64, dtype=torch.float32, device=x.device)
    lib = _build.library()
    code = lib.upgpt_fused_transformer_block(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in args),
        ws.data_ptr(), stats.data_ptr(), b, t, c, heads, tk, gn_eps,
        1.0 / math.sqrt(c // heads),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "fused_transformer_block")
    fused_transformer_block.launches += 1
    return out


def fused_transformer_block(x_tokens: torch.Tensor, p: Tree, heads: int,
                            context: Optional[torch.Tensor] = None, kv=None,
                            gn_eps: float = 1e-6,
                            use_flash: bool = False) -> torch.Tensor:
    """(B, T, C) tokens -> (B, T, C): the whole SpatialTransformer block.

    `kv` is the precomputed packed cross (k, v) pair, each (B, Tk, C).
    A CPU tensor takes `transformer_block_reference`; a CUDA tensor
    launches the kernel, which takes bf16 only.
    """
    if x_tokens.device.type == "cpu":
        return transformer_block_reference(x_tokens, p, heads, context, kv,
                                           gn_eps, use_flash)
    if x_tokens.device.type != "cuda":
        raise ValueError(f"fused_transformer_block: unsupported device "
                         f"{x_tokens.device}")
    if kv is None:
        raise NotImplementedError(
            "fused transformer block with the context projected in-kernel "
            "(kv=None): training slice")
    return _launch(x_tokens, p, heads, kv, gn_eps)


fused_transformer_block.launches = 0  # kernel launches since the last reset
