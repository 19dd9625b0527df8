"""The SpatialTransformer block (depth 1): a CUDA kernel and its twin.

Port of `upgpt_tpu.ops.fused_transformer`. The block is

    GN32(eps 1e-6) -> proj_in -> LN1 -> self-attn -> LN2 -> cross-attn ->
    LN3 -> GEGLU FF -> proj_out -> + input

with float32 GroupNorm/LayerNorm statistics and softmax, exact-erf GELU and
a bf16 residual stream rounded after every sub-block. The kernel is
`csrc/fused_transformer.cu`, which replaces `_fused_forward` /
`_block_kernel`. One TPU program per sample does not fit a Hopper SM, so on
this card the block is eleven launches from one C call: GroupNorm
statistics, seven products on the pipelined wgmma mainloop of
`csrc/gemm_sm90.cuh` (weights by TMA; norm prologues applied once to a
block's A panel in shared memory; bias/scale/residual/GEGLU epilogues on the
accumulator registers), and two passes of the shared attention routine over
the packed activations. Each product's tile, split of K and ring depth come
from `gemm_plan.transformer_plans`. Both variants are ported: cross K/V
precomputed by the sampler (`precompute_cross_kv`), and the training
variant (`kv=None`), where the same call first projects the context through
attn2's `to_k` and `to_v` (a twelfth launch).

`fused_transformer_block` is an autograd.Function, as the JAX function is a
custom_vjp: the forward is the kernel (its twin for CPU tensors), and the
backward recomputes `transformer_block_reference` under autograd and returns
gradients for the tokens, every parameter and the context (or K/V). With
`use_flash` the recompute's long self-attention goes through the flash
kernels, forward and backward (`ops/flash_attention.py`).

`transformer_block_shards` is the twin split over the shards of a
tensor-parallel grid (`parallel/tp.py`), Megatron's way: one all-gather
after proj_in and four all-reduces, summed in float32; K1's one call spans
those points, so the tp path runs this form in its place.

`p` is the SpatialTransformer's parameter tree with the JAX package's keys
(`norm`, `proj_in`, `proj_out`, `block_0/{attn1,attn2,ff,norm1..3}`) and
nn.Linear-layout leaves (`weight` (out, in), `bias`), as `param_tree` builds
it from a module. The kernel takes every leaf in bf16; a caller training
float32 masters passes their bf16 casts, and the gradients reach the masters
through the casts.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from upgpt_torch.ops import _build, gemm_plan
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


def self_attention_product(z: torch.Tensor, a1: Tree, heads: int,
                           use_flash: bool) -> torch.Tensor:
    """Self-attention over `heads` heads of the (B, T, heads * d) queries
    that `a1`'s to_q/to_k/to_v rows give, through `to_out`'s columns,
    without its bias: through the flash kernels where `use_flash` and
    their gate admit the shape, else the plain core. A tensor-parallel
    shard passes its own heads' rows and columns."""
    from upgpt_torch.ops.attention import attention_weight_split
    from upgpt_torch.ops.flash_attention import (
        flash_attention, flash_attention_qualifies,
    )

    comp = z.dtype
    b, tq, _ = z.shape
    d = a1["to_q"]["weight"].shape[0] // heads
    if use_flash and flash_attention_qualifies(b, heads, tq, tq, d, comp):
        def headed(w):
            kern = w["weight"].to(comp)
            return torch.einsum("btc,hdc->bhtd", z,
                                kern.reshape(heads, d, kern.shape[-1]))

        o = flash_attention(headed(a1["to_q"]).contiguous(),
                            headed(a1["to_k"]).contiguous(),
                            headed(a1["to_v"]).contiguous())
        wo = a1["to_out"]["weight"].to(comp)
        return torch.einsum("bhtd,chd->btc", o,
                            wo.reshape(wo.shape[0], heads, d))
    return attention_weight_split(z, None, a1, heads, bias=False)


def _basic_block_ref(h, blk, heads, context, kv, use_flash):
    """One BasicTransformerBlock (reference attention.py:196-215)."""
    from upgpt_torch.ops.attention import attention_weight_split

    comp = h.dtype
    z = _ln_tree(h, blk["norm1"])
    a1 = blk["attn1"]
    h = h + (self_attention_product(z, a1, heads, use_flash)
             + a1["to_out"]["bias"].to(comp))
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
    for name in _block_names(p):
        h = _basic_block_ref(h, p[name], heads, context,
                             _block_kv(kv, name), use_flash)
    return _dense(h, p["proj_out"]) + x_tokens


def _block_names(p: Tree):
    return sorted((k for k in p if k.startswith("block_")),
                  key=lambda s: int(s.split("_")[1]))


def _block_kv(kv, name: str):
    """A block's (k, v) pair of `kv`: a pair for block_0 or a {block_i:
    pair} dict."""
    if isinstance(kv, dict):
        return kv.get(name)
    return kv if name == "block_0" else None


# ---------------------------------------------------------------- shards


def transformer_block_shards(grid, trees, xs, heads: int, contexts=None,
                             kvs=None, gn_eps: float = 1e-6,
                             use_flash: bool = False):
    """`transformer_block_reference` split over the shards of one data
    group of a tensor-parallel grid (`parallel/tp.py`), Megatron's way.

    `trees[r]` is shard r's parameter tree: its `heads` heads' rows of
    to_q/to_k/to_v and columns of to_out, its share of proj_in's outputs
    and of proj_out's inputs, its run of GEGLU's value rows with the same
    run of the gate rows (so its GEGLU needs no exchange) and the matching
    columns of ff.proj_out; norms and the row-parallel biases whole. `xs[r]`
    is its copy of the (B, T, C) tokens, on its device, `contexts[r]` /
    `kvs[r]` its context or its heads' K/V columns (a pair or a {block_i:
    pair} dict). Each shard runs GN32, its proj_in columns, then one
    all-gather; per block LN1, attention over its heads (the flash kernels
    where `use_flash` and their gate admit the shard's shape), its to_out
    row partial, an all-reduce, the bias once and the residual; the same
    for attn2; LN3, its GEGLU, ff.proj_out's row partial, an all-reduce,
    the bias and the residual; then proj_out's row partial over its
    channels of h, an all-reduce, the bias and the input residual. The
    grid sums partials in float32; each sum plus its bias is rounded to the
    compute dtype once, where the twin rounds the residual stream. Returns
    each shard's (B, T, C) output, bitwise equal across shards.
    """
    from upgpt_torch.ops.attention import attention_weight_split

    comp = xs[0].dtype

    def reduce_into(hs, parts, biases):
        sums = grid.all_reduce_sum(parts)
        return [h + (s + b.float()).to(comp)
                for h, s, b in zip(hs, sums, biases)]

    hs = grid.all_gather([
        _dense(group_norm(x, p["norm"]["weight"], p["norm"]["bias"],
                          num_groups=32, eps=gn_eps).to(comp), p["proj_in"])
        for x, p in zip(xs, trees)], dim=-1)
    for name in _block_names(trees[0]):
        blks = [p[name] for p in trees]
        zs = [_ln_tree(h, blk["norm1"]) for h, blk in zip(hs, blks)]
        hs = reduce_into(
            hs, [self_attention_product(z, blk["attn1"], heads, use_flash)
                 for z, blk in zip(zs, blks)],
            [blk["attn1"]["to_out"]["bias"] for blk in blks])
        parts = []
        for r, (h, blk) in enumerate(zip(hs, blks)):
            z = _ln_tree(h, blk["norm2"])
            kv = None if kvs is None else _block_kv(kvs[r], name)
            src = z if contexts is None else contexts[r].to(comp)
            parts.append(attention_weight_split(
                z, src if kv is None else None, blk["attn2"], heads, kv=kv,
                bias=False))
        hs = reduce_into(hs, parts,
                         [blk["attn2"]["to_out"]["bias"] for blk in blks])
        parts = []
        for h, blk in zip(hs, blks):
            g = _dense(_ln_tree(h, blk["norm3"]), blk["ff"]["proj_in"])
            xh, gate = g.chunk(2, dim=-1)
            act = (xh.float() * _gelu_exact(gate.float())).to(comp)
            parts.append(F.linear(act, blk["ff"]["proj_out"]["weight"]
                                  .to(comp)))
        hs = reduce_into(hs, parts,
                         [blk["ff"]["proj_out"]["bias"] for blk in blks])
    n = hs[0].shape[-1] // len(trees)
    sums = grid.all_reduce_sum([
        F.linear(h[..., r * n:(r + 1) * n], p["proj_out"]["weight"].to(comp))
        for r, (h, p) in enumerate(zip(hs, trees))])
    return [(s + p["proj_out"]["bias"].float()).to(comp) + x
            for s, p, x in zip(sums, trees, xs)]


# ---------------------------------------------------------------- kernel

_MAX_NORM_WIDTH = 512  # csrc: norm prologues hold a (BM, C) panel
_MAX_TOKENS = 1024     # a dispatch rule, not a kernel limit (see the gate)

# the tree's leaves in the order the autograd.Function takes them
_LEAVES = (
    ("norm", "weight"), ("norm", "bias"),
    ("proj_in", "weight"), ("proj_in", "bias"),
    ("block_0", "norm1", "weight"), ("block_0", "norm1", "bias"),
    ("block_0", "attn1", "to_q", "weight"),
    ("block_0", "attn1", "to_k", "weight"),
    ("block_0", "attn1", "to_v", "weight"),
    ("block_0", "attn1", "to_out", "weight"),
    ("block_0", "attn1", "to_out", "bias"),
    ("block_0", "norm2", "weight"), ("block_0", "norm2", "bias"),
    ("block_0", "attn2", "to_q", "weight"),
    ("block_0", "attn2", "to_k", "weight"),
    ("block_0", "attn2", "to_v", "weight"),
    ("block_0", "attn2", "to_out", "weight"),
    ("block_0", "attn2", "to_out", "bias"),
    ("block_0", "norm3", "weight"), ("block_0", "norm3", "bias"),
    ("block_0", "ff", "proj_in", "weight"),
    ("block_0", "ff", "proj_in", "bias"),
    ("block_0", "ff", "proj_out", "weight"),
    ("block_0", "ff", "proj_out", "bias"),
    ("proj_out", "weight"), ("proj_out", "bias"),
)


def _flatten(p: Tree):
    out = []
    for path in _LEAVES:
        node = p
        for key in path:
            node = node[key]
        out.append(node)
    return out


def _unflatten(leaves) -> Dict:
    tree: Dict = {}
    for path, leaf in zip(_LEAVES, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def fused_transformer_qualifies(t: int, c: int, heads: int, tk: int,
                                depth: int = 1) -> bool:
    """Whether the CUDA kernel takes a block of this shape.

    Re-derived for Hopper's shared memory: the GroupNorm/LayerNorm
    prologues hold a block's whole (BM, C) panel (C <= 512). The
    attention passes run the tiled flash routine of
    csrc/flash_attention.cu, which takes any T; T <= 1024 stays as a
    dispatch rule, so the 512px nets' T = 3072 blocks keep the twin with
    the flash kernel for their self-attention. ds1 (768, 224) and ds2
    (192, 448) of the 256px nets qualify, and so does the upscale net's
    ds4 (768, 512), which JAX's VMEM budget refuses (25.8 MB against
    17 MB); the 896-channel ds4 and mid levels do not. The gate is about
    shape alone, as the JAX one is, and holds for both variants: the
    context projection is one more product, whose width the kernel does
    not stage.
    """
    if depth != 1 or tk < 1:
        return False
    if c % heads or c % 32 or heads * (c // heads) != c:
        return False
    return t <= _MAX_TOKENS and c <= _MAX_NORM_WIDTH


def _launch(x: torch.Tensor, p: Tree, heads: int, context, kv,
            gn_eps: float) -> torch.Tensor:
    b, t, c = x.shape
    blk = p["block_0"]
    a1, a2, ff = blk["attn1"], blk["attn2"], blk["ff"]
    if kv is not None:
        k, v = kv
        tk, ctx_dim = k.shape[1], 0
        ctx = wk2 = wv2 = None
    else:
        tk, ctx_dim = context.shape[1], context.shape[-1]
        k = v = None
        ctx, wk2, wv2 = context, a2["to_k"]["weight"], a2["to_v"]["weight"]
        if ctx_dim % 8:
            raise ValueError(f"fused transformer kernel takes a context "
                             f"width that is a multiple of 8, got {ctx_dim}")
    if not fused_transformer_qualifies(t, c, heads, tk):
        raise ValueError(
            f"fused transformer kernel does not take T={t}, C={c}, "
            f"heads={heads}, Tk={tk}")
    sq, vec = (c, c), (c,)
    # the C entry point's tensor arguments in order, with their shapes;
    # None for the variant's absent inputs
    args = [
        (x, (b, t, c)),
        (p["norm"]["weight"], vec), (p["norm"]["bias"], vec),
        (p["proj_in"]["weight"], sq), (p["proj_in"]["bias"], vec),
        (blk["norm1"]["weight"], vec), (blk["norm1"]["bias"], vec),
        (a1["to_q"]["weight"], sq), (a1["to_k"]["weight"], sq),
        (a1["to_v"]["weight"], sq),
        (a1["to_out"]["weight"], sq), (a1["to_out"]["bias"], vec),
        (blk["norm2"]["weight"], vec), (blk["norm2"]["bias"], vec),
        (a2["to_q"]["weight"], sq), (k, (b, tk, c)), (v, (b, tk, c)),
        (a2["to_out"]["weight"], sq), (a2["to_out"]["bias"], vec),
        (blk["norm3"]["weight"], vec), (blk["norm3"]["bias"], vec),
        (ff["proj_in"]["weight"], (8 * c, c)),
        (ff["proj_in"]["bias"], (8 * c,)),
        (ff["proj_out"]["weight"], (c, 4 * c)), (ff["proj_out"]["bias"], vec),
        (p["proj_out"]["weight"], sq), (p["proj_out"]["bias"], vec),
        (ctx, (b, tk, ctx_dim)), (wk2, (c, ctx_dim)), (wv2, (c, ctx_dim)),
    ]
    for i, (a, shape) in enumerate(args):
        if a is None:
            continue
        if tuple(a.shape) != shape:
            raise ValueError(f"fused transformer argument {i}: shape "
                             f"{tuple(a.shape)}, expected {shape}")
        if a.dtype != torch.bfloat16:
            raise TypeError(f"fused transformer kernel takes bf16, argument "
                            f"{i} is {a.dtype}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"fused transformer argument {i} must be a "
                             f"contiguous tensor on {x.device}")
    ptrs = [None if a is None else a.data_ptr() for a, _ in args]
    out = torch.empty_like(x)
    ws = torch.empty(10 * b * t * c + (2 * b * tk * c if kv is None else 0),
                     dtype=torch.bfloat16, device=x.device)
    stats = torch.empty(b * 64, dtype=torch.float32, device=x.device)
    _, plan, (floats, tiles) = gemm_plan.cached_transformer_plans(
        b, t, c, tk, None if kv is not None else ctx_dim)
    partials, counters = gemm_plan.split_scratch(x.device, floats, tiles)
    _build.launch(
        x.device, "upgpt_fused_transformer_block", "fused_transformer_block",
        ptrs[0], out.data_ptr(), *ptrs[1:], ws.data_ptr(), stats.data_ptr(),
        plan, None if partials is None else partials.data_ptr(), floats,
        None if counters is None else counters.data_ptr(),
        0 if counters is None else counters.numel(),
        b, t, c, heads, tk, ctx_dim, gn_eps, 1.0 / math.sqrt(c // heads),
        torch.cuda.current_stream(x.device).cuda_stream)
    fused_transformer_block.launches += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """Forward: the kernel (the twin on CPU tensors). Backward: recompute
    the twin under autograd, as `_fused_bwd` does with jax.vjp."""

    @staticmethod
    def forward(ctx, x, context, k, v, heads, gn_eps, use_flash, *leaves):
        kv = None if k is None else (k, v)
        if x.device.type == "cpu":
            out = transformer_block_reference(
                x, _unflatten(leaves), heads, context, kv, gn_eps, use_flash)
        else:
            out = _launch(x, _unflatten(leaves), heads, context, kv, gn_eps)
        ctx.save_for_backward(x, context, k, v, *leaves)
        ctx.config = (heads, gn_eps, use_flash)
        return out

    @staticmethod
    def backward(ctx, grad):
        heads, gn_eps, use_flash = ctx.config
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4] + ctx.needs_input_grad[7:]
        with torch.enable_grad():
            inputs = [None if a is None else a.detach().requires_grad_(n)
                      for a, n in zip(saved, needs)]
            x, context, k, v, *leaves = inputs
            out = transformer_block_reference(
                x, _unflatten(leaves), heads, context,
                None if k is None else (k, v), gn_eps, use_flash)
            wanted = [a for a, n in zip(inputs, needs) if a is not None and n]
            grads = iter(torch.autograd.grad(out, wanted, grad,
                                             allow_unused=True))
        out_grads = [next(grads) if a is not None and n else None
                     for a, n in zip(inputs, needs)]
        return (*out_grads[:4], None, None, None, *out_grads[4:])


def fused_transformer_block(x_tokens: torch.Tensor, p: Tree, heads: int,
                            context: Optional[torch.Tensor] = None, kv=None,
                            gn_eps: float = 1e-6,
                            use_flash: bool = False) -> torch.Tensor:
    """(B, T, C) tokens -> (B, T, C): the whole SpatialTransformer block.

    `kv` is the precomputed packed cross (k, v) pair, each (B, Tk, C);
    without it the block projects `context` (B, Tk, Cd) itself. A CPU
    tensor takes `transformer_block_reference`; a CUDA tensor launches the
    kernel, which takes bf16 only. Differentiable in every tensor input.
    """
    if x_tokens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_transformer_block: unsupported device "
                         f"{x_tokens.device}")
    if kv is None and context is None:
        raise ValueError("fused_transformer_block needs a context or K/V")
    k, v = (None, None) if kv is None else kv
    return _FusedBlock.apply(x_tokens, context if kv is None else None, k, v,
                             heads, gn_eps, use_flash, *_flatten(p))


fused_transformer_block.launches = 0  # kernel launches since the last reset
