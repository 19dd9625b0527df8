"""Tensor parallelism: the U-Net's transformers split over in-process shards.

Port of `upgpt_tpu.parallel.tp` and of the CLI's `_tp_shard`
(`upgpt_tpu/cli.py:180-210`). JAX annotates the U-Net's parameters with
PartitionSpecs over a (data x model) mesh and lets GSPMD partition one
program (`tp.py:1-29`); the port runs that program itself, in one process.

- The spec table (`spec_for`, `unet_param_specs`, `validate_divisibility`;
  JAX's `_spec_for`, `unet_param_specs` and `validate_divisibility`,
  `tp.py:47-124`), over the port's parameter names and nn.Linear's (out,
  in) / conv's (O, I, kh, kw) layouts. Column-parallel `to_q` / `to_k` /
  `to_v`, GEGLU `ff.proj_in` and the SpatialTransformer's `proj_in` shard
  their outputs (dim 0 of the weight, and of proj_in's bias); row-parallel
  `to_out`, `ff.proj_out` and `proj_out` shard their inputs (dim 1), their
  biases replicated; with `shard_convs` a conv weight shards its outputs
  where O % 8 == 0. Everything else is replicated.
- `TPGrid`: devices and `tp`. Consecutive runs of `tp` devices are the
  data groups, in the row-major order of JAX's `create_mesh((n // tp,
  tp))`; a device may repeat, as in `ServingEngine(devices=...)`. Its
  `all_reduce_sum` and `all_gather` take one group's per-shard tensors and
  give each shard the result on its device: tensors move peer to peer with
  `.to(device, non_blocking=True)` (PyTorch fences a copy between two cards
  with events on both cards' current streams), and the sum runs in float32
  in shard order on every destination, so every shard holds bitwise the
  same result. Both are plain tensor ops, so a loss backpropagates through
  them. The grid counts each collective once per shard that takes part
  (`all_reduces`, `all_gathers`) and the bytes that cross between shards
  (`bytes`, also where two shards share a device).
- `TPLatentDiffusion`: a batch splits over the data groups (a run of
  consecutive rows each). Each group runs its rows through the unchanged
  `UNetModel.forward` on its first device, each SpatialTransformer there
  a `ShardedTransformer`: shard r's slice of its weights on the group's
  r-th device, run in the shard form
  (`ops.fused_transformer.transformer_block_shards`: four all-reduces
  and one all-gather a block). `cross_kv` projects the fixed context
  through each shard's to_k/to_v columns once per sampling loop. The
  VAE, pose stage and text-style fusion are replicated per group, and
  decodes and encodes run per group on its first device. Samplers, draws
  and the loss run over the global batch on the grid's first device, so
  `GenerationPipeline` and `training_loss` take the model as they take an
  unsharded one.

Three choices differ from JAX's:

- The replicated layers (ResBlocks, the time embedding, the convs) run
  once a group, on its first device, where GSPMD runs them on every
  device of the group; they give the same values either way.
- GEGLU: shard r takes value rows [r * 4C / tp, (r + 1) * 4C / tp) of
  `ff.proj_in` and the same rows of the gate half, so its GEGLU needs no
  exchange; JAX's contiguous split declines this (`tp.py:63-70`) because it
  would permute a converted checkpoint's columns, and the port slices at
  shard time instead, leaving the stored tensors as they are.
- Kernels (ROADMAP §3 P12): JAX rebuilds the model with every Pallas
  kernel off under `--tp` (`cli.py:186-189, 567-583`). The port keeps its
  kernels wherever the unsharded model runs them, except the fused
  SpatialTransformer kernel, whose one call spans the block's four
  all-reduce points: a shard's self-attention goes through the flash
  kernels wherever their gate admits its shape.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.models.unet import (
    UNetModel, cross_attention_layers, layer_cross_kv,
)
from upgpt_torch.models.vae import DiagonalGaussian
from upgpt_torch.ops.fused_transformer import transformer_block_shards

_COLUMN = ("to_q", "to_k", "to_v")
_ROW = ("to_out",)


def spec_for(name: str, shape: Sequence[int],
             shard_convs: bool = False) -> Optional[int]:
    """The dim of parameter `name` (dotted, the port's layout) that the
    model axis shards, or None where it is replicated: JAX's `_spec_for`
    (`tp.py:47-77`) read through `convert.from_jax`'s layouts."""
    keys = name.split(".")
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    grand = keys[-3] if len(keys) >= 3 else ""
    if any("attn" in k for k in keys[:-1]):
        if parent in _COLUMN and leaf == "weight":
            return 0
        if parent in _ROW:
            return 1 if leaf == "weight" else None
        if grand == "ff" or parent in ("proj_in", "proj_out"):
            if parent == "proj_in":
                return 0
            if parent == "proj_out":
                return 1 if leaf == "weight" else None
        return None
    if (shard_convs and leaf == "weight" and len(shape) == 4
            and shape[0] % 8 == 0):
        return 0
    return None


def unet_param_specs(params: Mapping[str, object],
                     shard_convs: bool = False) -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} for a model's parameters (anything with
    a `.shape`, by dotted name): the U-Net's (`unet.` in the name) by
    `spec_for`, every other leaf replicated, as JAX's
    `unet_param_specs` (`tp.py:80-96`) leaves the VAE, pose and CLIP
    trees."""
    return {name: (spec_for(name, tuple(value.shape), shard_convs)
                   if "unet" in name.split(".") else None)
            for name, value in params.items()}


def validate_divisibility(params: Mapping[str, object], tp: int,
                          shard_convs: bool = False,
                          num_heads: Optional[int] = None) -> None:
    """Raise ValueError where the heads or a sharded dim do not divide by
    `tp` (JAX `tp.py:108-124`, whose GSPMD would otherwise replicate)."""
    if num_heads is not None and num_heads % tp:
        raise ValueError(f"num_heads {num_heads} not divisible by tp={tp}")
    for name, dim in unet_param_specs(params, shard_convs).items():
        if dim is not None and params[name].shape[dim] % tp:
            raise ValueError(f"{name} dim {dim} ({params[name].shape[dim]})"
                             f" not divisible by tp={tp}")


def _is_geglu_in(name: str) -> bool:
    return name.split(".")[-3:-1] == ["ff", "proj_in"]


def shard_slice(name: str, value: torch.Tensor, dim: int, r: int,
                tp: int) -> torch.Tensor:
    """Shard r's slice of a full parameter along `dim`: its contiguous run,
    except GEGLU's `ff.proj_in`, whose shard r takes the r-th run of the
    value rows and the same run of the gate rows."""
    if _is_geglu_in(name):
        half = value.shape[0] // 2
        n = half // tp
        return torch.cat([value[r * n:(r + 1) * n],
                          value[half + r * n:half + (r + 1) * n]])
    n = value.shape[dim] // tp
    return value.narrow(dim, r * n, n)


def unshard(name: str, slices: Sequence[torch.Tensor],
            dim: int) -> torch.Tensor:
    """The full parameter (or gradient) from its shards' slices: the
    inverse of `shard_slice`."""
    if _is_geglu_in(name):
        halves = [s.chunk(2, dim=0) for s in slices]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves])
    return torch.cat(list(slices), dim=dim)


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; between two cards an asynchronous peer copy."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.device.type == device.type == "cuda")


def _sum_f32(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc


class TPGrid:
    """A (data x model) grid over `devices`: `groups[g]` are the `tp`
    devices of data group g, shard order."""

    def __init__(self, devices: Sequence, tp: int):
        self.devices = [_indexed(d) for d in devices]
        if tp < 1 or not self.devices or len(self.devices) % tp:
            raise ValueError(f"tp={tp} does not divide "
                             f"{len(self.devices)} devices")
        self.tp = tp
        self.groups = [self.devices[i:i + tp]
                       for i in range(0, len(self.devices), tp)]
        self.reset_counts()

    def reset_counts(self) -> None:
        self.all_reduces = self.all_gathers = self.bytes = 0

    def row_slices(self, n: int) -> List[Tuple[int, slice]]:
        """(group, rows) of a batch of `n` rows: a consecutive run a group,
        the first n % groups runs one row longer; a group without rows is
        left out."""
        per, extra = divmod(n, len(self.groups))
        out, start = [], 0
        for g in range(len(self.groups)):
            size = per + (g < extra)
            if size:
                out.append((g, slice(start, start + size)))
            start += size
        return out

    def _exchange(self, parts: Sequence[torch.Tensor], combine):
        """combine(every shard's part) on each device of the shards, the
        parts in shard order; shards on one device share its result."""
        done: Dict[torch.device, torch.Tensor] = {}
        for p in parts:
            if p.device not in done:
                done[p.device] = combine([_to(q, p.device) for q in parts])
        self.bytes += (len(parts) - 1) * sum(p.nbytes for p in parts)
        return [done[p.device] for p in parts]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each shard's float32 sum of the group's parts, on its device."""
        self.all_reduces += len(parts)
        return self._exchange(parts, _sum_f32)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   dim: int = -1) -> List[torch.Tensor]:
        """Each shard's concatenation of the group's parts along `dim`, in
        shard order, on its device."""
        self.all_gathers += len(parts)
        return self._exchange(parts, lambda qs: torch.cat(qs, dim=dim))


def _sliced_dims(unet: UNetModel) -> Dict[str, int]:
    """{U-Net parameter: the dim a shard holds a slice of}, by the table
    (convs whole: the model does not shard them)."""
    out = {}
    for name, value in unet.named_parameters():
        dim = spec_for(name, tuple(value.shape))
        if dim is not None:
            out[name] = dim
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


class ShardedTransformer(nn.Module):
    """A SpatialTransformer's place in a data group's U-Net: shard r's
    slice of it on the group's r-th device (`shards[r]`), called as the
    SpatialTransformer is. The tokens and the context go to every shard,
    the block runs in its shard form (`transformer_block_shards`) and shard
    0's output, on the group's first device, comes back. `kv` is a list:
    each shard's {block_i: (k, v)} of its heads."""

    def __init__(self, layer: nn.Module, name: str,
                 sliced: Mapping[str, int], grid: "TPGrid",
                 devices: Sequence[torch.device]):
        super().__init__()
        self.grid = grid
        self.devices = list(devices)
        self.num_heads = layer.num_heads
        self.use_flash = layer.use_flash
        self.compute_dtype = layer.compute_dtype
        prefix = name + "."
        own = {k[len(prefix):]: d for k, d in sliced.items()
               if k.startswith(prefix)}
        self.shards = nn.ModuleList()
        for r, dev in enumerate(self.devices):
            rep = copy.deepcopy(layer)
            with torch.no_grad():
                for pname, dim in own.items():
                    path, leaf = pname.rsplit(".", 1)
                    mod = rep.get_submodule(path)
                    old = getattr(mod, leaf)
                    setattr(mod, leaf, nn.Parameter(
                        shard_slice(pname, old, dim, r, grid.tp).clone(),
                        requires_grad=old.requires_grad))
            # .to() also drops the copied tree of the whole parameters
            self.shards.append(rep.to(dev))

    def cross_kv(self, ctx: torch.Tensor) -> List[Dict]:
        """Each shard's {block_i: (k, v)}: `ctx` through its heads' to_k /
        to_v columns, on its device."""
        return [layer_cross_kv(m, _to(ctx, d))
                for m, d in zip(self.shards, self.devices)]

    def forward(self, x: torch.Tensor, context=None, kv=None) -> torch.Tensor:
        b, h, w, c = x.shape
        comp = self.compute_dtype or self.shards[0].proj_in.weight.dtype
        tokens = x.reshape(b, h * w, c).to(comp)
        outs = transformer_block_shards(
            self.grid, [m.cast_params(comp) for m in self.shards],
            [_to(tokens, d) for d in self.devices],
            self.num_heads // self.grid.tp,
            None if context is None else [_to(context, d)
                                          for d in self.devices],
            None if kv is None else [_map(k, lambda t, d=d: _to(t, d))
                                     for k, d in zip(kv, self.devices)],
            use_flash=self.use_flash)
        return outs[0].reshape(b, h, w, c)


class TPUNet(nn.Module):
    """`forward(x, timesteps, context, cross_kv)` of a UNetModel over a
    grid: the global batch in, on the grid's first device, and the global
    eps out there (float32). Each data group runs its rows through
    UNetModel.forward on its first device, every SpatialTransformer there a
    `ShardedTransformer` over the group's devices; groups on the same
    devices share one such U-Net."""

    def __init__(self, unet: UNetModel, grid: TPGrid):
        super().__init__()
        self.config = unet.config
        self.grid = grid
        self.sliced = _sliced_dims(unet)
        attns = [name for kind, name in unet._plan if kind == "attn"]
        devs: List[Tuple[torch.device, ...]] = []
        self.replicas = nn.ModuleList()
        for group in grid.groups:
            if tuple(group) in devs:
                continue
            devs.append(tuple(group))
            rep = copy.deepcopy(unet)
            for name in attns:
                setattr(rep, name, nn.Identity())
            rep.to(group[0])
            for name in attns:
                setattr(rep, name, ShardedTransformer(
                    getattr(unet, name), name, self.sliced, grid, group))
            self.replicas.append(rep)
        self._replica_of = [devs.index(tuple(g)) for g in grid.groups]

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.replicas[0].compute_dtype

    def cross_kv(self, context: torch.Tensor) -> Dict[str, List[Dict]]:
        """{layer: each shard's K/V of its heads} of the global context, on
        the first group's devices."""
        rep = self.replicas[0]
        ctx = context.to(rep.compute_dtype)
        return {name: getattr(rep, name).cross_kv(ctx)
                for name, _ch in cross_attention_layers(self.config)}

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                cross_kv: Optional[Dict] = None) -> torch.Tensor:
        outs = []
        for g, rows in self.grid.row_slices(x.shape[0]):
            lead = self.grid.groups[g][0]
            out = self.replicas[self._replica_of[g]](
                _to(x[rows], lead), _to(timesteps[rows], lead),
                None if context is None else _to(context[rows], lead),
                None if cross_kv is None else _map(cross_kv,
                                                   lambda t: t[rows]))
            outs.append(_to(out, x.device))
        return torch.cat(outs)


def _stages(model: LatentDiffusion, device: torch.device) -> nn.Module:
    """A copy of the model's stages outside the U-Net on `device`."""
    out = nn.Module()
    for name in ("vae", "pose", "cond_fusion"):
        mod = getattr(model, name)
        setattr(out, name, None if mod is None
                else copy.deepcopy(mod).to(device))
    return out


class TPLatentDiffusion(LatentDiffusion):
    """`model` sharded over a grid of `devices` with `tp` shards a group
    (copies: `model` is left as it was). It takes LatentDiffusion's calls
    (`apply_model`, `cross_kv`, `build_context`, `to_eps`, the first
    stage's encode and decode, `training_loss`) on the global batch, on
    the grid's first device (`device`). Raises ValueError where the heads
    or a sharded dim do not divide by `tp`."""

    def __init__(self, model: LatentDiffusion, devices: Sequence, tp: int):
        # the shards and stages below stand in for LatentDiffusion's
        # modules, so its __init__ does not run
        nn.Module.__init__(self)
        validate_divisibility(
            {f"unet.{k}": v for k, v in model.unet.named_parameters()}, tp,
            num_heads=model.config.unet.num_heads)
        self.config = model.config
        self.schedule = model.schedule
        self.grid = TPGrid(devices, tp)
        self.unet = TPUNet(model.unet, self.grid)
        leads = list(dict.fromkeys(g[0] for g in self.grid.groups))
        self.stages = nn.ModuleList(_stages(model, d) for d in leads)
        self._stage_of = [leads.index(g[0]) for g in self.grid.groups]
        self.pose = self.stages[0].pose
        self.cond_fusion = self.stages[0].cond_fusion

    @property
    def device(self) -> torch.device:
        return self.grid.devices[0]

    def cross_kv(self, context: torch.Tensor) -> List[Dict]:
        return self.unet.cross_kv(context)

    def _per_group(self, x: torch.Tensor, fn) -> torch.Tensor:
        """fn(stages of group g, its rows of x on its first device) for
        every group, concatenated on the grid's first device."""
        return torch.cat([
            _to(fn(self.stages[self._stage_of[g]],
                   _to(x[rows], self.grid.groups[g][0])), self.device)
            for g, rows in self.grid.row_slices(x.shape[0])])

    def _posterior(self, x: torch.Tensor) -> DiagonalGaussian:
        def moments(stages, rows):
            post = stages.vae.encode(rows)
            return torch.cat([post.mean, post.logvar], dim=-1)

        return DiagonalGaussian(self._per_group(x, moments))

    def encode_first_stage(self, x: torch.Tensor,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        with torch.no_grad():
            z = self._posterior(x).sample(noise, generator)
        return self.config.scale_factor * z

    def encode_first_stage_mode(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            z = self._posterior(x).mode()
        return self.config.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        scale = self.config.scale_factor
        return self._per_group(z, lambda s, rows: s.vae.decode(rows / scale))

    def gradients(self) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient over the sharded model, float32 on
        `device`, by the unsharded model's names: a sliced leaf's slices
        put back together (each summed over the replicas), every other
        leaf's copies (a replica's, a shard's) summed, as GSPMD's gradient
        of one logical parameter. Leaves no copy has a gradient for are
        left out."""
        tp = self.grid.tp
        out: Dict[str, torch.Tensor] = {}
        slices: Dict[str, List[Optional[torch.Tensor]]] = {}
        shapes: Dict[str, torch.Size] = {}

        def add(name, g):
            out[name] = out[name] + g if name in out else g

        for rep in self.unet.replicas:
            for name, p in rep.named_parameters():
                if ".shards." in name:
                    layer, rest = name.split(".shards.", 1)
                    r, leaf = rest.split(".", 1)
                    name, r = f"{layer}.{leaf}", int(r)
                if p.grad is None:
                    continue
                g = _to(p.grad, self.device).float()
                if name not in self.unet.sliced:
                    add(f"unet.{name}", g)
                    continue
                shapes[name] = p.shape
                slot = slices.setdefault(name, [None] * tp)
                slot[r] = g if slot[r] is None else slot[r] + g
        for name, parts in slices.items():
            out[f"unet.{name}"] = unshard(name, [
                torch.zeros(shapes[name], device=self.device) if g is None
                else g for g in parts], self.unet.sliced[name])
        for stages in self.stages:
            for name, p in stages.named_parameters():
                if p.grad is not None:
                    add(name, _to(p.grad, self.device).float())
        return out


def from_jax_params(model: LatentDiffusion, params: Mapping,
                    devices: Sequence, tp: int) -> TPLatentDiffusion:
    """JAX's parameter tree (numpy arrays, nested or flattened) loaded into
    `model` through the bridge (`convert.from_jax.load_jax_params`), then
    sharded: what JAX's `shard_params` (`tp.py:99-105`) does to a tree."""
    from upgpt_torch.convert.from_jax import load_jax_params

    return TPLatentDiffusion(load_jax_params(model, params), devices, tp)
