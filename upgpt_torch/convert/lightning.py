"""The reference's Lightning checkpoints -> the port's modules.

Counterpart of `upgpt_tpu/convert/torch_to_jax.py`. The released UPGPT
models are Lightning `.ckpt` files whose `state_dict` holds the U-Net under
`model.diffusion_model.*`, its LitEma shadow under `model_ema.*`, the VAE
under `first_stage_model.*`, the pose stage under `extra_cond_models.{i}.*`
and, for inshop_laion, the text-style fusion under
`cond_stage_model.cross_att.*` (reference ddpm.py:433-494).

Both layouts are torch (NCHW convs, (out, in) linears), so most tensors copy
straight. The port's modules carry the JAX tree's names
(`unet.down_0_0_res.conv_in`), so the map from the reference's names is the
JAX converter's index arithmetic: `input_blocks.{n}` and `output_blocks.{n}`
are recomputed from the config. One table per model (`unet_table`,
`vae_table`, `pose_table`, `fusion_table`) maps every tensor of the port's
module to the reference key it reads and how: a straight copy, or the
reference's 1x1 `proj_in`/`proj_out` convs (O, I, 1, 1) read as the
port's linears (O, I). `to_lightning_state_dict` writes the same tables
backwards.

Conversion is strict: a module tensor left unfilled, a U-Net, VAE, pose or
fusion key of the file left unread, or a shape that disagrees raises
ValueError naming the key. Keys of `cond_stage_model.*` other than the
fusion's, and keys outside every submodel (the schedule's buffers, a frozen
CLIP), are listed in the conversion record, not refused.

Loading never unpickles arbitrary objects (ROADMAP P8): the file is read
with `weights_only=True`, and where that loader refuses the file's
non-tensor entries (a Lightning file's `hyper_parameters`, `callbacks` and
`loops` may name arbitrary classes), a restricted unpickler reads the zip
archive itself. It admits torch's tensor and storage rebuilds and plain
containers, and turns every other global into an inert stub that is never
called through to anything.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Dict, List, Mapping, Optional, Tuple

import torch

StateDict = Mapping[str, torch.Tensor]
# (reference key, how): how is "copy" or "conv1x1" (an (O, I, 1, 1) conv
# read as an (O, I) linear)
Table = Dict[str, Tuple[str, str]]

_PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
           "cond_stage": "cond_stage_model.", "ema": "model_ema."}


# ---------------------------------------------------------------- loading

class _Inert:
    """What every global the restricted unpickler does not admit becomes:
    it takes any arguments and state and does nothing with them."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return _Inert()

    def __setstate__(self, state):
        pass

    def __setitem__(self, key, value):
        pass

    def append(self, value):
        pass

    def extend(self, values):
        pass


class _StorageType:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype


_STORAGES = {f"{name}Storage": dtype for name, dtype in (
    ("Float", torch.float32), ("Double", torch.float64),
    ("Half", torch.float16), ("BFloat16", torch.bfloat16),
    ("Long", torch.int64), ("Int", torch.int32), ("Short", torch.int16),
    ("Char", torch.int8), ("Byte", torch.uint8), ("Bool", torch.bool))}


def _rebuild_tensor(storage, offset, size, stride, *_):
    return storage.as_strided(tuple(size), tuple(stride), offset)


def _rebuild_parameter(data, *_):
    return data


_ADMITTED: Dict[Tuple[str, str], object] = {
    ("collections", "OrderedDict"): dict,
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch._utils", "_rebuild_parameter_with_state"): _rebuild_parameter,
    **{("torch", name): _StorageType(dtype)
       for name, dtype in _STORAGES.items()},
}


class _RestrictedUnpickler(pickle.Unpickler):
    """A torch zip archive's `data.pkl`, with storages read from the
    archive and every global outside `_ADMITTED` an inert stub."""

    def __init__(self, fh, archive: zipfile.ZipFile, prefix: str):
        super().__init__(fh)
        self.archive, self.prefix = archive, prefix

    def find_class(self, module, name):
        return _ADMITTED.get((module, name), _Inert)

    def persistent_load(self, pid):
        kind, storage_type, key, _location, numel = pid
        if kind != "storage" or not isinstance(storage_type, _StorageType):
            raise pickle.UnpicklingError(f"unsupported storage {pid!r}")
        raw = bytearray(self.archive.read(f"{self.prefix}data/{key}"))
        flat = (torch.frombuffer(raw, dtype=storage_type.dtype) if raw
                else torch.empty(0, dtype=storage_type.dtype))
        return flat[:numel]


def _restricted_load(path) -> dict:
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not a torch zip archive; the restricted "
                         f"reader takes only that format")
    with zipfile.ZipFile(path) as archive:
        pkl = next((n for n in archive.namelist()
                    if n.endswith("data.pkl") and n.count("/") == 1), None)
        if pkl is None:
            raise ValueError(f"{path}: no data.pkl in the archive")
        with archive.open(pkl) as fh:
            return _RestrictedUnpickler(fh, archive,
                                        pkl[:-len("data.pkl")]).load()


def load_lightning_state_dict(path) -> Dict[str, torch.Tensor]:
    """The `state_dict` of a Lightning checkpoint (or the file itself where
    it is a bare state dict), without running any code the pickle names."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    except (pickle.UnpicklingError, RuntimeError):
        # the weights-only loader refuses a global it does not know
        # (hyper_parameters' classes); read the tensors without it
        ckpt = _restricted_load(path)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else None
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: no state_dict mapping")
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def split_ldm_checkpoint(path) -> Dict[str, Dict[str, torch.Tensor]]:
    """A Lightning checkpoint's tensors by submodel, float32 on the host:
    `unet`, `vae`, `cond_stage`, `extra_cond_{i}`, `ema` (LitEma's
    flattened names) and `other`, each key without its prefix
    (`upgpt_tpu/convert/torch_to_jax.py:280-313`)."""
    buckets: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in load_lightning_state_dict(path).items():
        bucket, key = "other", k
        for name, prefix in _PREFIX.items():
            if k.startswith(prefix):
                bucket, key = name, k[len(prefix):]
                break
        else:
            if k.startswith("extra_cond_models."):
                idx, key = k[len("extra_cond_models."):].split(".", 1)
                bucket = f"extra_cond_{idx}"
        buckets.setdefault(bucket, {})[key] = v.float()
    return buckets


def ema_unet_state_dict(buckets) -> Optional[Dict[str, torch.Tensor]]:
    """The U-Net's weights from LitEma's shadow, in the `unet` bucket's
    names: LitEma registers `name.replace('.', '')` relative to the
    DiffusionWrapper (reference ema.py:13-15). A tensor the shadow lacks
    (a buffer such as `num_batches_tracked`) keeps its raw value. None
    where the file has no shadow."""
    ema, unet = buckets.get("ema"), buckets.get("unet")
    if not ema or not unet:
        return None
    out = {}
    for k, v in unet.items():
        flat = ("diffusion_model." + k).replace(".", "")
        out[k] = ema.get(flat, v)
    return out


# ----------------------------------------------------------------- tables

def _linear(table: Table, port: str, ref: str, bias: bool = True) -> None:
    table[f"{port}.weight"] = (f"{ref}.weight", "copy")
    if bias:
        table[f"{port}.bias"] = (f"{ref}.bias", "copy")


def _resblock(table: Table, port: str, ref: str, skip: bool) -> None:
    for p, r in (("norm_in", "in_layers.0"), ("conv_in", "in_layers.2"),
                 ("emb_proj", "emb_layers.1"), ("norm_out", "out_layers.0"),
                 ("conv_out", "out_layers.3")):
        _linear(table, f"{port}.{p}", f"{ref}.{r}")
    if skip:
        _linear(table, f"{port}.skip", f"{ref}.skip_connection")


def _cross_attention(table: Table, port: str, ref: str) -> None:
    for p in ("to_q", "to_k", "to_v"):
        _linear(table, f"{port}.{p}", f"{ref}.{p}", bias=False)
    _linear(table, f"{port}.to_out", f"{ref}.to_out.0")


def _transformer(table: Table, port: str, ref: str, depth: int) -> None:
    _linear(table, f"{port}.norm", f"{ref}.norm")
    for p in ("proj_in", "proj_out"):
        table[f"{port}.{p}.weight"] = (f"{ref}.{p}.weight", "conv1x1")
        table[f"{port}.{p}.bias"] = (f"{ref}.{p}.bias", "copy")
    for d in range(depth):
        pb, rb = f"{port}.block_{d}", f"{ref}.transformer_blocks.{d}"
        _cross_attention(table, f"{pb}.attn1", f"{rb}.attn1")
        _cross_attention(table, f"{pb}.attn2", f"{rb}.attn2")
        _linear(table, f"{pb}.ff.proj_in", f"{rb}.ff.net.0.proj")
        _linear(table, f"{pb}.ff.proj_out", f"{rb}.ff.net.2")
        for n in ("norm1", "norm2", "norm3"):
            _linear(table, f"{pb}.{n}", f"{rb}.{n}")


def unet_table(cfg) -> Table:
    """The U-Net's tensors (`UNetModel.state_dict()` names) -> the
    reference UNetModel's (openaimodel.py:516-692), walking the same
    (level, block) loops as both constructors
    (`upgpt_tpu/convert/torch_to_jax.py:112-176`)."""
    t: Table = {}
    _linear(t, "time_embed_0", "time_embed.0")
    _linear(t, "time_embed_2", "time_embed.2")
    _linear(t, "conv_in", "input_blocks.0.0")
    _linear(t, "out_norm", "out.0")
    _linear(t, "out_conv", "out.2")
    depth, attn = cfg.transformer_depth, cfg.attention_resolutions
    n, ch, ds = 1, cfg.model_channels, 1
    for level, mult in enumerate(cfg.channel_mult):
        for i in range(cfg.num_res_blocks):
            out_ch = mult * cfg.model_channels
            _resblock(t, f"down_{level}_{i}_res", f"input_blocks.{n}.0",
                      skip=ch != out_ch)
            ch = out_ch
            if ds in attn:
                _transformer(t, f"down_{level}_{i}_attn",
                             f"input_blocks.{n}.1", depth)
            n += 1
        if level != len(cfg.channel_mult) - 1:
            _linear(t, f"down_{level}_downsample.conv",
                    f"input_blocks.{n}.0.op")
            n += 1
            ds *= 2
    _resblock(t, "mid_res1", "middle_block.0", skip=False)
    _transformer(t, "mid_attn", "middle_block.1", depth)
    _resblock(t, "mid_res2", "middle_block.2", skip=False)
    n = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            # the skip concat always changes the channel count
            _resblock(t, f"up_{level}_{i}_res", f"output_blocks.{n}.0",
                      skip=True)
            layer = 1
            if ds in attn:
                _transformer(t, f"up_{level}_{i}_attn",
                             f"output_blocks.{n}.1", depth)
                layer = 2
            if level and i == cfg.num_res_blocks:
                _linear(t, f"up_{level}_upsample.conv",
                        f"output_blocks.{n}.{layer}.conv")
                ds //= 2
            n += 1
    return t


def _vae_resblock(table: Table, port: str, ref: str, skip: bool) -> None:
    for p in ("norm1", "conv1", "norm2", "conv2"):
        _linear(table, f"{port}.{p}", f"{ref}.{p}")
    if skip:
        _linear(table, f"{port}.nin_shortcut", f"{ref}.nin_shortcut")


def _vae_attn(table: Table, port: str, ref: str) -> None:
    # the reference's q/k/v/proj_out are 1x1 convs, and so are the port's
    for p in ("norm", "q", "k", "v", "proj_out"):
        _linear(table, f"{port}.{p}", f"{ref}.{p}")


def vae_table(cfg) -> Table:
    """AutoencoderKL's tensors -> the reference's Encoder/Decoder and
    quant convs (model.py:368-568, autoencoder.py:285-333)."""
    t: Table = {}
    levels = len(cfg.ch_mult)
    for part in ("encoder", "decoder"):
        for p in ("conv_in", "norm_out", "conv_out"):
            _linear(t, f"{part}.{p}", f"{part}.{p}")
    res, block_in = cfg.resolution, cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        block_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            _vae_resblock(t, f"encoder.down_{i}_block_{j}",
                          f"encoder.down.{i}.block.{j}",
                          skip=block_in != block_out)
            block_in = block_out
            if res in cfg.attn_resolutions:
                _vae_attn(t, f"encoder.down_{i}_attn_{j}",
                          f"encoder.down.{i}.attn.{j}")
        if i != levels - 1:
            _linear(t, f"encoder.down_{i}_downsample.conv",
                    f"encoder.down.{i}.downsample.conv")
            res //= 2
    for part in ("encoder", "decoder"):
        _vae_resblock(t, f"{part}.mid_block_1", f"{part}.mid.block_1", False)
        _vae_attn(t, f"{part}.mid_attn_1", f"{part}.mid.attn_1")
        _vae_resblock(t, f"{part}.mid_block_2", f"{part}.mid.block_2", False)
    block_in = cfg.ch * cfg.ch_mult[-1]
    res = cfg.resolution // 2 ** (levels - 1)
    for i in reversed(range(levels)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            _vae_resblock(t, f"decoder.up_{i}_block_{j}",
                          f"decoder.up.{i}.block.{j}",
                          skip=block_in != block_out)
            block_in = block_out
            if res in cfg.attn_resolutions:
                _vae_attn(t, f"decoder.up_{i}_attn_{j}",
                          f"decoder.up.{i}.attn.{j}")
        if i != 0:
            _linear(t, f"decoder.up_{i}_upsample.conv",
                    f"decoder.up.{i}.upsample.conv")
            res *= 2
    _linear(t, "quant_conv", "quant_conv")
    _linear(t, "post_quant_conv", "post_quant_conv")
    return t


def pose_table() -> Table:
    """LinearProject (poses.py:3-16): `extra_cond_models.{i}.model`."""
    return {"proj.weight": ("model.weight", "copy"),
            "proj.bias": ("model.bias", "copy")}


def fusion_table() -> Table:
    """CLIPTextImageCrossAtten's trainable `cross_att`
    (encoders/modules.py:274-278)."""
    t: Table = {}
    _cross_attention(t, "cross_att", "cross_att")
    return t


# ------------------------------------------------------------- conversion

def _read(table: Table, src: StateDict, target: StateDict, what: str,
          used: set) -> Dict[str, torch.Tensor]:
    if set(table) != set(target):
        raise ValueError(
            f"{what}: the key table and the module disagree: "
            f"{sorted(set(table) ^ set(target))[:8]}")
    out = {}
    for port, (ref, how) in table.items():
        if ref not in src:
            raise ValueError(f"{what}: the checkpoint has no {ref!r} "
                             f"(for {port!r})")
        v = src[ref]
        if how == "conv1x1":
            if v.dim() != 4 or v.shape[2:] != (1, 1):
                raise ValueError(f"{what}: {ref!r} has shape "
                                 f"{tuple(v.shape)}, not a 1x1 conv")
            v = v[:, :, 0, 0]
        if tuple(v.shape) != tuple(target[port].shape):
            raise ValueError(f"{what}: {ref!r} has shape {tuple(v.shape)}, "
                             f"the module's {port!r} {tuple(target[port].shape)}")
        out[port] = v.contiguous()
        used.add(ref)
    return out


def _pose_bucket(buckets, cfg) -> Optional[str]:
    for name in sorted(b for b in buckets if b.startswith("extra_cond_")):
        w = buckets[name].get("model.weight")
        if w is not None and tuple(w.shape) == (cfg.context_dim,
                                                cfg.pose_input_dim):
            return name
    return None


def convert_buckets(buckets, model, ema: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state dict of `model`, record): the split checkpoint's tensors
    under the LatentDiffusion's names (`unet.*`, `vae.*`, `pose.*`,
    `cond_fusion.*`), strictly. `ema` takes the U-Net from the LitEma
    shadow (raises where the file has none). `model` supplies the names
    and shapes only: a model on the `meta` device will do."""
    target = model.state_dict()
    unet_src = buckets.get("unet") or {}
    if ema:
        unet_src = ema_unet_state_dict(buckets)
        if unet_src is None:
            raise ValueError("--ema: the checkpoint has no model_ema shadow")
    parts: List[Tuple[str, str, Table, StateDict]] = [
        ("unet", "unet", unet_table(model.config.unet), unet_src),
        ("vae", "vae", vae_table(model.config.vae), buckets.get("vae") or {})]
    if model.pose is not None:
        pose = _pose_bucket(buckets, model.config)
        if pose is None:
            raise ValueError(
                f"the model has a pose stage; no extra_cond_models.* bucket "
                f"holds a ({model.config.context_dim}, "
                f"{model.config.pose_input_dim}) model.weight")
        parts.append(("pose", pose, pose_table(), buckets[pose]))
    if model.cond_fusion is not None:
        parts.append(("cond_fusion", "cond_stage", fusion_table(),
                      buckets.get("cond_stage") or {}))
    out: Dict[str, torch.Tensor] = {}
    read: Dict[str, set] = {}
    for name, bucket, table, src in parts:
        mine = {k[len(name) + 1:]: v for k, v in target.items()
                if k.startswith(name + ".")}
        got = _read(table, src, mine, bucket, read.setdefault(bucket, set()))
        out.update((f"{name}.{k}", v) for k, v in got.items())
    # every U-Net, VAE, pose and fusion key of the file must be read
    strict = {b: set(v) for b, v in buckets.items()
              if b in ("unet", "vae") or (b.startswith("extra_cond_")
                                          and "model.weight" in v)}
    strict["cond_stage"] = {k for k in buckets.get("cond_stage") or {}
                            if k.startswith("cross_att.")}
    for bucket, keys in strict.items():
        left = sorted(keys - read.get(bucket, set()))
        if left:
            raise ValueError(f"{bucket}: {len(left)} checkpoint key(s) left "
                             f"unread, first {left[0]!r}")
    unread = {b: sorted(set(v) - read.get(b, set()))
              for b, v in buckets.items() if b != "ema"}
    return out, {"ema": bool(ema),
                 "submodels": sorted(name for name, *_ in parts),
                 "unread": {b: v for b, v in unread.items() if v}}


def meta_model(variant: str):
    """The zoo's `variant` on the `meta` device: its names, shapes and
    config, no memory, no initialisation."""
    from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
    from upgpt_torch.zoo import _BUILDERS

    if variant not in _BUILDERS:
        raise KeyError(f"unknown variant {variant!r}; have {list(_BUILDERS)}")
    kernels = dict.fromkeys(("use_flash_attention", "use_fused_transformer",
                             "use_fused_groupnorm", "use_fused_resblock",
                             "use_fused_vae_groupnorm"), False)
    with torch.device("meta"):
        return LatentDiffusion(_BUILDERS[variant](torch.float32, kernels))


def convert_lightning(path, variant: str, ema: Optional[bool] = False):
    """(model, record): `variant`'s LatentDiffusion holding the Lightning
    checkpoint's weights, float32 on the host, built on `meta` and filled
    by assignment, so a full-width file is held once. `ema` None takes
    the LitEma shadow where the file has one."""
    buckets = split_ldm_checkpoint(path)
    if ema is None:
        ema = bool(buckets.get("ema"))
    model = meta_model(variant)
    state, record = convert_buckets(buckets, model, ema)
    model.load_state_dict(state, strict=True, assign=True)
    record.update(variant=variant, src=str(path))
    return model, record


# ----------------------------------------------------------------- writer

def to_lightning_state_dict(model, ema_unet: Optional[StateDict] = None
                            ) -> Dict[str, torch.Tensor]:
    """`model`'s weights in the reference's Lightning layout, the tables
    read backwards; `ema_unet` (the U-Net's state dict by the port's names)
    becomes the `model_ema.*` shadow. For rehearsals of the converter."""
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, table: Table, src: StateDict, part: str) -> None:
        for port, (ref, how) in table.items():
            v = src[f"{part}.{port}" if part else port]
            out[prefix + ref] = v[:, :, None, None] if how == "conv1x1" else v

    put("model.diffusion_model.", unet_table(model.config.unet), sd, "unet")
    put("first_stage_model.", vae_table(model.config.vae), sd, "vae")
    if model.pose is not None:
        put("extra_cond_models.0.", pose_table(), sd, "pose")
    if model.cond_fusion is not None:
        put("cond_stage_model.", fusion_table(), sd, "cond_fusion")
    if ema_unet is not None:
        for port, (ref, how) in unet_table(model.config.unet).items():
            v = ema_unet[port]
            out["model_ema." + ("diffusion_model." + ref).replace(".", "")] = (
                v[:, :, None, None] if how == "conv1x1" else v)
    return out
