"""CLIP checkpoints (HF transformers, openai-clip) -> the port's towers.

Port of `upgpt_tpu.convert.clip_weights`. Two upstream layouts exist in
the reference's dependency set:
- HF `CLIPTextModel` / `CLIPVisionModel` / `CLIPModel` state dicts
  (`text_model.` and `vision_model.` prefixes, or none for a bare model);
  FrozenCLIPEmbedder (modules.py:137-162) and the laion towers;
- openai-clip `CLIP` state dicts (ViT-L/14, jit=False), whose attention
  packs `in_proj_weight` as [q; k; v] (FrozenCLIPTextEmbedder,
  FrozenClipImageEmbedder2).

Each converter returns a state dict of the port's tower
(`models/clip.py`: `CLIPTextTower` or `CLIPVisionTower`) in float32. The
port's Linear weights are (out, in) as both upstream layouts keep them;
the projections are (width, projection_dim) matrices, as openai stores
them and as HF's `*_projection.weight` transposed.

`text_tower_from_state_dict` and `vision_tower_from_state_dict` detect the
layout by its keys (HF, openai or the port's own), read the geometry from
the tensors' shapes (layers, width, patch size, positions; heads are width
// 64, as in both released towers) and build the tower.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from upgpt_torch.models.clip import (
    CLIPTextConfig, CLIPTextTower, CLIPVisionConfig, CLIPVisionTower,
)

StateDict = Mapping[str, "torch.Tensor | np.ndarray"]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray)
                           else x).detach().cpu().float().contiguous()


def _copy(sd, out, src: str, dst: str) -> None:
    out[dst] = _t(sd[src])


def _wb(sd, out, src: str, dst: str) -> None:
    """A layer's weight and bias."""
    _copy(sd, out, f"{src}.weight", f"{dst}.weight")
    _copy(sd, out, f"{src}.bias", f"{dst}.bias")


def _hf_block(sd, out, lp: str, i: int) -> None:
    b = f"block_{i}"
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        for leaf in ("weight", "bias"):
            _copy(sd, out, f"{lp}.self_attn.{proj}.{leaf}",
                  f"{b}.attn.{proj}.{leaf}")
    _wb(sd, out, f"{lp}.layer_norm1", f"{b}.ln1")
    _wb(sd, out, f"{lp}.layer_norm2", f"{b}.ln2")
    _wb(sd, out, f"{lp}.mlp.fc1", f"{b}.fc1")
    _wb(sd, out, f"{lp}.mlp.fc2", f"{b}.fc2")


def _openai_block(sd, out, lp: str, i: int) -> None:
    """An openai-clip residual block, its packed q/k/v split in order."""
    b = f"block_{i}"
    w = _t(sd[f"{lp}.attn.in_proj_weight"])
    bias = _t(sd[f"{lp}.attn.in_proj_bias"])
    for proj, wi, bi in zip(("q_proj", "k_proj", "v_proj"),
                            w.chunk(3, dim=0), bias.chunk(3, dim=0)):
        out[f"{b}.attn.{proj}.weight"] = wi.contiguous()
        out[f"{b}.attn.{proj}.bias"] = bi.contiguous()
    _wb(sd, out, f"{lp}.attn.out_proj", f"{b}.attn.out_proj")
    _wb(sd, out, f"{lp}.ln_1", f"{b}.ln1")
    _wb(sd, out, f"{lp}.ln_2", f"{b}.ln2")
    _wb(sd, out, f"{lp}.mlp.c_fc", f"{b}.fc1")
    _wb(sd, out, f"{lp}.mlp.c_proj", f"{b}.fc2")


def _count(sd, pattern: str) -> int:
    rx = re.compile(pattern)
    found = {int(m.group(1)) for k in sd for m in [rx.match(k)] if m}
    return max(found) + 1 if found else 0


def _hf_prefix(sd, name: str) -> str:
    return f"{name}." if any(k.startswith(f"{name}.") for k in sd) else ""


def convert_hf_clip_text(sd: StateDict, num_layers: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """HF CLIPTextModel (or CLIPModel's `text_model.`) -> CLIPTextTower."""
    p = _hf_prefix(sd, "text_model")
    if num_layers is None:
        num_layers = _count(sd, re.escape(p) + r"encoder\.layers\.(\d+)\.")
    out: Dict[str, torch.Tensor] = {}
    _copy(sd, out, f"{p}embeddings.token_embedding.weight",
          "token_embedding.weight")
    _copy(sd, out, f"{p}embeddings.position_embedding.weight",
          "position_embedding")
    _wb(sd, out, f"{p}final_layer_norm", "ln_final")
    for i in range(num_layers):
        _hf_block(sd, out, f"{p}encoder.layers.{i}", i)
    if "text_projection.weight" in sd:
        out["text_projection"] = _t(
            sd["text_projection.weight"]).T.contiguous()
    else:
        # a bare CLIPTextModel has no projection: identity keeps pooled usable
        out["text_projection"] = torch.eye(out["position_embedding"].shape[1])
    return out


def convert_openai_clip_text(sd: StateDict, num_layers: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """openai-clip CLIP state dict (its text side) -> CLIPTextTower."""
    if num_layers is None:
        num_layers = _count(sd, r"transformer\.resblocks\.(\d+)\.")
    out: Dict[str, torch.Tensor] = {}
    _copy(sd, out, "token_embedding.weight", "token_embedding.weight")
    _copy(sd, out, "positional_embedding", "position_embedding")
    _wb(sd, out, "ln_final", "ln_final")
    _copy(sd, out, "text_projection", "text_projection")
    for i in range(num_layers):
        _openai_block(sd, out, f"transformer.resblocks.{i}", i)
    return out


def convert_openai_clip_vision(sd: StateDict, num_layers: Optional[int] = None
                               ) -> Dict[str, torch.Tensor]:
    """openai-clip CLIP state dict (its `visual.` side) -> CLIPVisionTower."""
    if num_layers is None:
        num_layers = _count(sd, r"visual\.transformer\.resblocks\.(\d+)\.")
    out: Dict[str, torch.Tensor] = {}
    _copy(sd, out, "visual.conv1.weight", "patch_embedding.weight")
    _copy(sd, out, "visual.class_embedding", "class_embedding")
    _copy(sd, out, "visual.positional_embedding", "position_embedding")
    _wb(sd, out, "visual.ln_pre", "ln_pre")
    _wb(sd, out, "visual.ln_post", "ln_post")
    _copy(sd, out, "visual.proj", "visual_projection")
    for i in range(num_layers):
        _openai_block(sd, out, f"visual.transformer.resblocks.{i}", i)
    return out


def convert_hf_clip_vision(sd: StateDict, num_layers: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """HF CLIPVisionModel (or CLIPModel's `vision_model.`) ->
    CLIPVisionTower."""
    p = _hf_prefix(sd, "vision_model")
    if num_layers is None:
        num_layers = _count(sd, re.escape(p) + r"encoder\.layers\.(\d+)\.")
    out: Dict[str, torch.Tensor] = {}
    _copy(sd, out, f"{p}embeddings.patch_embedding.weight",
          "patch_embedding.weight")
    _copy(sd, out, f"{p}embeddings.class_embedding", "class_embedding")
    _copy(sd, out, f"{p}embeddings.position_embedding.weight",
          "position_embedding")
    _wb(sd, out, f"{p}pre_layrnorm", "ln_pre")  # sic: HF's misspelled key
    _wb(sd, out, f"{p}post_layernorm", "ln_post")
    for i in range(num_layers):
        _hf_block(sd, out, f"{p}encoder.layers.{i}", i)
    if "visual_projection.weight" in sd:
        out["visual_projection"] = _t(
            sd["visual_projection.weight"]).T.contiguous()
    else:
        width = out["class_embedding"].shape[0]
        out["visual_projection"] = torch.eye(width)[:, :768].contiguous()
    return out


def text_layout(sd: StateDict) -> str:
    """'port', 'openai' or 'hf': the layout of a text tower's state dict."""
    if "block_0.attn.q_proj.weight" in sd and "text_projection" in sd:
        return "port"
    if "positional_embedding" in sd:
        return "openai"
    if any(k.endswith("embeddings.token_embedding.weight") for k in sd):
        return "hf"
    raise ValueError("not a CLIP text state dict (HF, openai or the "
                     "port's layout)")


def vision_layout(sd: StateDict) -> str:
    """'port', 'openai' or 'hf': the layout of a vision tower's state
    dict."""
    if "patch_embedding.weight" in sd and "class_embedding" in sd:
        return "port"
    if "visual.conv1.weight" in sd:
        return "openai"
    if any(k.endswith("embeddings.patch_embedding.weight") for k in sd):
        return "hf"
    raise ValueError("not a CLIP vision state dict (HF, openai or the "
                     "port's layout)")


def heads_for_width(width: int) -> int:
    """Attention heads of a CLIP tower of this width: one per 64 channels,
    as in both released ViT-L/14 towers (text 768 -> 12, vision 1024 ->
    16)."""
    if width % 64:
        raise ValueError(f"CLIP width {width} is not a multiple of 64")
    return width // 64


def text_config_from_state_dict(sd: Mapping[str, torch.Tensor],
                                quick_gelu: bool) -> CLIPTextConfig:
    """The geometry of a port-layout text tower, from its shapes."""
    vocab, width = sd["token_embedding.weight"].shape
    return CLIPTextConfig(
        vocab_size=vocab, hidden_size=width,
        num_layers=_count(sd, r"block_(\d+)\.attn\.q_proj\.weight"),
        num_heads=heads_for_width(width),
        mlp_ratio=sd["block_0.fc1.weight"].shape[0] // width,
        max_positions=sd["position_embedding"].shape[0],
        quick_gelu=quick_gelu,
        projection_dim=sd["text_projection"].shape[1])


def vision_config_from_state_dict(sd: Mapping[str, torch.Tensor],
                                  quick_gelu: bool) -> CLIPVisionConfig:
    """The geometry of a port-layout vision tower, from its shapes."""
    width = sd["class_embedding"].shape[0]
    patch = sd["patch_embedding.weight"].shape[-1]
    side = math.isqrt(sd["position_embedding"].shape[0] - 1)
    return CLIPVisionConfig(
        image_size=side * patch, patch_size=patch, hidden_size=width,
        num_layers=_count(sd, r"block_(\d+)\.attn\.q_proj\.weight"),
        num_heads=heads_for_width(width),
        mlp_ratio=sd["block_0.fc1.weight"].shape[0] // width,
        quick_gelu=quick_gelu,
        projection_dim=sd["visual_projection"].shape[1])


_TEXT = {"hf": convert_hf_clip_text, "openai": convert_openai_clip_text}
_VISION = {"hf": convert_hf_clip_vision, "openai": convert_openai_clip_vision}


def text_tower_from_state_dict(sd: StateDict, quick_gelu: bool,
                               device="cpu") -> CLIPTextTower:
    """A frozen CLIPTextTower from a state dict in any of the three
    layouts, its geometry read from the shapes."""
    layout = text_layout(sd)
    port = ({k: _t(v) for k, v in sd.items()} if layout == "port"
            else _TEXT[layout](sd))
    with torch.device("meta"):  # no init: every tensor comes from `port`
        tower = CLIPTextTower(text_config_from_state_dict(port, quick_gelu))
    tower.load_state_dict(port, strict=True, assign=True)
    return tower.to(device).eval().requires_grad_(False)


def vision_tower_from_state_dict(sd: StateDict, quick_gelu: bool,
                                 device="cpu") -> CLIPVisionTower:
    """A frozen CLIPVisionTower from a state dict in any of the three
    layouts (a `vision.` prefix, StyleImageEncoder's, is taken off), its
    geometry read from the shapes."""
    if any(k.startswith("vision.") for k in sd):
        sd = {k[len("vision."):]: v for k, v in sd.items()
              if k.startswith("vision.")}
    layout = vision_layout(sd)
    port = ({k: _t(v) for k, v in sd.items()} if layout == "port"
            else _VISION[layout](sd))
    with torch.device("meta"):  # no init: every tensor comes from `port`
        tower = CLIPVisionTower(
            vision_config_from_state_dict(port, quick_gelu))
    tower.load_state_dict(port, strict=True, assign=True)
    return tower.to(device).eval().requires_grad_(False)
