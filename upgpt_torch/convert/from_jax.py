"""JAX parameter tree -> upgpt_torch state_dict.

The inverse of the layout conventions of `upgpt_tpu/convert/torch_to_jax.py`,
applied to the JAX package's own trees. The port's modules carry the JAX
tree's names (`unet.down_0_0_res.conv_in`, `vae.decoder.mid_attn_1.q`, ...),
so a flattened JAX key maps to a port key by joining with "." instead of
"/" and renaming the leaf:

- conv `kernel` (kH, kW, I, O)        -> Conv2d `weight` (O, I, kH, kW)
- Dense `kernel` (in, out)            -> Linear `weight` (out, in)
- GroupNorm/LayerNorm `scale`/`bias`  -> `weight`/`bias`
- Embed `embedding` (V, D)            -> Embedding `weight` (V, D)
- BatchNorm `batch_stats` `mean`/`var` -> `running_mean`/`running_var`
  (the PatchGAN discriminator's; merge its `params` and `batch_stats`
  trees into one mapping: their leaves differ)
- the CLIP towers' bare parameters (`position_embedding`,
  `class_embedding`, `text_projection`, `visual_projection`) and the FID
  Inception's folded BatchNorm (`bn_scale`, `bn_bias`) keep their names
  and layout.

LPIPS's `lin_k` heads are bias-free 1x1 convs: their `kernel` maps as any
conv's, and a head with a bias would be reported as a missing key.

The CLIP towers (`models/clip.py`) and the text-style fusion
(`cond_fusion.cross_att`) carry JAX's names too, so their trees load the
same way.

The bridge is strict: a key the module lacks, a module key the tree lacks,
or a shape that disagrees raises ValueError. It takes numpy arrays and
imports no JAX; `flatten_tree` walks any nested mapping (a flax params
dict included) with plain Python.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}
_BARE = ("position_embedding", "class_embedding", "text_projection",
         "visual_projection", "bn_scale", "bn_bias")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def torch_key(jax_key: str) -> str:
    *path, leaf = jax_key.split("/")
    if leaf in _BARE:
        return ".".join(path + [leaf])
    if leaf not in _LEAF:
        raise ValueError(f"unknown parameter leaf {leaf!r} in {jax_key!r}")
    return ".".join(path + [_LEAF[leaf]])


def torch_array(jax_key: str, value: np.ndarray) -> np.ndarray:
    """Re-lay one JAX parameter in the port's layout."""
    if jax_key.endswith("/kernel"):
        if value.ndim == 4:  # HWIO -> OIHW
            return np.ascontiguousarray(value.transpose(3, 2, 0, 1))
        if value.ndim == 2:  # (in, out) -> (out, in)
            return np.ascontiguousarray(value.T)
        raise ValueError(f"{jax_key}: kernel of rank {value.ndim}")
    return value


def state_dict_from_jax(flat: Mapping[str, np.ndarray],
                        module: torch.nn.Module,
                        ignore: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Map a flattened JAX tree onto `module`'s state_dict, strictly.

    `ignore` lists JAX key prefixes dropped on purpose (a subtree the
    module does not hold). Tensors take the module's dtype and device, so
    float32 masters load as float32.
    """
    ignore = tuple(ignore)
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    extra = []
    for jk, value in flat.items():
        if ignore and jk.startswith(ignore):
            continue
        tk = torch_key(jk)
        if tk not in target:
            extra.append(jk)
            continue
        arr = torch_array(jk, np.asarray(value))
        ref = target[tk]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{jk} -> {tk}: shape {arr.shape}, module has "
                             f"{tuple(ref.shape)}")
        out[tk] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            dtype=ref.dtype, device=ref.device)
    missing = sorted(set(target) - set(out))
    if extra or missing:
        raise ValueError(f"JAX tree and module disagree: extra {extra[:8]} "
                         f"({len(extra)}), missing {missing[:8]} "
                         f"({len(missing)})")
    return out


def load_jax_params(module: torch.nn.Module, tree: Mapping,
                    ignore: Iterable[str] = ()) -> torch.nn.Module:
    """Load a JAX params tree (nested, or flattened with "/" keys) into
    `module`."""
    module.load_state_dict(
        state_dict_from_jax(flatten_tree(tree), module, ignore), strict=True)
    return module
