"""The port's checkpoints: one `torch.save` file each, in two layouts.

- The serving layout, `{"unet", "pose", "vae"}` and `cond_fusion` where
  the model has the text-style fusion: the state dicts of a
  LatentDiffusion's submodules (the JAX params tree's subtrees; `pose` is
  empty for a variant without a pose stage). Weights
  from the JAX package reach it through `convert.from_jax.load_jax_params`
  and `save_checkpoint`.
- The trainer's layout (`training.trainer.Trainer.save_checkpoint`):
  `step`, `names`, `params` (the trainable parameters by name, `unet.*`,
  `pose.*` and `cond_fusion.*`), `opt_state`, `ema` and `ema_updates`
  where the run keeps an EMA, and `frozen` = {"vae": the VAE's state
  dict}. The weights-only `trainstep_*` snapshots leave `opt_state` out.

`load_checkpoint` reads both, and the JAX package's orbax directories in
its two layouts (`convert.orbax`): `cli convert`'s and `cli distill`'s
trees (`unet`, `pose`, `vae`, `cond_fusion` at the top) and the trainer's
payload (`params`, `ema`, `frozen.vae`, ...), mapped onto the port's names
by `convert.from_jax`. From a trainer checkpoint it takes the EMA shadow
where there is one (ema_scope, reference ddpm.py:179-192, as the JAX CLI
prefers it, `upgpt_tpu/cli.py:146-177`). It refuses a checkpoint without
VAE weights, as the JAX CLI does (`upgpt_tpu/cli.py:164-171`): decoding
would use a random VAE.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import torch

from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion

PathLike = Union[str, os.PathLike]


def save_checkpoint(model: LatentDiffusion, path: PathLike) -> None:
    pose = {} if model.pose is None else model.pose.state_dict()
    payload = {"unet": model.unet.state_dict(), "pose": pose,
               "vae": model.vae.state_dict()}
    if model.cond_fusion is not None:
        payload["cond_fusion"] = model.cond_fusion.state_dict()
    torch.save(payload, path)


_SUBMODELS = ("unet", "pose", "cond_fusion")


def _read_orbax(path: PathLike) -> Tuple[dict, dict]:
    """(trainable, vae) of an orbax directory the JAX package wrote, as
    its `_restore_params` reads it: only the subtrees it uses are read
    (a trainer's optimizer state stays on disk)."""
    from upgpt_torch.convert.from_jax import jax_state_dict
    from upgpt_torch.convert.orbax import OrbaxCheckpoint

    ckpt = OrbaxCheckpoint(path)
    top = {keys[0][0] for keys, _ in ckpt.leaves}
    if "unet" in top:
        tree = ckpt.restore(_SUBMODELS + ("vae",))
        params = {k: tree[k] for k in _SUBMODELS if tree.get(k)}
        vae = tree.get("vae")
    else:
        tree = ckpt.restore(("ema", "frozen"))
        params = tree.get("ema") or ckpt.restore(("params",))["params"]
        vae = (tree.get("frozen") or {}).get("vae")
    return jax_state_dict(params), vae and jax_state_dict(vae)


def _read_torch(path: PathLike, map_location) -> Tuple[dict, dict]:
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if "unet" in payload:
        trainable = {f"unet.{k}": v for k, v in payload["unet"].items()}
        for sub in ("pose", "cond_fusion"):
            trainable.update((f"{sub}.{k}", v)
                             for k, v in (payload.get(sub) or {}).items())
        return trainable, payload.get("vae")
    return (dict(payload.get("ema") or payload["params"]),
            (payload.get("frozen") or {}).get("vae"))


def read_weights(path: PathLike, map_location=None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(trainable, vae) of a checkpoint in either layout, a `torch.save`
    file or a JAX orbax directory: the U-Net, pose and fusion weights by
    their names in the model (`unet.*`, `pose.*`, `cond_fusion.*`), EMA
    first, and the VAE's state dict. Raises where it has no VAE."""
    from upgpt_torch.convert.orbax import is_orbax_dir

    trainable, vae = (_read_orbax(path) if is_orbax_dir(path)
                      else _read_torch(path, map_location))
    if not vae:
        raise RuntimeError(
            f"checkpoint {path} carries no VAE (first-stage) weights: "
            f"decoding would use a random VAE")
    return trainable, vae


def load_checkpoint(model: LatentDiffusion, path: PathLike
                    ) -> LatentDiffusion:
    """Load `path` (any layout above) into `model` in place, strictly (each
    tensor takes the module's dtype and device), and return it."""
    trainable, vae = read_weights(path, model.device)
    if model.pose is None and any(k.startswith("pose.") for k in trainable):
        raise RuntimeError(f"checkpoint {path} has pose weights; the model "
                           f"has no pose stage")
    state = dict(trainable)
    state.update((f"vae.{k}", v) for k, v in vae.items())
    model.load_state_dict(state, strict=True)
    return model
