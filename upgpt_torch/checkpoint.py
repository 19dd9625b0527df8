"""The port's inference checkpoint: one `torch.save` file.

It holds `{"unet", "pose", "vae"}`, the state dicts of a LatentDiffusion's
three submodules (the JAX params tree's three subtrees; `pose` is empty for
a variant without a pose stage). `load_checkpoint` loads each strictly and
refuses a file without VAE weights, as the JAX CLI refuses a checkpoint
without its first stage (`upgpt_tpu/cli.py:164-171`): decoding would use a
random VAE. Weights from the JAX package reach this format through
`convert.from_jax.load_jax_params` and `save_checkpoint`.
"""

from __future__ import annotations

import os
from typing import Union

import torch

from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion

PathLike = Union[str, os.PathLike]


def save_checkpoint(model: LatentDiffusion, path: PathLike) -> None:
    pose = {} if model.pose is None else model.pose.state_dict()
    torch.save({"unet": model.unet.state_dict(), "pose": pose,
                "vae": model.vae.state_dict()}, path)


def load_checkpoint(model: LatentDiffusion, path: PathLike
                    ) -> LatentDiffusion:
    """Load `path` into `model` in place (each tensor takes the module's
    dtype and device) and return it."""
    payload = torch.load(path, map_location=model.device, weights_only=True)
    if not payload.get("vae"):
        raise RuntimeError(
            f"checkpoint {path} carries no VAE (first-stage) weights: "
            f"decoding would use a random VAE")
    model.unet.load_state_dict(payload["unet"], strict=True)
    model.vae.load_state_dict(payload["vae"], strict=True)
    pose = payload.get("pose") or {}
    if model.pose is not None:
        model.pose.load_state_dict(pose, strict=True)
    elif pose:
        raise RuntimeError(f"checkpoint {path} has pose weights; the model "
                           f"has no pose stage")
    return model
