"""The four product walkthroughs of `examples/` on the port:

    python -m upgpt_torch.examples.pose_transfer \\
        --base configs/deepfashion/interp_256.yaml --ckpt weights/interp_256 \\
        --folder /data/deepfashion_inshop --data-file map.csv \\
        --src MEN/...jpg --pose-of WOMEN/...jpg --out sample.jpg
    python -m upgpt_torch.examples.pose_interpolation ... \\
        --src MEN/...jpg --pose-a MEN/...jpg --pose-b WOMEN/...jpg
    python -m upgpt_torch.examples.style_mixing ... --src MEN/...jpg \\
        --style-texts '{"top": "red shirt"}' --drop-slots outer
    python -m upgpt_torch.examples.upscale_chain \\
        --base-256 configs/deepfashion/interp_256.yaml \\
        --base-512 configs/deepfashion/upscale.yaml \\
        --ckpt-256 weights/interp_256 --ckpt-512 weights/upscale ...

Each takes the JAX example's flags and defaults, and `--device` (the
card by default). A checkpoint is the port's `.pt` or a directory the JAX
package's orbax checkpointer wrote (`checkpoint.read_weights`; a trainer
checkpoint's EMA first), loaded as `cli sample` loads it: bf16 on the
card. Each example builds its batch in `conditioning(args, enc, device)`
and samples it with the port's pipeline and a `torch.Generator` seeded as
the JAX example seeds its key: `--seed` where it has the flag, else 0, and
1 for the upscale stage. PIL is imported where a JPEG is written, as the
JAX examples import it.
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the card)")


def load(base: Sequence[str], ckpt: str, device: str):
    """(config, model): the merged `base` configs' model on `device` with
    the weights of `ckpt`."""
    from upgpt_torch import cli
    from upgpt_torch.config import merge_configs

    cfg = merge_configs(base)
    model, grid = cli._load_model(cfg["model"], ckpt, device=device)
    if grid is not None:
        raise SystemExit(f"{ckpt}: a distilled student, valid on its own "
                         f"grid only; sample it with `cli sample`")
    return cfg, model


def pairs(args, rows: Sequence[Tuple[str, str]]) -> list:
    """The samples of the (from, to) image ids `rows` of the DeepFashion
    tree the flags name, bbox person masks."""
    from upgpt_torch.data.deepfashion import DeepFashionPair

    ds = DeepFashionPair(
        folder=args.folder, image_dir=args.image_dir, pair_file=[],
        data_file=args.data_file, input_mask_type="bbox",
        image_size=tuple(args.image_size), f=args.downsample)
    ds.rows = [{"from": a, "to": b} for a, b in rows]
    return [ds[i] for i in range(len(rows))]


def as_tensor(x, device) -> torch.Tensor:
    """A host array or a tensor anywhere as a float32 tensor on
    `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


def generation_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The keys of an encoded batch that the pipeline reads, on
    `device`."""
    from upgpt_torch.training.trainer import Trainer, to_device

    return to_device(batch, Trainer._GENERATE, device)


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """A [-1, 1] HWC image as the uint8 pixels the examples write."""
    arr = img.float().cpu().numpy()
    return (np.clip((arr + 1) / 2, 0, 1) * 255).astype(np.uint8)


def save_jpeg(img: torch.Tensor, path) -> None:
    from PIL import Image

    Image.fromarray(to_uint8(img)).save(path)
