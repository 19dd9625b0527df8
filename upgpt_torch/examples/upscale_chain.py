"""Example: two-stage 256 -> 512 generation (app.py:379-409 Upscale flow),
on the port (`examples/upscale_chain.py`).

Chains the interp_256 sampler output through edge-pad + bilinear resize
into the kl-f4 upscale stage's lr-concat conditioning, producing 512x384
images.

    python -m upgpt_torch.examples.upscale_chain \\
        --base-256 configs/deepfashion/interp_256.yaml \\
        --base-512 configs/deepfashion/upscale.yaml \\
        --ckpt-256 weights/interp_256 --ckpt-512 weights/upscale \\
        --folder /data/deepfashion_inshop --data-file map.csv \\
        --src MEN/...jpg --pose-of WOMEN/...jpg --out upscaled.jpg
"""

import argparse

import torch

from upgpt_torch import cli, examples
from upgpt_torch.examples import pose_transfer


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--base-256", nargs="*",
                   default=["configs/deepfashion/interp_256.yaml"])
    p.add_argument("--base-512", nargs="*",
                   default=["configs/deepfashion/upscale.yaml"])
    p.add_argument("--ckpt-256", required=True)
    p.add_argument("--ckpt-512", required=True)
    p.add_argument("--folder", required=True)
    p.add_argument("--data-file", required=True)
    p.add_argument("--image-dir", default="img_256")
    p.add_argument("--image-size", type=int, nargs=2, default=[256, 192])
    p.add_argument("--f", type=int, default=8, dest="downsample",
                   help="latent downsample factor of the 256 stage")
    p.add_argument("--src", required=True)
    p.add_argument("--pose-of", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default="upscaled.jpg")
    p.add_argument("--debug-encoder", action="store_true",
                   help="hash-embedding conditioning (no CLIP weights)")
    examples.add_device(p)
    return p


def conditioning(args, enc, device):
    """The 256 stage's batch: the encoded pair, as `pose_transfer` builds
    it; the upscale stage reuses its text and styles."""
    return pose_transfer.conditioning(args, enc, device)


def main(argv=None):
    """The 256 stage from generator seed 0, then `UpscalePipeline.upscale`
    from seed 1; writes the 512x384 image and returns it (HWC, [-1,
    1])."""
    from upgpt_torch.inference.pipeline import (
        GenerationPipeline, UpscalePipeline,
    )

    args = parser().parse_args(argv)
    cfg256, m256 = examples.load(args.base_256, args.ckpt_256, args.device)
    _, m512 = examples.load(args.base_512, args.ckpt_512, args.device)
    enc = cli._build_cond_encoder(cfg256, m256,
                                  allow_debug=args.debug_encoder)
    batch = conditioning(args, enc, m256.device)
    stage1 = GenerationPipeline(m256, num_steps=args.steps, eta=1.0)
    img256 = stage1.generate(
        batch, torch.Generator(device=m256.device).manual_seed(0))
    stage2 = UpscalePipeline(m512, num_steps=args.steps, eta=1.0)
    img512 = stage2.upscale(
        img256, batch["text_emb"], batch.get("style_emb"),
        torch.Generator(device=m512.device).manual_seed(1))[0]
    examples.save_jpeg(img512, args.out)
    print(f"wrote {args.out} ({img512.shape[0]}x{img512.shape[1]})")
    return img512


if __name__ == "__main__":
    main()
