"""Example: single 256px pose transfer (the inference.ipynb flow), on the
port (`examples/pose_transfer.py`).

Loads a model + checkpoint, takes a source image's style stack and a target
SMPL pose, runs DDIM and writes the sample. With converted reference
weights this reproduces the released model's behavior; without weights it
runs the plumbing with the debug encoder.

    python -m upgpt_torch.examples.pose_transfer \\
        --base configs/deepfashion/interp_256.yaml \\
        --ckpt weights/interp_256 --folder /data/deepfashion_inshop \\
        --data-file map.csv --src MEN/...jpg --pose-of WOMEN/...jpg \\
        --out sample.jpg
"""

import argparse

import torch

from upgpt_torch import cli, examples


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--base", nargs="*",
                   default=["configs/deepfashion/interp_256.yaml"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--folder", required=True)
    p.add_argument("--image-dir", default="img_256")
    p.add_argument("--image-size", type=int, nargs=2, default=[256, 192])
    p.add_argument("--f", type=int, default=8, dest="downsample",
                   help="latent downsample factor of the first stage")
    p.add_argument("--data-file", required=True)
    p.add_argument("--src", required=True,
                   help="source image id (style donor)")
    p.add_argument("--pose-of", required=True,
                   help="image id whose pose to take")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default="sample.jpg")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug-encoder", action="store_true",
                   help="hash-embedding conditioning (no CLIP weights)")
    examples.add_device(p)
    return p


def conditioning(args, enc, device):
    """The encoded pair (--src's styles and text, --pose-of's pose and
    person mask) on `device`: the batch of one the example samples."""
    from upgpt_torch.data.deepfashion import collate

    (sample,) = examples.pairs(args, [(args.src, args.pose_of)])
    return examples.generation_batch(enc.encode_batch(collate([sample])),
                                     device)


def main(argv=None):
    """Write the sample; returns it (HWC, [-1, 1])."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    args = parser().parse_args(argv)
    cfg, model = examples.load(args.base, args.ckpt, args.device)
    enc = cli._build_cond_encoder(cfg, model,
                                  allow_debug=args.debug_encoder)
    batch = conditioning(args, enc, model.device)
    pipe = GenerationPipeline(model, num_steps=args.steps, eta=1.0)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    img = pipe.generate(batch, gen)[0]
    examples.save_jpeg(img, args.out)
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
