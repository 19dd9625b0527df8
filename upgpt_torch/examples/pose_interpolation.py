"""Example: N-frame SMPL pose+camera interpolation sweep
(the inference-interpolation.ipynb / app Interpolate flow, app.py:280-308),
on the port (`examples/pose_interpolation.py`).

One batched DDIM run: styles/text are shared across frames, SMPL vectors
and person-mask bbox corners are lerped per frame, and every frame starts
from the same noise (`shared_x_T`).

    python -m upgpt_torch.examples.pose_interpolation \\
        --base configs/deepfashion/interp_256.yaml \\
        --ckpt weights/interp_256 --folder /data/deepfashion_inshop \\
        --data-file map.csv --src MEN/...jpg --pose-a MEN/...jpg \\
        --pose-b WOMEN/...jpg --frames 16 --out interp
"""

import argparse

import numpy as np
import torch

from upgpt_torch import cli, examples


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--base", nargs="*",
                   default=["configs/deepfashion/interp_256.yaml"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--folder", required=True)
    p.add_argument("--data-file", required=True)
    p.add_argument("--image-dir", default="img_256")
    p.add_argument("--image-size", type=int, nargs=2, default=[256, 192])
    p.add_argument("--f", type=int, default=8, dest="downsample",
                   help="latent downsample factor of the first stage")
    p.add_argument("--src", required=True)
    p.add_argument("--pose-a", required=True)
    p.add_argument("--pose-b", required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default="interp")
    p.add_argument("--debug-encoder", action="store_true",
                   help="hash-embedding conditioning (no CLIP weights)")
    examples.add_device(p)
    return p


def conditioning(args, enc, device):
    """--frames rows on `device`: --src's text and styles in every row,
    the SMPL vectors of --pose-a and --pose-b lerped over linspace(1, 0,
    F) and their person masks' boxes with them (`interpolate_smpl`,
    `interpolate_masks`)."""
    from upgpt_torch.data.deepfashion import collate
    from upgpt_torch.inference.pipeline import (
        interpolate_masks, interpolate_smpl,
    )

    sa, sb = examples.pairs(args, [(args.src, args.pose_a),
                                   (args.src, args.pose_b)])
    base = enc.encode_batch(collate([sa]))
    n = args.frames
    alphas = np.linspace(1.0, 0.0, n).astype(np.float32)
    smpl = interpolate_smpl(torch.as_tensor(sa["smpl"]),
                            torch.as_tensor(sb["smpl"]),
                            torch.as_tensor(alphas))
    masks = interpolate_masks(sa["person_mask"], sb["person_mask"], alphas)

    def rows(x):
        t = examples.as_tensor(x, device)
        return t.repeat(n, *([1] * (t.dim() - 1)))

    return {"text_emb": rows(base["text_emb"]),
            "style_emb": rows(base["style_emb"]),
            "smpl": examples.as_tensor(smpl.reshape(n, 1, -1), device),
            "person_mask": examples.as_tensor(masks, device)}


def main(argv=None):
    """Write the frames `{out}_{i:03d}.jpg`; returns them (FHWC, [-1,
    1])."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    args = parser().parse_args(argv)
    cfg, model = examples.load(args.base, args.ckpt, args.device)
    enc = cli._build_cond_encoder(cfg, model,
                                  allow_debug=args.debug_encoder)
    batch = conditioning(args, enc, model.device)
    pipe = GenerationPipeline(model, num_steps=args.steps, eta=1.0)
    gen = torch.Generator(device=model.device).manual_seed(0)
    imgs = pipe.generate(batch, gen, shared_x_T=True)
    for i, img in enumerate(imgs):
        examples.save_jpeg(img, f"{args.out}_{i:03d}.jpg")
    print(f"wrote {args.frames} frames to {args.out}_*.jpg")
    return imgs


if __name__ == "__main__":
    main()
