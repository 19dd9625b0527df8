"""Example: per-slot text<->image style mixing (inference-mix.ipynb / app
mix flow; reference generate_utils.py:172-190), on the port
(`examples/style_mixing.py`).

Takes a source image's 9-slot style stack, overrides chosen slots with
pooled CLIP text embeddings (e.g. top='red shirt'), optionally empties
others, then samples. Slot names: face hair headwear background top outer
bottom shoes accesories.

    python -m upgpt_torch.examples.style_mixing \\
        --base configs/deepfashion/interp_256.yaml \\
        --ckpt weights/interp_256 --folder /data/deepfashion_inshop \\
        --data-file map.csv --src MEN/...jpg \\
        --style-texts '{"top": "red shirt"}' --drop-slots outer
"""

import argparse
import json

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
    p.add_argument("--style-texts", default="{}",
                   help='JSON: {"top": "red shirt", ...}')
    p.add_argument("--drop-slots", nargs="*", default=[])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default="mixed.jpg")
    p.add_argument("--debug-encoder", action="store_true",
                   help="hash-embedding conditioning (no CLIP weights)")
    examples.add_device(p)
    return p


def conditioning(args, enc, device):
    """--src posed as itself on `device`, its style slots mixed
    (`mix_style`): the slots --style-texts names take their texts' pooled
    embeddings, the --drop-slots the empty style's embedding (the
    encoder's of the CLIP-normalised zeros image)."""
    from upgpt_torch.data.deepfashion import collate
    from upgpt_torch.data.transforms import CLIP_MEAN, CLIP_STD
    from upgpt_torch.inference.pipeline import STYLE_NAMES, mix_style

    (sample,) = examples.pairs(args, [(args.src, args.src)])
    batch = examples.generation_batch(enc.encode_batch(collate([sample])),
                                      device)
    overrides = json.loads(args.style_texts)
    texts = [overrides.get(n, "") for n in STYLE_NAMES]
    pooled = examples.as_tensor(enc.text_pooled(texts), device)[None]
    flags = [bool(overrides.get(n)) for n in STYLE_NAMES]
    drop = [STYLE_NAMES.index(n) for n in args.drop_slots]
    empty_img = np.broadcast_to(
        (-CLIP_MEAN / CLIP_STD), (1, 1, 224, 224, 3)).astype(np.float32)
    empty_emb = examples.as_tensor(enc.style_embeddings(empty_img),
                                   device)[0, 0]
    batch["style_emb"] = mix_style(batch["style_emb"], pooled, flags,
                                   drop_slots=drop,
                                   empty_style_emb=empty_emb)
    return batch


def main(argv=None):
    """Write the sample; returns it (HWC, [-1, 1])."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    args = parser().parse_args(argv)
    cfg, model = examples.load(args.base, args.ckpt, args.device)
    enc = cli._build_cond_encoder(cfg, model,
                                  allow_debug=args.debug_encoder)
    batch = conditioning(args, enc, model.device)
    pipe = GenerationPipeline(model, num_steps=args.steps, eta=1.0)
    gen = torch.Generator(device=model.device).manual_seed(0)
    img = pipe.generate(batch, gen)[0]
    examples.save_jpeg(img, args.out)
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
