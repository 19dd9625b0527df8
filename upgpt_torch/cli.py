"""The port's command line: `train`, `sample`, `serve` and `data-verify`.

Port of `upgpt_tpu.cli`'s subcommands of the same names. YAML configs merge
left to right with key=value dotlist overrides, and models and datasets
build through the `target:`/`params:` registry (`upgpt_torch.config`), so
the JAX package's `configs/deepfashion/*.yaml` drive the port unchanged:

    python -m upgpt_torch.cli data-verify \\
        --base configs/deepfashion/interp_256.yaml
    python -m upgpt_torch.cli train \\
        --base configs/deepfashion/interp_256.yaml --debug-encoder \\
        data.train.params.folder=/data/deepfashion_inshop
    python -m upgpt_torch.cli sample \\
        --base configs/deepfashion/interp_256.yaml --debug-encoder \\
        --ckpt logs/interp_256/checkpoints/last --steps 50
    python -m upgpt_torch.cli serve --config configs/deepfashion/mm_512.yaml \\
        --ckpt weights/mm_512.pt --debug-encoder --batch 8 \\
        --sampler unipc --schedule karras --steps 8 sampling.eta=0.0

`train` builds float32 master weights under the config's compute dtype
(flax's `param_dtype`), from `trainer.seed`, and ships batches to the card
in the compact transport by default. `sample` and `serve` take either
checkpoint layout of `upgpt_torch.checkpoint` (a trainer checkpoint's EMA
first) and cast the weights to bf16 on the card. `clip.*` in the config
names the CLIP towers' weights (torch state dicts) and the BPE merges; the
debug encoder (`--debug-encoder`) stands in without them. The JAX CLI's
`test`, `eval`, `convert`, `train-vae`, `distill` and `bringup`,
`--multihost`, `--dp`, `--tp` and the distilled-student sidecar are not
ported yet; each option names the ROADMAP item it waits on.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from upgpt_torch.config import instantiate_from_config, merge_configs
from upgpt_torch.utils.diagnostics import cast_floating


def _build_cond_encoder(cfg, model, allow_debug=False):
    """The CLIP encoder where the config names its weights
    (`clip.text_params`, `clip.vision_params`: `torch.save`d state dicts in
    HF, openai or the port's layout) and the BPE merges (`clip.bpe_path`),
    on the model's device; else the debug encoder where `allow_debug`.

    The towers' activation follows the variant: exact GELU for a model
    with the text-style fusion (inshop_laion_clip.yaml:52's laion towers),
    QuickGELU (openai's) otherwise. JAX builds both with QuickGELU for
    every variant (`upgpt_tpu/cli.py:38-42`), the reference fault R6."""
    clip_cfg = cfg.get("clip") or {}
    if clip_cfg.get("text_params") and clip_cfg.get("bpe_path"):
        from upgpt_torch.inference.encoders import CLIPConditioningEncoder

        if not clip_cfg.get("vision_params"):
            raise SystemExit("clip.vision_params: the style tower's weights "
                             "are required beside clip.text_params")
        return CLIPConditioningEncoder.from_files(
            clip_cfg["text_params"], clip_cfg["vision_params"],
            clip_cfg["bpe_path"], quick_gelu=model.cond_fusion is None,
            device=model.device)
    if not allow_debug:
        raise SystemExit(
            "no CLIP weights configured (clip.text_params / clip.bpe_path). "
            "Sampling with hash embeddings produces garbage; pass "
            "--debug-encoder to proceed deliberately.")
    print("WARNING: --debug-encoder -> DebugConditioningEncoder "
          "(hash embeddings; NOT output parity)", file=sys.stderr)
    from upgpt_torch.inference.encoders import DebugConditioningEncoder

    return DebugConditioningEncoder(context_dim=model.config.context_dim)


def _refuse_unported(args) -> None:
    if getattr(args, "multihost", False):
        raise SystemExit("--multihost: multi-host training waits on "
                         "torch.distributed (ROADMAP §1 item 10)")
    if (getattr(args, "dp", 1) or 1) > 1:
        raise SystemExit("--dp > 1: data-parallel serving waits on "
                         "torch.distributed (ROADMAP §1 item 10)")
    if (getattr(args, "tp", 1) or 1) > 1:
        raise SystemExit("--tp > 1: tensor-parallel serving waits on "
                         "torch.distributed (ROADMAP §1 item 10)")
    for ckpt in (getattr(args, "ckpt", None),
                 getattr(args, "upscale_ckpt", None)):
        if ckpt and Path(str(Path(ckpt).absolute()) + ".distill.json"
                         ).exists():
            raise SystemExit(f"{ckpt}: a distilled-student sidecar; "
                             f"distillation is not ported (ROADMAP §1 "
                             f"item 8)")


def _loaders(cfg, batch_size, compact=False, train_transform=None):
    """The config's data splits as loaders: `train` shuffled through the
    prefetching thread loader (`data.loader: process` selects worker
    processes), the others in order. One process: multi-process slicing
    waits on DDP (ROADMAP §1 item 10)."""
    from upgpt_torch.data.deepfashion import (
        DataLoader, PrefetchDataLoader, ProcessDataLoader,
    )

    data_cfg = cfg.get("data") or {}
    out = {}
    for split in ("train", "validation", "test"):
        if split not in data_cfg:
            continue
        split_cfg = data_cfg[split]
        if split == "train" and compact:
            # uint8 transport end to end (worker IPC and the copy to the
            # card); exact for uint8-sourced pixels
            split_cfg = dict(split_cfg)
            split_cfg["params"] = {**(split_cfg.get("params") or {}),
                                   "compact": True}
        ds = instantiate_from_config(split_cfg)
        if split == "train":
            cls = (ProcessDataLoader if data_cfg.get("loader") == "process"
                   else PrefetchDataLoader)
            out[split] = cls(ds, batch_size, shuffle=True,
                             num_workers=int(data_cfg.get("num_workers", 0)),
                             batch_transform=train_transform)
        else:
            out[split] = DataLoader(ds, batch_size, shuffle=False)
    return out


def _restore_params(ckpt):
    """(params, frozen) of a checkpoint in either layout, for `fit`: the
    trainable weights by name (a trainer checkpoint's EMA first) and
    {"vae": its VAE}; raises where the file has no VAE."""
    from upgpt_torch.checkpoint import read_weights

    trainable, vae = read_weights(ckpt, "cpu")
    return trainable, {"vae": vae}


def cmd_train(cfg, args):
    """Train the config's model on its data (JAX `cmd_train`)."""
    from upgpt_torch.training.trainer import Trainer, TrainerConfig

    _refuse_unported(args)
    tcfg = dict(cfg.get("trainer") or {})
    model_cfg = dict(cfg["model"])
    # float32 masters under the config's compute dtype, as flax trains
    # (param_dtype); the serving cast to bf16 is not for training
    model_cfg["params"] = {"param_dtype": "float32",
                           **(model_cfg.get("params") or {})}
    # the weights from the run's seed, as JAX inits from PRNGKey(seed)
    torch.manual_seed(TrainerConfig(**tcfg).seed)
    model = instantiate_from_config(model_cfg)
    # compact (uint8) transport by default on the card, as JAX's on
    # accelerators; the config can override
    tcfg.setdefault("compact_transport", model.device.type == "cuda")
    tc = TrainerConfig(**tcfg)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    trainer = Trainer(model, tc, enc)
    (Path(tc.logdir) / "configs").mkdir(parents=True, exist_ok=True)
    with open(Path(tc.logdir) / "configs" / "merged.json", "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    # the train loader runs the conditioning encode and the transport pack
    # in its producer (batch_transform), overlapping the step
    loaders = _loaders(cfg, tc.batch_size, compact=tc.compact_transport,
                       train_transform=trainer.host_encode)
    params = frozen = None
    if getattr(args, "finetune_from", None):
        # weights only, a fresh optimizer (main.py:597-609)
        params, frozen = _restore_params(args.finetune_from)
    try:
        return trainer.fit(loaders["train"], loaders.get("validation"),
                           params=params, frozen_params=frozen,
                           resume=args.resume)
    finally:
        close = getattr(loaders["train"], "close", None)
        if close is not None:
            close()


def cmd_sample(cfg, args):
    """Sample one batch of the config's test split (else validation, else
    train) from a checkpoint and write JPEGs (JAX `cmd_sample`)."""
    from PIL import Image

    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.training.trainer import Trainer, to_device

    _refuse_unported(args)
    model = _load_model(cfg["model"], args.ckpt)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    samp = cfg.get("sampling") or {}
    pipe = GenerationPipeline(
        model, num_steps=args.steps or samp.get("ddim_steps", 200),
        eta=samp.get("eta", 1.0),
        guidance_scale=samp.get("guidance_scale", 1.0),
        sampler=args.sampler or samp.get("sampler", "ddim"),
        schedule_method=args.schedule or samp.get("schedule", "uniform"))
    loaders = _loaders(cfg, args.batch)
    loader = (loaders.get("test") or loaders.get("validation")
              or loaders["train"])
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = to_device(enc.encode_batch(next(loader.epoch(0))),
                      Trainer._GENERATE, model.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    imgs = pipe.generate(batch, gen).float().cpu().numpy()
    for i, img in enumerate(imgs):
        arr = np.clip((img + 1) / 2, 0, 1)
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            out_dir / f"sample_{i:03d}.jpg")
    print(f"wrote {len(imgs)} samples to {out_dir}")
    return imgs


def cmd_data_verify(cfg, args):
    """The readiness drill (`data/verify.py`): a DeepFashion root's CSV
    schemas, caption keys, SMPL pickles and tree completeness, before the
    first run. With --base, the paths come from the config's data.<split>
    entry; flags override. Exits 2 on a broken tree."""
    from upgpt_torch.data.verify import verify_root

    params = {}
    if cfg:
        split = (cfg.get("data") or {}).get(args.split) or {}
        params = dict(split.get("params") or {})
    kw = dict(
        root=args.root or params.get("folder"),
        image_dir=args.image_dir or params.get("image_dir", "img_256"),
        pair_files=args.pair_file or params.get(
            "pair_file", ["data/deepfashion/pairs-test-all.csv"]),
        data_file=args.data_file or params.get(
            "data_file", "data/deepfashion/deepfashion_map.csv"),
        input_mask_type=params.get("input_mask_type", "bbox"),
        check_loss_weight=bool(params.get("loss_weight", True)),
        limit=args.limit,
    )
    if not kw["root"]:
        raise SystemExit("--root (or a --base config with data paths) "
                         "required")
    if isinstance(kw["pair_files"], str):
        kw["pair_files"] = [kw["pair_files"]]
    report = verify_root(**kw)
    print(json.dumps(report, indent=2))
    if not report["ok"]:
        raise SystemExit(2)


def _load_model(model_cfg, ckpt, device=None):
    """Build a config's model (on `device` where its params name none),
    load `ckpt` (either layout) into it and cast it to bf16 on the card."""
    from upgpt_torch.checkpoint import load_checkpoint

    model_cfg = dict(model_cfg)
    if device is not None:
        params = dict(model_cfg.get("params") or {})
        params.setdefault("device", device)
        model_cfg["params"] = params
    model = load_checkpoint(instantiate_from_config(model_cfg), ckpt)
    if model.device.type == "cuda":
        cast_floating(model, torch.bfloat16)
    return model


def _build_serving(cfg, args):
    """(engine, builder, label) for `serve`, factored out so tests can drive
    the construction without the blocking HTTP loop."""
    from upgpt_torch.inference.http_serve import RequestBuilder
    from upgpt_torch.inference.pipeline import (
        ChainedUpscalePipeline, GenerationPipeline,
    )
    from upgpt_torch.inference.serving import ServingEngine

    _refuse_unported(args)
    model = _load_model(cfg["model"], args.ckpt)
    enc = _build_cond_encoder(
        cfg, model, allow_debug=getattr(args, "debug_encoder", False))
    samp = cfg.get("sampling") or {}
    steps = args.steps or samp.get("ddim_steps", 50)
    sampler = args.sampler or samp.get("sampler", "ddim")
    sched_method = (getattr(args, "schedule", None)
                    or samp.get("schedule", "uniform"))
    if args.upscale_base:
        # chained 256->512: one submit -> 512px result through both stages;
        # the upscale stage builds on the first stage's device
        up_cfg = merge_configs(args.upscale_base, [])
        up_model = _load_model(up_cfg["model"], args.upscale_ckpt,
                               device=str(model.device))
        pipe = ChainedUpscalePipeline(
            model, up_model, num_steps=steps, eta=samp.get("eta", 1.0),
            sampler=sampler, output_uint8=True,
            schedule_method=sched_method)
        label = f"chained {sampler}-{steps}"
    else:
        pipe = GenerationPipeline(
            model,
            num_steps=steps,
            eta=samp.get("eta", 1.0),
            guidance_scale=samp.get("guidance_scale", 1.0),
            sampler=sampler,
            output_uint8=True,
            schedule_method=sched_method,
        )
        label = f"{sampler}-{steps}"
    engine = ServingEngine(
        pipe, batch_size=args.batch, max_delay_s=args.max_delay,
        base_seed=args.seed, max_in_flight=getattr(args, "in_flight", 2))
    builder = RequestBuilder(
        enc, mask_hw=tuple(model.config.latent_size),
        context_dim=model.config.context_dim,
        pose_dim=model.config.pose_input_dim)
    return engine, builder, label


def cmd_serve(cfg, args):
    """HTTP daemon: concurrent requests batch into full static-shape
    device batches through the ServingEngine."""
    from upgpt_torch.inference.http_serve import serve

    engine, builder, label = _build_serving(cfg, args)
    engine.start()
    server = serve(engine, builder, port=args.port, host=args.host)
    print(f"serving on {args.host}:{server.server_address[1]} "
          f"(batch {args.batch}, {label})", file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()
        print(json.dumps(engine.stats.summary()), file=sys.stderr)


def _common(sub, name: str) -> argparse.ArgumentParser:
    sp = sub.add_parser(name)
    sp.add_argument("--config", "--base", dest="config", nargs="*",
                    default=[], help="YAML configs, merged left to right")
    sp.add_argument("overrides", nargs="*", help="key=value dotlist")
    if name != "data-verify":
        sp.add_argument("--debug-encoder", action="store_true",
                        help="allow hash-embedding conditioning (no CLIP "
                             "weights; NOT output parity)")
    return sp


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("upgpt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = _common(sub, "train")
    sp.add_argument("--resume", action="store_true",
                    help="continue from <logdir>/checkpoints/last")
    sp.add_argument("--finetune-from", default=None,
                    help="checkpoint to load weights from (fresh optimizer)")
    sp.add_argument("--multihost", action="store_true",
                    help="multi-host training (not ported: raises)")

    sp = _common(sub, "sample")
    sp.add_argument("--ckpt", required=True,
                    help="a checkpoint of upgpt_torch.checkpoint, either "
                         "layout")
    sp.add_argument("--out", default="results")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sampler", default=None,
                    choices=("ddim", "dpm++", "unipc"))
    sp.add_argument("--schedule", default=None,
                    choices=("uniform", "quad", "karras"))
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel sampling (not ported: > 1 raises)")

    sp = _common(sub, "data-verify")
    sp.add_argument("--root", default=None,
                    help="DeepFashion root (defaults to the config's "
                         "data.<split>.params.folder)")
    sp.add_argument("--split", default="train")
    sp.add_argument("--image-dir", default=None)
    sp.add_argument("--pair-file", nargs="*", default=None)
    sp.add_argument("--data-file", default=None)
    sp.add_argument("--limit", type=int, default=None,
                    help="check only the first N pair rows")

    sp = _common(sub, "serve")
    sp.add_argument("--ckpt", required=True,
                    help="the port's checkpoint (upgpt_torch.checkpoint)")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--batch", type=int, default=32)
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-delay", type=float, default=0.25,
                    help="batching window (s): tail latency traded for "
                         "batch occupancy")
    sp.add_argument("--in-flight", type=int, default=2,
                    help="dispatched-but-unfenced batch depth; 2 overlaps "
                         "the host's dispatch with device compute")
    sp.add_argument("--dp", type=int, default=1,
                    help="data-parallel serving (not ported: > 1 raises)")
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving (not ported: > 1 raises)")
    sp.add_argument("--sampler", default=None,
                    choices=("ddim", "dpm++", "unipc"))
    sp.add_argument("--schedule", default=None,
                    choices=("uniform", "quad", "karras"))
    sp.add_argument("--upscale-base", nargs="*", default=None,
                    help="upscale-stage config: serve the chained 256->512 "
                         "pipeline (one submit per 512px result)")
    sp.add_argument("--upscale-ckpt", default=None)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = merge_configs(args.config, args.overrides) if args.config else {}
    return {"train": cmd_train, "sample": cmd_sample, "serve": cmd_serve,
            "data-verify": cmd_data_verify}[args.cmd](cfg, args)


if __name__ == "__main__":
    main()
