"""The port's command line: `serve`.

Port of the serving part of `upgpt_tpu.cli`. YAML configs merge left to
right with key=value dotlist overrides, and the model builds through the
`target:`/`params:` registry (`upgpt_torch.config`), so the JAX package's
`configs/deepfashion/*.yaml` serve the port's models unchanged:

    python -m upgpt_torch.cli serve --config configs/deepfashion/mm_512.yaml \\
        --ckpt weights/mm_512.pt --debug-encoder --batch 8 \\
        --sampler unipc --schedule karras --steps 8 sampling.eta=0.0

`--ckpt` is the port's own checkpoint (`upgpt_torch.checkpoint`: one
`torch.save` of the unet, pose and vae state dicts). The JAX CLI's
`sample`, `test`, `train` and the other subcommands, its CLIP encoder,
`--dp`, `--tp` and the distilled-student sidecar are not ported yet; each
names the ROADMAP item it waits on.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from upgpt_torch.config import instantiate_from_config, merge_configs


def cast_floating(module: torch.nn.Module, dtype: torch.dtype
                  ) -> torch.nn.Module:
    """Cast the floating parameters of `module` to `dtype` in place (the
    JAX CLI's `cast_floating` for serving: half the weight traffic)."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def _build_cond_encoder(cfg, model, allow_debug=False):
    clip_cfg = cfg.get("clip") or {}
    if clip_cfg.get("text_params"):
        raise NotImplementedError(
            "clip.text_params: the CLIP conditioning encoder is not ported "
            "yet (ROADMAP §1 item 7); serve with --debug-encoder and no "
            "clip weights")
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
    if (getattr(args, "dp", 1) or 1) > 1:
        raise SystemExit("--dp > 1: data-parallel serving waits on "
                         "torch.distributed (ROADMAP §1 item 6)")
    if (getattr(args, "tp", 1) or 1) > 1:
        raise SystemExit("--tp > 1: tensor-parallel serving waits on "
                         "torch.distributed (ROADMAP §1 item 6)")
    for ckpt in (args.ckpt, getattr(args, "upscale_ckpt", None)):
        if ckpt and Path(str(Path(ckpt).absolute()) + ".distill.json"
                         ).exists():
            raise SystemExit(f"{ckpt}: a distilled-student sidecar; "
                             f"distillation is not ported (ROADMAP §1 "
                             f"item 9)")


def _load_model(model_cfg, ckpt, device=None):
    """Build a config's model (on `device` where its params name none),
    load `ckpt` into it and cast it to bf16 on the card."""
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


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("upgpt_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve")
    sp.add_argument("--config", "--base", dest="config", nargs="*",
                    default=[], help="YAML configs, merged left to right")
    sp.add_argument("overrides", nargs="*", help="key=value dotlist")
    sp.add_argument("--ckpt", required=True,
                    help="the port's checkpoint (upgpt_torch.checkpoint)")
    sp.add_argument("--debug-encoder", action="store_true",
                    help="allow hash-embedding conditioning (no CLIP "
                         "weights; NOT output parity)")
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
    {"serve": cmd_serve}[args.cmd](cfg, args)


if __name__ == "__main__":
    main()
