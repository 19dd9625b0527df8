"""The port's command line: `train`, `sample`, `test`, `eval`,
`train-vae`, `convert`, `serve`, `bringup` and `data-verify`.

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
    python -m upgpt_torch.cli test \\
        --base configs/deepfashion/interp_256.yaml --debug-encoder \\
        --ckpt logs/interp_256/checkpoints/last --steps 50 \\
        --fid-weights weights/pt_inception-2015-12-05.pth
    python -m upgpt_torch.cli eval --dir results \\
        --fid-weights weights/pt_inception-2015-12-05.pth
    python -m upgpt_torch.cli train-vae \\
        --base configs/autoencoder/kl_f8_deepfashion.yaml \\
        data.train.params.folder=/data/deepfashion_inshop
    python -m upgpt_torch.cli serve --config configs/deepfashion/mm_512.yaml \\
        --ckpt weights/mm_512.pt --debug-encoder --batch 8 \\
        --sampler unipc --schedule karras --steps 8 sampling.eta=0.0
    python -m upgpt_torch.cli convert --torch-ckpt interp_256.ckpt \\
        --out weights/interp_256.pt --variant interp_256 --ema
    python -m upgpt_torch.cli bringup --drop weights_drop --out bringup \\
        --data-root /data/deepfashion_inshop

`train` builds float32 master weights under the config's compute dtype
(flax's `param_dtype`), from `trainer.seed`, and ships batches to the card
in the compact transport by default. `sample` and `serve` take either
checkpoint layout of `upgpt_torch.checkpoint` (a trainer checkpoint's EMA
first) and cast the weights to bf16 on the card. `test` samples the test
split (else validation), dumps the paired groups and scores them (SSIM,
MS-SSIM, the FID with `--fid-weights`, a pt_inception .pth); `eval` scores
a dump again. `train-vae` trains the first stage with the PatchGAN loss
and writes `<logdir>/last` in the port's layout. `clip.*` in the config
names the CLIP towers' weights (torch state dicts) and the BPE merges; the
debug encoder (`--debug-encoder`) stands in without them. `convert` reads
a released Lightning checkpoint (`convert.lightning`) into the serving
layout that `sample`, `test`, `serve` and the demo app read; `bringup` is
the weight-drop runbook (`upgpt_torch.bringup`), exiting 3 when its report
is not accepted. The JAX CLI's `distill`, orbax weight directories,
`--multihost`, `--dp`, `--tp` and the distilled-student sidecar are not
ported yet; each names the ROADMAP item it waits on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
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


def _fid_fn(cfg, args, device):
    """The protocol FID's extractor from --fid-weights (else
    eval.fid_weights): pytorch_fid's InceptionV3 pool3 from a pt_inception
    .pth, on `device` (reference scripts/eval_metrics.py:100-112)."""
    from upgpt_torch.eval.inception import (
        InceptionFeatureFn, load_pt_inception,
    )

    path = getattr(args, "fid_weights", None) or (
        cfg.get("eval") or {}).get("fid_weights")
    if not path:
        return None
    if Path(path).is_dir():
        raise SystemExit(
            f"--fid-weights {path}: a directory (the JAX CLI's converted "
            f"orbax tree); the port reads the pt_inception .pth, and orbax "
            f"trees wait on a reader of their own (ROADMAP §1 item 11)")
    return InceptionFeatureFn(load_pt_inception(path), device)


def _crop_hw(cfg) -> tuple:
    # the protocol's crop: 256x176, or the config's (512x352 for the 512px
    # stages, mm_512.yaml:39-40)
    return tuple((cfg.get("eval") or {}).get("crop_size") or (256, 176))


def _write_metrics(results_dir, metrics: dict) -> None:
    # beside metrics.csv, so callers need not read stdout
    (Path(results_dir) / "metrics.json").write_text(
        json.dumps(metrics, indent=2))


def cmd_test(cfg, args):
    """Sample the config's test split (else validation) from a checkpoint,
    dump the paired groups and score them (JAX `cmd_test`: the reference's
    test_step, ddpm.py:1327-1377, then its auto-eval, main.py:797-801).
    Prints the metrics, writes metrics.json beside metrics.csv and returns
    {"metrics", "seconds"}: the host wall of the sampling, the recon, the
    dump and the metrics."""
    from upgpt_torch.eval.harness import dump_test_results, evaluate_dirs
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.training.trainer import Trainer, to_device

    _refuse_unported(args)
    model = _load_model(cfg["model"], args.ckpt)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    fid_fn = _fid_fn(cfg, args, model.device)
    samp = cfg.get("sampling") or {}
    pipe = GenerationPipeline(
        model, num_steps=args.steps or samp.get("ddim_steps", 200),
        eta=samp.get("eta", 1.0),
        sampler=args.sampler or samp.get("sampler", "ddim"),
        schedule_method=args.schedule or samp.get("schedule", "uniform"))
    crop_hw = _crop_hw(cfg)
    loaders = _loaders(cfg, args.batch)
    loader = loaders.get("test") or loaders["validation"]
    results = Path(args.out)
    seconds = dict.fromkeys(("sampling", "recon", "dump", "metrics"), 0.0)
    n = 0
    for raw in loader.epoch(0):
        t0 = time.perf_counter()
        batch = to_device(enc.encode_batch(raw), Trainer._GENERATE,
                          model.device)
        gen = torch.Generator(device=model.device).manual_seed(
            args.seed + n)
        imgs = pipe.generate(batch, gen).float().cpu().numpy()
        t1 = time.perf_counter()
        # the VAE's round trip through the posterior's mode (the
        # reference's `reconstruction`, ddpm.py:1389-1393)
        gt = np.asarray(raw["image"], np.float32)
        with torch.inference_mode():
            recon = model.decode_first_stage(model.encode_first_stage_mode(
                torch.from_numpy(gt))).float().cpu().numpy()
        t2 = time.perf_counter()
        extra = {"recon": recon}
        for key, group in (("src_image", "src"), ("smpl_image", "smpl")):
            if key in raw:
                extra[group] = np.asarray(raw[key])
        fnames = raw.get("fname", [f"img{n + i}" for i in range(len(imgs))])
        dump_test_results(str(results), fnames, imgs, gt=gt, extra=extra,
                          styles=raw.get("styles"), make_concats=True,
                          crop_hw=crop_hw)
        seconds["sampling"] += t1 - t0
        seconds["recon"] += t2 - t1
        seconds["dump"] += time.perf_counter() - t2
        n += len(imgs)
        if args.max_images and n >= args.max_images:
            break
    t0 = time.perf_counter()
    metrics = evaluate_dirs(str(results), crop_hw=crop_hw,
                            fid_feature_fn=fid_fn, device=model.device)
    seconds["metrics"] = time.perf_counter() - t0
    print(json.dumps(metrics))
    _write_metrics(results, metrics)
    print(f"cli test: {n} images, wall {json.dumps(seconds)} s",
          file=sys.stderr)
    return {"metrics": metrics, "seconds": seconds}


def cmd_eval(cfg, args):
    """Score a dump of `test` again (JAX `cmd_eval`), on --device, at the
    config's crop; prints the metrics and writes metrics.json."""
    from upgpt_torch.eval.harness import evaluate_dirs

    metrics = evaluate_dirs(args.dir, crop_hw=_crop_hw(cfg),
                            fid_feature_fn=_fid_fn(cfg, args, args.device),
                            device=args.device)
    print(json.dumps(metrics))
    _write_metrics(args.dir, metrics)
    return metrics


def build_vae_training(cfg):
    """(vae, loss module) of a `train-vae` config from its trainer.seed:
    the config's autoencoder (float32 parameters under its compute dtype)
    and the PatchGAN loss (`loss.*`) on the VAE's device."""
    from upgpt_torch.training.vae_loss import (
        LPIPSWithDiscriminator, VAELossConfig,
    )

    torch.manual_seed((cfg.get("trainer") or {}).get("seed", 42))
    vae = instantiate_from_config(cfg["model"])
    loss_mod = LPIPSWithDiscriminator(VAELossConfig(**(cfg.get("loss")
                                                       or {})))
    return vae, loss_mod.to(vae.quant_conv.weight.device)


def cmd_train_vae(cfg, args):
    """Train the first stage (JAX `cmd_train_vae`; the reference's main.py
    on an autoencoder config, contperceptual's loss) on the config's train
    split: Adam at the scaled learning rate, a JSON log line every
    `trainer.log_every` steps, `<logdir>/last` ({"vae", "loss": {"disc",
    "disc_stats", "logvar"}, "step"}) after each epoch. Stops at
    `trainer.max_steps` within an epoch, where JAX finishes the epoch
    (ROADMAP R9). Returns {"step", "logs", "vae", "loss"}."""
    from upgpt_torch.training.train_state import scaled_learning_rate
    from upgpt_torch.training.vae_trainer import (
        make_vae_optimizers, vae_train_step,
    )

    tc = cfg.get("trainer") or {}
    vae, loss_mod = build_vae_training(cfg)
    dev = vae.quant_conv.weight.device
    if loss_mod.config.perceptual_weight > 0:
        # JAX's cli builds the loss without an lpips_fn too (ROADMAP R8)
        print(f"WARNING: train-vae: the perceptual term (perceptual_weight "
              f"{loss_mod.config.perceptual_weight}) is off: no LPIPS "
              f"weights are wired into the loss; it trains on L1 + KL + "
              f"GAN", file=sys.stderr)
    batch_size = tc.get("batch_size", 12)
    lr = scaled_learning_rate(tc.get("base_learning_rate", 4.5e-6),
                              batch_size, 1,
                              scale_lr=tc.get("scale_lr", True))
    opts = make_vae_optimizers(lr, vae, loss_mod)
    gen = torch.Generator(device=dev).manual_seed(tc.get("seed", 42))
    logdir = Path(tc.get("logdir", "logs/vae"))
    logdir.mkdir(parents=True, exist_ok=True)
    loader = _loaders(cfg, batch_size)["train"]
    max_steps, log_every = tc.get("max_steps"), tc.get("log_every", 50)
    step, logged = 0, []
    try:
        for epoch in range(tc.get("max_epochs", 100)):
            for raw in loader.epoch(epoch):
                batch = torch.as_tensor(np.asarray(raw["image"],
                                                   np.float32)).to(dev)
                logs = vae_train_step(vae, loss_mod, opts, batch, step,
                                      generator=gen)
                step += 1
                if step % log_every == 0:
                    line = {"step": step, **{k: float(v)
                                             for k, v in logs.items()}}
                    logged.append(line)
                    print(json.dumps(line), flush=True)
                if max_steps and step >= max_steps:
                    break
            torch.save({"vae": vae.state_dict(),
                        "loss": loss_mod.checkpoint_state(), "step": step},
                       logdir / "last")
            if max_steps and step >= max_steps:
                break
    finally:
        close = getattr(loader, "close", None)
        if close is not None:
            close()
    print(f"done at step {step}; checkpoints in {logdir}")
    return {"step": step, "logs": logged, "vae": vae, "loss": loss_mod}


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


def cmd_convert(cfg, args):
    """A released Lightning checkpoint -> the port's serving layout
    (`checkpoint.save_checkpoint`) at `--variant`'s geometry (JAX
    `cmd_convert`); `--ema` takes the U-Net from the LitEma shadow. Host
    work: nothing reaches the card. Returns the conversion record."""
    from upgpt_torch.checkpoint import save_checkpoint
    from upgpt_torch.convert.lightning import convert_lightning

    try:
        model, record = convert_lightning(args.torch_ckpt, args.variant,
                                          ema=args.ema)
    except ValueError as err:
        raise SystemExit(f"convert: {err}")
    Path(args.out).absolute().parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(model, args.out)
    print(f"converted {record['submodels']} (ema={record['ema']}) -> "
          f"{args.out}")
    if record["unread"]:
        print(f"left unread: {json.dumps(record['unread'])}",
              file=sys.stderr)
    return record


def cmd_bringup(cfg, args):
    """The weight-drop runbook (`upgpt_torch.bringup`): inventory, convert
    (EMA), the validators, the sampler check, CLIP, bench and eval, one
    acceptance report (JAX `cmd_bringup`). The dotlist applies to the eval
    step's `cli test`. Exits 3 when the report is not accepted."""
    from upgpt_torch.bringup import run_bringup

    report = run_bringup(
        args.drop, args.out, variants=args.variants or None,
        data_root=args.data_root, skip_bench=args.skip_bench,
        skip_eval=args.skip_eval, geometry_override=args.geometry or None,
        fid_reference=args.fid_reference,
        skip_sampler_check=args.skip_sampler_check, device=args.device,
        eval_overrides=args.overrides)
    print(json.dumps({"accepted": report["accepted"],
                      "report": str(Path(args.out) / "REPORT.md")}))
    if not report["accepted"]:
        raise SystemExit(3)
    return report


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
    if name in ("train", "sample", "test", "serve"):
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

    sp = _common(sub, "test")
    sp.add_argument("--ckpt", required=True,
                    help="a checkpoint of upgpt_torch.checkpoint, either "
                         "layout")
    sp.add_argument("--out", default="results")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--seed", type=int, default=0,
                    help="each batch draws from seed + the number of "
                         "images before it")
    sp.add_argument("--max-images", type=int, default=None)
    sp.add_argument("--sampler", default=None,
                    choices=("ddim", "dpm++", "unipc"))
    sp.add_argument("--schedule", default=None,
                    choices=("uniform", "quad", "karras"))
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel sampling (not ported: > 1 raises)")
    sp.add_argument("--fid-weights", default=None,
                    help="pt_inception .pth for the protocol's FID")

    sp = _common(sub, "eval")
    sp.add_argument("--dir", required=True,
                    help="a `test` dump (samples/ and gt/)")
    sp.add_argument("--fid-weights", default=None,
                    help="pt_inception .pth for the protocol's FID")
    sp.add_argument("--device", default="cuda",
                    help="where the metrics run (default: the card)")

    _common(sub, "train-vae")

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

    sp = _common(sub, "convert")
    sp.add_argument("--torch-ckpt", required=True,
                    help="a released Lightning .ckpt (the reference's "
                         "key layout)")
    sp.add_argument("--out", required=True,
                    help="the port's checkpoint file to write")
    sp.add_argument("--variant", default="interp_256",
                    help="the zoo geometry to convert into")
    sp.add_argument("--ema", action="store_true",
                    help="convert the model_ema shadow weights (the "
                         "released eval protocol)")

    sp = _common(sub, "bringup")
    sp.add_argument("--drop", required=True,
                    help="directory with the released ckpts, the HF CLIP "
                         "snapshot and the metric weights")
    sp.add_argument("--out", default="bringup")
    sp.add_argument("--data-root", default=None,
                    help="DeepFashion root for the eval step")
    sp.add_argument("--variants", nargs="*", default=None)
    sp.add_argument("--geometry", default=None,
                    help="override the converter's geometry (rehearsals "
                         "on small synthetic drops)")
    sp.add_argument("--skip-bench", action="store_true")
    sp.add_argument("--skip-eval", action="store_true")
    sp.add_argument("--skip-sampler-check", action="store_true",
                    help="skip the DDIM-200 vs DDIM-50/UniPC/DPM++ "
                         "ordering check on the converted weights")
    sp.add_argument("--fid-reference", type=float, default=None,
                    help="the reference pipeline's FID on the same pairs: "
                         "accept only within 2%% of it")
    sp.add_argument("--device", default="cuda",
                    help="where the validators, the sampler check, CLIP, "
                         "the bench and the eval run (default: the card)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = merge_configs(args.config, args.overrides) if args.config else {}
    return {"train": cmd_train, "sample": cmd_sample, "test": cmd_test,
            "eval": cmd_eval, "train-vae": cmd_train_vae,
            "convert": cmd_convert, "serve": cmd_serve,
            "bringup": cmd_bringup,
            "data-verify": cmd_data_verify}[args.cmd](cfg, args)


if __name__ == "__main__":
    main()
