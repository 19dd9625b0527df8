"""The port's command line: `train`, `sample`, `test`, `eval`,
`train-vae`, `convert`, `serve`, `bringup`, `data-verify` and `distill`.

Port of `upgpt_tpu.cli`'s subcommands of the same names. YAML configs merge
left to right with key=value dotlist overrides, and models and datasets
build through the `target:`/`params:` registry (`upgpt_torch.config`), so
the JAX package's `configs/deepfashion/*.yaml` drive the port unchanged:

    python -m upgpt_torch.cli data-verify \\
        --base configs/deepfashion/interp_256.yaml
    python -m upgpt_torch.cli train \\
        --base configs/deepfashion/interp_256.yaml --debug-encoder \\
        data.train.params.folder=/data/deepfashion_inshop
    torchrun --nproc-per-node 8 -m upgpt_torch.cli train --multihost \\
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
    python -m upgpt_torch.cli distill \\
        --base configs/deepfashion/interp_256.yaml --debug-encoder \\
        --teacher-ckpt weights/interp_256.pt --out weights/student.pt \\
        --start-steps 64 --end-steps 4 --synthetic

`train` builds float32 master weights under the config's compute dtype
(flax's `param_dtype`), from `trainer.seed`, and ships batches to the card
in the compact transport by default. `sample` and `serve` take either
checkpoint layout of `upgpt_torch.checkpoint` (a trainer checkpoint's EMA
first) and cast the weights to bf16 on the card. `test` samples the test
split (else validation), dumps the paired groups and scores them (SSIM,
MS-SSIM, the FID with `--fid-weights`, a pt_inception .pth); `eval` scores
a dump again. `train-vae` trains the first stage with the PatchGAN loss
and writes `<logdir>/last` in the port's layout. `clip.*` in the config
names the CLIP towers' weights (torch state dicts, or the JAX CLI's orbax
trees) and the BPE merges; the debug encoder (`--debug-encoder`) stands in
without them. Every `--ckpt`, `--upscale-ckpt` and `--teacher-ckpt` takes
a `torch.save` file or a directory the JAX package's orbax checkpointer
wrote (`cli convert`'s, `cli distill`'s or the trainer's), read without
JAX (`convert.orbax`); so does `--fid-weights`. `convert` reads
a released Lightning checkpoint (`convert.lightning`) into the serving
layout that `sample`, `test`, `serve` and the demo app read; `bringup` is
the weight-drop runbook (`upgpt_torch.bringup`), exiting 3 when its report
is not accepted. `distill` halves a teacher's sampling steps
(`training.distill`) on the synthetic rig or the config's train split and
writes the v-parameterised student with its grid sidecar
`<out>.distill.json`; `sample`, `test` and `serve` read a checkpoint's
sidecar, rebuild the model at its parameterisation and sample eta-0 DDIM
on its grid, whatever --steps and --sampler say.

`train --multihost` trains data-parallel over the process group that
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) names (`upgpt_torch.parallel`): one rank a card over NCCL,
the global batch rounded up to a multiple of the ranks, each rank on its
rows; with no such environment it trains as one process. Each rank
prints a summary line on stderr at the end (`multihost summary {...}`).
`serve --dp N` keeps a replica of the pipeline on each of cuda:0..N-1 and
splits every batch over them; its kernels stay on (JAX turns its Pallas
kernels off under --dp, ROADMAP §3 P9). `sample --tp N` and `test --tp N`
split the U-Net's transformers over a (data x model) grid
(`upgpt_torch.parallel.tp`): the process's cards, N shards a data group and
the batch over the groups, as JAX's mesh over its devices; a model on the
CPU takes one group of N CPU shards. The kernels stay on but for the fused
SpatialTransformer's (ROADMAP §3 P12). `serve --tp` exits: JAX's serve has
no tensor parallelism.
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
    HF, openai or the port's layout, or the JAX CLI's orbax trees) and the
    BPE merges (`clip.bpe_path`),
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


def _sidecar_path(ckpt) -> Path:
    """Where `cli distill` writes a student's grid sidecar."""
    return Path(str(Path(ckpt).absolute()) + ".distill.json")


def _refuse_unported(args) -> None:
    up_ckpt = getattr(args, "upscale_ckpt", None)
    if up_ckpt and _sidecar_path(up_ckpt).exists():
        raise SystemExit(
            f"{up_ckpt}: a distilled student's sidecar beside the upscale "
            f"checkpoint; distillation makes no upscale students (the "
            f"ladder conditions on text, style and pose, and the upscale "
            f"stage has no pose)")
    if getattr(args, "upscale_base", None) and _sidecar_path(
            args.ckpt).exists():
        raise SystemExit(
            f"{args.ckpt}: a distilled student ({_sidecar_path(args.ckpt)}) "
            f"under --upscale-base: the chain would sample it at --steps / "
            f"--sampler, off the only grid it was trained on (JAX does, "
            f"ROADMAP §3 R2); serve it without the upscale stage")


def _loaders(cfg, batch_size, compact=False, train_transform=None):
    """The config's data splits as loaders: `train` shuffled through the
    prefetching thread loader (`data.loader: process` selects worker
    processes), the others in order. `batch_size` is the global batch: in
    a process group each rank loads its slice of every global batch
    (DistributedSampler's split, the same permutation on every rank)."""
    from upgpt_torch.data.deepfashion import (
        DataLoader, PrefetchDataLoader, ProcessDataLoader,
    )
    from upgpt_torch.parallel import multihost

    proc = dict(process_index=multihost.process_index(),
                process_count=multihost.process_count())

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
                             batch_transform=train_transform, **proc)
        else:
            out[split] = DataLoader(ds, batch_size, shuffle=False, **proc)
    return out


def _restore_params(ckpt):
    """(params, frozen) of a checkpoint in either layout, for `fit`: the
    trainable weights by name (a trainer checkpoint's EMA first) and
    {"vae": its VAE}; raises where the file has no VAE."""
    from upgpt_torch.checkpoint import read_weights

    trainable, vae = read_weights(ckpt, "cpu")
    return trainable, {"vae": vae}


def cmd_train(cfg, args):
    """Train the config's model on its data (JAX `cmd_train`); with
    `--multihost`, data-parallel over the run's process group."""
    from upgpt_torch.parallel import multihost

    _refuse_unported(args)
    model_cfg = dict(cfg["model"])
    # float32 masters under the config's compute dtype, as flax trains
    # (param_dtype); the serving cast to bf16 is not for training
    model_cfg["params"] = {"param_dtype": "float32",
                           **(model_cfg.get("params") or {})}
    group = None
    if getattr(args, "multihost", False):
        # before the first CUDA touch: the rank's card becomes the current
        # device, where the zoo's default "cuda" builds the model
        device = str(model_cfg["params"].get("device", "cuda"))
        group = multihost.initialize(device=torch.device(device).type)
    try:
        return _train(cfg, args, model_cfg, group)
    finally:
        multihost.shutdown()


def _train(cfg, args, model_cfg, group):
    from upgpt_torch.training.trainer import Trainer, TrainerConfig

    tcfg = dict(cfg.get("trainer") or {})
    # the weights from the run's seed, as JAX inits from PRNGKey(seed)
    torch.manual_seed(TrainerConfig(**tcfg).seed)
    model = instantiate_from_config(model_cfg)
    # compact (uint8) transport by default on the card, as JAX's on
    # accelerators; the config can override
    tcfg.setdefault("compact_transport", model.device.type == "cuda")
    tc = TrainerConfig(**tcfg)
    ranks = 1 if group is None else group.world_size
    if tc.batch_size % ranks:
        # the global batch splits over the ranks: round it up rather than
        # idle a card (JAX's rule over its devices)
        import dataclasses
        import math

        new_bs = math.ceil(tc.batch_size / ranks) * ranks
        print(f"batch_size {tc.batch_size} -> {new_bs} (global batch must "
              f"divide over all {ranks} ranks)", file=sys.stderr)
        tc = dataclasses.replace(tc, batch_size=new_bs)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    trainer = Trainer(model, tc, enc)
    if group is None or group.rank == 0:
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
        state = trainer.fit(loaders["train"], loaders.get("validation"),
                            params=params, frozen_params=frozen,
                            resume=args.resume)
    finally:
        close = getattr(loaders["train"], "close", None)
        if close is not None:
            close()
    if group is not None:
        summary = _multihost_summary(trainer, state, group)
        print(f"multihost summary {json.dumps(summary)}", file=sys.stderr,
              flush=True)
    return state


def _multihost_summary(trainer, state, group) -> dict:
    """This rank's account of a `--multihost` run: the group, the host
    clock between consecutive train steps (ms), DDP's exchanges and their
    bytes in the last step, the ms of those exchanges all-reduced alone
    after the run (a collective: every rank calls it), peak device memory
    (GiB, None on the CPU) and the kernel wrappers' launch counts."""
    from upgpt_torch.parallel import mesh
    from upgpt_torch.utils.diagnostics import kernel_launches

    ends = list(trainer.step_ends)
    steps = state.step
    exchanged = state.ddp.exchange_log.steps
    one_step = exchanged[-1] if exchanged else []
    dev = group.device
    return {
        "rank": group.rank, "world_size": group.world_size,
        "local_rank": group.local_rank, "backend": group.backend,
        "device": str(dev), "steps": steps, "global_batch":
            trainer.config.batch_size,
        "step_ms": [1e3 * (b - a) for a, b in zip(ends, ends[1:])],
        "exchanges_per_step": len(one_step),
        "exchange_bytes_per_step": sum(one_step),
        "exchange_ms": mesh.time_all_reduce(one_step, dev),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
        "launches": kernel_launches(),
    }


def _tp_shard(model, tp, batch_size=None, devices=None):
    """`model` sharded for `--tp` (JAX `_tp_shard`, `upgpt_tpu/cli.py:
    180-210`) over `devices`: by default every card of the process for a
    model on the card, as JAX's mesh takes `jax.devices()`, and one data
    group of `tp` shards of the model's device otherwise. Exits with JAX's
    messages where `tp` does not divide the devices or `batch_size` the
    data groups; raises ValueError where the heads or a sharded dim do not
    divide by `tp`. `tp` <= 1 returns `model`."""
    if not tp or tp <= 1:
        return model
    from upgpt_torch.parallel.tp import TPLatentDiffusion

    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if model.device.type == "cuda" else [model.device] * tp)
    n_dev = len(devices)
    if n_dev % tp:
        raise SystemExit(f"--tp {tp} does not divide {n_dev} devices")
    if batch_size and batch_size % (n_dev // tp):
        raise SystemExit(
            f"--batch {batch_size} does not divide the data axis "
            f"({n_dev} devices / tp {tp} = {n_dev // tp} shards)")
    return TPLatentDiffusion(model, devices, tp)


def cmd_sample(cfg, args):
    """Sample one batch of the config's test split (else validation, else
    train) from a checkpoint and write JPEGs (JAX `cmd_sample`)."""
    from PIL import Image

    from upgpt_torch.training.trainer import Trainer, to_device

    _refuse_unported(args)
    model, grid = _load_model(cfg["model"], args.ckpt)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    model = _tp_shard(model, getattr(args, "tp", 1), args.batch)
    samp = cfg.get("sampling") or {}
    pipe = _pipeline(
        model, grid, num_steps=args.steps or samp.get("ddim_steps", 200),
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
    .pth, or from the JAX CLI's converted orbax tree
    (`upgpt_tpu/cli.py:388-406`), on `device` (reference
    scripts/eval_metrics.py:100-112)."""
    from upgpt_torch.eval.inception import (
        InceptionFeatureFn, load_jax_inception, load_pt_inception,
    )

    path = getattr(args, "fid_weights", None) or (
        cfg.get("eval") or {}).get("fid_weights")
    if not path:
        return None
    load = load_jax_inception if Path(path).is_dir() else load_pt_inception
    return InceptionFeatureFn(load(path), device)


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
    from upgpt_torch.training.trainer import Trainer, to_device

    _refuse_unported(args)
    model, grid = _load_model(cfg["model"], args.ckpt)
    enc = _build_cond_encoder(cfg, model,
                              allow_debug=getattr(args, "debug_encoder",
                                                  False))
    model = _tp_shard(model, getattr(args, "tp", 1), args.batch)
    fid_fn = _fid_fn(cfg, args, model.device)
    samp = cfg.get("sampling") or {}
    pipe = _pipeline(
        model, grid, num_steps=args.steps or samp.get("ddim_steps", 200),
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


# the batch keys the distillation losses read
_DISTILL_KEYS = ("image", "person_mask", "text_emb", "style_emb", "smpl",
                 "loss_w")


def cmd_distill(cfg, args):
    """Progressive distillation (`training.distill`, JAX `cmd_distill`):
    halve a trained teacher's sampling steps from --start-steps to
    --end-steps on the synthetic rig (--synthetic) or the config's train
    split, then write the v-parameterised student in the serving layout
    (VAE included) and its grid sidecar `<out>.distill.json`
    ({"parameterization", "timesteps", "history"}), which `sample`, `test`
    and `serve` read. The teacher comes from either checkpoint layout (EMA
    first) as float32 masters under the config's compute dtype. A teacher
    with a sidecar (a student) is built at the sidecar's parameterisation
    and the ladder continues its grid, with no adapt phase; JAX's CLI
    drops the sidecar (ROADMAP §3 R15). Prints JAX's one-line summary and
    returns {"student", "grid", "history", "seconds"}: the wall of the
    load, the adapt phase, the stages and the write."""
    from upgpt_torch.checkpoint import load_checkpoint, save_checkpoint
    from upgpt_torch.training.distill import (
        DistillConfig, progressive_distill,
    )
    from upgpt_torch.training.trainer import to_device

    try:
        dcfg = DistillConfig(
            start_steps=args.start_steps, end_steps=args.end_steps,
            steps_per_stage=args.stage_steps, learning_rate=args.lr,
            grid_method=args.grid, use_ema=True, ema_decay=args.ema_decay,
            adapt_steps=args.adapt_steps)
    except ValueError as err:
        raise SystemExit(f"distill: {err}")
    t0 = time.perf_counter()
    sidecar = _read_sidecar(args.teacher_ckpt)
    model_cfg = dict(cfg["model"])
    params = {"param_dtype": "float32", **(model_cfg.get("params") or {})}
    if sidecar is not None:
        params["parameterization"] = sidecar[0]
    model_cfg["params"] = params
    teacher = load_checkpoint(instantiate_from_config(model_cfg),
                              args.teacher_ckpt)
    start_grid = (None if sidecar is None
                  else _checked_grid(teacher, args.teacher_ckpt, sidecar[1]))
    close = None
    if args.synthetic:
        from upgpt_torch.data.synthetic import SyntheticPairs

        data_iter = SyntheticPairs.for_model(
            teacher.config, n_samples=384, split="train").iterator(
                args.batch, seed=3)
    else:
        import itertools

        enc = _build_cond_encoder(cfg, teacher,
                                  allow_debug=getattr(args, "debug_encoder",
                                                      False))
        loader = _loaders(cfg, args.batch)["train"]
        close = getattr(loader, "close", None)
        data_iter = (to_device(enc.encode_batch(raw), _DISTILL_KEYS,
                               teacher.device)
                     for epoch in itertools.count()
                     for raw in loader.epoch(epoch))
    seconds = {"load": time.perf_counter() - t0}
    stage_starts = []

    def log(line: str) -> None:
        # a stage's first line ("stage k: ...") marks where it starts, and
        # stage 0's where the adapt phase ends
        if line.startswith("stage "):
            stage_starts.append(time.perf_counter())
        print(line, file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    try:
        student, grid, history = progressive_distill(
            teacher, data_iter, dcfg,
            generator=torch.Generator(device=teacher.device).manual_seed(
                args.seed),
            log_fn=log, start_grid=start_grid)
    finally:
        if close is not None:
            close()
    t1 = time.perf_counter()
    seconds["adapt"] = (stage_starts[0] if stage_starts else t1) - t0
    seconds["stages"] = t1 - (stage_starts[0] if stage_starts else t1)
    out = Path(args.out).absolute()
    out.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(student, out)
    _sidecar_path(out).write_text(json.dumps(
        {"parameterization": student.config.parameterization,
         "timesteps": [int(t) for t in grid], "history": history},
        indent=2))
    seconds["write"] = time.perf_counter() - t1
    print(json.dumps({"out": str(out), "steps": len(grid),
                      "stages": [h["steps"] for h in history],
                      "final_loss": history[-1]["loss"] if history
                      else None}))
    print(f"cli distill: wall {json.dumps(seconds)} s", file=sys.stderr)
    return {"student": student, "grid": grid, "history": history,
            "seconds": seconds}


def _read_sidecar(ckpt):
    """(parameterization, timesteps) of a distilled student's sidecar
    beside `ckpt`, or None where it has none; exits naming the file where
    the sidecar lacks either key."""
    path = _sidecar_path(ckpt)
    if not path.exists():
        return None
    try:
        meta = json.loads(path.read_text())
        param = meta["parameterization"]
        grid = np.asarray(meta["timesteps"], dtype=np.int64)
    except (ValueError, KeyError, TypeError) as err:
        raise SystemExit(f"{path}: not a distilled-student sidecar "
                         f"({type(err).__name__}: {err}); it needs "
                         f"'parameterization' and 'timesteps'")
    if param not in ("eps", "v", "x0"):
        raise SystemExit(f"{path}: unknown parameterization {param!r}")
    return param, grid


def _checked_grid(model, ckpt, grid) -> np.ndarray:
    """A sidecar's grid, if the DDIM schedule takes it on the model's
    noise schedule; else exit naming the sidecar."""
    from upgpt_torch.diffusion.schedule import make_ddim_schedule

    try:
        make_ddim_schedule(model.schedule, len(grid), eta=0.0,
                           timesteps=grid)
    except ValueError as err:
        raise SystemExit(f"{_sidecar_path(ckpt)}: {err}")
    return grid


def _load_model(model_cfg, ckpt, device=None):
    """(model, grid): build a config's model (on `device` where its params
    name none), load `ckpt` (either layout) into it and cast it to bf16 on
    the card. Where `ckpt` has a distilled student's sidecar, the model is
    built at the sidecar's parameterisation and `grid` is the student's
    t-grid (None otherwise)."""
    from upgpt_torch.checkpoint import load_checkpoint

    sidecar = _read_sidecar(ckpt)
    model_cfg = dict(model_cfg)
    params = dict(model_cfg.get("params") or {})
    if device is not None:
        params.setdefault("device", device)
    if sidecar is not None:
        params["parameterization"] = sidecar[0]
    model_cfg["params"] = params
    model = load_checkpoint(instantiate_from_config(model_cfg), ckpt)
    if model.device.type == "cuda":
        cast_floating(model, torch.bfloat16)
    if sidecar is None:
        return model, None
    grid = _checked_grid(model, ckpt, sidecar[1])
    print(f"distilled student: {sidecar[0]}-param, {len(grid)}-step grid "
          f"{grid.tolist()}", file=sys.stderr)
    return model, grid


def _pipeline(model, grid, output_uint8: bool = False, **sampling):
    """A distilled student's pipeline where `grid` is set: eta-0 DDIM on
    its own grid, the one sampler it is valid for, whatever `sampling`
    says; else the pipeline of `sampling`."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    if grid is not None:
        return GenerationPipeline(model, num_steps=len(grid), eta=0.0,
                                  timesteps=grid, output_uint8=output_uint8)
    return GenerationPipeline(model, output_uint8=output_uint8, **sampling)


def _build_serving(cfg, args):
    """(engine, builder, label) for `serve`, factored out so tests can drive
    the construction without the blocking HTTP loop."""
    from upgpt_torch.inference.http_serve import RequestBuilder
    from upgpt_torch.inference.pipeline import ChainedUpscalePipeline
    from upgpt_torch.inference.serving import ServingEngine

    _refuse_unported(args)
    if (getattr(args, "tp", 1) or 1) > 1:
        raise SystemExit("serve --tp: JAX's cli serve has no tensor "
                         "parallelism (its --tp is on sample and test); "
                         "serve --dp N splits each batch over N cards")
    dp = getattr(args, "dp", 1) or 1
    devices = None
    if dp > 1:
        # a replica of the pipeline per card, each batch split over them
        # (JAX's mesh data axis, its `--dp`); the kernels stay on (P9)
        cards = torch.cuda.device_count()
        if dp > cards:
            raise SystemExit(f"--dp {dp} exceeds {cards} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(dp)]
    model, grid = _load_model(cfg["model"], args.ckpt)
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
        up_model, _ = _load_model(up_cfg["model"], args.upscale_ckpt,
                                  device=str(model.device))
        pipe = ChainedUpscalePipeline(
            model, up_model, num_steps=steps, eta=samp.get("eta", 1.0),
            sampler=sampler, output_uint8=True,
            schedule_method=sched_method)
        label = f"chained {sampler}-{steps}"
    else:
        pipe = _pipeline(
            model, grid, output_uint8=True,
            num_steps=steps,
            eta=samp.get("eta", 1.0),
            guidance_scale=samp.get("guidance_scale", 1.0),
            sampler=sampler,
            schedule_method=sched_method,
        )
        label = (f"{sampler}-{steps}" if grid is None
                 else f"distilled-{len(grid)} {grid.tolist()}")
    if devices is not None:
        label += f" dp{dp}"
    engine = ServingEngine(
        pipe, batch_size=args.batch, max_delay_s=args.max_delay,
        base_seed=args.seed, max_in_flight=getattr(args, "in_flight", 2),
        devices=devices)
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
    if name in ("train", "sample", "test", "serve", "distill"):
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
                    help="data-parallel over the process group torchrun's "
                         "environment names (one process without one)")

    sp = _common(sub, "sample")
    sp.add_argument("--ckpt", required=True,
                    help="a checkpoint of upgpt_torch.checkpoint, either "
                         "layout, or a JAX orbax directory")
    sp.add_argument("--out", default="results")
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sampler", default=None,
                    choices=("ddim", "dpm++", "unipc"))
    sp.add_argument("--schedule", default=None,
                    choices=("uniform", "quad", "karras"))
    sp.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: split the U-Net's "
                         "transformers over N shards of a (data x model) "
                         "grid of the process's cards (one group of N CPU "
                         "shards for a model on the CPU); the batch "
                         "splits over the data groups")

    sp = _common(sub, "test")
    sp.add_argument("--ckpt", required=True,
                    help="a checkpoint of upgpt_torch.checkpoint, either "
                         "layout, or a JAX orbax directory")
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
                    help="tensor-parallel degree: split the U-Net's "
                         "transformers over N shards of a (data x model) "
                         "grid of the process's cards (one group of N CPU "
                         "shards for a model on the CPU); the batch "
                         "splits over the data groups")
    sp.add_argument("--fid-weights", default=None,
                    help="pt_inception .pth (or the JAX CLI's orbax "
                         "tree) for the protocol's FID")

    sp = _common(sub, "eval")
    sp.add_argument("--dir", required=True,
                    help="a `test` dump (samples/ and gt/)")
    sp.add_argument("--fid-weights", default=None,
                    help="pt_inception .pth (or the JAX CLI's orbax "
                         "tree) for the protocol's FID")
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
                    help="the port's checkpoint (upgpt_torch.checkpoint) "
                         "or a JAX orbax directory")
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
                    help="data-parallel serving: a replica on each of "
                         "cuda:0..N-1, every batch split over them")
    sp.add_argument("--tp", type=int, default=1,
                    help="refused above 1: JAX's serve has no tensor "
                         "parallelism (--dp splits batches over cards)")
    sp.add_argument("--sampler", default=None,
                    choices=("ddim", "dpm++", "unipc"))
    sp.add_argument("--schedule", default=None,
                    choices=("uniform", "quad", "karras"))
    sp.add_argument("--upscale-base", nargs="*", default=None,
                    help="upscale-stage config: serve the chained 256->512 "
                         "pipeline (one submit per 512px result)")
    sp.add_argument("--upscale-ckpt", default=None)

    sp = _common(sub, "distill")
    sp.add_argument("--teacher-ckpt", required=True,
                    help="the trained teacher (either checkpoint layout "
                         "or a JAX orbax directory; "
                         "EMA first), or a student with its sidecar to "
                         "continue its ladder")
    sp.add_argument("--out", required=True,
                    help="the student's checkpoint file (its grid sidecar "
                         "<out>.distill.json is written beside it)")
    sp.add_argument("--start-steps", type=int, default=64,
                    help="the top teacher sampling grid (a power-of-2 "
                         "multiple of --end-steps)")
    sp.add_argument("--end-steps", type=int, default=4)
    sp.add_argument("--stage-steps", type=int, default=2000,
                    help="optimizer steps per halving stage")
    sp.add_argument("--lr", type=float, default=2e-4)
    sp.add_argument("--batch", type=int, default=32)
    sp.add_argument("--grid", default="karras",
                    choices=("uniform", "karras"),
                    help="the ladder's t-grid (nested halving keeps its "
                         "shape)")
    sp.add_argument("--ema-decay", type=float, default=0.999)
    sp.add_argument("--adapt-steps", type=int, default=400,
                    help="eps->v re-parameterisation updates before the "
                         "first halving stage")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--synthetic", action="store_true",
                    help="distil on the procedural synthetic dataset (no "
                         "data root needed)")

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
            "bringup": cmd_bringup, "data-verify": cmd_data_verify,
            "distill": cmd_distill}[args.cmd](cfg, args)


if __name__ == "__main__":
    main()
