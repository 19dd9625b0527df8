"""What the modes share: the program's model built on the card from a
configuration file with the benchmark's seeded weights, kernel launch
counts, layer work for the ranges, and the reference's weights."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from portbench import flops, inputs
from portbench.weights import SeededWeights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(run, param_dtype: str, **switches):
    """The program's LatentDiffusion for `run.cfg`, built on the device
    (no host copy of the weights) and loaded with the seeded weights;
    returns (model, weights). The built model's geometry is checked
    against the configuration file."""
    from upgpt_torch.zoo import build_latent_diffusion

    cfg = run.cfg
    kernels = dict(cfg["kernels"], **switches)
    with torch.device(run.device):
        model = build_latent_diffusion(
            cfg["variant"], dtype=cfg["compute_dtype"],
            param_dtype=param_dtype, device=run.device, **kernels)
    u, v = model.config.unet, model.config.vae
    got = {"model_channels": u.model_channels, "channel_mult": list(u.channel_mult),
           "num_res_blocks": u.num_res_blocks, "num_heads": u.num_heads,
           "attention_resolutions": sorted(u.attention_resolutions),
           "in_channels": u.in_channels, "out_channels": u.out_channels,
           "latent_size": list(model.config.latent_size),
           "vae_ch": v.ch, "vae_ch_mult": list(v.ch_mult),
           "vae_resolution": v.resolution}
    want = {"model_channels": cfg["unet"]["model_channels"],
            "channel_mult": cfg["unet"]["channel_mult"],
            "num_res_blocks": cfg["unet"]["num_res_blocks"],
            "num_heads": cfg["unet"]["num_heads"],
            "attention_resolutions": sorted(cfg["unet"]["attention_resolutions"]),
            "in_channels": cfg["unet"]["in_channels"],
            "out_channels": cfg["unet"]["out_channels"],
            "latent_size": cfg["latent_size"], "vae_ch": cfg["vae"]["ch"],
            "vae_ch_mult": cfg["vae"]["ch_mult"],
            "vae_resolution": cfg["vae"]["resolution"]}
    if got != want:
        raise RuntimeError(f"the program's {cfg['variant']} is {got}, the "
                           f"configuration file says {want}")
    weights = SeededWeights(cfg, inputs.sub_seed(run.seed, 0), run.device,
                            DTYPES[param_dtype])
    weights.load_into(model)
    return model, weights


def launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters (exact counts)."""
    from upgpt_torch.utils.diagnostics import kernel_launches

    return dict(kernel_launches())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def release(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_weights(weights: SeededWeights) -> Dict[str, torch.Tensor]:
    """The seeded weights as float32 tensors, for the reference."""
    return {n: v.float() for n, v in weights.views.items()}


def xformer_work(cfg: dict):
    """A SpatialTransformer call's (flops, bytes) from its arguments."""
    def work(mod, args, kwargs):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        kv = kwargs.get("kv")
        b, h, w, c = x.shape
        if kv is not None:
            return flops.transformer(b, h * w, c, kv["block_0"][0].shape[1])
        return flops.transformer_with_context(b, h * w, c, ctx.shape[1],
                                              ctx.shape[2])
    return work


def sampling_hooks(ranges, model, cfg: dict) -> set:
    """Ranges around a sampling model's SpatialTransformers, ResBlocks and
    decode; returns the layers' names."""
    ranges.hook(model.unet, "SpatialTransformer", "xformer",
                xformer_work(cfg))
    ranges.hook(model.unet, "ResBlock", "resblock", resblock_work)
    ranges.wrap(model.vae, "decode", "decoder", decoder_work(cfg, model.vae))
    return {"xformer", "resblock", "decoder"}


def resblock_work(mod, args, kwargs):
    x = args[0]
    b, h, w, cin = x.shape
    return flops.resblock(b, h, w, cin, mod.conv_in.out_channels,
                          mod.emb_proj.in_features)


def decoder_work(cfg: dict, vae: torch.nn.Module):
    """The decode's (flops, bytes): `AutoencoderKL.decode(z)`."""
    weights = sum(p.numel() for n, p in vae.named_parameters()
                  if n.startswith(("decoder.", "post_quant_conv.")))

    def work(z):
        b = z.shape[0]
        return (b * flops.decoder_flops(cfg),
                flops.decoder_bytes(cfg, b, weights))
    return work
