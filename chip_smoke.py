"""Drive the PyTorch port's sampling path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It

1. builds the port's CUDA kernels from `upgpt_torch/csrc` (nvcc, sm_90a);
2. holds each kernel against its plain PyTorch version in bf16 at the
   shapes the sampling path below gives it (batch 8), and times both;
3. builds interp_256 at full width in bf16 with every parameter re-drawn
   from a seeded generator (std 1/sqrt(fan_in), nothing left at zero),
   checks the kernel path against the plain path end to end (one U-Net
   eval, and a 4-step eta-0 sample plus decode at batch 2), then runs
   DDIM-50 with eta 1 at batch 8 to uint8 images: one warm-up and three
   timed runs, counting kernel launches in each;
4. prints a JSON line of per-kernel results, the card's name and power
   limit, and as its last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It needs one card and imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

# Kernel vs plain, bf16, at the path's shapes: max|kernel - plain| must stay
# under this share of max|plain|. Both sides round the same intermediates to
# bf16 (3 significant digits) but accumulate in different orders, so single
# elements differ by a few bf16 steps: 2e-2 leaves room for ~5 of them.
KERNEL_REL_TOL = 2e-2
# End to end, kernel path vs plain path on the same weights: relative L2 of
# the U-Net output, of the latents after 4 eta-0 DDIM steps, and of the
# image those latents decode to. Each path rounds to bf16 ~100 times per
# eval; measured on an H100 (700 W): 1.6e-2 (U-Net output), 5.5e-3
# (latents) and 1.2e-2 (image), so each bound has a margin of 3x or more.
EPS_REL_L2 = 5e-2
LATENT_REL_L2 = 5e-2
IMAGE_REL_L2 = 5e-2
BATCH, STEPS, TIMED_RUNS = 8, 50, 3


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _random_block(c: int, ctx_dim: int, g: torch.Generator) -> dict:
    """bf16 SpatialTransformer parameters, std 1/sqrt(fan_in)."""
    dev = g.device

    def w(o, i):
        return (torch.randn(o, i, generator=g, device=dev)
                / math.sqrt(i)).bfloat16()

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).bfloat16()

    def attn(cd):
        return {"to_q": {"weight": w(c, c)}, "to_k": {"weight": w(c, cd)},
                "to_v": {"weight": w(c, cd)},
                "to_out": {"weight": w(c, c), "bias": vec(c)}}

    norm = lambda: {"weight": vec(c, 1.0), "bias": vec(c)}
    return {
        "norm": norm(), "proj_in": {"weight": w(c, c), "bias": vec(c)},
        "proj_out": {"weight": w(c, c), "bias": vec(c)},
        "block_0": {
            "attn1": attn(c), "attn2": attn(ctx_dim),
            "ff": {"proj_in": {"weight": w(8 * c, c), "bias": vec(8 * c)},
                   "proj_out": {"weight": w(c, 4 * c), "bias": vec(c)}},
            "norm1": norm(), "norm2": norm(), "norm3": norm()},
    }


def _compare(name, shape, kernel, plain):
    got = kernel().float()
    torch.cuda.synchronize()
    want = plain().float()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name} {shape}: non-finite kernel output")
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    ms, plain_ms = _time_ms(kernel), _time_ms(plain)
    print(f"{name} {shape}: max|d|/max|ref| {rel:.3e} (max|d| {err:.3e}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if rel > KERNEL_REL_TOL:
        raise RuntimeError(f"{name} {shape}: kernel disagrees with plain "
                           f"({rel:.3e} > {KERNEL_REL_TOL})")
    return {"shape": list(shape), "max_abs_err": err, "rel_err": rel,
            "ms": ms, "plain_ms": plain_ms}


def kernel_checks(dev) -> dict:
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_transformer as ft

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {"fused_transformer_block": [], "flash_attention": []}
    with torch.no_grad():
        # ds1 and ds2 at the main path's batch
        for b, t, c in [(BATCH, 768, 224), (BATCH, 192, 448)]:
            p = _random_block(c, 768, g)
            x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
            k = torch.randn(b, 87, c, generator=g, device=dev).bfloat16()
            v = torch.randn(b, 87, c, generator=g, device=dev).bfloat16()
            cases["fused_transformer_block"].append(_compare(
                "fused_transformer_block", (b, t, c, 8, 87),
                lambda: ft.fused_transformer_block(x, p, 8, kv=(k, v)),
                lambda: ft.transformer_block_reference(x, p, 8, kv=(k, v))))
        # the VAE mid AttnBlock at the main path's batch, then a 512px-slice
        # shape (K3's regime, not on this path)
        for shape in [(BATCH, 1, 768, 512), (2, 8, 3072, 64)]:
            q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
                       for _ in range(3))
            cases["flash_attention"].append(_compare(
                "flash_attention", shape,
                lambda: fa.flash_attention(q, k, v),
                lambda: fa._reference_attention(q, k, v)))
    return cases


def _redraw(model, seed: int, dev) -> None:
    """Every parameter from a seeded generator: weights N(0, 1/fan_in),
    norm scales 1 + 0.1 N(0, 1), biases and norm shifts 0.1 N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            z = torch.randn(prm.shape, generator=g, device=dev)
            if prm.dim() >= 2:  # Linear (out, in) or Conv2d (O, I, kH, kW)
                z = z / math.sqrt(prm[0].numel())
            elif name.endswith("weight"):  # the only 1-D weights are norms'
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            prm.copy_(z.to(prm.dtype))


def _batch(b: int, h: int, w: int, dev, seed: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.where(torch.rand(b, h, w, 1, generator=g, device=dev) < 0.5,
                       -1.0, -0.99215686)
    return {"text_emb": torch.randn(b, 77, 768, generator=g, device=dev),
            "style_emb": torch.randn(b, 9, 768, generator=g, device=dev),
            "smpl": torch.randn(b, 1, 85, generator=g, device=dev),
            "person_mask": mask}


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def slice_run(dev, card: str) -> dict:
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.models.unet import precompute_cross_kv
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_transformer as ft
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion("interp_256", dtype="bfloat16", device=dev)
    _redraw(model, seed=1, dev=dev)
    plain = build_latent_diffusion(
        "interp_256", dtype="bfloat16", device=dev,
        use_flash_attention=False, use_fused_transformer=False)
    plain.load_state_dict(model.state_dict())
    h, w = model.config.latent_size

    # --- end to end, kernel path vs plain path, batch 2 ---
    small = _batch(2, h, w, dev, seed=2)
    x_t = torch.randn(2, h, w, 4, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    with torch.inference_mode():
        eps = {}
        for tag, m in (("kernel", model), ("plain", plain)):
            ctx = m.build_context(small["text_emb"], small["style_emb"],
                                  small["smpl"])
            cond = {"c_crossattn": ctx, "c_concat": small["person_mask"],
                    "cross_kv": precompute_cross_kv(m.unet, ctx)}
            t = torch.tensor([981, 421], device=dev)
            eps[tag] = m.apply_model(x_t, t, cond)
        lat = {tag: GenerationPipeline(m, num_steps=4, eta=0.0, decode=False)
               .generate(small, x_T=x_t)
               for tag, m in (("kernel", model), ("plain", plain))}
        img = {tag: m.decode_first_stage(lat[tag])
               for tag, m in (("kernel", model), ("plain", plain))}
    for tag in ("kernel", "plain"):
        for what, val in (("eps", eps[tag]), ("latents", lat[tag]),
                          ("image", img[tag])):
            if not torch.isfinite(val).all():
                raise RuntimeError(f"{tag} path: non-finite {what}")
    e2e = {"eps_rel_l2": _rel_l2(eps["kernel"], eps["plain"]),
           "latent_rel_l2": _rel_l2(lat["kernel"], lat["plain"]),
           "image_rel_l2": _rel_l2(img["kernel"], img["plain"])}
    print(f"end to end (batch 2): eps rel L2 {e2e['eps_rel_l2']:.3e}, "
          f"4-step latents rel L2 {e2e['latent_rel_l2']:.3e}, decoded image "
          f"rel L2 {e2e['image_rel_l2']:.3e}", flush=True)
    if (e2e["eps_rel_l2"] > EPS_REL_L2 or e2e["latent_rel_l2"] > LATENT_REL_L2
            or e2e["image_rel_l2"] > IMAGE_REL_L2):
        raise RuntimeError(f"kernel path disagrees with plain path: {e2e}")
    del plain

    # --- the main path: DDIM-50, eta 1, batch 8, uint8 ---
    pipe = GenerationPipeline(model, num_steps=STEPS, eta=1.0,
                              output_uint8=True)
    batch = _batch(BATCH, h, w, dev, seed=4)
    t0 = time.perf_counter()
    pipe.generate(batch, torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    print(f"warm-up run: {time.perf_counter() - t0:.3f} s", flush=True)
    times, counts = [], []
    for i in range(TIMED_RUNS):
        gen = torch.Generator(device=dev).manual_seed(10 + i)
        torch.cuda.synchronize()
        ft.fused_transformer_block.launches = 0
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        out = pipe.generate(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append((ft.fused_transformer_block.launches,
                       fa.flash_attention.launches))
        if tuple(out.shape) != (BATCH, 256, 192, 3) or out.dtype != torch.uint8:
            raise RuntimeError(f"output {tuple(out.shape)} {out.dtype}")
        if out.min().item() == out.max().item():
            raise RuntimeError("output image is constant")
    for fused_n, flash_n in counts:
        # 10 qualifying SpatialTransformers per U-Net eval; the VAE's mid
        # AttnBlock once per decode
        if fused_n != 10 * STEPS or flash_n != 1:
            raise RuntimeError(f"launch counts {counts}: expected "
                               f"({10 * STEPS}, 1) per run")
    sec = min(times)
    print(f"DDIM-{STEPS} eta 1 batch {BATCH} -> uint8 {tuple(out.shape)}: "
          f"{' '.join(f'{t:.4f}' for t in times)} s/batch, best {sec:.4f} "
          f"s/batch = {BATCH / sec:.3f} img/s on {card}", flush=True)
    return {"launches": {"fused_transformer_block": counts[0][0],
                         "flash_attention": counts[0][1]},
            "s_per_batch": times, "img_per_s": BATCH / sec, **e2e}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script only runs "
                         "on a GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from upgpt_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)

    cases = kernel_checks(dev)
    result = slice_run(dev, card)

    def entry(kname, source, replaces, path_cases):
        cs = cases[kname]
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": result["launches"][kname],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": sum(cs[i]["ms"] for i in path_cases),
            "plain_ms": sum(cs[i]["plain_ms"] for i in path_cases),
            "cases": cs,
        }

    kernels = [
        # ms: one ds1 plus one ds2 call, the two shapes of the path
        entry("fused_transformer_block", "upgpt_torch/csrc/fused_transformer.cu",
              "upgpt_tpu/ops/fused_transformer.py:436", [0, 1]),
        # ms: the VAE mid AttnBlock shape; the second case covers K3's
        # 512px regime (upgpt_tpu/ops/flash_attention.py:310)
        entry("flash_attention", "upgpt_torch/csrc/flash_attention.cu",
              "upgpt_tpu/ops/flash_attention.py:284", [0]),
    ]
    print(json.dumps({"slice": {k: v for k, v in result.items()
                                if k != "launches"}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
