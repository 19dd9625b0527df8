"""Drive the PyTorch port's sampling, training, evaluation, 256->512 chain,
serving, weight-drop runbook and demo app paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It

1. builds the port's CUDA kernels from `upgpt_torch/csrc` (one nvcc per
   source, in parallel, sm_90a);
2. holds each kernel against its plain PyTorch version in bf16 at the
   shapes the paths below give it (sampling at batch 8, training at
   batch 12, inshop_laion's 78-token context at batch 12, the chain at
   batch 4, mm_512's served batch of 8, the runbook's validators at batch
   1 over a 77-token context projected in-kernel, its sampler check and
   the app at batch 2, the app's upscale stage at batch 2, a
   data-parallel training rank's 6 rows and a dp serving replica's 4; the
   half-step kernel and the two
   GroupNorm kernels after step 5, at every shape the train step and the
   chain run launched them at, with the launches their counters recorded
   there; the GroupNorm statistics alone at the half-step's shapes; an
   empty kernel's device time as the latency floor; the GroupNorm kernels
   twice, bit for bit, and on two streams at once), and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (`library_ms`, a yardstick the port never calls;
   for the transformer block, which no one call computes, its products as
   torch.matmul, `gemm_library_ms`); the flash backward also at
   (4, 8, 3072, 64), which JAX's gate admits and no path runs;
3. sampling: builds interp_256 at full width in bf16 with every parameter
   re-drawn from a seeded generator (std 1/sqrt(fan_in), nothing left at
   zero), checks the kernel path against the plain path end to end (one
   U-Net eval, and a 4-step eta-0 sample plus decode at batch 2), then runs
   DDIM-50 with eta 1 at batch 8 to uint8 images: one warm-up and two
   timed runs, counting kernel launches in each;
4. training: builds interp_256 with float32 master parameters under bf16
   compute and the training kernels on (flash attention, fused transformer,
   fused GroupNorm), checks one AdamW step of the kernel path against the
   plain path (all three switches off) on the same weights, batch and
   draws at batch 2, then runs the train step at batch 12: one warm-up and
   five timed steps, counting kernel launches per step against the counts
   the model's structure gives;
   distillation: re-draws interp_256 the same way, checks one
   distillation update (the teacher eps under no_grad, the student its v
   copy) of the kernel path against the plain path at batch 2 (loss and
   update), writes the teacher's checkpoint and runs `python -m
   upgpt_torch.cli distill --synthetic` in-process (8 -> 4 -> 2 steps on
   the karras grid, two adapt updates and three a stage at batch 12),
   each update's launches held to `expected_distill_counts`: the
   sidecar's grid, the history, the student's weights moved; then the
   student as the teacher of a chained run (2 -> 1 on its own grid, no
   adapt phase), `cli sample` from it at batch 12 on its 2-step grid (12
   JPEGs of 256x192) and one batch served through `cli._build_serving`,
   their launches against the structure; ms per update, peak memory and
   `cli distill`'s wall split;
   the fit: writes a DeepFashion-shaped tree at interp_256's sizes (48
   training pairs with the config's men_factor, 24 validation pairs, from
   a seed) and runs `python -m upgpt_torch.cli train` in-process on
   `configs/deepfashion/interp_256.yaml` with the debug encoder, the
   compact transport and the training kernels on (model.params dotlist):
   one epoch at batch 12 (float32 masters, image grids and weights-only
   snapshots every 4 steps), then `train --resume` for a second epoch under
   torch.profiler, each step's launches (the trainer module's
   `train_step`, wrapped here) held to the bare step's; checks the step
   and epoch counts, every loss finite, last/best/trainstep_* and the
   grids, `last`'s EMA against the run's; then `cli sample` from `last` at
   batch 12, DDIM-50, 12 JPEGs of 256x192, its launches against the
   model's structure; prints the loop's ms/step beside the bare step's,
   the card's busy share over the loop, whether the native JPEG core is
   live, and the training loader's img/s alone (thread and process);
   evaluation: `python -m upgpt_torch.cli test` from that `last` (its
   switches, bf16) over 12 distinct validation pairs, DDIM-50 at batch
   12, the FID network from a pt_inception-layout file of seeded weights:
   12 JPEGs in each of the seven groups, metrics.json finite, the run's
   launches against the model's structure (per batch a sampling run, the
   recon's encode and decode), its wall split into sampling, recon, dump
   and metrics; `cli eval --dir` reproducing the numbers; the harness with
   the rehearsal LPIPS on the card against the CPU (float32, TF32 off);
   the FID network's img/s and LPIPS's pairs/s at batch 16; then `cli
   train-vae` on `configs/autoencoder/kl_f8_deepfashion.yaml` over the
   tree (full-width kl-f8 at 256x192, batch 12, bf16 over float32 masters,
   the GAN terms from step 0, six steps): finite logs, d_weight above 0,
   the VAE, the discriminator and its statistics moved, `last` read back,
   no kernel launched; ms/step, the generator's and discriminator's
   halves, peak memory; one step at full width in float32 on the card
   against the CPU;
   data parallelism (`ddp_run`, on the fit's training split): `python -m
   upgpt_torch.cli train --multihost` in subprocesses with torchrun's
   environment, at batch 12 with the training kernels on and no
   validation, three steps each: (a) one rank over NCCL at batch 12, its
   ms/step beside the fit loop's, its exchanges and bytes a step, the
   exchange timed alone, peak memory; (b) two ranks sharing the card over
   gloo (6 rows each) against (a), one process (loss per step, final
   parameters' relative L2), each rank's launches against
   `expected_train_counts` at 6 rows, rank 1's logdir never created, each
   rank's ms/step, exchange and peak memory;
   CLIP: writes synthetic full-width state dicts (openai's ViT-L/14 CLIP,
   text 12 x 768 with QuickGELU and vision 24 x 1024; laion's text tower,
   exact GELU, in HF's layout) and a merges table, builds the towers
   through the port's converters on the card, holds each against the same
   tower on the CPU in float32, and times the encode of one training
   batch (12 captions, 12 x 9 uint8 crops); inshop_laion (the interp_256
   U-Net with the trainable text-style fusion, a 78-token context,
   `use_checkpoint`): one AdamW step of the kernel path against the plain
   path at batch 2, the bare step at batch 12 with and without
   rematerialisation (ms, memory, launches against the structure with
   the recompute), `cli train --base
   configs/deepfashion/inshop_laion_clip.yaml` through those towers over
   a tree (four steps at batch 12, one epoch: finite losses, the fusion's
   weights moving, each step's launches), then `cli sample` from its
   checkpoint at batch 12, DDIM-50, its launches against the structure;
5. the chain: builds interp_256 and upscale at full width in bf16 with
   every GroupNorm kernel switch on (fused ResBlock half-steps, the out
   head's GroupNorm, the VAEs' GroupNorm) and re-drawn weights, checks the
   kernel path against the plain path (all switches off) on one upscale
   U-Net eval and on the 512x384 image of a 4-step eta-0 chain at batch 2,
   then runs DDIM-50 eta 1 through both stages at batch 4 to uint8
   (4, 512, 384, 3): one warm-up and one timed run, counting kernel
   launches against the counts the two models' structure gives, and the
   half-step kernel's launches by (shape, O);
6. UniPC: on the sampling phase's weights, checks the kernel path against
   the plain path for UniPC-8 and DPM++(2M)-8 on the karras grid at batch
   2 (latents, and UniPC's decoded image), then runs UniPC-8-karras, eta
   0, at batch 64 to uint8 (64, 256, 192, 3), `bench.py`'s second row: one
   warm-up and two timed runs, counting launches (K1 ten a U-Net eval,
   one flash forward for the decode, nothing else);
7. micro_block: the self-attention leg's two kernels (full-width K8,
   per-head K9) against their twins at (32, 768, 224, 8 heads) and at a
   ragged T of 700, on unit-scale inputs so the softmax is far from
   uniform, timed beside `F.multi_head_attention_forward` (one call
   of the same function), each twice bit for bit and on two streams at
   once, each of their three launches (Q/K/V, flash, to_out) timed alone
   beside the parent's device time; then
   `upgpt_torch.benchmarks.micro_block.main` at its defaults,
   counting the wrappers' calls (graph replays uncounted);
8. serving: builds mm_512 (the interp_256 U-Net over a 64x48 latent,
   kl-f8 at 512x384) in bf16 with re-drawn weights, checks its kernel path
   against the plain path at batch 2 (one U-Net eval, UniPC-8-karras eta-0
   latents and their uint8 image), writes its checkpoint and builds the
   serving engine through `upgpt_torch.cli` (UniPC-8-karras, eta 0, batch
   8, the debug encoder), times the raw pipeline at batch 8 to uint8 on
   the host (one warm-up, two timed runs, launches counted per batch),
   runs one batch's dispatch under `torch.cuda.set_sync_debug_mode
   ("error")`, then serves 12 concurrent /v1/generate requests, a 4-frame
   /v1/interpolate, /v1/stats and /healthz over HTTP on 127.0.0.1: every
   reply a 512x384 PNG, the launches those batches' structure gives, and
   one request's image against the pipeline's on the same packed batch and
   generators (at most one uint8 level; the share that differs printed);
   before the server, the dp engine (`dp_serve`): `cli serve --dp 2`
   exiting on one card, then two replicas of the served pipeline on the
   card through `ServingEngine(devices=...)`, the batch of 8 split 4 + 4,
   held to the one-replica engine's images and timed beside it, the
   replicas' launches against their structure;
9. bringup: re-draws interp_256 at full width in float32 on the card and
   writes a drop: `interp_256.ckpt` in the reference's Lightning layout
   (the U-Net under `model.diffusion_model.*`, a `model_ema.*` shadow of
   half its weights, the VAE, the pose stage under
   `extra_cond_models.0.*`, non-tensor entries the weights-only loader
   refuses), an HF CLIP snapshot at ViT-L/14's widths with BPE merges,
   and a pt_inception-layout .pth; runs `python -m upgpt_torch.cli
   convert --ema` in-process (every output tensor equal to its EMA, VAE
   or pose source bit for bit; one U-Net eval of the converted model
   equal to the source weights' on the card); then `cli bringup --variants
   interp_256 --skip-eval` with the bench on: exit 3 (random weights
   rejected: PSNR below 20 dB, |eps correlation| below 0.1), finite
   sampler SSIMs, the CLIP step's towers loaded on the card, report.json
   and REPORT.md written, the bench's img/s (DDIM-50, eta 1, batch 8) and
   the launches against the structure (validators, sampler check, bench);
10. the demo app (`upgpt_torch.app`) on 127.0.0.1 over the converted
   checkpoint with a re-drawn full-width upscale stage: the page, two
   frames with a style text override at DDIM-50 and at UniPC-8 (two
   256x192 PNGs each), `/api/upscale` (two 512x384 PNGs at 200 steps) and
   a 404, each request's launches against the structure and its latency;
   the drop, the checkpoints and the report are removed after;
11. prints a JSON line of per-kernel results, the card's name and power
   limit, and as its last line {"ok": true, "device": {...}}.

On every path bf16 attention must run the tensor-core flash kernels: the
counts expect no launch of their float32 FMA instantiations, nor of the
half-step kernel's float32 one.

Any failed check raises, so the script exits non-zero and prints no result.
It needs one card and imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import torch
import torch.nn.functional as F

# Kernel vs plain, bf16, at the path's shapes: max|kernel - plain| must stay
# under this share of max|plain|. Both sides round the same intermediates to
# bf16 (3 significant digits) but accumulate in different orders, so single
# elements differ by a few bf16 steps: 2e-2 leaves room for ~5 of them.
KERNEL_REL_TOL = 2e-2
# Sampling end to end, kernel path vs plain path on the same weights:
# relative L2 of the U-Net output, of the latents after 4 eta-0 DDIM steps,
# and of the image those latents decode to. Each path rounds to bf16 ~100
# times per eval; measured on an H100 (700 W): 1.6e-2 (U-Net output),
# 5.5e-3 (latents) and 1.2e-2 (image), so each bound has a margin of 3x or
# more.
EPS_REL_L2 = 5e-2
LATENT_REL_L2 = 5e-2
IMAGE_REL_L2 = 5e-2
# Training end to end, one AdamW step at batch 2, kernel path vs plain path
# on the same float32 masters, batch and draws: |loss difference| / loss,
# relative L2 of the global gradient, of the parameters after the step and
# of the step's update (parameters after minus before). Both paths compute
# in bf16 but round at different places (the kernels keep float32 inside a
# sub-block where the plain path rounds), and the backward carries those
# differences through the whole U-Net to all 688 leaves. The update is
# Adam's first step, about lr * sign(gradient), so it differs wherever a
# gradient entry is smaller than that noise. Measured on an H100 (700 W):
# 1.12e-4 (loss), 1.05e-2 (gradient), 1.17e-5 (parameters) and 0.155
# (update), so each bound has a margin of 3x or more.
TRAIN_LOSS_REL = 5e-4
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_PARAM_REL_L2 = 5e-5
TRAIN_UPDATE_REL_L2 = 0.5
# The chain end to end, kernel path vs plain path on the same weights:
# relative L2 of one upscale U-Net eval and of the 512x384 image after a
# 4-step eta-0 chain at batch 2. Both paths compute in bf16 and round at
# different places (the half-step kernel keeps the normalised activation in
# float32 until one bf16 rounding; K6's statistics sum in another order).
# Measured on an H100 (700 W): 1.637e-2 (eps) and 1.233e-2 (image), so each
# bound has a margin of 3x or more.
CHAIN_EPS_REL_L2 = 5e-2
CHAIN_IMAGE_REL_L2 = 5e-2
BATCH, STEPS, TIMED_RUNS = 8, 50, 2
# bench.py's second row: UniPC-8 on the karras grid, eta 0, batch 64
UNIPC_BATCH, UNIPC_STEPS = 64, 8
# the self-attention leg at micro_block's geometry, and a ragged T
SELFATTN_SHAPES = [((32, 768, 224, 8), "micro_block"),
                   ((32, 700, 224, 8), "none")]
# K8's and K9's device ms at those shapes in their first version (mma.sync
# products around K3's flash routine), recorded by this script on an
# NVIDIA H100 80GB HBM3 at 700 W: printed beside this run's times for
# scale, and kept out of the results, which hold this run's readings only
SELFATTN_RECORDED_PARENT_MS = {
    ("selfattn_fullwidth", 768): 0.3331, ("selfattn_perhead", 768): 0.3747,
    ("selfattn_fullwidth", 700): 0.2971, ("selfattn_perhead", 700): 0.3335,
}
# the leg's three launches in the order one call makes them, and a test of
# the kernel's name for each
SELFATTN_LAUNCHES = (("qkv", "leg_product_kernel<"),
                     ("flash", "flash_kernel<"),
                     ("to_out", "leg_product_kernel<"))
# K9 against K8 (max|d|/max|ref|): the two compute the same products and
# differ only in where to_out adds the bias, a bf16 step at most
SELFATTN_K9_K8_TOL = 1e-2
TRAIN_BATCH, TRAIN_STEPS, LEARNING_RATE = 12, 5, 2e-6
# data parallelism: the global training batch over two ranks (6 rows a
# rank), and a served batch of 8 over two replicas (4 rows a replica)
DDP_RANKS, DP_REPLICAS = 2, 2
DDP_RANK_BATCH = TRAIN_BATCH // DDP_RANKS
# serving mm_512: UniPC-8-karras, eta 0, batch 8; 12 concurrent requests
# (a full batch and a padded one), then a 4-frame interpolation
SERVE_VARIANT = "mm_512"
SERVE_BATCH, SERVE_STEPS, SERVE_REQUESTS, SERVE_FRAMES = 8, 8, 12, 4
CHAIN_BATCH, CHAIN_TIMED_RUNS = 4, 1
# K5's and K6's launches by ((N, H, W, C), kernel) per train step and per
# chain run, as the models' structure and the gates give them: the U-Net's
# level-1 GroupNorm+SiLU inputs and out head at batch 12; the out head,
# the kl-f8 decoder's 32x24 norms (K5) and the two decoders' larger norms
# (K6) at batch 4. The paths check them on the card, the CPU tests
# (tests/test_torch_gn_plan.py) against the structure.
_K5, _K6 = "fused_group_norm", "tiled_group_norm"
GN_LAUNCHES = {
    "training": {
        ((12, 32, 24, 224), _K5): 8, ((12, 32, 24, 448), _K5): 2,
        ((12, 32, 24, 672), _K5): 1, ((12, 16, 12, 224), _K5): 1,
        ((12, 16, 12, 448), _K5): 6, ((12, 16, 12, 672), _K5): 1,
        ((12, 16, 12, 896), _K5): 1, ((12, 16, 12, 1344), _K5): 1,
        ((12, 8, 6, 448), _K5): 1, ((12, 8, 6, 896), _K5): 6,
        ((12, 8, 6, 1344), _K5): 1, ((12, 8, 6, 1792), _K5): 2,
        ((12, 4, 3, 896), _K5): 11, ((12, 4, 3, 1792), _K5): 3},
    "chain": {
        ((4, 32, 24, 224), _K5): 50, ((4, 32, 24, 512), _K5): 11,
        ((4, 64, 48, 512), _K6): 6, ((4, 128, 96, 256), _K6): 5,
        ((4, 128, 96, 512), _K6): 12, ((4, 256, 192, 128), _K6): 6,
        ((4, 256, 192, 256), _K6): 6, ((4, 256, 192, 512), _K6): 1,
        ((4, 512, 384, 128), _K6): 6, ((4, 512, 384, 256), _K6): 1},
}
CONTEXT_TOKENS = 87  # 77 text + 9 style + 1 pose
UP_CONTEXT_TOKENS = 86  # the upscale stage has no pose token
LAION_CONTEXT_TOKENS = 78  # 77 fused text + 1 pose (inshop_laion)
# NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores, float32
# outside them, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# exponentials a second on the special-function units: 16 a clock per SM
# (NVIDIA's arithmetic-instruction throughput table for compute
# capability 9.0), 132 SMs, the 1,980 MHz boost clock
PEAK_EXP = 16 * 132 * 1.98e9


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


def _graph_ms(fn, iters: int = 20):
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed (`micro_block.graph_ms`), so the host's per-call cost
    (Python, argument checks, the launch itself) drops out of the figure
    that `_time_ms` measures with it. None, with the reason printed, where
    a call cannot be captured."""
    from upgpt_torch.benchmarks.micro_block import graph_ms

    try:
        return graph_ms(fn, iters)
    except RuntimeError as err:
        print(f"  (not captured in a CUDA graph: {err})", flush=True)
        torch.cuda.synchronize()
        return None


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


def _bound(flops: float, nbytes: float, peak: float):
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _compare(name, shape, path, kernel, plain, work, library=None):
    """Kernel against plain on the same inputs; both timed, and `library`
    (one PyTorch call computing the same function) where there is one.
    `work` is (flops, bytes, peak) for the bound."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = rel = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise RuntimeError(f"{name} {shape}: non-finite kernel output")
        e = (a - b).abs().max().item()
        err, rel = max(err, e), max(rel, e / b.abs().max().item())
    ms, plain_ms = _time_ms(kernel), _time_ms(plain)
    library_ms = None if library is None else _time_ms(library)
    device_ms = _graph_ms(kernel)
    # the library's device time where it is a forward call (an autograd
    # backward is not captured)
    library_device_ms = (None if library is None or "backward" in name
                         else _graph_ms(library))
    bound_ms, bound_by = _bound(*work)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    dev = ("" if device_ms is None else
           f"; in a CUDA graph kernel {device_ms:.4f} ms" +
           ("" if library_device_ms is None
            else f", library {library_device_ms:.4f} ms"))
    print(f"{name} {shape} [{path}]: max|d|/max|ref| {rel:.3e} (max|d| "
          f"{err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
          f"bound {bound_ms:.4f} ms ({bound_by}){dev}", flush=True)
    if rel > KERNEL_REL_TOL:
        raise RuntimeError(f"{name} {shape}: kernel disagrees with plain "
                           f"({rel:.3e} > {KERNEL_REL_TOL})")
    return {"shape": list(shape), "path": path, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "device_ms": device_ms,
            "library_device_ms": library_device_ms}


def _block_work(b, t, c, tk, ctx_dim=None):
    """K1's flops and bytes: eight products over M = B*T rows (40 M C^2),
    self- and cross-attention (4 B T^2 C and 4 B T Tk C), and with a
    context its K/V projection (4 B Tk Cd C); bytes: tokens in and out,
    20 C^2 weights and 21 C vectors, and the K/V or the context and
    to_k/to_v, all bf16."""
    flops = 40 * b * t * c * c + 4 * b * t * t * c + 4 * b * t * tk * c
    nbytes = 2 * (2 * b * t * c + 20 * c * c + 21 * c)
    if ctx_dim is None:
        nbytes += 2 * 2 * b * tk * c
    else:
        flops += 4 * b * tk * ctx_dim * c
        nbytes += 2 * (b * tk * ctx_dim + 2 * c * ctx_dim)
    return flops, nbytes, PEAK_BF16


def _block_gemm_library_ms(b, t, c, tk, ctx_dim, randn):
    """K1's products alone as torch.matmul (cuBLAS) on the same shapes:
    proj_in, packed QKV, to_out, cross q, to_out, GEGLU FF1 (both halves),
    FF2 and proj_out over M = B*T rows, and with a context its K/V
    projection: (eager ms, device ms). A yardstick only: no one PyTorch
    call computes the block, and the port never calls these."""
    m = b * t
    shapes = [(m, c, c), (m, c, 3 * c), (m, c, c), (m, c, c), (m, c, c),
              (m, c, 8 * c), (m, 4 * c, c), (m, c, c)]
    if ctx_dim is not None:
        shapes.append((b * tk, ctx_dim, 2 * c))
    pairs = [(randn(rows, k).bfloat16(), randn(n, k).bfloat16())
             for rows, k, n in shapes]

    def products():
        for a, w in pairs:
            torch.matmul(a, w.t())

    return _time_ms(products), _graph_ms(products)


def kernel_checks(dev) -> dict:
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_transformer as ft

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    cases = {k: [] for k, _, _ in KERNELS}
    with torch.no_grad():
        # K1, ds1 and ds2: precomputed K/V at the sampling batch and at the
        # training batch (the fit's image logs, `cli sample` and `cli
        # test`), the
        # context projected in-kernel at the training batch; the same at
        # inshop_laion's 78-token context (its `cli sample` and its train
        # step, the latter also in the backward's recompute); the upscale
        # net's ds4 (C 512, dh 64) with its 86-token K/V at the chain batch
        # and mm_512's ds2 (T 768, C 448) at the serving batch; the
        # runbook's validators (batch 1, the context projected in-kernel
        # over 77 tokens), its sampler check and the app (batch 2, Tk 87),
        # the app's upscale ds4 (batch 2, Tk 86), a data-parallel training
        # rank's ds1 and ds2 (batch 6, the context projected in-kernel) and
        # a dp serving replica's mm_512 ds2 (batch 4, Tk 87)
        for b, t, c, variant in [(BATCH, 768, 224, "kv"),
                                 (BATCH, 192, 448, "kv"),
                                 (TRAIN_BATCH, 768, 224, "fit"),
                                 (TRAIN_BATCH, 192, 448, "fit"),
                                 (TRAIN_BATCH, 768, 224, "ctx"),
                                 (TRAIN_BATCH, 192, 448, "ctx"),
                                 (TRAIN_BATCH, 768, 224, "laion_kv"),
                                 (TRAIN_BATCH, 192, 448, "laion_kv"),
                                 (TRAIN_BATCH, 768, 224, "laion_ctx"),
                                 (TRAIN_BATCH, 192, 448, "laion_ctx"),
                                 (CHAIN_BATCH, 768, 512, "chain"),
                                 (SERVE_BATCH, 768, 448, "serve"),
                                 (1, 768, 224, "validate"),
                                 (1, 192, 448, "validate"),
                                 (2, 768, 224, "bringup_kv"),
                                 (2, 192, 448, "bringup_kv"),
                                 (APP_FRAMES, 768, 512, "app_up"),
                                 (DDP_RANK_BATCH, 768, 224, "ddp"),
                                 (DDP_RANK_BATCH, 192, 448, "ddp"),
                                 (SERVE_BATCH // DP_REPLICAS, 768, 448,
                                  "dp")]:
            p = _random_block(c, 768, g)
            x = randn(b, t, c).bfloat16()
            tk = {"chain": UP_CONTEXT_TOKENS, "laion_kv": LAION_CONTEXT_TOKENS,
                  "laion_ctx": LAION_CONTEXT_TOKENS, "validate": 77,
                  "app_up": UP_CONTEXT_TOKENS}.get(variant, CONTEXT_TOKENS)
            if variant in ("kv", "fit", "chain", "serve", "laion_kv",
                           "bringup_kv", "app_up", "dp"):
                kv = (randn(b, tk, c).bfloat16(), randn(b, tk, c).bfloat16())
                kw, work = {"kv": kv}, _block_work(b, t, c, tk)
            else:
                kw = {"context": randn(b, tk, 768).bfloat16()}
                work = _block_work(b, t, c, tk, 768)
            row = _compare(
                f"fused_transformer_block[{variant}]", (b, t, c, 8, tk),
                {"kv": "sampling", "ctx": "training", "fit": "fit",
                 "serve": "serve", "laion_kv": "laion_sample",
                 "laion_ctx": "laion_train", "validate": "bringup",
                 "bringup_kv": "bringup", "app_up": "app", "ddp": "ddp",
                 "dp": "dp_serve"}.get(variant, "chain"),
                lambda: ft.fused_transformer_block(x, p, 8, **kw),
                lambda: ft.transformer_block_reference(x, p, 8, **kw), work)
            row["gemm_library_ms"], row["gemm_library_device_ms"] = \
                _block_gemm_library_ms(b, t, c, tk,
                                       None if "kv" in kw else 768, randn)
            print(f"  its {8 if 'kv' in kw else 9} products as torch.matmul: "
                  f"{row['gemm_library_ms']:.4f} ms, in a CUDA graph "
                  f"{row['gemm_library_device_ms']:.4f} ms (a yardstick "
                  f"only)", flush=True)
            cases["fused_transformer_block"].append(row)
        # flash forward: the VAE mid AttnBlock (decoder at the sampling
        # batch, encoder at the training batch, also `cli test`'s decode
        # and recon), the ds1 self-attention the
        # training backward recomputes, the upscale net's ds2
        # self-attention at the chain batch, mm_512's decoder mid
        # AttnBlock and ds1 self-attention (T 3072) at the serving batch,
        # the runbook's kl-f8 AttnBlocks at batch 1 (validators) and 2
        # (sampler check, app), the app's upscale ds2 at batch 2, a
        # data-parallel training rank's encoder AttnBlock and ds1
        # recompute at batch 6, and a dp serving replica's 512px decode
        # and mm_512 ds1 at batch 4
        for shape, path in [((BATCH, 1, 768, 512), "sampling"),
                            ((TRAIN_BATCH, 1, 768, 512), "training"),
                            ((TRAIN_BATCH, 8, 768, 28), "training"),
                            ((CHAIN_BATCH, 8, 3072, 64), "chain"),
                            ((SERVE_BATCH, 1, 3072, 512), "serve"),
                            ((SERVE_BATCH, 8, 3072, 28), "serve"),
                            ((1, 1, 768, 512), "bringup"),
                            ((APP_FRAMES, 1, 768, 512), "bringup"),
                            ((APP_FRAMES, 8, 3072, 64), "app"),
                            ((DDP_RANK_BATCH, 1, 768, 512), "ddp"),
                            ((DDP_RANK_BATCH, 8, 768, 28), "ddp"),
                            ((SERVE_BATCH // DP_REPLICAS, 1, 3072, 512),
                             "dp_serve"),
                            ((SERVE_BATCH // DP_REPLICAS, 8, 3072, 28),
                             "dp_serve")]:
            q, k, v = (randn(shape).bfloat16() for _ in range(3))
            bh, t, d = shape[0] * shape[1], shape[2], shape[3]
            cases["flash_attention"].append(_compare(
                "flash_attention", shape, path,
                lambda: fa.flash_attention(q, k, v),
                lambda: fa._reference_attention(q, k, v),
                (4 * bh * t * t * d, 2 * 4 * bh * t * d, PEAK_BF16),
                lambda: F.scaled_dot_product_attention(q, k, v)))
    backward_checks(cases, randn)
    return cases


def backward_checks(cases, randn) -> None:
    """K4 at the ds1 recompute of the training path, and at the upscale
    net's ds2 (4, 8, 3072, 64), which JAX's backward condition admits in
    bf16 and no path of the port trains yet ("none"). No one library call
    computes a pass alone: the `scaled_dot_product_attention` backward (dq,
    dk and dv together) stands on pass 1's line, and dQ + dK/dV is timed as
    a pair beside it over 200 calls, so that the host's part is small."""
    from upgpt_torch.ops import flash_attention as fa

    for shape, path in [((TRAIN_BATCH, 8, 768, 28), "training"),
                        ((DDP_RANK_BATCH, 8, 768, 28), "ddp"),
                        ((CHAIN_BATCH, 8, 3072, 64), "none")]:
        bh, t, d = shape[0] * shape[1], shape[2], shape[3]
        q, k, v, do = (randn(shape).bfloat16() for _ in range(4))
        o = fa._reference_attention(q, k, v)
        _, lse, di = fa._reference_backward_dq(q, k, v, o, do)
        lq, lk, lv = (a.detach().clone().requires_grad_() for a in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv)

        def library_backward():
            return torch.autograd.grad(lout, (lq, lk, lv), do,
                                       retain_graph=True)

        def pair():
            dq, lse_, di_ = fa.flash_backward_dq(q, k, v, o, do)
            return (dq,) + fa.flash_backward_dkv(q, k, v, do, lse_, di_)

        stats = 2 * bh * t * 4
        row = _compare(
            "flash_backward_dq", shape, path,
            lambda: fa.flash_backward_dq(q, k, v, o, do),
            lambda: fa._reference_backward_dq(q, k, v, o, do),
            (6 * bh * t * t * d, 2 * 6 * bh * t * d + stats, PEAK_BF16),
            library_backward)
        row["pair_ms"] = _time_ms(pair, 200)
        row["pair_library_ms"] = _time_ms(library_backward, 200)
        print(f"flash backward dQ + dK/dV {shape} [{path}]: "
              f"{row['pair_ms']:.4f} ms, one scaled_dot_product_attention "
              f"backward {row['pair_library_ms']:.4f} ms (200 calls each)",
              flush=True)
        cases["flash_backward_dq"].append(row)
        cases["flash_backward_dkv"].append(_compare(
            "flash_backward_dkv", shape, path,
            lambda: fa.flash_backward_dkv(q, k, v, do, lse, di),
            lambda: fa._reference_backward_dkv(q, k, v, do, lse, di),
            (8 * bh * t * t * d, 2 * 6 * bh * t * d + stats, PEAK_BF16)))
        del q, k, v, do, o, lse, di, lq, lk, lv, lout
        torch.cuda.empty_cache()


def _gn_work(shape, flops_per_value):
    """GroupNorm's bound: float32 operations on the values, x read once
    and written once in bf16, and the float32 scale and shift."""
    n = math.prod(shape)
    return flops_per_value * n, 2 * 2 * n + 2 * 4 * shape[-1], PEAK_F32


def latency_floor_ms(blocks: int = 1, cluster: int = 0) -> float:
    """Device time of an empty kernel of `blocks` blocks, launched as
    clusters of `cluster` blocks (0: a plain launch), replayed from a CUDA
    graph: the floor under any one launch of that shape, beside the
    GroupNorm kernels' bounds."""
    from upgpt_torch.ops import _build

    lib = _build.library()
    return _graph_ms(lambda: _build.check(lib.upgpt_empty(
        blocks, cluster, torch.cuda.current_stream().cuda_stream),
        "empty"), 50)


def groupnorm_checks(dev, by_path: dict, k7_shapes) -> dict:
    """K5 and K6 at every shape the train step and the chain run launched
    them at (`launches_by_shape`), each row with the launches per run
    counted there; K6 also as statistics and normalize alone; the
    statistics alone (with the half-step's affine, as K7's first launch)
    at K7's chain shapes. All bf16 with SiLU, eps 1e-5 (K5) and 1e-6 (K6,
    the VAE's). Then each kernel twice, bit for bit, and on two streams at
    once against one. The library yardstick is `F.group_norm` + `F.silu`
    on the channels-last view, and for the statistics alone one
    `torch.var_mean` over the grouped (N, H*W, G, C/G) view."""
    from upgpt_torch.ops import fused_gn as fg

    g = torch.Generator(device=dev).manual_seed(50)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    floor = latency_floor_ms()
    # the same, launched as K5's clusters are at the training batch
    cluster_floor = latency_floor_ms(TRAIN_BATCH * 8, 8)
    print(f"latency floor: an empty kernel replayed from a CUDA graph "
          f"{floor:.4f} ms; {TRAIN_BATCH * 8} blocks in clusters of 8 "
          f"{cluster_floor:.4f} ms", flush=True)

    def inputs(shape):
        x = (2 * randn(shape) + 0.5).bfloat16()
        return x, 1 + 0.1 * randn(shape[-1]), 0.1 * randn(shape[-1])

    def library(x, scale, bias, eps):
        ls, lb = scale.bfloat16(), bias.bfloat16()
        return lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), 32, ls, lb,
                                           eps))

    def stats_library(x):
        # the statistics alone: one var_mean over the grouped view; the
        # kernels' rsqrt (and K7's affine) are O(C) more
        n, c = x.shape[0], x.shape[-1]
        grouped = x.view(n, -1, 32, c // 32)
        return lambda: torch.var_mean(grouped, dim=(1, 3), correction=0)

    out = {"fused_group_norm": [], "tiled_group_norm": [], "gn_stats_k7": [],
           "latency_floor_ms": floor, "cluster_floor_ms": cluster_floor}
    for path, kernels in by_path.items():
        for (shape, kind), runs in sorted(kernels.items()):
            x, scale, bias = inputs(shape)
            if kind == "fused_group_norm":
                row = _compare(
                    "fused_group_norm", shape, path,
                    lambda: fg.fused_group_norm(x, scale, bias, 32, 1e-5,
                                                True),
                    lambda: fg._reference_gn(x, scale, bias, 32, 1e-5, True),
                    # 3 for the sums, 4 for the affine normalise, 3 for SiLU
                    _gn_work(shape, 10), library(x, scale, bias, 1e-5))
                row["cluster"] = fg.fused_gn_plan(shape, 32, 2).cluster
            else:
                row = _compare(
                    "tiled_group_norm", shape, path,
                    lambda: fg.tiled_group_norm(x, scale, bias, 32, 1e-6,
                                                True),
                    lambda: fg._reference_tiled(x, scale, bias, 32, 1e-6,
                                                True),
                    # 4 for the sums, 2 for x * a + b, 3 for SiLU
                    _gn_work(shape, 9), library(x, scale, bias, 1e-6))
                # where x exceeds L2, the normalize pass reads it again
                row["two_read_floor_ms"] = 3 * 2 * math.prod(shape) / (
                    PEAK_BYTES * 1e-3)
                stats = fg._stats_launch(x, 32, 1e-6)
                parts = {
                    "stats": _compare(
                        "gn_stats", shape, path,
                        lambda: fg._stats_launch(x, 32, 1e-6),
                        lambda: fg._reference_gn_stats(x, 32, 1e-6),
                        (4 * math.prod(shape),
                         2 * math.prod(shape) + 4 * 2 * shape[0] * shape[-1],
                         PEAK_F32), stats_library(x)),
                    "apply": _compare(
                        "gn_apply", shape, path,
                        lambda: fg._apply_launch(x, stats, scale, bias, True),
                        lambda: fg._reference_gn_apply(x, stats, scale, bias,
                                                       True),
                        (5 * math.prod(shape), 2 * 2 * math.prod(shape),
                         PEAK_F32))}
                for part, res in parts.items():
                    for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "rel_err", "library_ms",
                                "library_device_ms"):
                        row[f"{part}_{key}"] = res[key]
            row["launches_per_run"] = runs
            out[kind].append(row)
            del x
    # the statistics alone at K7's shapes, writing K7's [a; b]
    for shape in k7_shapes:
        x, scale, bias = inputs(shape)

        def coef_twin():
            st = fg._reference_gn_stats(x, 32, 1e-5)
            a = st[:, 1] * scale
            return torch.stack([a, bias - st[:, 0] * a], 1)

        out["gn_stats_k7"].append(_compare(
            "gn_stats[K7 head]", shape, "chain",
            lambda: fg._stats_launch(x, 32, 1e-5, scale, bias), coef_twin,
            (4 * math.prod(shape),
             2 * math.prod(shape) + 4 * 2 * shape[0] * shape[-1]
             + 2 * 4 * shape[-1], PEAK_F32), stats_library(x)))
    _repeat_checks(fg, inputs)
    torch.cuda.empty_cache()
    return out


def _repeat_checks(fg, inputs) -> None:
    """K5, K6 and K6's statistics: two calls give the same bits, and calls
    on two streams at once give the bits each gives alone (each stream
    counts its images in counters of its own)."""
    calls = [
        ("fused_group_norm", (CHAIN_BATCH, 32, 24, 512),
         lambda x, s, b: fg.fused_group_norm(x, s, b, 32, 1e-5, True)),
        ("tiled_group_norm", (CHAIN_BATCH, 64, 48, 512),
         lambda x, s, b: fg.tiled_group_norm(x, s, b, 32, 1e-6, True)),
        ("gn_stats[K7 head]", (CHAIN_BATCH, 16, 12, 896),
         lambda x, s, b: fg._stats_launch(x, 32, 1e-5, s, b))]
    for name, shape, call in calls:
        args = [inputs(shape) for _ in range(2)]
        want = [call(*a) for a in args]
        if not all(torch.equal(call(*a), w) for a, w in zip(args, want)):
            raise RuntimeError(f"{name} {shape}: two calls differ")
        streams = [torch.cuda.Stream() for _ in args]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        got = [[], []]
        for _ in range(10):
            for k, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[k].append(call(*args[k]))
        torch.cuda.synchronize()
        if not all(torch.equal(t, want[k]) for k in range(2)
                   for t in got[k]):
            raise RuntimeError(f"{name} {shape}: two streams differ from "
                               f"one")
        print(f"{name} {shape}: bit for bit over two calls and over two "
              f"streams at once", flush=True)


def resblock_checks(dev, chain_shapes: dict) -> list:
    """K7 at every (shape, O) the chain run launched it at, each row with
    the launches that run counted there, so that launches x ms sum to the
    kernel's time in a run; and one shape past the JAX gate (the upscale
    net's ds1), on no path. Its library yardstick is three calls
    (`F.group_norm`, `F.silu`, `F.conv2d` through cuDNN on the
    channels-last view), as no one call computes the half-step."""
    from upgpt_torch.ops import fused_resblock as frb

    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    shapes = [(key[:4], key[4], "chain", n)
              for key, n in sorted(chain_shapes.items())]
    shapes.append(((CHAIN_BATCH, 128, 96, 256), 256, "none", 0))
    rows = []
    for shape, o, path, runs in shapes:
        b, h, w, c = shape
        x = (2 * randn(shape) + 0.5).bfloat16()
        gs, gb = 1 + 0.1 * randn(c), 0.1 * randn(c)
        wt = (randn(o, c, 3, 3) / math.sqrt(9 * c)).bfloat16()
        cb = (0.1 * randn(o)).bfloat16()
        lib_gs, lib_gb = gs.bfloat16(), gb.bfloat16()
        with torch.no_grad():
            row = _compare(
                "fused_resblock", shape + (o,), path,
                lambda: frb.fused_gn_silu_conv(x, gs, gb, wt, cb, 32, 1e-5),
                lambda: frb._reference(x, gs, gb, wt, cb, 32, 1e-5),
                (2 * b * h * w * 9 * c * o,
                 b * h * w * (c + o) * 2 + 9 * c * o * 2, PEAK_BF16),
                lambda: F.conv2d(F.silu(F.group_norm(
                    x.permute(0, 3, 1, 2), 32, lib_gs, lib_gb, 1e-5)),
                    wt, cb, padding=1))
        row["launches_per_chain_run"] = runs
        rows.append(row)
    return rows


def resblock_gradient_check(dev) -> float:
    """K7's autograd.Function against autograd of its twin at one shape.
    The backward recomputes the twin, so only the order of cuDNN's float32
    sums in the conv backward differs; the gradients of x, the weights and
    the conv bias are bf16, where that order flips roundings by one bf16
    step (2^-8 of an element). Bound: two steps of max|gradient|, 8e-3
    (measured on an H100 (700 W): 9.6e-5 and 1.9e-4 in two runs)."""
    from upgpt_torch.ops import fused_resblock as frb

    g = torch.Generator(device=dev).manual_seed(40)
    c = o = 448
    x = (2 * torch.randn(CHAIN_BATCH, 16, 12, c, generator=g, device=dev)
         + 0.5).bfloat16()
    gs = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    gb = 0.1 * torch.randn(c, generator=g, device=dev)
    wt = (torch.randn(o, c, 3, 3, generator=g, device=dev)
          / math.sqrt(9 * c)).bfloat16()
    cb = (0.1 * torch.randn(o, generator=g, device=dev)).bfloat16()
    leaves = [a.detach().requires_grad_() for a in (x, gs, gb, wt, cb)]
    out = frb.fused_gn_silu_conv(*leaves, 32, 1e-5)
    ct = torch.randn(out.shape, generator=g, device=dev).bfloat16()
    got = torch.autograd.grad(out, leaves, ct)
    ref = [a.detach().requires_grad_() for a in (x, gs, gb, wt, cb)]
    want = torch.autograd.grad(frb._reference(*ref, 32, 1e-5), ref, ct)
    rel = max((a.float() - b.float()).abs().max().item()
              / b.float().abs().max().item() for a, b in zip(got, want))
    print(f"fused_resblock gradient vs autograd of the twin "
          f"{(CHAIN_BATCH, 16, 12, c, o)}: max|d|/max|ref| {rel:.3e}",
          flush=True)
    if rel > 8e-3:
        raise RuntimeError(f"fused_resblock gradient disagrees: {rel:.3e}")
    return rel


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


def _train_batch(model, b: int, dev, seed: int) -> dict:
    """The batch benchmarks/bench_train.py feeds: 0.3 N(0, 1) images at
    the VAE's input size, unit loss weights."""
    h, w = model.config.latent_size
    f = 2 ** (len(model.config.vae.ch_mult) - 1)
    batch = _batch(b, h, w, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    batch["image"] = 0.3 * torch.randn(b, f * h, f * w, 3, generator=g,
                                       device=dev)
    batch["loss_w"] = torch.ones(b, h, w, 1, device=dev)
    return batch


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _rel_l2_lists(xs, ys) -> float:
    num = sum((x.float() - y.float()).square().sum() for x, y in zip(xs, ys))
    den = sum(y.float().square().sum() for y in ys)
    return (num / den).sqrt().item()


def _counters():
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_gn as fg
    from upgpt_torch.ops import fused_resblock as frb
    from upgpt_torch.ops import fused_transformer as ft
    from upgpt_torch.ops import selfattn_leg as sl

    return {"fused_transformer_block": ft.fused_transformer_block,
            "flash_attention": fa.flash_attention,
            "flash_backward_dq": fa.flash_backward_dq,
            "flash_backward_dkv": fa.flash_backward_dkv,
            "fused_group_norm": fg.fused_group_norm,
            "tiled_group_norm": fg.tiled_group_norm,
            "fused_resblock": frb.fused_gn_silu_conv,
            "selfattn_fullwidth": sl.selfattn_fullwidth,
            "selfattn_perhead": sl.selfattn_perhead}


def _routes():
    """The counted routes away from a kernel: (key, function, attribute):
    the flash forward's and backward's FMA instantiations (float32, and
    bf16 beyond D = 128 in the backward) and the half-step kernel's
    float32 instantiation, which no path should reach, the
    flash backward's plain autograd beyond its gate, fused GroupNorms and
    level-2 ResBlock half-steps that their gates send to the plain path."""
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import fused_gn as fg
    from upgpt_torch.ops import fused_resblock as frb

    return [("flash_attention_fma", fa.flash_attention, "fma_launches"),
            ("flash_backward_dq_fma", fa.flash_backward_dq, "fma_launches"),
            ("flash_backward_dkv_fma", fa.flash_backward_dkv,
             "fma_launches"),
            ("flash_reference_backwards", fa.flash_attention,
             "reference_backwards"),
            ("fused_group_norm_plain_routes", fg.fused_group_norm,
             "plain_routes"),
            ("fused_resblock_plain_routes", frb.fused_gn_silu_conv,
             "plain_routes"),
            ("fused_resblock_fp32", frb.fused_gn_silu_conv,
             "fp32_launches")]


# every path runs bf16: no launch of the flash kernels' FMA instantiations
# or of the half-step kernel's float32 one
_NO_FMA = {"flash_attention_fma": 0, "flash_backward_dq_fma": 0,
           "flash_backward_dkv_fma": 0, "fused_resblock_fp32": 0}
# the self-attention leg's kernels run only in the micro-benchmark
_NO_SELFATTN = {"selfattn_fullwidth": 0, "selfattn_perhead": 0}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
    for name in ("fused_resblock", "fused_group_norm", "tiled_group_norm"):
        _counters()[name].launches_by_shape = {}
    _counters()["fused_group_norm"].clusters = 0
    for _, fn, attr in _routes():
        setattr(fn, attr, 0)


def _gn_by_shape(counts: dict) -> dict:
    """K5's and K6's launches by ((N, H, W, C), kernel) since the last
    reset, checked against their launch counts, and K5's clusters against
    one per image of every launch."""
    fns = _counters()
    out = {(shape, name): n
           for name in ("fused_group_norm", "tiled_group_norm")
           for shape, n in fns[name].launches_by_shape.items()}
    for name in ("fused_group_norm", "tiled_group_norm"):
        if sum(n for (_, k), n in out.items() if k == name) != counts[name]:
            raise RuntimeError(f"{name} launches by shape {out} against "
                               f"{counts[name]}")
    clusters = sum(shape[0] * n for (shape, k), n in out.items()
                   if k == "fused_group_norm")
    if fns["fused_group_norm"].clusters != clusters:
        raise RuntimeError(f"fused_group_norm launched "
                           f"{fns['fused_group_norm'].clusters} clusters, "
                           f"{clusters} expected")
    return out


def _read_counts() -> dict:
    from upgpt_torch.utils.diagnostics import kernel_launches

    return kernel_launches()


def slice_run(dev, card: str) -> dict:
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.models.unet import precompute_cross_kv
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
    print(f"sampling end to end (batch 2): eps rel L2 "
          f"{e2e['eps_rel_l2']:.3e}, 4-step latents rel L2 "
          f"{e2e['latent_rel_l2']:.3e}, decoded image rel L2 "
          f"{e2e['image_rel_l2']:.3e}", flush=True)
    if (e2e["eps_rel_l2"] > EPS_REL_L2 or e2e["latent_rel_l2"] > LATENT_REL_L2
            or e2e["image_rel_l2"] > IMAGE_REL_L2):
        raise RuntimeError(f"kernel path disagrees with plain path: {e2e}")
    del plain

    # --- the sampling path: DDIM-50, eta 1, batch 8, uint8 ---
    pipe = GenerationPipeline(model, num_steps=STEPS, eta=1.0,
                              output_uint8=True)
    batch = _batch(BATCH, h, w, dev, seed=4)
    t0 = time.perf_counter()
    pipe.generate(batch, torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    print(f"sampling warm-up run: {time.perf_counter() - t0:.3f} s",
          flush=True)
    times, counts = [], []
    for i in range(TIMED_RUNS):
        gen = torch.Generator(device=dev).manual_seed(10 + i)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = pipe.generate(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(_read_counts())
        if tuple(out.shape) != (BATCH, 256, 192, 3) or out.dtype != torch.uint8:
            raise RuntimeError(f"output {tuple(out.shape)} {out.dtype}")
        if out.min().item() == out.max().item():
            raise RuntimeError("output image is constant")
    # 10 qualifying SpatialTransformers per U-Net eval; the VAE decoder's mid
    # AttnBlock once per decode; nothing of the training kernels
    expected = {"fused_transformer_block": 10 * STEPS, "flash_attention": 1,
                "flash_backward_dq": 0, "flash_backward_dkv": 0,
                "fused_group_norm": 0, "tiled_group_norm": 0,
                "fused_resblock": 0, "flash_reference_backwards": 0,
                "fused_group_norm_plain_routes": 0,
                "fused_resblock_plain_routes": 0, **_NO_FMA, **_NO_SELFATTN}
    if any(c != expected for c in counts):
        raise RuntimeError(f"sampling launch counts {counts}, expected "
                           f"{expected} per run")
    sec = min(times)
    print(f"DDIM-{STEPS} eta 1 batch {BATCH} -> uint8 {tuple(out.shape)}: "
          f"{' '.join(f'{t:.4f}' for t in times)} s/batch, best {sec:.4f} "
          f"s/batch = {BATCH / sec:.3f} img/s on {card}", flush=True)
    return model, {"launches": counts[0], "s_per_batch": times,
                   "img_per_s": BATCH / sec, **e2e}


def unipc_run(dev, card: str, model) -> dict:
    """UniPC-8 and DPM++(2M)-8 on the karras grid, on the sampling phase's
    weights: kernel path against plain path at batch 2, then UniPC-8-karras
    at batch 64 to uint8, the best of three runs after a warm-up."""
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.zoo import build_latent_diffusion

    plain = build_latent_diffusion(
        "interp_256", dtype="bfloat16", device=dev,
        use_flash_attention=False, use_fused_transformer=False)
    plain.load_state_dict(model.state_dict())
    h, w = model.config.latent_size
    small = _batch(2, h, w, dev, seed=60)
    x_t = torch.randn(2, h, w, 4, generator=torch.Generator(
        device=dev).manual_seed(61), device=dev)
    e2e = {}
    with torch.inference_mode():
        for sampler, tag in (("unipc", "unipc"), ("dpm++", "dpmpp")):
            lat, img = {}, {}
            for path, m in (("kernel", model), ("plain", plain)):
                pipe = GenerationPipeline(
                    m, num_steps=UNIPC_STEPS, eta=0.0, sampler=sampler,
                    schedule_method="karras", decode=False)
                lat[path] = pipe.generate(small, x_T=x_t)
                if sampler == "unipc":
                    img[path] = m.decode_first_stage(lat[path])
            for val in list(lat.values()) + list(img.values()):
                if not torch.isfinite(val).all():
                    raise RuntimeError(f"{sampler}: non-finite output")
            e2e[f"{tag}_latent_rel_l2"] = _rel_l2(lat["kernel"], lat["plain"])
            if img:
                e2e[f"{tag}_image_rel_l2"] = _rel_l2(img["kernel"],
                                                     img["plain"])
    print(f"UniPC-{UNIPC_STEPS} / DPM++-{UNIPC_STEPS} karras end to end "
          f"(batch 2): {', '.join(f'{k} {v:.3e}' for k, v in e2e.items())}",
          flush=True)
    if (max(v for k, v in e2e.items() if "latent" in k) > LATENT_REL_L2
            or e2e["unipc_image_rel_l2"] > IMAGE_REL_L2):
        raise RuntimeError(f"UniPC/DPM++ kernel path disagrees with plain "
                           f"path: {e2e}")
    del plain
    torch.cuda.empty_cache()

    # --- bench.py's second row: UniPC-8-karras, eta 0, batch 64, uint8 ---
    pipe = GenerationPipeline(model, num_steps=UNIPC_STEPS, eta=0.0,
                              sampler="unipc", schedule_method="karras",
                              output_uint8=True)
    batch = _batch(UNIPC_BATCH, h, w, dev, seed=62)
    t0 = time.perf_counter()
    pipe.generate(batch, torch.Generator(device=dev).manual_seed(63))
    torch.cuda.synchronize()
    print(f"UniPC warm-up run: {time.perf_counter() - t0:.3f} s", flush=True)
    times, counts = [], []
    for i in range(TIMED_RUNS):
        gen = torch.Generator(device=dev).manual_seed(64 + i)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = pipe.generate(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(_read_counts())
        if (tuple(out.shape) != (UNIPC_BATCH, 256, 192, 3)
                or out.dtype != torch.uint8):
            raise RuntimeError(f"UniPC output {tuple(out.shape)} {out.dtype}")
        if out.min().item() == out.max().item():
            raise RuntimeError("UniPC output image is constant")
    # ten K1 launches a U-Net eval, one flash forward for the decode
    expected = {k: 0 for k in counts[0]}
    expected.update(fused_transformer_block=10 * pipe.num_steps,
                    flash_attention=1)
    if any(c != expected for c in counts):
        raise RuntimeError(f"UniPC launch counts {counts}, expected "
                           f"{expected} per run")
    sec = min(times)
    print(f"UniPC-{pipe.num_steps}-karras eta 0 batch {UNIPC_BATCH} -> uint8 "
          f"{tuple(out.shape)}: {' '.join(f'{t:.4f}' for t in times)} "
          f"s/batch, best {sec:.4f} s/batch = {UNIPC_BATCH / sec:.3f} img/s "
          f"on {card}", flush=True)
    return {"launches": counts[0], "num_steps": pipe.num_steps,
            "s_per_batch": times, "img_per_s": UNIPC_BATCH / sec, **e2e}


def _leg_launch_ms(call, calls: int = 20) -> dict:
    """Device ms of each of the leg's three launches, averaged over `calls`
    calls of the whole leg under the profiler: each kernel's own device
    activity, matched to its launch by the order one call makes them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and any(m in e.name for _, m in SELFATTN_LAUNCHES))
    parts = len(SELFATTN_LAUNCHES)
    if len(spans) != parts * calls or any(
            SELFATTN_LAUNCHES[i % parts][1] not in name
            for i, (_, _, name) in enumerate(spans)):
        raise RuntimeError(f"the profiler saw {len(spans)} of the leg's "
                           f"{parts * calls} launches, or not in their order")
    return {part: sum(e - s for s, e, _ in spans[i::parts]) / calls / 1e3
            for i, (part, _) in enumerate(SELFATTN_LAUNCHES)}


def selfattn_checks(dev) -> dict:
    """K8 and K9 against their twins at micro_block's geometry and at a
    ragged T, timed beside `F.multi_head_attention_forward` (the three
    (C, C) weights transposed and stacked as `in_proj_weight`, `wo`
    transposed with `bo` as the out projection): one PyTorch call of the
    same function. Bound: the four products and QK^T / PV on the tensor
    cores against x, the weights and the output once; `exp_ms` is the
    softmax's B H T^2 exponentials at the SFU rate. Then each kernel twice
    bit for bit and on two streams at once, and each of its three
    launches (Q/K/V, flash, to_out) from the profiler over whole calls;
    beside them, for scale, K3's flash routine alone on the same heads
    and, printed only, the parent's recorded device time. Each kernel
    must run below the library's device time.

    The inputs are unit-scale (x N(0, 1), weights N(0, 1/C), bias
    0.1 N(0, 1)), so the scores q.k/sqrt(dh) are O(1) and a wrong Q/K
    product, scale, head offset or key mask moves the output far past the
    tolerance. micro_block's own 0.1 / 0.03 scales make the softmax
    uniform to 0.2% and leave the bias as most of the output, which is
    why they serve for timing only."""
    from upgpt_torch.benchmarks.micro_block import rel_err
    from upgpt_torch.ops import flash_attention as fa
    from upgpt_torch.ops import selfattn_leg as sl

    g = torch.Generator(device=dev).manual_seed(70)
    cases = {"selfattn_fullwidth": [], "selfattn_perhead": []}
    for (b, t, c, heads), path in SELFATTN_SHAPES:
        x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
        attn1 = {n: {"kernel": (torch.randn(c, c, generator=g, device=dev)
                                / math.sqrt(c)).bfloat16().float().cpu()
                     .numpy()} for n in ("to_q", "to_k", "to_v", "to_out")}
        attn1["to_out"]["bias"] = (0.1 * torch.randn(
            c, generator=g, device=dev)).bfloat16().float().cpu().numpy()
        full, per_head = sl.selfattn_weights(attn1, heads, torch.bfloat16,
                                             dev)
        wq, wk, wv, wo, bo = full
        in_proj = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()
        out_w, out_b = wo.t().contiguous(), bo.reshape(-1).bfloat16()
        xt = x.transpose(0, 1)

        def library():
            return F.multi_head_attention_forward(
                xt, xt, xt, c, heads, in_proj, None, None, None, False, 0.0,
                out_w, out_b, training=False, need_weights=False)[0]

        work = (8 * b * t * c * c + 4 * b * t * t * c,
                2 * (2 * b * t * c + 4 * c * c) + 4 * c, PEAK_BF16)
        exp_ms = b * heads * t * t / PEAK_EXP * 1e3
        # K3's flash routine (csrc/flash_attention.cu) alone on contiguous
        # heads of the same shape, which the leg's first version launched:
        # a yardstick for the leg's own flash pass
        qkv = [torch.randn(b, heads, t, c // heads, generator=g,
                           device=dev).bfloat16() for _ in range(3)]
        attention_ms = _graph_ms(lambda: fa.flash_attention(*qkv))
        if attention_ms is None:
            raise RuntimeError("K3's flash routine could not be captured in "
                               "a CUDA graph")
        print(f"  K3's flash routine alone {(b, heads, t, c // heads)}: "
              f"{attention_ms:.4f} ms in a CUDA graph", flush=True)
        with torch.no_grad():
            for name, kernel, plain in (
                    ("selfattn_fullwidth",
                     lambda: sl.selfattn_fullwidth(x, *full, heads),
                     lambda: sl.selfattn_fullwidth_reference(x, *full, heads)),
                    ("selfattn_perhead",
                     lambda: sl.selfattn_perhead(x, *per_head),
                     lambda: sl.selfattn_perhead_reference(x, *per_head))):
                row = _compare(name, (b, t, c, heads), path, kernel, plain,
                               work, library)
                row["exp_ms"] = exp_ms
                row["attention_device_ms"] = attention_ms
                row["launch_device_ms"] = each = _leg_launch_ms(kernel)
                print(f"  {name} {(b, t, c, heads)} launches by the "
                      f"profiler: " + ", ".join(f"{k} {v:.4f} ms"
                                                for k, v in each.items())
                      + "; the parent's call "
                      f"{SELFATTN_RECORDED_PARENT_MS[(name, t)]:.4f} ms as "
                      f"recorded in its PR (not this run)", flush=True)
                lib_dev = row["library_device_ms"]
                if lib_dev is None or not row["device_ms"] < lib_dev:
                    raise RuntimeError(
                        f"{name} {(b, t, c, heads)}: {row['device_ms']} ms "
                        f"of device time, not below the library's {lib_dev}")
                want = kernel()
                streams = [torch.cuda.Stream() for _ in range(2)]
                got = [kernel()]
                for st in streams:
                    st.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(st):
                        got.append(kernel())
                torch.cuda.synchronize()
                if not all(torch.equal(a, want) for a in got):
                    raise RuntimeError(f"{name} {(b, t, c, heads)}: repeated "
                                       f"calls differ")
                row["bit_for_bit"] = True
                print(f"  {name} {(b, t, c, heads)}: bit for bit over three "
                      f"calls, two of them on two streams at once; the "
                      f"softmax's exponentials alone {exp_ms:.4f} ms at the "
                      f"SFU rate", flush=True)
                cases[name].append(row)
            rel = rel_err(sl.selfattn_perhead(x, *per_head),
                          sl.selfattn_fullwidth(x, *full, heads))
            print(f"  K9 against K8 {(b, t, c, heads)}: max|d|/max|ref| "
                  f"{rel:.3e}", flush=True)
            if rel > SELFATTN_K9_K8_TOL:
                raise RuntimeError(f"K9 and K8 disagree at {(b, t, c, heads)}"
                                   f": {rel:.3e} > {SELFATTN_K9_K8_TOL}")
            for name in cases:
                cases[name][-1]["k9_vs_k8_rel_err"] = rel
        del x, full, per_head, in_proj, qkv
        torch.cuda.empty_cache()
    return cases


def micro_block_run() -> dict:
    """The ported micro-benchmark's entry point at its defaults, on the
    card, with its launches counted."""
    from upgpt_torch.benchmarks import micro_block

    torch.cuda.synchronize()
    _reset_counts()
    result = micro_block.main(["--iters", "5"])
    torch.cuda.synchronize()
    counts = _read_counts()
    for name in ("selfattn_fullwidth", "selfattn_perhead",
                 "fused_transformer_block"):
        if counts[name] == 0:
            raise RuntimeError(f"micro_block launched no {name}")
    # At micro_block's 0.1 / 0.03 scales the softmax is uniform to 0.2%,
    # so this holds the entry point's plumbing only; selfattn_checks holds
    # K8 and K9 to their twins on unit-scale inputs.
    for name in ("selfattn_fullwidth", "selfattn_perhead",
                 "fused_full_block"):
        if result["rel_err"][name] > KERNEL_REL_TOL:
            raise RuntimeError(f"micro_block: {name} disagrees with its twin "
                               f"{result['rel_err']}")
    return {"launches": counts, "ms": result["ms"],
            "rel_err": result["rel_err"]}


def context_tokens(model) -> int:
    """The cross-attention context's length for `model`: 77 text tokens,
    then 9 style tokens unless the text-style fusion takes them in, then
    the pose token where there is a pose stage (87 for interp_256, 78 for
    inshop_laion, 86 for the upscale stage)."""
    cfg = model.config
    return 77 + (0 if cfg.cond_fusion else 9) + (1 if cfg.pose_input_dim
                                                 else 0)


def expected_train_counts(model, b: int = TRAIN_BATCH,
                          backward: bool = True) -> dict:
    """Kernel launches per train step (`backward`) or per validation
    forward, from the model's structure: every SpatialTransformer the
    fused kernel takes; every ResBlock GroupNorm+SiLU and the out head the
    GroupNorm kernel takes; the flash forward for the VAE encoder's
    attention and, in K1's recompute backward, for each fused block whose
    self-attention the flash gate takes, which also runs each backward
    pass once. With `use_checkpoint` the backward first runs every
    ResBlock's and SpatialTransformer's forward again: K1 and the
    ResBlocks' GroupNorms launch twice a step (the out head's once)."""
    from upgpt_torch.models.unet import cross_attention_layers
    from upgpt_torch.ops.flash_attention import flash_attention_qualifies
    from upgpt_torch.ops.fused_gn import fused_group_norm_qualifies
    from upgpt_torch.ops.fused_transformer import fused_transformer_qualifies

    cfg = model.config
    ucfg = model.unet.config
    h, w = cfg.latent_size
    heads = ucfg.num_heads
    tk = context_tokens(model)
    # forwards a step of each remat'd module: the step's, and with
    # use_checkpoint the backward's recompute
    runs = 1 + int(backward and ucfg.use_checkpoint)
    fused = recompute = 0
    for name, ch in cross_attention_layers(ucfg):
        s = 2 ** _level(ucfg, name)
        t = (h // s) * (w // s)
        if fused_transformer_qualifies(t, ch, heads, tk):
            fused += 1
            recompute += backward and flash_attention_qualifies(
                b, heads, t, t, ch // heads, ucfg.dtype)
    res_norms = []
    for kind, name in model.unet._plan:
        if kind == "res":
            s = 2 ** _level(ucfg, name)
            blk = getattr(model.unet, name)
            res_norms += [(b, h // s, w // s, norm.weight.numel())
                          for norm in (blk.norm_in, blk.norm_out)]
    head = (b, h, w, model.unet.out_norm.weight.numel())
    gn_res = sum(fused_group_norm_qualifies(x, 32) for x in res_norms)
    gn_head = int(fused_group_norm_qualifies(head, 32))
    vae = cfg.vae
    c_mid = vae.ch * vae.ch_mult[-1]
    encoder_flash = int(vae.use_flash_attention and flash_attention_qualifies(
        b, 1, h * w, h * w, c_mid, vae.dtype))
    return {"fused_transformer_block": runs * fused,
            "flash_attention": encoder_flash + recompute,
            "flash_backward_dq": recompute, "flash_backward_dkv": recompute,
            "fused_group_norm": runs * gn_res + gn_head,
            "tiled_group_norm": 0, "fused_resblock": 0,
            "flash_reference_backwards": 0,
            "fused_group_norm_plain_routes": (
                runs * (len(res_norms) - gn_res) + 1 - gn_head),
            "fused_resblock_plain_routes": 0, **_NO_FMA, **_NO_SELFATTN}


def step_kernel_vs_plain(model, plain, dev, seed: int, label: str) -> dict:
    """One AdamW step of `model` (kernels on) and `plain` (kernels off) on
    the same weights, batch (2) and draws, held to the TRAIN_* gates."""
    from upgpt_torch.training.train_state import create_train_state, train_step

    plain.load_state_dict(model.state_dict())
    small = _train_batch(model, 2, dev, seed=seed)
    draws = model.training_draws(2, torch.Generator(device=dev).manual_seed(
        seed + 1))
    result = {}
    for tag, m in (("kernel", model), ("plain", plain)):
        # no warm-up here: the default schedule's first step is at 1e-6 of
        # the LR, an update below float32's resolution of the parameters
        st = create_train_state(m, LEARNING_RATE, scheduler=lambda step: 1.0)
        before = [p.detach().clone() for p in st.params]
        st, metrics = train_step(m, st, small, draws=draws)
        if not torch.isfinite(metrics["loss"]):
            raise RuntimeError(f"{tag} path: non-finite training loss")
        result[tag] = (metrics["loss"].item(),
                       [p.grad for p in st.params], before, st.params)
    del st
    (lk, gk, bk, pk), (lp, gp, bp, pp) = result["kernel"], result["plain"]
    e2e = {"train_loss_rel": abs(lk - lp) / abs(lp),
           "train_grad_rel_l2": _rel_l2_lists(gk, gp),
           "train_param_rel_l2": _rel_l2_lists(pk, pp),
           "train_update_rel_l2": _rel_l2_lists(
               [a - b for a, b in zip(pk, bk)],
               [a - b for a, b in zip(pp, bp)])}
    print(f"{label} end to end (batch 2, one AdamW step): loss kernel "
          f"{lk:.6f} plain {lp:.6f} (rel {e2e['train_loss_rel']:.3e}), "
          f"gradient rel L2 {e2e['train_grad_rel_l2']:.3e}, parameters rel "
          f"L2 {e2e['train_param_rel_l2']:.3e}, update rel L2 "
          f"{e2e['train_update_rel_l2']:.3e}", flush=True)
    if (e2e["train_loss_rel"] > TRAIN_LOSS_REL
            or e2e["train_grad_rel_l2"] > TRAIN_GRAD_REL_L2
            or e2e["train_param_rel_l2"] > TRAIN_PARAM_REL_L2
            or e2e["train_update_rel_l2"] > TRAIN_UPDATE_REL_L2):
        raise RuntimeError(f"{label}: kernel path disagrees with plain "
                           f"path: {e2e}")
    model.zero_grad(set_to_none=True)
    return e2e


def train_run(dev, card: str) -> dict:
    from upgpt_torch.training.train_state import create_train_state, train_step
    from upgpt_torch.zoo import build_latent_diffusion

    def build(kernels: bool):
        return build_latent_diffusion(
            "interp_256", dtype="bfloat16", param_dtype="float32",
            device=dev, use_flash_attention=kernels,
            use_fused_transformer=kernels, use_fused_groupnorm=kernels)

    model = build(True)
    _redraw(model, seed=21, dev=dev)

    # --- one step, kernel path vs plain path, batch 2 ---
    plain = build(False)
    e2e = step_kernel_vs_plain(model, plain, dev, 22, "training")
    del plain

    # --- the training path: batch 12, one warm-up and five timed steps ---
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    state = create_train_state(model, LEARNING_RATE)
    start = [p.detach().clone() for p in state.params]
    batch = _train_batch(model, TRAIN_BATCH, dev, seed=24)
    gen = torch.Generator(device=dev).manual_seed(25)
    expected = expected_train_counts(model)
    t0 = time.perf_counter()
    state, metrics = train_step(model, state, batch, gen)
    torch.cuda.synchronize()
    print(f"training warm-up step: {time.perf_counter() - t0:.3f} s, loss "
          f"{metrics['loss'].item():.6f}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    times, counts, losses, gn_shapes = [], [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(model, state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(_read_counts())
        gn_shapes.append(_gn_by_shape(counts[-1]))
        losses.append(metrics["loss"].item())
        if not math.isfinite(losses[-1]):
            raise RuntimeError(f"non-finite training loss {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if any(c != expected for c in counts) or any(
            d != GN_LAUNCHES["training"] for d in gn_shapes):
        raise RuntimeError(f"training launch counts {counts}, expected "
                           f"{expected} per step; GroupNorm by shape "
                           f"{gn_shapes}")
    moved = sum(not torch.equal(a, p) for a, p in zip(start, state.params))
    shadow = sum(not torch.equal(a, s) for a, s in zip(start, state.ema.shadow))
    if moved == 0 or shadow == 0:
        raise RuntimeError(f"after {state.step} steps {moved} parameters and "
                           f"{shadow} EMA tensors changed")
    ms = 1e3 * min(times)
    print(f"train step interp_256 batch {TRAIN_BATCH} (bf16 compute, float32 "
          f"masters, AdamW + EMA): {' '.join(f'{1e3 * t:.2f}' for t in times)}"
          f" ms/step, best {ms:.2f} ms/step = {TRAIN_BATCH / ms * 1e3:.3f} "
          f"img/s on {card}; losses {' '.join(f'{x:.6f}' for x in losses)}; "
          f"{moved}/{len(start)} parameters and {shadow} EMA tensors moved; "
          f"peak memory {peak_gb:.3f} GiB; launches per step {counts[0]}",
          flush=True)
    return {"launches": counts[0], "gn_by_shape": gn_shapes[0],
            "ms_per_step": [1e3 * t for t in times],
            "img_per_s": TRAIN_BATCH / ms * 1e3, "losses": losses,
            "peak_memory_gib": peak_gb, **e2e}


# the distill phase: `cli distill --synthetic` at interp_256's full width
# from a re-drawn teacher (float32 masters, bf16 compute, the training
# kernels on), 8 -> 4 -> 2 steps on the karras grid, two adapt updates and
# three a stage at batch 12; then the student chained 2 -> 1, sampled by
# `cli sample` and served through `cli._build_serving` on its grid
DISTILL_BATCH, DISTILL_START, DISTILL_END = 12, 8, 2
DISTILL_STAGE_STEPS, DISTILL_ADAPT_STEPS, DISTILL_CHAIN_STEPS = 3, 2, 2
# One distillation update at batch 2, kernel path vs plain path on the same
# float32 masters, batch and draws (the teacher eps, the student its v
# copy): |loss difference| / loss and the relative L2 of the update
# (parameters after minus before). The teacher's two sub-steps and the
# student each round to bf16 at different places on the two paths, and
# the x target divides by a_next - (s_next / s_t) a_t, which can amplify
# that difference; the update is Adam's first step, about lr *
# sign(gradient), which flips wherever a gradient entry is below that
# noise, as in the train step. Measured on an H100 (700 W): 1.091e-4
# (loss) and 0.1448 (update), so each bound has a margin of 3x or more.
DISTILL_LOSS_REL = 5e-4
DISTILL_UPDATE_REL_L2 = 0.5


def expected_distill_counts(model, b: int = DISTILL_BATCH,
                            teacher_evals: int = 2) -> dict:
    """Kernel launches per distillation update (`teacher_evals` 2) or
    eps->v adaptation update (1), from the model's structure: the
    student's forward and backward, as a train step launches them
    (`expected_train_counts`, one VAE encode shared by both models), and
    the teacher's U-Net forwards under no_grad: K1 for each fused block
    (`kv=None`, with nothing saved for a backward, so no recompute and no
    K4) and K5 for each GroupNorm its gate takes."""
    step = expected_train_counts(model, b)
    forward = expected_train_counts(model, b, backward=False)
    for key in ("fused_transformer_block", "fused_group_norm",
                "fused_group_norm_plain_routes"):
        step[key] += teacher_evals * forward[key]
    return step


def distill_kernel_vs_plain(model, plain, dev, seed: int) -> dict:
    """One distillation update (stage 0 of DISTILL_START -> DISTILL_START
    / 2, the teacher eps, the student its v copy) with the kernels on
    (`model`) and off (`plain`) on the same weights, batch (2) and draws,
    held to the DISTILL_* gates."""
    from upgpt_torch.training import distill as td
    from upgpt_torch.training.train_state import create_train_state

    plain.load_state_dict(model.state_dict())
    small = _train_batch(model, 2, dev, seed=seed)
    grids = td.make_distill_grids(model.schedule, DISTILL_START, DISTILL_END,
                                  method="karras")
    tables = td.make_stage_tables(model.schedule, grids[0])
    result = {}
    for tag, teacher in (("kernel", model), ("plain", plain)):
        student = td.v_student(teacher)
        teacher.requires_grad_(False)
        draws = td.distill_draws(student, 2, tables.num_steps,
                                 torch.Generator(device=dev).manual_seed(
                                     seed + 1))
        st = create_train_state(student, LEARNING_RATE,
                                scheduler=lambda step: 1.0, use_ema=False,
                                weight_decay=0.0)
        before = [p.detach().clone() for p in st.params]
        st, metrics = td.distill_step(student, st, teacher, "eps", small,
                                      tables, draws=draws)
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"{tag} path: non-finite distill metrics "
                               f"{metrics}")
        result[tag] = ({k: v.item() for k, v in metrics.items()},
                       [a.detach() - b for a, b in zip(st.params, before)])
        del st, student, before
    (mk, uk), (mp, up) = result["kernel"], result["plain"]
    e2e = {"distill_loss_rel": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
           "distill_update_rel_l2": _rel_l2_lists(uk, up),
           "teacher_gap_kernel": mk["teacher_gap"],
           "teacher_gap_plain": mp["teacher_gap"]}
    print(f"distill end to end (batch 2, one update, {len(grids[0])} -> "
          f"{tables.num_steps} steps): loss kernel {mk['loss']:.6f} plain "
          f"{mp['loss']:.6f} (rel {e2e['distill_loss_rel']:.3e}), x-mse "
          f"kernel {mk['loss_x']:.6f} plain {mp['loss_x']:.6f}, teacher "
          f"gap kernel {mk['teacher_gap']:.6f} plain "
          f"{mp['teacher_gap']:.6f}, update rel L2 "
          f"{e2e['distill_update_rel_l2']:.3e}", flush=True)
    if (e2e["distill_loss_rel"] > DISTILL_LOSS_REL
            or e2e["distill_update_rel_l2"] > DISTILL_UPDATE_REL_L2):
        raise RuntimeError(f"distill: kernel path disagrees with plain "
                           f"path: {e2e}")
    model.zero_grad(set_to_none=True)
    return e2e


def _distill_cli(args: list, expected: dict, adapt: int, stages: int):
    """`cli distill` in-process with its two step functions wrapped: every
    update's launches against `expected` ({"adapt", "distill"}), the run's
    against their sum. Returns (result, adapt ms, distill ms, run
    launches), the ms from CUDA events around each update."""
    from upgpt_torch import cli
    from upgpt_torch.training import distill as td

    probes = {"adapt": _StepProbe(td.adapt_step, "adapt_step"),
              "distill": _StepProbe(td.distill_step, "distill_step")}
    td.adapt_step, td.distill_step = probes["adapt"], probes["distill"]
    try:
        torch.cuda.synchronize()
        _reset_counts()
        result = cli.main(args)
        torch.cuda.synchronize()
        counts = _read_counts()
    finally:
        td.adapt_step, td.distill_step = probes["adapt"].fn, probes[
            "distill"].fn
    for kind, n in (("adapt", adapt), ("distill", stages)):
        got = [r["launches"] for r in probes[kind].records]
        if len(got) != n or any(c != expected[kind] for c in got):
            raise RuntimeError(f"cli distill {kind} updates: {len(got)} "
                               f"({n} expected), launches {got[:2]}, "
                               f"expected {expected[kind]} per update")
    want = {k: adapt * expected["adapt"][k] + stages * expected["distill"][k]
            for k in counts}
    if counts != want:
        raise RuntimeError(f"cli distill launches {counts}, expected {want}")
    return result, probes["adapt"].ms(), probes["distill"].ms(), counts


def distill_run(dev, card: str) -> dict:
    """The distill phase in a temporary directory under
    `upgpt_torch/_build`, removed after: kernel vs plain for one update,
    `cli distill --synthetic` from a teacher checkpoint it writes, the
    chained run from the student, `cli sample` and one served batch of the
    student. Returns the paths `distill_run` (both `cli distill` runs),
    `distill_sample` and `distill_serve`."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from upgpt_torch import cli
    from upgpt_torch.checkpoint import read_weights, save_checkpoint
    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.data.tree import write_fashion_tree
    from upgpt_torch.training import distill as td
    from upgpt_torch.zoo import build_latent_diffusion

    def build(kernels: bool):
        return build_latent_diffusion(
            "interp_256", dtype="bfloat16", param_dtype="float32",
            device=dev, use_flash_attention=kernels,
            use_fused_transformer=kernels, use_fused_groupnorm=kernels)

    t_phase = time.perf_counter()
    model = build(True)
    _redraw(model, seed=91, dev=dev)
    plain = build(False)
    e2e = distill_kernel_vs_plain(model, plain, dev, 92)
    del plain
    expected = {"adapt": expected_distill_counts(model, teacher_evals=1),
                "distill": expected_distill_counts(model)}
    grids = td.make_distill_grids(model.schedule, DISTILL_START, DISTILL_END,
                                  method="karras")
    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "configs", "deepfashion", "interp_256.yaml")
    build_dir = os.path.join(repo, "upgpt_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir, prefix="distill-")
    try:
        teacher = os.path.join(work, "teacher.pt")
        save_checkpoint(model, teacher)
        del model
        torch.cuda.empty_cache()
        tree = write_fashion_tree(os.path.join(work, "tree"),
                                  {"validation": (DISTILL_BATCH, 0)},
                                  seed=93)
        dotlist = [f"data.{s}.params.{k}={tree[v]}"
                   for s in ("train", "validation", "test")
                   for k, v in (("folder", "folder"),
                                ("data_file", "data_file"))]
        dotlist += [f"data.{s}.params.pair_file=['{tree['validation']}']"
                    for s in ("train", "validation", "test")]
        dotlist += [f"model.params.{k}=True" for k in FIT_KERNELS]
        student = os.path.join(work, "student.pt")

        # --- cli distill --synthetic: 8 -> 4 -> 2 ---
        stages = len(grids) - 1
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, adapt_ms, step_ms, counts = _distill_cli(
            ["distill", "--base", config, "--teacher-ckpt", teacher,
             "--out", student, "--start-steps", str(DISTILL_START),
             "--end-steps", str(DISTILL_END), "--stage-steps",
             str(DISTILL_STAGE_STEPS), "--adapt-steps",
             str(DISTILL_ADAPT_STEPS), "--batch", str(DISTILL_BATCH),
             "--grid", "karras", "--synthetic"] + dotlist, expected,
            DISTILL_ADAPT_STEPS, stages * DISTILL_STAGE_STEPS)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        meta = json.load(open(student + ".distill.json"))
        hist = meta["history"]
        if (meta["parameterization"] != "v"
                or meta["timesteps"] != grids[-1].tolist()
                or [(h["stage"], h["steps"]) for h in hist]
                != [(-1, DISTILL_START)] + [(i, len(g)) for i, g in
                                            enumerate(grids[1:])]
                or not all(math.isfinite(h["loss"]) for h in hist)):
            raise RuntimeError(f"cli distill sidecar {meta}")
        t_weights, _ = read_weights(teacher, dev)
        moved = sum(not torch.equal(t_weights[n], p.detach()) for n, p in
                    result["student"].named_parameters() if n in t_weights)
        if moved == 0:
            raise RuntimeError("the student's weights equal the teacher's")
        n_trainable = len(t_weights)
        del t_weights, result["student"]
        torch.cuda.empty_cache()
        print(f"cli distill --synthetic interp_256 batch {DISTILL_BATCH}, "
              f"{DISTILL_START} -> {DISTILL_END} steps on the karras grid "
              f"{grids[-1].tolist()}: adapt "
              f"{' '.join(f'{x:.2f}' for x in adapt_ms)} ms/update, distill "
              f"{' '.join(f'{x:.2f}' for x in step_ms)} ms/update (median "
              f"{float(np.median(step_ms)):.2f}); wall {wall:.3f} s split "
              f"{json.dumps(result['seconds'])}; peak "
              f"memory {peak_gb:.3f} GiB; {moved}/{n_trainable} tensors "
              f"moved; losses {[round(h['loss'], 6) for h in hist]}; "
              f"launches per distill update {expected['distill']}, per "
              f"adapt update {expected['adapt']} on {card}", flush=True)

        # --- chained: the student as the teacher, 2 -> 1 ---
        chained = os.path.join(work, "student1.pt")
        t0 = time.perf_counter()
        result2, _, chain_ms, counts2 = _distill_cli(
            ["distill", "--base", config, "--teacher-ckpt", student,
             "--out", chained, "--end-steps", "1", "--stage-steps",
             str(DISTILL_CHAIN_STEPS), "--batch", str(DISTILL_BATCH),
             "--synthetic"] + dotlist, expected, 0, DISTILL_CHAIN_STEPS)
        chain_wall = time.perf_counter() - t0
        meta2 = json.load(open(chained + ".distill.json"))
        if (meta2["parameterization"] != "v"
                or meta2["timesteps"] != grids[-1][1::2].tolist()
                or [(h["stage"], h["steps"]) for h in meta2["history"]]
                != [(0, 1)]):
            raise RuntimeError(f"chained cli distill sidecar {meta2}")
        del result2
        torch.cuda.empty_cache()
        print(f"cli distill chained from the student (v teacher, its grid "
              f"continued, no adapt phase): {meta['timesteps']} -> "
              f"{meta2['timesteps']}, {' '.join(f'{x:.2f}' for x in chain_ms)}"
              f" ms/update, wall {chain_wall:.3f} s", flush=True)

        # --- the student sampled: cli sample at batch 12, its 2-step grid
        out_dir = os.path.join(work, "samples")
        model_cfg = merge_configs([config], dotlist)["model"]
        with torch.device("meta"):
            meta_model = instantiate_from_config(
                {**model_cfg, "params": {**model_cfg["params"],
                                         "device": "meta"}})
        expected_sample = expected_sampling_counts(
            meta_model, DISTILL_BATCH, context_tokens(meta_model),
            len(grids[-1]))
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        imgs = cli.main(["sample", "--base", config, "--debug-encoder",
                         "--ckpt", student, "--batch", str(DISTILL_BATCH),
                         "--steps", "50", "--out", out_dir] + dotlist)
        sample_wall = time.perf_counter() - t0
        sample_counts = _read_counts()
        files = sorted(os.listdir(out_dir))
        shapes = {np.asarray(Image.open(os.path.join(out_dir, f))).shape
                  for f in files}
        if (len(files) != DISTILL_BATCH or shapes != {(256, 192, 3)}
                or not np.isfinite(imgs).all()):
            raise RuntimeError(f"cli sample wrote {files}, shapes {shapes}")
        if sample_counts != expected_sample:
            raise RuntimeError(f"student cli sample launches "
                               f"{sample_counts}, expected {expected_sample}")

        # --- the student served: one batch through cli._build_serving ---
        args = cli.parser().parse_args([
            "serve", "--ckpt", student, "--debug-encoder", "--batch",
            str(DISTILL_BATCH), "--steps", "50", "--host", "127.0.0.1",
            "--port", "0"])
        cfg = {"model": {"target": "upgpt_torch.zoo.build_latent_diffusion",
                         "params": {"variant": "interp_256",
                                    "dtype": "bfloat16"}}}
        engine, builder, label = cli._build_serving(cfg, args)
        if label != f"distilled-{len(grids[-1])} {grids[-1].tolist()}":
            raise RuntimeError(f"served student labelled {label!r}")
        served = engine.pipeline.model
        expected_serve = expected_sampling_counts(
            served, DISTILL_BATCH, context_tokens(served), len(grids[-1]))
        rng = np.random.default_rng(94)
        batch = engine._pack([([builder.build(
            {"txt": f"a person in outfit {i}", "seed": i,
             "smpl": rng.normal(size=(1, 85)).tolist()})], None, None)
            for i in range(DISTILL_BATCH)])
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        host = engine.fetch(*engine.dispatch(batch, 95))
        serve_s = time.perf_counter() - t0
        serve_counts = _read_counts()
        if (host.shape != (DISTILL_BATCH, 256, 192, 3)
                or host.min() == host.max()):
            raise RuntimeError(f"served student batch {host.shape}, range "
                               f"{host.min()}..{host.max()}")
        if serve_counts != expected_serve:
            raise RuntimeError(f"served student launches {serve_counts}, "
                               f"expected {expected_serve}")
        del engine, builder, served
        print(f"the student sampled: cli sample {DISTILL_BATCH} JPEGs of "
              f"256x192 on its grid {grids[-1].tolist()} (eta-0 DDIM, "
              f"--steps 50 not applied) in {sample_wall:.3f} s of wall "
              f"(model build and load included); served through "
              f"cli._build_serving ({label}) one batch of {DISTILL_BATCH} "
              f"to uint8 in {serve_s:.4f} s; launches {sample_counts}",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"distill phase: {phase_s:.3f} s on {card}", flush=True)
    run = {k: counts[k] + counts2[k] for k in counts}
    return {"distill_run": {
        "launches": run, "per_update": expected["distill"],
        "per_adapt_update": expected["adapt"],
        "adapt_ms": adapt_ms, "distill_ms": step_ms,
        "median_distill_ms": float(np.median(step_ms)),
        "chained_ms": chain_ms, "wall_s": wall, "chained_wall_s": chain_wall,
        "seconds": result["seconds"], "peak_memory_gib": peak_gb,
        "history": hist, "phase_s": phase_s, **e2e},
        "distill_sample": {"launches": sample_counts, "wall_s": sample_wall},
        "distill_serve": {"launches": serve_counts, "batch_s": serve_s}}


# the fit phase: `cli train` on a DeepFashion-shaped tree at interp_256's
# sizes. The train split's pairs from WOMEN and MEN sources: with the
# config's men_factor 4 the 28 + 4 rows are 48, four batches of 12; the
# validation split 24 pairs, two batches
FIT_TRAIN_PAIRS, FIT_VAL_PAIRS, FIT_EPOCHS = (28, 4), (24, 0), 1
FIT_IMAGE_LOG_EVERY = FIT_CKPT_EVERY = 4
FIT_SAMPLE_STEPS = 50
# the kernel switches `train_run` sets, as the config's model.params dotlist
FIT_KERNELS = ("use_flash_attention", "use_fused_transformer",
               "use_fused_groupnorm")
LOADER_EPOCHS = 2


class _StepProbe:
    """Wraps a module's function, the trainer's `train_step` or the VAE
    trainer's steps (in this script, not in the package): each call's
    kernel launches (the counters before and after it), its host start
    time and CUDA events around it, and a profiler range named `label`."""

    def __init__(self, fn, label: str = "fit_step"):
        self.fn = fn
        self.label = label
        self.records = []

    def __call__(self, *args, **kwargs):
        before = _read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with torch.profiler.record_function(self.label):
            start.record()
            out = self.fn(*args, **kwargs)
            end.record()
        after = _read_counts()
        self.records.append({"t0": t0, "events": (start, end),
                             "launches": {k: after[k] - before[k]
                                          for k in after}})
        return out

    def ms(self) -> list:
        """Each call's CUDA-event span, ms."""
        torch.cuda.synchronize()
        return [r["events"][0].elapsed_time(r["events"][1])
                for r in self.records]


def _fit_counts(model, per_step: dict, steps: int, evals: int,
                image_logs: int) -> dict:
    """Launches of the fit phase's `cli train` runs: `steps` train steps
    (`per_step` each), `evals` validation losses (forward only: the fused
    blocks, the VAE encoder's flash forward and the GroupNorm kernel; raw
    and EMA weights count apart) and `image_logs` image logs (DDIM at the
    trainer's 20 steps, the final image and six progressive frames
    decoded)."""
    from upgpt_torch.training.trainer import TrainerConfig

    tc = TrainerConfig()
    forward = expected_train_counts(model, backward=False)
    tk = context_tokens(model)
    run = expected_sampling_counts(model, TRAIN_BATCH, tk,
                                   tc.image_log_ddim_steps)
    decode = expected_sampling_counts(model, TRAIN_BATCH, tk, 0)
    frames = tc.image_log_progressive_frames
    return {k: steps * per_step[k] + evals * forward[k]
            + image_logs * (run[k] + frames * decode[k]) for k in per_step}


def _fit_intervals(records, per_epoch: int) -> list:
    """Host ms from one step's start to the next within each epoch, the
    run's first step left out: the loop's time per step (loader wait,
    copy, step, the log's read of the metrics)."""
    out = []
    for e in range(0, len(records), per_epoch):
        ts = [r["t0"] for r in records[e:e + per_epoch]][1 if e == 0 else 0:]
        out += [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
    return out


def _window_busy_ms(prof, first: int, last: int):
    """Device busy ms (the union of the device activities' intervals) from
    the start of profiled step `first` to the start of step `last`, and
    that window's length in ms."""
    from torch.autograd import DeviceType

    events = prof.events()
    steps = sorted(e.time_range.start for e in events
                   if e.name == "fit_step" and e.device_type == DeviceType.CPU)
    lo, hi = steps[first], steps[last]
    spans = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t > s:
            spans.append((s, t))
    total, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total / 1e3, (hi - lo) / 1e3


def _time_loader(cls, ds, transform, **kw) -> dict:
    """img/s of a training loader alone over LOADER_EPOCHS epochs after a
    first one (a worker pool starts there)."""
    loader = cls(ds, TRAIN_BATCH, shuffle=True, batch_transform=transform,
                 **kw)
    try:
        t0 = time.perf_counter()
        for _ in loader.epoch(0):
            pass
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = 0
        for e in range(1, 1 + LOADER_EPOCHS):
            for batch in loader.epoch(e):
                n += len(batch["person_mask"])
        wall = time.perf_counter() - t0
    finally:
        if hasattr(loader, "close"):
            loader.close()
    return {"img_per_s": n / wall, "images": n, "first_epoch_s": first_s,
            "workers": loader.num_workers}


def fit_dotlist(tree: dict, logdir: str) -> list:
    """The fit phase's `cli train` dotlist over a tree from
    `write_fashion_tree`: its three splits, batch 12, a log every step,
    image logs and weights-only snapshots every 4 steps, the compact
    transport and the training kernels on."""
    dotlist = [f"data.{s}.params.{k}={tree[v]}"
               for s in ("train", "validation", "test")
               for k, v in (("folder", "folder"),
                            ("data_file", "data_file"))]
    dotlist += [f"data.train.params.pair_file=['{tree['train']}']",
                f"data.validation.params.pair_file=['{tree['validation']}']",
                f"data.test.params.pair_file=['{tree['validation']}']",
                f"trainer.batch_size={TRAIN_BATCH}", "trainer.log_every=1",
                "trainer.warm_up_steps=1",
                f"trainer.log_images_every={FIT_IMAGE_LOG_EVERY}",
                f"trainer.ckpt_every_steps={FIT_CKPT_EVERY}",
                f"trainer.logdir={logdir}",
                "trainer.compact_transport=True"]
    return dotlist + [f"model.params.{k}=True" for k in FIT_KERNELS]


def fit_run(dev, card: str, bare_ms: list, work: str):
    """`python -m upgpt_torch.cli train` on interp_256 in-process: a
    DeepFashion-shaped tree at the config's sizes under `work`,
    FIT_EPOCHS epochs at batch 12 through `cli.main` (float32 masters,
    compact transport, the debug encoder, the training kernels on), each
    step's launches held to `expected_train_counts`; `train --resume` for
    one more epoch under the
    profiler; `sample` from the last checkpoint at batch 12, DDIM-50; then
    the training loader alone. Returns the paths `fit_run` (the two
    training runs) and `sample_run`, and what the eval phase takes: the
    config, its dotlist, the tree and the last checkpoint."""
    import shutil

    import numpy as np
    from PIL import Image

    from upgpt_torch import cli, native
    from upgpt_torch.checkpoint import read_weights
    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.data.deepfashion import (
        PrefetchDataLoader, ProcessDataLoader,
    )
    from upgpt_torch.data.tree import write_fashion_tree
    from upgpt_torch.inference.encoders import DebugConditioningEncoder
    from upgpt_torch.training import trainer as trainer_mod

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "configs", "deepfashion", "interp_256.yaml")
    free_gb = shutil.disk_usage(work).free / 1e9
    print(f"fit phase: {free_gb:.1f} GB free beside the checkpoints; native "
          f"JPEG core live: {native.available()}", flush=True)
    probe = _StepProbe(trainer_mod.train_step)
    trainer_mod.train_step = probe
    try:
        t0 = time.perf_counter()
        tree = write_fashion_tree(os.path.join(work, "tree"),
                                  {"train": FIT_TRAIN_PAIRS,
                                   "validation": FIT_VAL_PAIRS}, seed=81)
        print(f"fit phase: tree written in {time.perf_counter() - t0:.3f} s",
              flush=True)
        logdir = os.path.join(work, "run")
        dotlist = fit_dotlist(tree, logdir)
        train = ["train", "--base", config, "--debug-encoder"] + dotlist
        cfg = merge_configs([config], dotlist)
        with torch.device("meta"):
            meta = instantiate_from_config(
                {**cfg["model"], "params": {**cfg["model"]["params"],
                                            "device": "meta"}})
        expected = expected_train_counts(meta)
        per_epoch = len(instantiate_from_config(cfg["data"]["train"])
                        ) // TRAIN_BATCH
        val_batches = len(instantiate_from_config(
            cfg["data"]["validation"])) // TRAIN_BATCH

        # --- FIT_EPOCHS epochs ---
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state = cli.main(train + [f"trainer.max_epochs={FIT_EPOCHS}"])
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        if state.step != FIT_EPOCHS * per_epoch:
            raise RuntimeError(f"fit ran {state.step} steps, "
                               f"{FIT_EPOCHS * per_epoch} expected")
        if next(iter(state.params)).dtype != torch.float32:
            raise RuntimeError("fit trained without float32 masters")
        del state
        torch.cuda.empty_cache()

        # --- one more epoch from `last`, profiled ---
        from torch.profiler import ProfilerActivity, profile

        n_fit = len(probe.records)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = cli.main(train[:1] + ["--resume"] + train[1:] + [
                f"trainer.max_epochs={FIT_EPOCHS + 1}"])
            torch.cuda.synchronize()
            resume_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        fit_counts = _read_counts()
        if (state.step != (FIT_EPOCHS + 1) * per_epoch
                or len(probe.records) != state.step):
            raise RuntimeError(f"resume ended at step {state.step} after "
                               f"{len(probe.records)} steps")
        resumed = [json.loads(line) for line in open(
            os.path.join(logdir, "metrics.jsonl"))]
        losses = [r["loss"] for r in resumed if "loss" in r]
        if (len(losses) != state.step
                or not all(math.isfinite(x) for x in losses)):
            raise RuntimeError(f"fit losses {losses}")
        first_resumed = next(r["step"] for r in resumed
                             if "loss" in r and r["epoch"] == FIT_EPOCHS)
        if first_resumed != FIT_EPOCHS * per_epoch + 1:
            raise RuntimeError(f"resume started at step {first_resumed}")
        bad = [(i, r["launches"]) for i, r in enumerate(probe.records)
               if r["launches"] != expected]
        if bad:
            raise RuntimeError(f"fit step launches {bad[:2]}, expected "
                               f"{expected} per step")
        want = _fit_counts(meta, expected, steps=state.step, evals=2 * (
            1 + (FIT_EPOCHS + 1) * val_batches),
            image_logs=state.step // FIT_IMAGE_LOG_EVERY)
        if fit_counts != want or any(
                fit_counts[k] == 0 for k, _, _ in KERNELS[:5]):
            raise RuntimeError(f"fit launches {fit_counts}, expected {want}")
        ckpts = os.listdir(os.path.join(logdir, "checkpoints"))
        snaps = sorted(c for c in ckpts if c.startswith("trainstep_")
                       and not c.endswith(".json"))
        want = [f"trainstep_{s:09d}" for s in range(
            FIT_CKPT_EVERY, state.step + 1, FIT_CKPT_EVERY)]
        if "last" not in ckpts or "best" not in ckpts or snaps != want:
            raise RuntimeError(f"checkpoints {sorted(ckpts)}")
        grids = os.listdir(os.path.join(logdir, "images"))
        for kind in ("samples", "progressive", "src_image", "smpl_image",
                     "styles"):
            want = {f"{kind}_{s:08d}.png" for s in range(
                FIT_IMAGE_LOG_EVERY, state.step + 1, FIT_IMAGE_LOG_EVERY)}
            if not want <= set(grids):
                raise RuntimeError(f"image grids {sorted(grids)}")
        # the last checkpoint's EMA weights are the run's, bit for bit
        saved, _ = read_weights(os.path.join(logdir, "checkpoints", "last"),
                                "cpu")
        if not all(torch.equal(saved[n], s.cpu()) for n, s in
                   zip(state.names, state.ema.shadow)):
            raise RuntimeError("the last checkpoint's EMA differs from the "
                               "run's")
        del state, saved
        torch.cuda.empty_cache()

        # --- the loop's time per step, beside the bare step's ---
        for r in probe.records:
            r["device_ms"] = r["events"][0].elapsed_time(r["events"][1])
        loop = _fit_intervals(probe.records[:n_fit], per_epoch)
        fit_ms = float(np.median(loop))
        step_ms = float(np.median([r["device_ms"] for r in
                                   probe.records[1:n_fit]]))
        busy_ms, window_ms = _window_busy_ms(prof, 1, per_epoch - 1)
        steps_in_window = per_epoch - 2
        busy_per_step = busy_ms / steps_in_window
        bare = float(np.median(bare_ms))
        print(f"fit loop interp_256 batch {TRAIN_BATCH} through cli train "
              f"(compact transport, {PrefetchDataLoader.__name__}): "
              f"{' '.join(f'{x:.2f}' for x in loop)} ms/step, median "
              f"{fit_ms:.2f} ms/step = {TRAIN_BATCH / fit_ms * 1e3:.3f} "
              f"img/s; "
              f"bare train step median {bare:.2f} ms/step (best "
              f"{min(bare_ms):.2f}), fit/bare {fit_ms / bare:.3f}; CUDA "
              f"events around each step median {step_ms:.2f} ms; on {card}",
              flush=True)
        print(f"fit loop device busy (profiled resume epoch, steps 2-"
              f"{per_epoch}): {busy_per_step:.2f} ms/step, busy share "
              f"{busy_per_step / fit_ms:.4f} of the unprofiled loop "
              f"({busy_ms / window_ms:.4f} of the profiled window "
              f"{window_ms:.2f} ms); fit {fit_wall:.3f} s and resume "
              f"{resume_wall:.3f} s of wall (model builds, checkpoints, "
              f"image logs included) on {card}", flush=True)

        # --- cli sample from the last checkpoint ---
        out_dir = os.path.join(work, "samples")
        with torch.device("meta"):
            sampled_model = instantiate_from_config(
                {**cfg["model"], "params": {**cfg["model"]["params"],
                                            "device": "meta"}})
        expected_sample = expected_sampling_counts(
            sampled_model, TRAIN_BATCH, context_tokens(sampled_model),
            FIT_SAMPLE_STEPS)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        imgs = cli.main(["sample", "--base", config, "--debug-encoder",
                         "--ckpt", os.path.join(logdir, "checkpoints",
                                                "last"),
                         "--batch", str(TRAIN_BATCH), "--steps",
                         str(FIT_SAMPLE_STEPS), "--out", out_dir] + dotlist)
        sample_wall = time.perf_counter() - t0
        sample_counts = _read_counts()
        files = sorted(os.listdir(out_dir))
        shapes = {np.asarray(Image.open(os.path.join(out_dir, f))).shape
                  for f in files}
        if (len(files) != TRAIN_BATCH or shapes != {(256, 192, 3)}
                or not np.isfinite(imgs).all()):
            raise RuntimeError(f"cli sample wrote {files}, shapes {shapes}")
        if sample_counts != expected_sample:
            raise RuntimeError(f"cli sample launches {sample_counts}, "
                               f"expected {expected_sample}")
        print(f"cli sample from checkpoints/last: {TRAIN_BATCH} JPEGs of "
              f"256x192, DDIM-{FIT_SAMPLE_STEPS} eta 1, {sample_wall:.3f} s "
              f"of wall (model build and load included); launches "
              f"{sample_counts}", flush=True)

        # --- the training loader alone ---
        enc = DebugConditioningEncoder()
        keep = trainer_mod.Trainer._KEEP
        memo = {}

        def transform(raw):
            batch = enc.encode_batch(raw)
            return trainer_mod.encode_transport(
                {k: v for k, v in batch.items() if k in keep}, memo)

        ds = instantiate_from_config({**cfg["data"]["train"], "params": {
            **cfg["data"]["train"]["params"], "compact": True}})
        loaders = {
            "prefetch": _time_loader(PrefetchDataLoader, ds, transform),
            "process": _time_loader(ProcessDataLoader, ds, transform)}
        for name, r in loaders.items():
            print(f"training loader alone ({name}, {r['workers']} workers, "
                  f"compact, debug encoder): {r['img_per_s']:.3f} img/s over "
                  f"{r['images']} images (first epoch {r['first_epoch_s']:.3f}"
                  f" s); the fit loop consumed "
                  f"{TRAIN_BATCH / fit_ms * 1e3:.3f}"
                  f" img/s", flush=True)
    finally:
        trainer_mod.train_step = probe.fn
    fit = {"launches": {k: fit_counts[k] for k in fit_counts},
           "steps": len(probe.records), "ms_per_step": loop,
           "median_ms_per_step": fit_ms, "bare_median_ms_per_step": bare,
           "step_event_ms": [r["device_ms"] for r in probe.records],
           "busy_ms_per_step": busy_per_step,
           "busy_share": busy_per_step / fit_ms,
           "profiled_window_busy_share": busy_ms / window_ms,
           "fit_wall_s": fit_wall, "resume_wall_s": resume_wall,
           "losses": losses, "native_jpeg": native.available(),
           "loader": loaders, "free_disk_gb": free_gb}
    sample = {"launches": sample_counts, "wall_s": sample_wall}
    return {"fit_run": fit, "sample_run": sample}, {
        "config": config, "dotlist": dotlist, "tree": tree,
        "ckpt": os.path.join(logdir, "checkpoints", "last")}


# the eval phase: `cli test` from the fit phase's `last` over 12 distinct
# validation pairs of its tree (one batch of 12), DDIM-50, bf16, the FID
# network from a pt_inception-layout file of seeded weights; then `cli eval`
# on the dump, and the harness on the card against the CPU
EVAL_IMAGES, EVAL_STEPS = 12, 50
EVAL_GROUPS = ("samples", "gt", "recon", "src", "smpl", "concats", "styles")
# `cli eval` on the same files and the same card: the metrics again, to a
# relative 1e-6 (the same arithmetic; a looser bound would hide a harness
# that reads other files)
EVAL_REPRO_REL = 1e-6
# the harness on the card against the CPU, float32 with TF32 off on both,
# the same files and weights: per-image SSIM and MS-SSIM as absolute
# differences (scores at most 1; the samples of random weights score near
# 0, so a relative one would divide by ~0.01), LPIPS relative to the
# CPU's, the Inception features' max|d| over max|ref|. Both sides differ
# only in the order of float32 sums. Measured on an H100 (700 W): SSIM
# 1.9e-5 and MS-SSIM 4.1e-5 relative at scores ~0.05 (~1e-6 absolute),
# LPIPS 2.4e-7, features 8.1e-7, so each bound has a margin of 10x or
# more.
EVAL_SCORE_ABS = 1e-5
EVAL_LPIPS_REL = 1e-5
INCEPTION_FEATURE_REL = 1e-4
EVAL_TIMED_BATCH, EVAL_TIMED_ITERS = 16, 10
LPIPS_REHEARSAL_SEED = 5
# the train-vae phase: `cli train-vae` on configs/autoencoder/
# kl_f8_deepfashion.yaml over the fit tree's 32 training images at
# 256x192 (two batches of 12 an epoch), full width, bf16 compute over
# float32 masters, the GAN terms on from step 0
VAE_CONFIG = os.path.join("configs", "autoencoder", "kl_f8_deepfashion.yaml")
VAE_STEPS = 6
# one vae_train_step at full width in float32 on a 64x64 batch of 2 with
# the same weights and draws, the card against the CPU (TF32 off): each
# log relative to the CPU's; the first step's gradients (from Adam's first
# moment) and the parameters after the step, relative L2 over the VAE and
# over the discriminator (with its statistics). Both sides differ only in
# the order of float32 sums, but the normalisations' backward subtracts
# nearly equal means: the discriminator's BatchNorm on batch statistics
# under a hinge gradient that is almost constant cancels most, and Adam's
# first step, about lr * sign(gradient), flips where an element's gradient
# is near 0. Measured on an H100 (700 W): logs 3.6e-4 (the fake logits'
# mean, near 0; the generator's at most 2.6e-6), gradients 2.3e-4 (VAE)
# and 6.4e-3 (discriminator), parameters 9.9e-5 and 2.1e-4, so each bound
# has a margin of 4x or more.
VAE_CHECK_HW, VAE_CHECK_BATCH, VAE_CHECK_LR = 64, 2, 1e-4
VAE_LOG_REL = 2e-3
VAE_GRAD_REL_L2 = 1e-3
VAE_DISC_GRAD_REL_L2 = 3e-2
VAE_PARAM_REL_L2 = 5e-4
VAE_DISC_PARAM_REL_L2 = 1e-3


def _pt_inception_state_dict(seed: int) -> dict:
    """Random weights in pt_inception's layout (torchvision's names, each
    BasicConv2d's BatchNorm with running statistics, the 1008-way fc),
    from a seed: the FID network's file where the published one is
    absent. He-scaled kernels keep the activations near unit scale
    through the 94 layers."""
    from upgpt_torch.eval.inception import (
        FID_FEATURE_DIM, FID_NUM_CLASSES, BasicConv2d, InceptionV3Features,
    )

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, mod in InceptionV3Features().named_modules():
        if not isinstance(mod, BasicConv2d):
            continue
        shape = mod.conv.weight.shape
        o, fan_in = shape[0], shape[1] * shape[2] * shape[3]
        sd[f"{name}.conv.weight"] = (torch.randn(shape, generator=g)
                                     * (2.0 / fan_in) ** 0.5)
        sd[f"{name}.bn.weight"] = 0.5 + torch.rand(o, generator=g)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(o, generator=g)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(o, generator=g)
        sd[f"{name}.bn.running_var"] = 0.5 + torch.rand(o, generator=g)
    sd["fc.weight"] = 0.01 * torch.randn(FID_NUM_CLASSES, FID_FEATURE_DIM,
                                         generator=g)
    sd["fc.bias"] = torch.zeros(FID_NUM_CLASSES)
    return sd


def _distinct_pairs(pair_file: str, n: int, out: str) -> str:
    """A pair file of `n` distinct (from, to) pairs over the people of
    `pair_file`: the dump names each image by its pair, so a pair drawn
    twice would overwrite its files."""
    import csv

    with open(pair_file, newline="") as f:
        people = sorted({p for row in csv.DictReader(f)
                         for p in (row["from"], row["to"])})
    pairs = [(people[i], people[(i + k) % len(people)])
             for k in range(1, len(people)) for i in range(len(people))]
    if len(pairs) < n:
        raise RuntimeError(f"{len(people)} people give {len(pairs)} pairs")
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["from", "to"])
        w.writerows(pairs[:n])
    return out


def expected_test_counts(model, b: int, steps: int, batches: int) -> dict:
    """`cli test`'s launches: per batch, a sampling run (`steps` U-Net
    evals and one decode) and the recon (an encode and a decode). The
    encoder's GroupNorms stay plain: the eval phase keeps the VAE's
    GroupNorm kernels off, as the fit's config does."""
    from upgpt_torch.ops.flash_attention import flash_attention_qualifies

    if model.vae.config.use_fused_groupnorm:
        raise RuntimeError("expected_test_counts counts no VAE GroupNorm "
                           "kernel in the encoder")
    tk = context_tokens(model)
    run = expected_sampling_counts(model, b, tk, steps)
    decode = expected_sampling_counts(model, b, tk, 0)
    h, w = model.config.latent_size
    vcfg = model.vae.config
    encode = int(vcfg.use_flash_attention and flash_attention_qualifies(
        b, 1, h * w, h * w, vcfg.ch * vcfg.ch_mult[-1],
        model.vae.encoder.conv_in.weight.dtype))
    out = {k: batches * (run[k] + decode[k]) for k in run}
    out["flash_attention"] += batches * encode
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _csv_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def eval_run(dev, card: str, work: str, fit: dict) -> dict:
    """`python -m upgpt_torch.cli test` in-process on interp_256 from the
    fit phase's `last` (bf16 on the card, its kernel switches): 24
    images, DDIM-50 at batch 12, the FID network from a pt_inception-layout
    file of seeded weights; the dump's seven groups, metrics.json and the
    run's launches against the model's structure; `cli eval` on the dump;
    the harness with the rehearsal LPIPS on the card against the CPU; the
    FID network's and LPIPS's throughput at batch 16."""
    from upgpt_torch import cli
    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.eval.harness import evaluate_dirs
    from upgpt_torch.eval.inception import (
        InceptionFeatureFn, load_pt_inception,
    )
    from upgpt_torch.eval.lpips import rehearsal_lpips_fn

    t_phase = time.perf_counter()
    fid_path = os.path.join(work, "pt_inception.pth")
    torch.save(_pt_inception_state_dict(91), fid_path)
    pairs = _distinct_pairs(fit["tree"]["validation"], EVAL_IMAGES,
                            os.path.join(work, "pairs-test.csv"))
    dotlist = fit["dotlist"] + [f"data.test.params.pair_file=['{pairs}']"]
    cfg = merge_configs([fit["config"]], dotlist)
    with torch.device("meta"):
        meta = instantiate_from_config(
            {**cfg["model"], "params": {**cfg["model"]["params"],
                                        "device": "meta"}})
    expected = expected_test_counts(meta, TRAIN_BATCH, EVAL_STEPS,
                                    EVAL_IMAGES // TRAIN_BATCH)
    out = os.path.join(work, "results")

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    result = cli.main(["test", "--base", fit["config"], "--debug-encoder",
                       "--ckpt", fit["ckpt"], "--steps", str(EVAL_STEPS),
                       "--batch", str(TRAIN_BATCH), "--max-images",
                       str(EVAL_IMAGES), "--fid-weights", fid_path,
                       "--out", out] + dotlist)
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - t0
    counts = _read_counts()
    for group in EVAL_GROUPS:
        files = os.listdir(os.path.join(out, group))
        if len(files) != EVAL_IMAGES or any(not f.endswith(".jpg")
                                            for f in files):
            raise RuntimeError(f"cli test wrote {len(files)} files to "
                               f"{group}/: {sorted(files)[:4]}")
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    if (metrics != result["metrics"] or metrics["n_images"] != EVAL_IMAGES
            or not all(math.isfinite(metrics[k]) for k in
                       ("ssim", "ms_ssim", "fid_inception", "fid"))):
        raise RuntimeError(f"cli test metrics {metrics}")
    if counts != expected or not (counts["fused_transformer_block"]
                                  and counts["flash_attention"]):
        raise RuntimeError(f"cli test launches {counts}, expected "
                           f"{expected}")
    sec = result["seconds"]
    print(f"cli test interp_256 from checkpoints/last: {EVAL_IMAGES} images "
          f"DDIM-{EVAL_STEPS} at batch {TRAIN_BATCH}, {test_wall:.3f} s of "
          f"wall (model build and load included): sampling "
          f"{sec['sampling']:.3f} s, recon {sec['recon']:.3f} s, dump "
          f"{sec['dump']:.3f} s, metrics {sec['metrics']:.3f} s = "
          f"{EVAL_IMAGES / sec['sampling']:.3f} img/s sampled; metrics "
          f"{json.dumps(metrics)}; launches {counts} on {card}", flush=True)

    # --- cli eval on the same dump ---
    t0 = time.perf_counter()
    again = cli.main(["eval", "--dir", out, "--fid-weights", fid_path])
    eval_wall = time.perf_counter() - t0
    repro = max(_rel(again[k], metrics[k]) for k in metrics)
    if set(again) != set(metrics) or repro > EVAL_REPRO_REL:
        raise RuntimeError(f"cli eval {again} against cli test {metrics}")
    print(f"cli eval --dir: {eval_wall:.3f} s, metrics within {repro:.3e} "
          f"of cli test's", flush=True)

    # --- the harness on the card against the CPU ---
    inception = load_pt_inception(fid_path)
    runs = {}
    for d in (dev, torch.device("cpu")):
        feats = []
        fid_fn = InceptionFeatureFn(inception, d)

        def features(x, fid_fn=fid_fn, feats=feats):
            f = fid_fn(x)
            feats.append(f.cpu())
            return f

        features.fid_name = "inception"
        t0 = time.perf_counter()
        m = evaluate_dirs(out, lpips_fn=rehearsal_lpips_fn(
            LPIPS_REHEARSAL_SEED, d), fid_feature_fn=features, device=d)
        runs[d.type] = {"metrics": m, "wall_s": time.perf_counter() - t0,
                        "rows": _csv_rows(os.path.join(out, "metrics.csv")),
                        "features": torch.cat(feats)}
    pairs_rows = list(zip(runs["cuda"]["rows"], runs["cpu"]["rows"]))
    card_cpu = {}
    for key in ("ssim", "ms_ssim", "lpips"):
        card_cpu[key] = max(_rel(float(a[key]), float(b[key]))
                            for a, b in pairs_rows)
        card_cpu[f"{key}_abs"] = max(abs(float(a[key]) - float(b[key]))
                                     for a, b in pairs_rows)
    fa, fb = runs["cuda"]["features"], runs["cpu"]["features"]
    card_cpu["inception_features"] = ((fa - fb).abs().max()
                                      / fb.abs().max()).item()
    print(f"evaluate_dirs card vs CPU (float32, TF32 off, rehearsal LPIPS): "
          f"per-image SSIM {card_cpu['ssim_abs']:.3e} ({card_cpu['ssim']:.3e}"
          f" relative), MS-SSIM {card_cpu['ms_ssim_abs']:.3e} "
          f"({card_cpu['ms_ssim']:.3e}), LPIPS {card_cpu['lpips']:.3e} "
          f"relative, Inception features {card_cpu['inception_features']:.3e}"
          f" of max|ref|; FID {runs['cuda']['metrics']['fid']:.6f} / "
          f"{runs['cpu']['metrics']['fid']:.6f}; wall "
          f"{runs['cuda']['wall_s']:.3f} s card, {runs['cpu']['wall_s']:.3f}"
          f" s CPU", flush=True)
    if (max(card_cpu["ssim_abs"], card_cpu["ms_ssim_abs"]) > EVAL_SCORE_ABS
            or card_cpu["lpips"] > EVAL_LPIPS_REL
            or card_cpu["inception_features"] > INCEPTION_FEATURE_REL):
        raise RuntimeError(f"the harness on the card disagrees with the "
                           f"CPU: {card_cpu}")

    # --- the FID network and LPIPS alone, batch 16 at the eval crop ---
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand(EVAL_TIMED_BATCH, 256, 176, 3, generator=g,
                   device=dev) * 2 - 1
    y = torch.rand(EVAL_TIMED_BATCH, 256, 176, 3, generator=g,
                   device=dev) * 2 - 1
    fid_fn = InceptionFeatureFn(inception, dev)
    lpips = rehearsal_lpips_fn(LPIPS_REHEARSAL_SEED, dev)
    with torch.inference_mode():
        inc_ms = _time_ms(lambda: fid_fn(x), EVAL_TIMED_ITERS)
        lpips_ms = _time_ms(lambda: lpips(x, y), EVAL_TIMED_ITERS)
    rates = {"inception_img_per_s": EVAL_TIMED_BATCH / inc_ms * 1e3,
             "lpips_pairs_per_s": EVAL_TIMED_BATCH / lpips_ms * 1e3}
    wall = time.perf_counter() - t_phase
    print(f"FID InceptionV3 (float32, TF32 off) at batch "
          f"{EVAL_TIMED_BATCH}, 256x176 -> 299x299: {inc_ms:.3f} ms = "
          f"{rates['inception_img_per_s']:.1f} img/s; LPIPS VGG16: "
          f"{lpips_ms:.3f} ms = {rates['lpips_pairs_per_s']:.1f} pairs/s; "
          f"eval phase {wall:.3f} s of wall on {card}", flush=True)
    return {"launches": counts, "wall_s": test_wall, "seconds": sec,
            "metrics": metrics, "eval_wall_s": eval_wall,
            "eval_repro_rel": repro, "card_vs_cpu": card_cpu,
            "harness_wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "phase_wall_s": wall, **rates}


def _moved(before: dict, after: dict) -> tuple:
    """(tensors that changed, tensors) of two state dicts."""
    n = sum(not torch.equal(before[k].cpu(), after[k].cpu()) for k in before)
    return n, len(before)


def _first_gradients(opt) -> list:
    """The gradients of an Adam's first step, from its first moment
    (exp_avg = (1 - beta1) g after one step), in parameter order."""
    b1 = opt.param_groups[0]["betas"][0]
    return [opt.state[p]["exp_avg"] / (1 - b1)
            for p in opt.param_groups[0]["params"]]


def vae_step_card_vs_cpu(dev) -> dict:
    """One `vae_train_step` at full width (kl-f8 and the PatchGAN) in
    float32 on a 64x64 batch of 2, the card against the CPU on the same
    weights, images and posterior draws: each log's relative difference,
    the gradients' relative L2 (VAE, discriminator) and the parameters'
    after the step."""
    from upgpt_torch.training.vae_loss import (
        LPIPSWithDiscriminator, VAELossConfig,
    )
    from upgpt_torch.training.vae_trainer import (
        make_vae_optimizers, vae_train_step,
    )
    from upgpt_torch.zoo import build_autoencoder

    torch.manual_seed(7)
    side = {}
    for d in (torch.device("cpu"), dev):
        vae = build_autoencoder("kl_f8", "float32", device=d)
        loss = LPIPSWithDiscriminator(VAELossConfig(disc_start=0)).to(d)
        if side:
            vae.load_state_dict(side["cpu"]["vae"].state_dict())
            loss.load_state_dict(side["cpu"]["loss"].state_dict())
        side[d.type] = {"vae": vae, "loss": loss}
    g = torch.Generator().manual_seed(8)
    hw, b = VAE_CHECK_HW, VAE_CHECK_BATCH
    x = torch.rand(b, hw, hw, 3, generator=g) * 2 - 1
    noises = [torch.randn(b, hw // 8, hw // 8, 4, generator=g)
              for _ in range(2)]
    for d, s in side.items():
        s["opts"] = make_vae_optimizers(VAE_CHECK_LR, s["vae"], s["loss"])
        s["logs"] = vae_train_step(s["vae"], s["loss"], s["opts"], x.to(d),
                                   0, noises=[n.to(d) for n in noises])
    ref, got = side["cpu"], side["cuda"]
    out = {"logs_rel": {k: _rel(float(got["logs"][k]),
                                float(ref["logs"][k]))
                        for k in ref["logs"]}}
    for i, name in enumerate(("vae", "disc")):
        out[f"{name}_grad_rel_l2"] = _rel_l2_lists(
            [t.cpu() for t in _first_gradients(got["opts"][i])],
            _first_gradients(ref["opts"][i]))
    for name in ("vae", "loss"):
        out[f"{name}_param_rel_l2"] = _rel_l2_lists(
            [t.cpu() for t in got[name].state_dict().values()],
            list(ref[name].state_dict().values()))
    return out


def train_vae_run(dev, card: str, work: str, tree: dict) -> dict:
    """`python -m upgpt_torch.cli train-vae` in-process on
    configs/autoencoder/kl_f8_deepfashion.yaml over the fit tree: six steps
    at batch 12, 256x192, the GAN terms on from step 0; every log finite,
    d_weight above 0, the VAE, the discriminator and its running
    statistics moved from their seeded start, `last` read back into
    `build_autoencoder`; the launches (none: flash attention and the
    GroupNorm kernels stay off, as JAX's AutoencoderConfig has them); then
    one step on the card against the CPU in float32."""
    import numpy as np

    from upgpt_torch import cli
    from upgpt_torch.config import merge_configs
    from upgpt_torch.training import vae_trainer
    from upgpt_torch.zoo import build_autoencoder

    t_phase = time.perf_counter()
    logdir = os.path.join(work, "vae")
    dotlist = [f"data.train.params.folder={tree['folder']}",
               f"data.train.params.data_file={tree['data_file']}",
               f"data.train.params.pair_file=['{tree['train']}']",
               f"trainer.batch_size={TRAIN_BATCH}", "loss.disc_start=0",
               f"trainer.max_steps={VAE_STEPS}", "trainer.log_every=1",
               f"trainer.logdir={logdir}"]
    spans = {name: _StepProbe(getattr(vae_trainer, name), name) for name in
             ("vae_train_step", "generator_step", "discriminator_step")}
    for name, span in spans.items():
        setattr(vae_trainer, name, span)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        result = cli.main(["train-vae"] + dotlist + ["--base", VAE_CONFIG])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the run's own peak, above what earlier phases left allocated
        peak_gib = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        counts = _read_counts()
        ms = {name: span.ms() for name, span in spans.items()}
    finally:
        for name, span in spans.items():
            setattr(vae_trainer, name, span.fn)
    logs = result["logs"]
    if (result["step"] != VAE_STEPS or len(logs) != VAE_STEPS
            or not all(math.isfinite(v) for line in logs
                       for v in line.values())
            or not all(line["gen/d_weight"] > 0 for line in logs)):
        raise RuntimeError(f"train-vae ran {result['step']} steps, logs "
                           f"{logs}")
    if any(counts.values()):
        raise RuntimeError(f"train-vae launched kernels: {counts}")
    cfg = merge_configs([VAE_CONFIG], dotlist + ["model.params.device=cpu"])
    vae0, loss0 = cli.build_vae_training(cfg)
    vae1, loss1 = result["vae"], result["loss"]
    state0, state1 = loss0.checkpoint_state(), loss1.checkpoint_state()
    moved = {"vae": _moved(vae0.state_dict(), vae1.state_dict()),
             "disc": _moved(state0["disc"], state1["disc"]),
             "disc_stats": _moved(state0["disc_stats"],
                                  state1["disc_stats"])}
    if not all(n for n, _ in moved.values()):
        raise RuntimeError(f"train-vae left weights where they started: "
                           f"{moved}")
    last = torch.load(os.path.join(logdir, "last"), map_location=dev,
                      weights_only=True)
    back = build_autoencoder("kl_f8", "bfloat16", device=dev)
    back.load_state_dict(last["vae"], strict=True)
    if (last["step"] != VAE_STEPS or not all(
            torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                              vae1.state_dict().values()))):
        raise RuntimeError("train-vae's last does not hold the run's VAE")
    loss0.load_checkpoint_state(last["loss"])
    step_ms = float(np.median(ms["vae_train_step"][1:]))
    g_ms = float(np.median(ms["generator_step"][1:]))
    d_ms = float(np.median(ms["discriminator_step"][1:]))
    loss_line = " ".join(f"{line['gen/total_loss']:.2f}" for line in logs)
    weights = " ".join(f"{line['gen/d_weight']:.3g}" for line in logs)
    print(f"cli train-vae kl-f8 256x192 batch {TRAIN_BATCH} (bf16 over "
          f"float32 masters, disc_start 0): {VAE_STEPS} steps, "
          f"{' '.join(f'{x:.2f}' for x in ms['vae_train_step'])} ms/step, "
          f"median of steps 2-{VAE_STEPS} {step_ms:.2f} ms/step = "
          f"{TRAIN_BATCH / step_ms * 1e3:.3f} img/s (generator {g_ms:.2f}, "
          f"discriminator {d_ms:.2f}); peak {peak_gib:.3f} GiB above "
          f"{resident / 2 ** 30:.3f} GiB resident before the run; losses "
          f"{loss_line}; d_weight {weights}; tensors moved {moved}; "
          f"{wall:.3f} s of wall on {card}",
          flush=True)
    check = vae_step_card_vs_cpu(dev)
    logs_rel = {k: f"{v:.2e}" for k, v in check["logs_rel"].items()}
    print(f"vae_train_step card vs CPU (kl-f8 full width, float32, "
          f"{VAE_CHECK_HW}x{VAE_CHECK_HW} batch {VAE_CHECK_BATCH}): logs "
          f"{json.dumps(logs_rel)} relative; gradients {check['vae_grad_rel_l2']:.3e} (VAE), "
          f"{check['disc_grad_rel_l2']:.3e} (discriminator) relative L2; "
          f"after the step {check['vae_param_rel_l2']:.3e} (VAE), "
          f"{check['loss_param_rel_l2']:.3e} (discriminator and statistics)"
          f"; phase {time.perf_counter() - t_phase:.3f} s of wall",
          flush=True)
    if (max(check["logs_rel"].values()) > VAE_LOG_REL
            or check["vae_grad_rel_l2"] > VAE_GRAD_REL_L2
            or check["disc_grad_rel_l2"] > VAE_DISC_GRAD_REL_L2
            or check["vae_param_rel_l2"] > VAE_PARAM_REL_L2
            or check["loss_param_rel_l2"] > VAE_DISC_PARAM_REL_L2):
        raise RuntimeError(f"vae_train_step on the card disagrees with the "
                           f"CPU: {check}")
    return {"launches": counts, "steps": result["step"], "logs": logs,
            "step_ms": ms["vae_train_step"], "median_ms_per_step": step_ms,
            "generator_ms": g_ms, "discriminator_ms": d_ms,
            "peak_gib": peak_gib, "resident_gib": resident / 2 ** 30,
            "moved": moved, "wall_s": wall,
            "card_vs_cpu": check,
            "phase_wall_s": time.perf_counter() - t_phase}


# the ddp phase: `python -m upgpt_torch.cli train --multihost` as a user
# launches it (torchrun's environment), on the fit phase's training split
# (48 pairs, four global batches of 12) at interp_256's full width with the
# training kernels on, no validation and no image logs, DDP_STEPS steps
# each: (a) one rank over NCCL at batch 12, one process (DDP's mean over
# one rank is the rank's own gradient); (b) two ranks sharing the card
# (gloo: NCCL takes one rank per card), 6 rows a rank, against (a): the
# same seed, data and draws
DDP_STEPS = 3
# each rank's subprocess: the start, the model build, the steps, the save
DDP_RANK_TIMEOUT_S = 600
# Two ranks against one process, per step |loss difference| / loss and the
# relative L2 of the final parameters. Both compute in bf16; a rank's
# forward at 6 rows matches the one process's rows at 12 but for the
# order of a few sums, and the ranks' halves of the gradient are averaged
# in float32 where one process sums 12 rows. Measured on an H100 (700 W):
# 6.386e-8 (loss) and 1.971e-8 (parameters), so each bound has a margin
# of 15x or more.
DDP_LOSS_REL = 1e-6
DDP_PARAM_REL_L2 = 1e-6


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost_train(argvs: list, local_world: int, label: str) -> list:
    """Run `python -m upgpt_torch.cli train --multihost` once per rank
    (`argvs[r]` its arguments) with torchrun's environment on one host,
    all at once; returns each rank's `multihost summary` and its
    `multihost:` start line. A rank that fails, or outlives
    DDP_RANK_TIMEOUT_S, fails the phase; every rank is stopped."""
    repo = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs = []
    for rank, argv in enumerate(argvs):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(len(argvs)),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(local_world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "upgpt_torch.cli", "train", "--multihost"]
            + argv, cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=DDP_RANK_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"{label}: rank {rank} exited "
                                   f"{proc.returncode}:\n{out[-2000:]}\n"
                                   f"{err[-6000:]}")
            start = next(line for line in err.splitlines()
                         if line.startswith("multihost: rank"))
            summary = json.loads(next(
                line for line in err.splitlines()
                if line.startswith("multihost summary "))[
                    len("multihost summary "):])
            results.append((summary, start))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def _rank_counts(meta, b: int, steps: int) -> dict:
    """Launches of `steps` train steps at `b` rows a rank."""
    per_step = expected_train_counts(meta, b)
    return {k: steps * n for k, n in per_step.items()}


def _trained_params(logdir: str) -> dict:
    """The raw trainable weights of a trainer checkpoint's `last`, read
    through a memory map (the optimizer state stays on disk)."""
    payload = torch.load(os.path.join(logdir, "checkpoints", "last"),
                         map_location="cpu", mmap=True, weights_only=True)
    return payload["params"]


def ddp_run(dev, card: str, work: str, fit: dict, fit_ms: float) -> dict:
    """`cli train --multihost` on the card: (a) one rank over NCCL, its
    ms/step beside the fit loop's `fit_ms`; (b) two ranks sharing the card
    over gloo, held to (a)'s one process (loss per step, final
    parameters), each rank's launches to `expected_train_counts` at 6
    rows, rank 1 writing nothing. Returns the path's launches (every
    rank's), times and errors."""
    import numpy as np
    import yaml

    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.training.train_state import trainable_parameters

    t_phase = time.perf_counter()
    cfg = merge_configs([fit["config"]], fit["dotlist"])
    # the training split alone: no validation, test or image logs, no
    # snapshots; the fit's seed
    for split in ("validation", "test"):
        cfg["data"].pop(split, None)
    cfg["trainer"].update(log_images_every=0, ckpt_every_steps=None,
                          log_every=1)
    base = os.path.join(work, "ddp.yaml")
    with open(base, "w") as f:
        # through JSON: tuples as lists, which safe YAML can write
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    with torch.device("meta"):
        meta = instantiate_from_config(
            {**cfg["model"], "params": {**cfg["model"]["params"],
                                        "device": "meta"}})
    # a step's exchange: every trainable float32 gradient, once
    grad_bytes = 4 * sum(p.numel() for _, p in trainable_parameters(meta))

    def argv(logdir: str, steps: int) -> list:
        return ["--base", base, "--debug-encoder", f"trainer.logdir={logdir}",
                f"trainer.max_steps={steps}"]

    # --- (a) one rank over NCCL ---
    t0 = time.perf_counter()
    ((one, start),) = _multihost_train(
        [argv(os.path.join(work, "ddp_nccl"), DDP_STEPS)], 1, "nccl")
    nccl_wall = time.perf_counter() - t0
    want = _rank_counts(meta, TRAIN_BATCH, DDP_STEPS)
    if one["backend"] != "nccl" or "backend nccl" not in start:
        raise RuntimeError(f"one rank on one card chose {one['backend']}")
    if one["steps"] != DDP_STEPS or one["launches"] != want:
        raise RuntimeError(f"nccl rank: {one['steps']} steps, launches "
                           f"{one['launches']}, expected {want}")
    if one["exchange_bytes_per_step"] != grad_bytes:
        raise RuntimeError(f"nccl rank exchanged "
                           f"{one['exchange_bytes_per_step']} bytes a step, "
                           f"{grad_bytes} expected")
    nccl_ms = float(np.median(one["step_ms"]))
    print(f"ddp (a) cli train --multihost, 1 rank over NCCL: {start}; "
          f"{DDP_STEPS} steps at batch {TRAIN_BATCH}: "
          f"{' '.join(f'{x:.2f}' for x in one['step_ms'])} ms between steps, "
          f"median {nccl_ms:.2f} ms/step against the fit loop's "
          f"{fit_ms:.2f} (x{nccl_ms / fit_ms:.3f}); {one['exchanges_per_step']}"
          f" exchanges, {one['exchange_bytes_per_step'] / 2**20:.1f} MiB a "
          f"step, alone {one['exchange_ms']:.3f} ms; peak "
          f"{one['peak_memory_gib']:.3f} GiB; {nccl_wall:.3f} s of wall; "
          f"launches {one['launches']}; on {card}", flush=True)

    # --- (b) two ranks sharing the card over gloo, against (a) ---
    logdirs = [os.path.join(work, f"ddp_gloo_rank{r}")
               for r in range(DDP_RANKS)]
    t0 = time.perf_counter()
    ranks = _multihost_train([argv(d, DDP_STEPS) for d in logdirs],
                             DDP_RANKS, "gloo")
    gloo_wall = time.perf_counter() - t0
    want = _rank_counts(meta, DDP_RANK_BATCH, DDP_STEPS)
    for rank, (summary, start) in enumerate(ranks):
        if summary["backend"] != "gloo" or "backend gloo" not in start:
            raise RuntimeError(f"rank {rank} of two on one card chose "
                               f"{summary['backend']}")
        if (summary["steps"] != DDP_STEPS
                or summary["launches"] != want
                or summary["exchange_bytes_per_step"] != grad_bytes):
            raise RuntimeError(f"gloo rank {rank}: {summary['steps']} "
                               f"steps, launches {summary['launches']}, "
                               f"expected {want}; exchanged "
                               f"{summary['exchange_bytes_per_step']} bytes "
                               f"a step, {grad_bytes} expected")
    if any(os.path.exists(d) for d in logdirs[1:]):
        raise RuntimeError("a rank other than 0 wrote under its logdir")
    ref_dir = os.path.join(work, "ddp_nccl")

    def losses(logdir):
        return [r["loss"] for r in map(json.loads, open(os.path.join(
            logdir, "metrics.jsonl"))) if "loss" in r]

    got, ref = losses(logdirs[0]), losses(ref_dir)
    if len(got) != DDP_STEPS or len(ref) != DDP_STEPS:
        raise RuntimeError(f"losses {got} against {ref}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    a, b = _trained_params(logdirs[0]), _trained_params(ref_dir)
    param_rel = _rel_l2_lists([a[n] for n in b], list(b.values()))
    del a, b
    print(f"ddp (b) cli train --multihost, {DDP_RANKS} ranks sharing the "
          f"card over gloo ({DDP_RANK_BATCH} rows a rank), {DDP_STEPS} "
          f"steps against (a), one process at batch {TRAIN_BATCH}: losses "
          f"{' '.join(f'{x:.6f}' for x in got)} against "
          f"{' '.join(f'{x:.6f}' for x in ref)} (max rel {loss_rel:.3e}), "
          f"final parameters rel L2 {param_rel:.3e}; {gloo_wall:.3f} s of "
          f"wall; on {card}", flush=True)
    for rank, (summary, start) in enumerate(ranks):
        print(f"  rank {rank}: {start}; "
              f"{' '.join(f'{x:.2f}' for x in summary['step_ms'])} ms "
              f"between steps (gloo stages CUDA tensors through the host: "
              f"no DDP speed figure); {summary['exchanges_per_step']} "
              f"exchanges, {summary['exchange_bytes_per_step'] / 2**20:.1f} "
              f"MiB a step, alone {summary['exchange_ms']:.3f} ms; peak "
              f"{summary['peak_memory_gib']:.3f} GiB", flush=True)
    if loss_rel > DDP_LOSS_REL or param_rel > DDP_PARAM_REL_L2:
        raise RuntimeError(f"two ranks disagree with one process: loss "
                           f"{loss_rel:.3e}, parameters {param_rel:.3e}")
    launches = {k: one["launches"][k] + sum(s["launches"][k]
                                            for s, _ in ranks)
                for k in one["launches"]}
    return {"launches": launches, "nccl": {
        "step_ms": one["step_ms"], "median_ms": nccl_ms,
        "fit_loop_median_ms": fit_ms,
        "exchanges_per_step": one["exchanges_per_step"],
        "exchange_bytes_per_step": one["exchange_bytes_per_step"],
        "exchange_ms": one["exchange_ms"],
        "peak_memory_gib": one["peak_memory_gib"], "wall_s": nccl_wall},
        "gloo": {"ranks": [s for s, _ in ranks], "wall_s": gloo_wall,
                 "losses": got, "one_process_losses": ref,
                 "loss_rel": loss_rel, "param_rel_l2": param_rel},
        "phase_s": time.perf_counter() - t_phase}


def fit_eval_and_vae_run(dev, card: str, bare_ms: list) -> dict:
    """The fit phase, then the eval phase from its checkpoint, the
    train-vae phase and the ddp phase on its tree, in a temporary
    directory under `upgpt_torch/_build` removed after."""
    import shutil
    import tempfile

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "upgpt_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir, prefix="fit-")
    try:
        out, fit = fit_run(dev, card, bare_ms, work)
        torch.cuda.empty_cache()
        out["test_run"] = eval_run(dev, card, work, fit)
        torch.cuda.empty_cache()
        out["train_vae_run"] = train_vae_run(dev, card, work, fit["tree"])
        torch.cuda.empty_cache()
        # the fit's checkpoints are done with: room for the ddp phase's
        shutil.rmtree(os.path.join(work, "run"), ignore_errors=True)
        out["ddp_run"] = ddp_run(dev, card, work, fit,
                                 out["fit_run"]["median_ms_per_step"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# CLIP at full width: openai's ViT-L/14 CLIP (text 12 x 768 QuickGELU,
# vision 24 x 1024) and laion's text tower (12 x 768, exact GELU, HF
# layout), synthetic weights written to disk and read back through the
# port's converters. Towers on the card against the same towers on the CPU
# in float32 (TF32 off) on CLIP_CHECK_TEXTS captions and CLIP_CHECK_CROPS
# crops: max|d|/max|ref| under CLIP_REL_TOL. Both sides are float32 and
# differ only in summation order through 12 or 24 blocks; measured on an
# H100 (700 W): 1.57e-6 (openai text), 1.40e-6 (laion text), 1.27e-6
# (ViT-L/14), so the bound has a margin of 6x or more.
CLIP_REL_TOL = 1e-5
CLIP_CHECK_TEXTS, CLIP_CHECK_CROPS, CLIP_VOCAB = 4, 2, 49408
CLIP_TIMED = 5
# the inshop_laion phase: `cli train` over 48 training pairs (four steps
# of 12, no men_factor in that config) and 12 validation pairs, one epoch
LAION_CONFIG = os.path.join("configs", "deepfashion", "inshop_laion_clip.yaml")
LAION_TRAIN_PAIRS, LAION_VAL_PAIRS = (48, 0), (12, 0)
LAION_SAMPLE_STEPS = 50


def _clip_state_dicts(dev, seed: int):
    """(openai CLIP state dict, laion text state dict in HF layout), host
    float32 tensors drawn on the card: weights N(0, 1/fan_in), norm scales
    1 + 0.1 N(0, 1), biases and shifts 0.1 N(0, 1), embeddings 0.02
    N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def mat(*shape, std=None):
        std = 1 / math.sqrt(math.prod(shape[1:])) if std is None else std
        return (std * torch.randn(*shape, generator=g, device=dev)).cpu()

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).cpu()

    def norm(sd, prefix, w):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = vec(w, 1.0), vec(w)

    def linear(sd, prefix, o, i):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = mat(o, i), vec(o)

    def openai_blocks(sd, prefix, w, layers):
        for i in range(layers):
            lp = f"{prefix}transformer.resblocks.{i}"
            linear(sd, f"{lp}.attn", 3 * w, w)
            sd[f"{lp}.attn.in_proj_weight"] = sd.pop(f"{lp}.attn.weight")
            sd[f"{lp}.attn.in_proj_bias"] = sd.pop(f"{lp}.attn.bias")
            linear(sd, f"{lp}.attn.out_proj", w, w)
            norm(sd, f"{lp}.ln_1", w)
            norm(sd, f"{lp}.ln_2", w)
            linear(sd, f"{lp}.mlp.c_fc", 4 * w, w)
            linear(sd, f"{lp}.mlp.c_proj", w, 4 * w)

    openai = {"token_embedding.weight": mat(CLIP_VOCAB, 768, std=0.02),
              "positional_embedding": mat(77, 768, std=0.02),
              "text_projection": mat(768, 768)}
    openai_blocks(openai, "", 768, 12)
    norm(openai, "ln_final", 768)
    openai.update({"visual.conv1.weight": mat(1024, 3, 14, 14),
                   "visual.class_embedding": mat(1024, std=0.02),
                   "visual.positional_embedding": mat(257, 1024, std=0.02),
                   "visual.proj": mat(1024, 768)})
    openai_blocks(openai, "visual.", 1024, 24)
    norm(openai, "visual.ln_pre", 1024)
    norm(openai, "visual.ln_post", 1024)
    p = "text_model."
    laion = {f"{p}embeddings.token_embedding.weight": mat(CLIP_VOCAB, 768,
                                                          std=0.02),
             f"{p}embeddings.position_embedding.weight": mat(77, 768,
                                                             std=0.02),
             "text_projection.weight": mat(768, 768)}
    for i in range(12):
        lp = f"{p}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(laion, f"{lp}.self_attn.{proj}", 768, 768)
        norm(laion, f"{lp}.layer_norm1", 768)
        norm(laion, f"{lp}.layer_norm2", 768)
        linear(laion, f"{lp}.mlp.fc1", 3072, 768)
        linear(laion, f"{lp}.mlp.fc2", 768, 3072)
    norm(laion, f"{p}final_layer_norm", 768)
    return openai, laion


def _write_merges(path: str) -> None:
    """A synthetic merges table in openai's gzip format (a header line,
    then the merges): each caption word of `data/tree.py` built up a
    character at a time. The real table (48,894 merges) is not in the
    repository."""
    import gzip

    from upgpt_torch.data.tree import _WORDS

    merges = []
    for word in _WORDS:
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        while len(pieces) > 1:
            pair = (pieces[0], pieces[1])
            if pair not in merges:
                merges.append(pair)
            pieces = [pieces[0] + pieces[1]] + pieces[2:]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [" ".join(m) for m in merges]))


def _captions(n: int, seed: int) -> list:
    import numpy as np

    from upgpt_torch.data.tree import _WORDS

    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(4, 12))))
            for _ in range(n)]


def _clip_flops(b: int, t: int, d: int, layers: int) -> float:
    """A CLIP tower's float32 operations: per block Q/K/V/out and the MLP
    (24 T D^2) and the two attention products (4 T^2 D), per sequence."""
    return b * layers * (24 * t * d * d + 4 * t * t * d)


def clip_run(dev, card: str, work: str) -> dict:
    """The CLIP towers at full width: synthetic openai and laion state
    dicts and a merges file written under `work`, towers built through
    `CLIPConditioningEncoder.from_files` on the card, each held against
    the same tower on the CPU, then the encode of one training batch (12
    captions, 12 x 9 uint8 crops) timed. Returns the files for the laion
    phase and the measurements."""
    from upgpt_torch.convert.clip_weights import (
        text_tower_from_state_dict, vision_tower_from_state_dict,
    )
    from upgpt_torch.inference.encoders import CLIPConditioningEncoder

    t0 = time.perf_counter()
    openai, laion = _clip_state_dicts(dev, seed=61)
    files = {"openai": os.path.join(work, "openai_vit_l14.pt"),
             "laion_text": os.path.join(work, "laion_text_hf.pt"),
             "bpe": os.path.join(work, "bpe_simple_vocab.txt.gz")}
    torch.save(openai, files["openai"])
    torch.save(laion, files["laion_text"])
    _write_merges(files["bpe"])
    print(f"clip phase: synthetic state dicts written in "
          f"{time.perf_counter() - t0:.3f} s ("
          f"{sum(v.numel() for v in openai.values()) / 1e6:.1f} M + "
          f"{sum(v.numel() for v in laion.values()) / 1e6:.1f} M values)",
          flush=True)
    encoders = {
        "openai": CLIPConditioningEncoder.from_files(
            files["openai"], files["openai"], files["bpe"], quick_gelu=True,
            device=dev),
        "laion": CLIPConditioningEncoder.from_files(
            files["laion_text"], files["openai"], files["bpe"],
            quick_gelu=False, device=dev)}
    tok = encoders["laion"].tokenizer
    ids = torch.from_numpy(tok(_captions(CLIP_CHECK_TEXTS, 62)))
    crops = torch.randint(0, 256, (CLIP_CHECK_CROPS, 224, 224, 3),
                          generator=torch.Generator().manual_seed(63),
                          dtype=torch.uint8)
    from upgpt_torch.inference.encoders import _dequant_styles

    pixels = _dequant_styles(crops)
    checks = {}
    with torch.no_grad():
        for name, sd, quick in (("openai_text", openai, True),
                                ("laion_text", laion, False)):
            cpu = text_tower_from_state_dict(sd, quick, "cpu")
            gpu = encoders["openai" if quick else "laion"].text_tower
            want, got = cpu(ids), gpu(ids.to(dev))
            checks[name] = max(
                ((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, want))
            del cpu
        cpu = vision_tower_from_state_dict(openai, False, "cpu")
        want = cpu(pixels)
        got = encoders["laion"].style_encoder.vision(pixels.to(dev))
        checks["vision_l14"] = max(
            ((a.cpu() - b).abs().max() / b.abs().max()).item()
            for a, b in zip(got, want))
        del cpu
    del openai, laion
    for name, rel in checks.items():
        print(f"clip {name} on the card vs the CPU (float32; hidden states "
              f"and pooled): max|d|/max|ref| {rel:.3e}", flush=True)
        if not math.isfinite(rel) or rel > CLIP_REL_TOL:
            raise RuntimeError(f"clip {name}: card and CPU disagree "
                               f"({rel:.3e} > {CLIP_REL_TOL})")
    # the encode of one training batch: the trainer's device half
    b = TRAIN_BATCH
    batch = {"token_ids": torch.from_numpy(tok(_captions(b, 64))).to(dev),
             "styles": torch.randint(0, 256, (b, 9, 224, 224, 3), device=dev,
                                     dtype=torch.uint8)}
    enc = encoders["laion"]
    times = {}
    with torch.no_grad():
        for name, fn in (
                ("encode", lambda: enc.encode_device(batch)),
                ("text", lambda: enc.text_tower(batch["token_ids"])),
                ("styles", lambda: enc.style_encoder(
                    _dequant_styles(batch["styles"])))):
            times[name] = _time_ms(fn, CLIP_TIMED)
        out = enc.encode_device(batch)
    if (tuple(out["text_emb"].shape) != (b, 77, 768)
            or tuple(out["style_emb"].shape) != (b, 9, 768)
            or not all(torch.isfinite(v).all() for v in out.values())):
        raise RuntimeError(f"clip encode: "
                           f"{[(k, tuple(v.shape)) for k, v in out.items()]}")
    flops = (_clip_flops(b, 77, 768, 12)
             + _clip_flops(9 * b, 257, 1024, 24)
             + 2 * 9 * b * 256 * 1024 * 3 * 14 * 14)
    bound_ms = flops / PEAK_F32 * 1e3
    print(f"clip encode of a training batch ({b} captions, {b}x9 uint8 "
          f"crops; laion towers, float32): {times['encode']:.2f} ms (text "
          f"{times['text']:.2f}, styles {times['styles']:.2f}); "
          f"{flops / 1e12:.2f} TFLOP, float32 bound {bound_ms:.2f} ms at "
          f"67 TFLOP/s; on {card}", flush=True)
    del encoders, enc, batch, out
    torch.cuda.empty_cache()
    return {"files": files, "rel_err": checks, "encode_ms": times,
            "encode_tflop": flops / 1e12, "encode_bound_ms": bound_ms}


def laion_run(dev, card: str, work: str, clip: dict) -> dict:
    """inshop_laion at full width (the interp_256 U-Net with the text-style
    fusion, a 78-token context, `use_checkpoint`): one AdamW step of the
    kernel path against the plain path; the bare train step at batch 12
    with and without rematerialisation (ms, peak memory, launches against
    `expected_train_counts`); then `cli train --base
    configs/deepfashion/inshop_laion_clip.yaml` through the CLIP encoder
    (the clip phase's files) over a tree, its steps' launches held to the
    structure, the fusion's weights moving, and `cli sample` from its
    checkpoint at batch 12, DDIM-50, its launches against
    `expected_sampling_counts(model, 12, tk=78)`. Returns the paths
    `laion_train` and `laion_sample`."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from upgpt_torch import cli
    from upgpt_torch.config import instantiate_from_config, merge_configs
    from upgpt_torch.data.tree import write_fashion_tree
    from upgpt_torch.training import trainer as trainer_mod
    from upgpt_torch.training.train_state import create_train_state, train_step
    from upgpt_torch.zoo import build_latent_diffusion

    def build(kernels: bool):
        return build_latent_diffusion(
            "inshop_laion", dtype="bfloat16", param_dtype="float32",
            device=dev, use_checkpoint=True, use_flash_attention=kernels,
            use_fused_transformer=kernels, use_fused_groupnorm=kernels)

    # --- one step, kernel path vs plain path, batch 2 ---
    model = build(True)
    _redraw(model, seed=71, dev=dev)
    plain = build(False)
    e2e = step_kernel_vs_plain(model, plain, dev, 72, "inshop_laion training")
    del plain
    torch.cuda.empty_cache()
    if context_tokens(model) != LAION_CONTEXT_TOKENS:
        raise RuntimeError(f"inshop_laion context {context_tokens(model)}")

    # --- the bare step at batch 12, with and without rematerialisation ---
    batch = _train_batch(model, TRAIN_BATCH, dev, seed=73)
    gen = torch.Generator(device=dev).manual_seed(74)
    bare = {}
    for remat in (True, False):
        model.unet.config = dataclasses.replace(model.unet.config,
                                                use_checkpoint=remat)
        expected = expected_train_counts(model)
        state = create_train_state(model, LEARNING_RATE)
        train_step(model, state, batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts = [], []
        for _ in range(2):
            _reset_counts()
            t0 = time.perf_counter()
            state, metrics = train_step(model, state, batch, gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            counts.append(_read_counts())
        if any(c != expected for c in counts) or not math.isfinite(
                metrics["loss"].item()):
            raise RuntimeError(f"inshop_laion step (use_checkpoint={remat}) "
                               f"launches {counts}, expected {expected}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the forward and backward alone, above what stays resident (the
        # masters, AdamW's moments, the EMA): the saved activations and
        # the gradients, without the optimizer's temporaries
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.training_loss(batch, gen)[0].backward()
        torch.cuda.synchronize()
        above = (torch.cuda.max_memory_allocated() - resident) / 2**30
        bare[remat] = {"ms_per_step": times, "launches": counts[0],
                       "peak_memory_gib": peak,
                       "resident_gib": resident / 2**30,
                       "forward_backward_gib": above}
        print(f"inshop_laion train step batch {TRAIN_BATCH} (embeddings "
              f"given), use_checkpoint={remat}: "
              f"{' '.join(f'{x:.2f}' for x in times)} ms/step, peak memory "
              f"{peak:.3f} GiB a step; forward + backward "
              f"{above:.3f} GiB above the resident {resident / 2**30:.3f} "
              f"GiB; launches per step {counts[0]}; on {card}", flush=True)
        del state
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    del model, batch
    torch.cuda.empty_cache()

    # --- cli train through the CLIP encoder ---
    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, LAION_CONFIG)
    tree = write_fashion_tree(os.path.join(work, "tree"),
                              {"train": LAION_TRAIN_PAIRS,
                               "validation": LAION_VAL_PAIRS}, seed=75)
    logdir = os.path.join(work, "run")
    files = clip["files"]
    dotlist = [f"data.{s}.params.{k}={tree[v]}"
               for s in ("train", "validation")
               for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    dotlist += [f"data.train.params.pair_file=['{tree['train']}']",
                f"data.validation.params.pair_file=['{tree['validation']}']",
                f"trainer.batch_size={TRAIN_BATCH}", "trainer.log_every=1",
                "trainer.warm_up_steps=1", "trainer.max_epochs=1",
                f"trainer.logdir={logdir}", "trainer.compact_transport=True",
                f"clip.text_params={files['laion_text']}",
                f"clip.vision_params={files['openai']}",
                f"clip.bpe_path={files['bpe']}"]
    dotlist += [f"model.params.{k}=True" for k in FIT_KERNELS]
    cfg = merge_configs([config], dotlist)
    if not cfg["model"]["params"].get("use_checkpoint"):
        raise RuntimeError("inshop_laion_clip.yaml no longer sets "
                           "use_checkpoint")
    with torch.device("meta"):
        meta = instantiate_from_config(
            {**cfg["model"], "params": {**cfg["model"]["params"],
                                        "device": "meta"}})
    expected = expected_train_counts(meta)
    steps = len(instantiate_from_config(cfg["data"]["train"])) // TRAIN_BATCH
    val_batches = len(instantiate_from_config(
        cfg["data"]["validation"])) // TRAIN_BATCH
    probe = _StepProbe(trainer_mod.train_step)
    fusion_start = {}

    def step(model, state, batch, gen):
        if not fusion_start:
            fusion_start.update(
                (n, p.detach().clone()) for n, p in zip(state.names,
                                                        state.params)
                if n.startswith("cond_fusion."))
        return probe(model, state, batch, gen)

    trainer_mod.train_step = step
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state = cli.main(["train"] + dotlist + ["--base", config])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
    finally:
        trainer_mod.train_step = probe.fn
    train_counts = _read_counts()
    records = [json.loads(line) for line in open(
        os.path.join(logdir, "metrics.jsonl"))]
    losses = [r["loss"] for r in records if "loss" in r]
    if (state.step != steps or len(probe.records) != steps
            or len(losses) != steps
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"laion cli train: {state.step} steps, losses "
                           f"{losses}")
    bad = [(i, r["launches"]) for i, r in enumerate(probe.records)
           if r["launches"] != expected]
    if bad:
        raise RuntimeError(f"laion step launches {bad[:2]}, expected "
                           f"{expected} per step")
    want = _fit_counts(meta, expected, steps=steps,
                       evals=2 * (1 + val_batches), image_logs=0)
    if train_counts != want:
        raise RuntimeError(f"laion cli train launches {train_counts}, "
                           f"expected {want}")
    by_name = dict(zip(state.names, state.params))
    moved = sum(not torch.equal(fusion_start[n], by_name[n])
                for n in fusion_start)
    reached = sum(bool(by_name[n].grad is not None
                       and by_name[n].grad.abs().max() > 0)
                  for n in fusion_start)
    if not fusion_start or moved != len(fusion_start) or reached == 0:
        raise RuntimeError(f"cond_fusion: {moved}/{len(fusion_start)} "
                           f"tensors moved, {reached} with a gradient on "
                           f"the last step")
    for r in probe.records:
        r["device_ms"] = r["events"][0].elapsed_time(r["events"][1])
    loop = _fit_intervals(probe.records, steps)
    loop_ms = float(np.median(loop))
    event_ms = " ".join(f"{r['device_ms']:.2f}" for r in probe.records)
    print(f"laion cli train (inshop_laion_clip.yaml, batch {TRAIN_BATCH}, "
          f"use_checkpoint, CLIP encoder on the card, compact transport): "
          f"losses {' '.join(f'{x:.6f}' for x in losses)}; fit loop "
          f"{' '.join(f'{x:.2f}' for x in loop)} ms/step, median "
          f"{loop_ms:.2f} ms/step = {TRAIN_BATCH / loop_ms * 1e3:.3f} img/s;"
          f" CUDA events around each step {event_ms} ms; "
          f"the encode alone {clip['encode_ms']['encode']:.2f} ms a batch "
          f"(clip phase); {moved}/{len(fusion_start)} fusion tensors moved, "
          f"{reached} with a gradient on the last step; launches per step "
          f"{expected}, in all {train_counts}; {train_wall:.3f} s of wall; "
          f"on {card}", flush=True)
    del state, by_name, fusion_start
    torch.cuda.empty_cache()

    # --- cli sample from that checkpoint through the CLIP encoder ---
    out_dir = os.path.join(work, "samples")
    expected_sample = expected_sampling_counts(
        meta, TRAIN_BATCH, LAION_CONTEXT_TOKENS, LAION_SAMPLE_STEPS)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    imgs = cli.main(["sample", "--base", config, "--ckpt",
                     os.path.join(logdir, "checkpoints", "last"), "--batch",
                     str(TRAIN_BATCH), "--steps", str(LAION_SAMPLE_STEPS),
                     "--out", out_dir] + dotlist)
    sample_wall = time.perf_counter() - t0
    sample_counts = _read_counts()
    files_out = sorted(os.listdir(out_dir))
    shapes = {np.asarray(Image.open(os.path.join(out_dir, f))).shape
              for f in files_out}
    if (len(files_out) != TRAIN_BATCH or shapes != {(256, 192, 3)}
            or not np.isfinite(imgs).all()):
        raise RuntimeError(f"laion cli sample wrote {files_out}, shapes "
                           f"{shapes}")
    if sample_counts != expected_sample:
        raise RuntimeError(f"laion cli sample launches {sample_counts}, "
                           f"expected {expected_sample}")
    print(f"laion cli sample from checkpoints/last through the CLIP "
          f"encoder: {TRAIN_BATCH} JPEGs of 256x192, DDIM-"
          f"{LAION_SAMPLE_STEPS} eta 1, {sample_wall:.3f} s of wall (model "
          f"build, load and encode included); launches {sample_counts}",
          flush=True)
    train = {"launches": train_counts, "steps": steps, "losses": losses,
             "ms_per_step": loop, "median_ms_per_step": loop_ms,
             "step_event_ms": [r["device_ms"] for r in probe.records],
             "launches_per_step": expected, "wall_s": train_wall,
             "bare_step": {str(k): v for k, v in bare.items()},
             "encode_ms": clip["encode_ms"], **e2e}
    return {"laion_train": train,
            "laion_sample": {"launches": sample_counts,
                             "wall_s": sample_wall}}


def clip_and_laion_run(dev, card: str) -> dict:
    """The clip phase, then the inshop_laion phases on its files, in a
    temporary directory under `upgpt_torch/_build` removed after."""
    import shutil
    import tempfile

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "upgpt_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir, prefix="laion-")
    try:
        clip = clip_run(dev, card, work)
        torch.cuda.empty_cache()
        out = laion_run(dev, card, work, clip)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["laion_train"]["clip"] = {k: v for k, v in clip.items()
                                  if k != "files"}
    return out


def _level(cfg, name: str) -> int:
    """The U-Net level (2**level downsampling) of a module name."""
    if name.startswith("mid"):
        return len(cfg.channel_mult) - 1
    return int(name.split("_")[1])


def expected_sampling_counts(model, b: int, tk: int,
                             steps: int = STEPS) -> dict:
    """Kernel launches of one sampling run of `model` (`steps` U-Net evals,
    DDIM-50 by default) at batch `b` with a `tk`-token context, and one
    decode, from the model's structure: per U-Net eval, the
    SpatialTransformers K1 takes, the flash forward in the others' self-
    attention where its gate admits the shape, the ResBlock half-steps the
    half-step gate admits at level 2 (plain otherwise) or the GroupNorm
    kernel takes at level 1, and the out head's GroupNorm, with the fused
    calls their gates send to the plain path counted apart; per decode,
    each VAE GroupNorm on the one-pass or the row-tiled route and the mid
    AttnBlock's flash forward."""
    from upgpt_torch.models.unet import cross_attention_layers
    from upgpt_torch.models.vae import VAEGroupNorm
    from upgpt_torch.ops.flash_attention import flash_attention_qualifies
    from upgpt_torch.ops.fused_gn import (
        fused_group_norm_qualifies, tiled_group_norm_qualifies,
    )
    from upgpt_torch.ops.fused_resblock import fused_resblock_qualifies
    from upgpt_torch.ops.fused_transformer import fused_transformer_qualifies

    cfg = model.config
    ucfg, vcfg = cfg.unet, cfg.vae
    h, w = cfg.latent_size
    heads, dtype = ucfg.num_heads, model.unet.compute_dtype
    n = {k: 0 for k in ("fused_transformer_block", "flash_attention",
                        "fused_group_norm", "tiled_group_norm",
                        "fused_resblock", "fused_group_norm_plain_routes",
                        "fused_resblock_plain_routes")}
    for name, ch in cross_attention_layers(ucfg):
        s = 2 ** _level(ucfg, name)
        t = (h // s) * (w // s)
        if ucfg.use_fused_transformer and fused_transformer_qualifies(
                t, ch, heads, tk):
            n["fused_transformer_block"] += 1
        elif ucfg.use_flash_attention:
            n["flash_attention"] += flash_attention_qualifies(
                b, heads, t, t, ch // heads, dtype)
    for kind, name in model.unet._plan:
        if kind != "res":
            continue
        s = 2 ** _level(ucfg, name)
        blk = getattr(model.unet, name)
        cout = blk.conv_in.out_channels
        for cin in (blk.norm_in.weight.numel(), cout):
            shape = (b, h // s, w // s, cin)
            if blk.fused >= 2:
                fits = fused_resblock_qualifies(shape, cout)
                n["fused_resblock" if fits
                  else "fused_resblock_plain_routes"] += 1
            elif blk.fused == 1:
                fits = fused_group_norm_qualifies(shape, 32)
                n["fused_group_norm" if fits
                  else "fused_group_norm_plain_routes"] += 1
    if ucfg.use_fused_groupnorm:
        fits = fused_group_norm_qualifies(
            (b, h, w, model.unet.out_norm.weight.numel()), 32)
        n["fused_group_norm" if fits
          else "fused_group_norm_plain_routes"] += 1
    counts = {k: v * steps for k, v in n.items()}
    # the decoder: mid blocks at the latent grid, up_{i} at 2**(levels-1-i)
    # times it, norm_out at the image size
    levels = len(vcfg.ch_mult)
    for name, mod in model.vae.decoder.named_modules():
        if not isinstance(mod, VAEGroupNorm) or not mod.fused:
            continue
        top = name.split(".")[0]
        if top.startswith("mid"):
            f = 1
        elif top == "norm_out":
            f = 2 ** (levels - 1)
        else:
            f = 2 ** (levels - 1 - int(top.split("_")[1]))
        shape = (b, h * f, w * f, mod.weight.numel())
        if fused_group_norm_qualifies(shape, 32):
            counts["fused_group_norm"] += 1
        elif tiled_group_norm_qualifies(shape, 32):
            counts["tiled_group_norm"] += 1
        else:
            counts["fused_group_norm_plain_routes"] += 1
    c_mid = vcfg.ch * vcfg.ch_mult[-1]
    counts["flash_attention"] += int(
        vcfg.use_flash_attention and flash_attention_qualifies(
            b, 1, h * w, h * w, c_mid, model.vae.decoder.conv_in.weight.dtype))
    counts.update(flash_backward_dq=0, flash_backward_dkv=0,
                  flash_reference_backwards=0, **_NO_FMA, **_NO_SELFATTN)
    return counts


def chain_run(dev, card: str) -> dict:
    from upgpt_torch.inference.pipeline import (
        ChainedUpscalePipeline, prepare_lr_condition,
    )
    from upgpt_torch.models.unet import precompute_cross_kv
    from upgpt_torch.ops import fused_resblock as frb
    from upgpt_torch.zoo import build_latent_diffusion

    def build(variant: str, kernels: bool):
        return build_latent_diffusion(
            variant, dtype="bfloat16", device=dev,
            use_flash_attention=kernels, use_fused_transformer=kernels,
            use_fused_groupnorm=kernels, use_fused_resblock=kernels,
            use_fused_vae_groupnorm=kernels)

    base, up = build("interp_256", True), build("upscale", True)
    _redraw(base, seed=31, dev=dev)
    _redraw(up, seed=32, dev=dev)
    plain_base, plain_up = build("interp_256", False), build("upscale", False)
    plain_base.load_state_dict(base.state_dict())
    plain_up.load_state_dict(up.state_dict())
    h, w = base.config.latent_size
    uh, uw = up.config.latent_size
    f = 2 ** (len(up.config.vae.ch_mult) - 1)
    image = (f * uh, f * uw, 3)  # (512, 384, 3)

    # --- end to end, kernel path vs plain path, batch 2 ---
    small = _batch(2, h, w, dev, seed=33)
    g = torch.Generator(device=dev).manual_seed(34)
    x_t = torch.randn(2, h, w, 4, generator=g, device=dev)
    up_x_t = torch.randn(2, uh, uw, 3, generator=g, device=dev)
    lr = torch.rand(2, 2 * uh, 2 * uw, 3, generator=g, device=dev) * 2 - 1
    with torch.inference_mode():
        eps, img = {}, {}
        for tag, (mb, mu) in (("kernel", (base, up)),
                              ("plain", (plain_base, plain_up))):
            ctx = mu.build_context(small["text_emb"], small["style_emb"])
            cond = {"c_crossattn": ctx,
                    "c_concat": prepare_lr_condition(lr, (uh, uw)),
                    "cross_kv": precompute_cross_kv(mu.unet, ctx)}
            t = torch.tensor([981, 421], device=dev)
            eps[tag] = mu.apply_model(up_x_t, t, cond)
            img[tag] = ChainedUpscalePipeline(mb, mu, num_steps=4, eta=0.0
                                              ).generate(small, x_T=x_t,
                                                         up_x_T=up_x_t)
    for tag in ("kernel", "plain"):
        for what, val in (("upscale eps", eps[tag]), ("image", img[tag])):
            if not torch.isfinite(val).all():
                raise RuntimeError(f"chain {tag} path: non-finite {what}")
    if tuple(img["kernel"].shape) != (2,) + image:
        raise RuntimeError(f"chain image {tuple(img['kernel'].shape)}")
    e2e = {"chain_eps_rel_l2": _rel_l2(eps["kernel"], eps["plain"]),
           "chain_image_rel_l2": _rel_l2(img["kernel"], img["plain"])}
    print(f"chain end to end (batch 2): upscale eps rel L2 "
          f"{e2e['chain_eps_rel_l2']:.3e}, 4-step eta-0 chain 512x384 image "
          f"rel L2 {e2e['chain_image_rel_l2']:.3e}", flush=True)
    if (e2e["chain_eps_rel_l2"] > CHAIN_EPS_REL_L2
            or e2e["chain_image_rel_l2"] > CHAIN_IMAGE_REL_L2):
        raise RuntimeError(f"chain kernel path disagrees with plain path: "
                           f"{e2e}")
    del plain_base, plain_up, eps, img
    torch.cuda.empty_cache()

    # --- the chain: DDIM-50 eta 1 through both stages, batch 4, uint8 ---
    pipe = ChainedUpscalePipeline(base, up, num_steps=STEPS, eta=1.0,
                                  output_uint8=True)
    batch = _batch(CHAIN_BATCH, h, w, dev, seed=35)
    expected = {k: a + b for (k, a), b in zip(
        expected_sampling_counts(base, CHAIN_BATCH, CONTEXT_TOKENS).items(),
        expected_sampling_counts(up, CHAIN_BATCH,
                                 UP_CONTEXT_TOKENS).values())}
    t0 = time.perf_counter()
    pipe.generate(batch, torch.Generator(device=dev).manual_seed(36))
    torch.cuda.synchronize()
    print(f"chain warm-up run: {time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    times, counts, by_shape, gn_shapes = [], [], [], []
    for i in range(CHAIN_TIMED_RUNS):
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = pipe.generate(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(_read_counts())
        by_shape.append(dict(frb.fused_gn_silu_conv.launches_by_shape))
        gn_shapes.append(_gn_by_shape(counts[-1]))
        if tuple(out.shape) != (CHAIN_BATCH,) + image or (
                out.dtype != torch.uint8):
            raise RuntimeError(f"chain output {tuple(out.shape)} {out.dtype}")
        if out.min().item() == out.max().item():
            raise RuntimeError("chain output image is constant")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if any(c != expected for c in counts):
        raise RuntimeError(f"chain launch counts {counts}, expected "
                           f"{expected} per run")
    # K7's launches by (shape, O), counted where it launches: the same in
    # every run, and adding up to its launches
    if any(d != by_shape[0] for d in by_shape) or (
            sum(by_shape[0].values()) != counts[0]["fused_resblock"]):
        raise RuntimeError(f"chain K7 launches by shape {by_shape}")
    if any(d != GN_LAUNCHES["chain"] for d in gn_shapes):
        raise RuntimeError(f"chain GroupNorm launches by shape {gn_shapes}, "
                           f"expected {GN_LAUNCHES['chain']} per run")
    sec = min(times)
    print(f"chain DDIM-{STEPS} eta 1 (interp_256 -> upscale) batch "
          f"{CHAIN_BATCH} -> uint8 {tuple(out.shape)}: "
          f"{' '.join(f'{t:.4f}' for t in times)} s/batch, best {sec:.4f} "
          f"s/batch = {CHAIN_BATCH / sec:.4f} img/s on {card}; peak memory "
          f"{peak_gb:.3f} GiB; launches per run {counts[0]}", flush=True)
    return {"launches": counts[0], "k7_by_shape": by_shape[0],
            "gn_by_shape": gn_shapes[0],
            "s_per_batch": times,
            "img_per_s": CHAIN_BATCH / sec, "peak_memory_gib": peak_gb,
            **e2e}


def _http(url: str, payload=None) -> dict:
    """GET `url`, or POST `payload` as JSON; the decoded JSON reply. A
    reply other than 200 raises (urllib's HTTPError)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=(
        "GET" if payload is None else "POST"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as reply:
        if reply.status != 200:
            raise RuntimeError(f"{url}: HTTP {reply.status}")
        return json.loads(reply.read())


def _image_shape(model) -> tuple:
    """(H, W, 3) of the images `model` decodes to."""
    h, w = model.config.latent_size
    f = 2 ** (len(model.config.vae.ch_mult) - 1)
    return (f * h, f * w, 3)


def _served_image(b64: str, shape: tuple):
    """A served PNG through the port's reader, checked to be `shape`."""
    import base64

    from upgpt_torch.inference.png import decode_png

    img = decode_png(base64.b64decode(b64))
    if img.shape != shape:
        raise RuntimeError(f"served image {img.shape}, expected {shape}")
    return img


def _trace_engine(engine) -> list:
    """Record, on the host's clock, when `engine` takes each group
    (`submit`, with its size), packs each batch (`pack`, with its
    requests), returns from each dispatch and finishes each fence: the
    instance's methods wrapped, the engine's code unchanged."""
    timeline = []

    def traced(name, fn, size=lambda *a: None):
        def call(*args):
            out = fn(*args)
            timeline.append((time.perf_counter(), name, size(*args)))
            return out
        return call

    engine.submit_group = traced("submit", engine.submit_group, len)
    engine._pack = traced("pack", engine._pack,
                          lambda items: sum(len(it[0]) for it in items))
    engine.dispatch = traced("dispatched", engine.dispatch)
    engine.fetch = traced("fenced", engine.fetch)
    return timeline


def _mm512_paths(model, plain, dev) -> dict:
    """mm_512's kernel path against its plain path on the same weights at
    batch 2: one U-Net eval, the latents of UniPC-8-karras eta 0, and
    their uint8 image."""
    from upgpt_torch.inference.pipeline import GenerationPipeline, _to_uint8
    from upgpt_torch.models.unet import precompute_cross_kv

    h, w = model.config.latent_size
    small = _batch(2, h, w, dev, seed=72)
    g = torch.Generator(device=dev).manual_seed(73)
    x_t = torch.randn(2, h, w, 4, generator=g, device=dev)
    eps, lat, img = {}, {}, {}
    with torch.inference_mode():
        for tag, m in (("kernel", model), ("plain", plain)):
            ctx = m.build_context(small["text_emb"], small["style_emb"],
                                  small["smpl"])
            cond = {"c_crossattn": ctx, "c_concat": small["person_mask"],
                    "cross_kv": precompute_cross_kv(m.unet, ctx)}
            t = torch.tensor([981, 421], device=dev)
            eps[tag] = m.apply_model(x_t, t, cond)
            lat[tag] = GenerationPipeline(
                m, num_steps=SERVE_STEPS, eta=0.0, sampler="unipc",
                schedule_method="karras", decode=False).generate(
                small, x_T=x_t)
            img[tag] = _to_uint8(torch.clamp(
                m.decode_first_stage(lat[tag]), -1.0, 1.0))
    for tag in ("kernel", "plain"):
        for what, val in (("eps", eps[tag]), ("latents", lat[tag])):
            if not torch.isfinite(val).all():
                raise RuntimeError(f"mm_512 {tag} path: non-finite {what}")
    if tuple(img["kernel"].shape) != (2,) + _image_shape(model):
        raise RuntimeError(f"mm_512 image {tuple(img['kernel'].shape)}")
    e2e = {"mm512_eps_rel_l2": _rel_l2(eps["kernel"], eps["plain"]),
           "mm512_latent_rel_l2": _rel_l2(lat["kernel"], lat["plain"]),
           "mm512_image_rel_l2": _rel_l2(img["kernel"], img["plain"])}
    print(f"mm_512 end to end (batch 2): eps rel L2 "
          f"{e2e['mm512_eps_rel_l2']:.3e}, UniPC-{SERVE_STEPS}-karras "
          f"latents rel L2 {e2e['mm512_latent_rel_l2']:.3e}, uint8 512x384 "
          f"image rel L2 {e2e['mm512_image_rel_l2']:.3e}", flush=True)
    if (e2e["mm512_eps_rel_l2"] > EPS_REL_L2
            or e2e["mm512_latent_rel_l2"] > LATENT_REL_L2
            or e2e["mm512_image_rel_l2"] > IMAGE_REL_L2):
        raise RuntimeError(f"mm_512 kernel path disagrees with plain path: "
                           f"{e2e}")
    return e2e


def serve_run(dev, card: str) -> dict:
    """mm_512 served over HTTP: the model at full width with re-drawn
    weights, held kernel path against plain path; its checkpoint written
    and served through `upgpt_torch.cli`'s construction (UniPC-8-karras,
    eta 0, batch 8, the debug encoder); the raw pipeline timed at the same
    batch; one batch's dispatch under the sync debug mode; then 12
    concurrent /v1/generate requests, a 4-frame /v1/interpolate, /v1/stats
    and /healthz against the server, and one request's image against the
    pipeline's on the same packed batch and generators."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from upgpt_torch.checkpoint import save_checkpoint
    from upgpt_torch.cli import _build_serving, parser
    from upgpt_torch.inference.http_serve import serve
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion(SERVE_VARIANT, dtype="bfloat16",
                                   device=dev)
    _redraw(model, seed=71, dev=dev)
    plain = build_latent_diffusion(
        SERVE_VARIANT, dtype="bfloat16", device=dev,
        use_flash_attention=False, use_fused_transformer=False)
    plain.load_state_dict(model.state_dict())
    e2e = _mm512_paths(model, plain, dev)
    del plain
    repo = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(repo, "upgpt_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ckpt = os.path.join(tmp, "mm_512.pt")
        save_checkpoint(model, ckpt)
        del model
        torch.cuda.empty_cache()
        cfg = {"model": {"target": "upgpt_torch.zoo.build_latent_diffusion",
                         "params": {"variant": SERVE_VARIANT,
                                    "dtype": "bfloat16"}},
               "sampling": {"eta": 0.0}}
        args = parser().parse_args([
            "serve", "--ckpt", ckpt, "--debug-encoder",
            "--batch", str(SERVE_BATCH), "--steps", str(SERVE_STEPS),
            "--sampler", "unipc", "--schedule", "karras",
            "--host", "127.0.0.1", "--port", "0"])
        engine, builder, label = _build_serving(cfg, args)
    pipe, served = engine.pipeline, engine.pipeline.model
    shape = _image_shape(served)
    expected = expected_sampling_counts(served, SERVE_BATCH,
                                        CONTEXT_TOKENS, pipe.num_steps)
    rng = np.random.default_rng(74)
    requests = [{"txt": f"a person in outfit {i}", "seed": i,
                 "smpl": rng.normal(size=(1, 85)).tolist()}
                for i in range(SERVE_REQUESTS)]

    # --- the raw pipeline at the same batch: warm-up + 3 timed runs ---
    batch = engine._pack([([builder.build(r)], None, None)
                          for r in requests[:SERVE_BATCH]])
    times, counts = [], []
    for i in range(1 + TIMED_RUNS):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out, event = engine.dispatch(batch, 1000 + i)
        host = engine.fetch(out, event)
        times.append(time.perf_counter() - t0)
        counts.append(_read_counts())
        if host.shape != (SERVE_BATCH,) + shape or host.min() == host.max():
            raise RuntimeError(f"raw pipeline output {host.shape}, range "
                               f"{host.min()}..{host.max()}")
    times, counts = times[1:], counts[1:]
    if any(c != expected for c in counts):
        raise RuntimeError(f"mm_512 launch counts {counts}, expected "
                           f"{expected} per batch")
    raw_s = min(times)
    print(f"mm_512 raw pipeline ({label}, eta 0) batch {SERVE_BATCH} -> "
          f"uint8 on the host {(SERVE_BATCH,) + shape}: "
          f"{' '.join(f'{t:.4f}' for t in times)} s/batch, best "
          f"{raw_s:.4f} s/batch = {SERVE_BATCH / raw_s:.3f} img/s on {card}; "
          f"launches per batch {counts[0]}", flush=True)

    # --- one served batch's dispatch makes no host sync ---
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, event = engine.dispatch(batch, 2000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    engine.fetch(out, event)
    print("mm_512 dispatch under torch.cuda.set_sync_debug_mode('error'): "
          "no sync raised", flush=True)
    dp = dp_serve_run(engine, batch, card)

    # --- the server: concurrent requests, interpolation, stats ---
    engine.start()
    server = serve(engine, builder, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = _http(url + "/healthz")
        torch.cuda.synchronize()
        _reset_counts()
        timeline = _trace_engine(engine)
        # the clients start together: each waits for all the others
        start = threading.Barrier(SERVE_REQUESTS + 1)

        def client(req):
            start.wait()
            t = time.perf_counter()
            reply = _http(url + "/v1/generate", req)
            return reply, time.perf_counter() - t

        with ThreadPoolExecutor(SERVE_REQUESTS) as pool:
            futures = [pool.submit(client, r) for r in requests]
            start.wait()
            t0 = time.perf_counter()
            replies, client_s = zip(*(f.result() for f in futures))
            wall = time.perf_counter() - t0
        generate_batches = engine.stats.batches
        generate_padded = engine.stats.padded_slots
        generate_stats = engine.stats.summary()
        burst = [(round(t - t0, 4), what, n) for t, what, n in timeline]
        timeline.clear()
        images = [_served_image(r["image_b64"], shape) for r in replies]
        interp = _http(url + "/v1/interpolate", {
            "txt": "a person walking", "seed": 7, "frames": SERVE_FRAMES,
            "smpl_src": rng.normal(size=(1, 85)).tolist(),
            "smpl_dst": rng.normal(size=(1, 85)).tolist()})
        frames = [_served_image(b, shape) for b in interp["frames_b64"]]
        index = engine.stats.batches
        reference = {"txt": "the reference request", "seed": 99}
        served_img = _served_image(
            _http(url + "/v1/generate", reference)["image_b64"], shape)
        stats = _http(url + "/v1/stats")
        batches = engine.stats.batches
        launches = _read_counts()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    if len(frames) != SERVE_FRAMES or not health.get("ok"):
        raise RuntimeError(f"{len(frames)} frames, healthz {health}")
    if stats["requests"] != SERVE_REQUESTS + SERVE_FRAMES + 1 or (
            generate_batches < 2):
        raise RuntimeError(f"stats {stats}, {generate_batches} batches for "
                           f"{SERVE_REQUESTS} requests")
    want = {k: v * batches for k, v in expected.items()}
    if launches != want:
        raise RuntimeError(f"served launches {launches}, expected {want} "
                           f"({batches} batches)")
    # the pipeline on the reference request's packed batch and generators
    gen, host_gen = engine.generators(index)
    with torch.inference_mode():
        direct = pipe.generate(engine.to_device(engine._pack(
            [([builder.build(reference)], None, None)])), gen,
            seed_generator=host_gen)[0].cpu().numpy()
    diff = np.abs(direct.astype(np.int32) - served_img.astype(np.int32))
    differ = float((diff > 0).mean())
    print(f"served image against the pipeline's: max |d| {diff.max()} "
          f"levels, {differ:.6f} of values differ", flush=True)
    if diff.max() > 1:
        raise RuntimeError(f"served image differs from the pipeline's by "
                           f"{diff.max()} levels")
    if len({im.tobytes() for im in images}) != SERVE_REQUESTS:
        raise RuntimeError("two served requests returned the same image")
    img_per_s = SERVE_REQUESTS / wall
    client_s = sorted(client_s)
    print(f"mm_512 burst timeline (s after the clients start: event, "
          f"requests): {burst}", flush=True)
    print(f"mm_512 served ({label}, batch {SERVE_BATCH}, "
          f"{engine.max_in_flight} in flight, {engine.max_delay_s} s "
          f"window): {SERVE_REQUESTS} concurrent /v1/generate in "
          f"{wall:.4f} s = {img_per_s:.3f} img/s ({generate_batches} "
          f"batches, {generate_padded} padded slots); engine latency p50 "
          f"{generate_stats['p50_latency_s']:.4f} s, p95 "
          f"{generate_stats['p95_latency_s']:.4f} s; client latency "
          f"{client_s[0]:.4f}..{client_s[-1]:.4f} s; raw pipeline "
          f"{SERVE_BATCH / raw_s:.3f} img/s, served/raw "
          f"{img_per_s * raw_s / SERVE_BATCH:.3f}; on {card}", flush=True)
    return {"launches": launches, "num_steps": pipe.num_steps,
            "batches": batches, "generate_batches": generate_batches,
            "requests": stats["requests"],
            "generate_padded_slots": generate_padded,
            "padded_slots": engine.stats.padded_slots,
            "served_wall_s": wall, "served_img_per_s": img_per_s,
            "p50_latency_s": generate_stats["p50_latency_s"],
            "p95_latency_s": generate_stats["p95_latency_s"],
            "client_latency_s": client_s, "burst_timeline": burst,
            "raw_s_per_batch": times, "raw_img_per_s": SERVE_BATCH / raw_s,
            "served_max_level_diff": int(diff.max()),
            "served_share_differing": differ, **e2e, "dp_serve": dp}


# The dp engine's images against the one-replica engine's on the same
# requests and generators, uint8: a replica's U-Net runs at 4 rows where
# the one engine's runs at 8, so values round one bf16 step apart here and
# there, and eight UniPC steps carry that into the image. Measured on an
# H100 (700 W): at most 5 levels, 45% of values one level or more apart;
# the bounds: 16 levels, and the images' relative L2 under the sampling
# phase's kernel-vs-plain gate IMAGE_REL_L2 (a difference of the same
# kind: bf16 roundings at other places).
DP_MAX_LEVELS = 16


def dp_serve_run(engine, batch, card: str) -> dict:
    """`ServingEngine(devices=...)`: DP_REPLICAS replicas of the served
    mm_512 pipeline on this card (`cli serve --dp 2` itself exits on one
    card, as JAX's does), the packed batch of SERVE_BATCH split into equal
    parts, held to the one-replica engine's images for the same requests
    and generators; the dp dispatch's launches against the replicas'
    structure."""
    import numpy as np

    from upgpt_torch.cli import _build_serving, parser
    from upgpt_torch.inference.serving import ServingEngine

    args = parser().parse_args(["serve", "--ckpt", "unused.pt",
                                "--debug-encoder", "--dp", str(DP_REPLICAS)])
    try:
        _build_serving({}, args)
    except SystemExit as err:
        refused = str(err)
    else:
        raise RuntimeError(f"--dp {DP_REPLICAS} was served on one card")
    if "exceeds 1 CUDA devices" not in refused:
        raise RuntimeError(f"--dp {DP_REPLICAS} on one card: {refused}")
    pipe = engine.pipeline
    dev = engine.device
    dp = ServingEngine(pipe, batch_size=SERVE_BATCH,
                       devices=[dev] * DP_REPLICAS)
    per = SERVE_BATCH // DP_REPLICAS
    expected = {k: DP_REPLICAS * v for k, v in expected_sampling_counts(
        pipe.model, per, CONTEXT_TOKENS, pipe.num_steps).items()}
    dp.fetch(*dp.dispatch(batch, 3000))  # the copy's first call, untimed
    times = {}
    for name, eng in (("one", engine), ("dp", dp), ("dp", dp),
                      ("one", engine)):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = eng.fetch(*eng.dispatch(batch, 3001))
        times.setdefault(name, []).append(time.perf_counter() - t0)
        if name == "dp":
            got, counts = out, _read_counts()
        else:
            want = out
    if counts != expected:
        raise RuntimeError(f"dp launches {counts}, expected {expected}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    differ = float((diff > 0).mean())
    rel = float(np.sqrt(np.square(diff, dtype=np.float64).sum()
                        / np.square(want, dtype=np.float64).sum()))
    print(f"mm_512 dp engine, {DP_REPLICAS} replicas on {dev} ({per} rows "
          f"each) against one: max |d| {diff.max()} levels, {differ:.6f} of "
          f"values differ, rel L2 {rel:.3e}; s/batch dp "
          f"{' '.join(f'{t:.4f}' for t in times['dp'])}, one "
          f"{' '.join(f'{t:.4f}' for t in times['one'])}; `--dp "
          f"{DP_REPLICAS}` on one card: {refused!r}; launches {counts}; on "
          f"{card}", flush=True)
    if got.shape != want.shape or diff.max() > DP_MAX_LEVELS or (
            rel > IMAGE_REL_L2):
        raise RuntimeError(f"the dp engine's images differ from one "
                           f"replica's: {diff.max()} levels, rel L2 {rel}")
    del dp
    torch.cuda.empty_cache()
    return {"launches": counts, "replicas": DP_REPLICAS,
            "s_per_batch": times["dp"], "one_s_per_batch": times["one"],
            "max_level_diff": int(diff.max()), "share_differing": differ,
            "rel_l2": rel}


# the bringup phase: a drop of re-drawn interp_256 weights in the
# reference's Lightning layout, `cli convert --ema`, then `cli bringup`
# with the bench on; the app phase: the demo app over the converted
# checkpoint and a re-drawn upscale stage
BRINGUP_VARIANT = "interp_256"
APP_FRAMES, APP_STEPS, APP_UNIPC_STEPS = 2, 50, 8
APP_UPSCALE_STEPS = 200  # UpscalePipeline's default
# random weights: the validators' gates (20 dB, 0.5) must reject them, by
# a margin: PSNR below 20 dB and |eps correlation| below 0.1
BRINGUP_CORR_MAX = 0.1


def _hf_clip_state_dict(dev, seed: int) -> dict:
    """An HF CLIPModel state dict at ViT-L/14's widths (text 12 x 768,
    vision 24 x 1024 over 16 x 16 patches of 14, both projections to 768),
    host float32 drawn on the card: weights N(0, 1/fan_in), norm scales
    1 + 0.1 N(0, 1), biases and shifts 0.1 N(0, 1), embeddings 0.02
    N(0, 1). The released snapshot's layout (`pytorch_model.bin`)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def mat(*shape, std=None):
        std = 1 / math.sqrt(math.prod(shape[1:])) if std is None else std
        return (std * torch.randn(*shape, generator=g, device=dev)).cpu()

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).cpu()

    sd = {}

    def norm(prefix, w):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = vec(w, 1.0), vec(w)

    def linear(prefix, o, i):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = mat(o, i), vec(o)

    def encoder(prefix, w, layers):
        for i in range(layers):
            lp = f"{prefix}encoder.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(f"{lp}.self_attn.{proj}", w, w)
            norm(f"{lp}.layer_norm1", w)
            norm(f"{lp}.layer_norm2", w)
            linear(f"{lp}.mlp.fc1", 4 * w, w)
            linear(f"{lp}.mlp.fc2", w, 4 * w)

    t, v = "text_model.", "vision_model."
    sd[f"{t}embeddings.token_embedding.weight"] = mat(CLIP_VOCAB, 768,
                                                      std=0.02)
    sd[f"{t}embeddings.position_embedding.weight"] = mat(77, 768, std=0.02)
    encoder(t, 768, 12)
    norm(f"{t}final_layer_norm", 768)
    sd[f"{v}embeddings.patch_embedding.weight"] = mat(1024, 3, 14, 14)
    sd[f"{v}embeddings.class_embedding"] = mat(1024, std=0.02)
    sd[f"{v}embeddings.position_embedding.weight"] = mat(257, 1024, std=0.02)
    norm(f"{v}pre_layrnorm", 1024)
    norm(f"{v}post_layernorm", 1024)
    encoder(v, 1024, 24)
    sd["text_projection.weight"] = mat(768, 768)
    sd["visual_projection.weight"] = mat(768, 1024)
    return sd


def _add_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def expected_bringup_counts(model, pipes: list) -> dict:
    """`cli bringup`'s launches on one converted variant: the validators
    (an encode and a decode at batch 1, one U-Net eval over a zero 77-token
    context, the block kernel projecting it), the sampler check (each of
    its four pipelines at batch 2 with an 87-token context, one decode
    each) and the bench (a warm-up and three runs of DDIM-50 at batch 8).
    `pipes` are the sampler check's pipelines (their step counts)."""
    from upgpt_torch.bringup import BENCH_BATCH, BENCH_RUNS, BENCH_STEPS
    from upgpt_torch.ops.flash_attention import flash_attention_qualifies

    h, w = model.config.latent_size
    vcfg = model.vae.config
    validate = expected_sampling_counts(model, 1, 77, 1)
    validate["flash_attention"] += int(
        vcfg.use_flash_attention and flash_attention_qualifies(
            1, 1, h * w, h * w, vcfg.ch * vcfg.ch_mult[-1],
            model.vae.encoder.conv_in.weight.dtype))
    checks = [expected_sampling_counts(model, 2, CONTEXT_TOKENS,
                                       p.num_steps) for p in pipes]
    bench = expected_sampling_counts(model, BENCH_BATCH, CONTEXT_TOKENS,
                                     BENCH_STEPS)
    return _add_counts(validate, *checks,
                       *([bench] * (BENCH_RUNS + 1)))


def _write_drop(dev, drop: str) -> dict:
    """The drop: interp_256 re-drawn at full width in float32 on the card,
    written in the reference's Lightning layout with a LitEma shadow of
    half the raw U-Net, non-tensor entries (an argparse Namespace among
    the hyper-parameters, which the weights-only loader refuses); an HF
    CLIP snapshot with the BPE merges; a pt_inception-layout .pth. Returns
    the sources the conversion is held to (host tensors by the port's
    names) and the checkpoint's path and bytes."""
    import argparse

    from upgpt_torch.convert.lightning import to_lightning_state_dict
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion(BRINGUP_VARIANT, dtype="float32",
                                   device=dev)
    _redraw(model, seed=101, dev=dev)
    with torch.no_grad():
        ema = {k: 0.5 * v for k, v in model.unet.state_dict().items()}
        sd = {k: v.cpu() for k, v in
              to_lightning_state_dict(model, ema).items()}
    src = {"unet": {k: v.cpu() for k, v in ema.items()},
           "vae": {k: v.cpu() for k, v in model.vae.state_dict().items()},
           "pose": {k: v.cpu() for k, v in model.pose.state_dict().items()}}
    del model, ema
    torch.cuda.empty_cache()
    ckpt = os.path.join(drop, f"{BRINGUP_VARIANT}.ckpt")
    torch.save({"state_dict": sd, "epoch": 11, "global_step": 123456,
                "pytorch-lightning_version": "1.4.2",
                "hyper_parameters": {"args": argparse.Namespace(
                    base=["configs/deepfashion/interp_256.yaml"],
                    scale_lr=False)}}, ckpt)
    del sd
    clip = os.path.join(drop, "clip-vit-large-patch14")
    os.makedirs(clip)
    torch.save(_hf_clip_state_dict(dev, 103),
               os.path.join(clip, "pytorch_model.bin"))
    _write_merges(os.path.join(clip, "bpe_simple_vocab_16e6.txt.gz"))
    torch.save(_pt_inception_state_dict(105),
               os.path.join(drop, "pt_inception-2015-12-05.pth"))
    return {"src": src, "ckpt": ckpt, "bytes": os.path.getsize(ckpt)}


def _convert_check(dev, drop: dict, conv: str) -> dict:
    """`cli convert --ema` in-process; every tensor of the output against
    its EMA, VAE or pose source bit for bit, and one U-Net eval of the
    converted model against the source weights' on the card (bf16, the
    zoo's switches), equal."""
    from upgpt_torch import cli
    from upgpt_torch.bringup import load_converted
    from upgpt_torch.models.unet import precompute_cross_kv
    from upgpt_torch.zoo import build_latent_diffusion

    t0 = time.perf_counter()
    record = cli.main(["convert", "--torch-ckpt", drop["ckpt"], "--out",
                       conv, "--variant", BRINGUP_VARIANT, "--ema"])
    convert_s = time.perf_counter() - t0
    if not record["ema"] or record["submodels"] != ["pose", "unet", "vae"]:
        raise RuntimeError(f"cli convert: {record}")
    payload = torch.load(conv, map_location="cpu", weights_only=True)
    n = 0
    for part, want in drop["src"].items():
        got = payload[part]
        if sorted(got) != sorted(want):
            raise RuntimeError(f"cli convert: {part} keys differ")
        for k, v in want.items():
            if got[k].dtype != torch.float32 or not torch.equal(got[k], v):
                raise RuntimeError(f"cli convert: {part}.{k} differs from "
                                   f"its source")
            n += 1
    del payload
    cvt = load_converted(BRINGUP_VARIANT, conv, dev)
    src = build_latent_diffusion(BRINGUP_VARIANT, device=dev,
                                 dtype=cvt.unet.conv_in.weight.dtype)
    src.load_state_dict({f"{p}.{k}": v for p, part in drop["src"].items()
                         for k, v in part.items()})
    h, w = src.config.latent_size
    batch = _batch(2, h, w, dev, seed=102)
    x_t = torch.randn(2, h, w, 4, generator=torch.Generator(
        device=dev).manual_seed(104), device=dev)
    t = torch.tensor([981, 421], device=dev)
    eps = []
    with torch.inference_mode():
        for m in (src, cvt):
            ctx = m.build_context(batch["text_emb"], batch["style_emb"],
                                  batch["smpl"])
            eps.append(m.apply_model(x_t, t, {
                "c_crossattn": ctx, "c_concat": batch["person_mask"],
                "cross_kv": precompute_cross_kv(m.unet, ctx)}))
    if not torch.isfinite(eps[0]).all() or not torch.equal(*eps):
        raise RuntimeError(f"converted U-Net eval differs from the source's "
                           f"(max|d| {(eps[0] - eps[1]).abs().max().item()})")
    del src, cvt
    torch.cuda.empty_cache()
    print(f"cli convert --ema: {drop['bytes']} bytes in {convert_s:.3f} s "
          f"({drop['bytes'] / convert_s / 1e9:.3f} GB/s), {n} tensors equal "
          f"to their sources bit for bit; one U-Net eval (batch 2) of the "
          f"converted model equals the source's", flush=True)
    return {"convert_s": convert_s, "tensors": n, "unread": record["unread"]}


def bringup_run(dev, card: str, drop: str, conv: str) -> dict:
    """`cli bringup --drop ... --variants interp_256 --skip-eval` in-process
    with the bench on: exit 3 on random weights, the validators' values
    past their gates, finite sampler SSIMs, the CLIP step's towers loaded
    on the card, report.json and REPORT.md, the bench's img/s, and the
    launches against the structure."""
    from upgpt_torch import cli
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.zoo import build_latent_diffusion

    out = os.path.join(os.path.dirname(drop), "bringup")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["bringup", "--drop", drop, "--out", out, "--variants",
                  BRINGUP_VARIANT, "--skip-eval"])
        code = 0
    except SystemExit as exc:
        code = exc.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    if code != 3:
        raise RuntimeError(f"cli bringup exited {code}, expected 3 (random "
                           f"weights must be rejected)")
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    if not os.path.exists(os.path.join(out, "REPORT.md")):
        raise RuntimeError("cli bringup wrote no REPORT.md")
    steps = report["steps"]
    (val,), (sc,) = steps["validate"], steps["sampler_check"]
    if ("error" in val or val["vae_pass"] or val["unet_pass"]
            or not val["vae_roundtrip_psnr_db"] < 20.0
            or not abs(val["eps_corr_mid_t"]) < BRINGUP_CORR_MAX
            or not val["unet_finite"]):
        raise RuntimeError(f"validators on random weights: {val}")
    ssims = {k: v for k, v in sc.items() if k.startswith("ssim_")}
    if len(ssims) != 3 or not all(math.isfinite(v) for v in ssims.values()):
        raise RuntimeError(f"sampler check: {sc}")
    clip = steps["clip"]
    if "error" in clip or not clip.get("loaded_on", "").startswith("cuda"):
        raise RuntimeError(f"CLIP step: {clip}")
    bench = steps["bench"]
    if "img_per_s" not in bench or bench["shape"] != [8, 256, 192, 3]:
        raise RuntimeError(f"bench step: {bench}")
    # the structure of what the runbook built: the zoo's switches, bf16
    with torch.device("meta"):
        meta = build_latent_diffusion(BRINGUP_VARIANT, dtype="bfloat16",
                                      device="meta")
    pipes = [GenerationPipeline(meta, num_steps=n, eta=0.0, sampler=s,
                                schedule_method=m)
             for s, n, m in (("ddim", 200, "uniform"), ("ddim", 50, "uniform"),
                             ("unipc", 8, "karras"),
                             ("dpm++", 20, "uniform"))]
    expected = expected_bringup_counts(meta, pipes)
    if counts != expected:
        raise RuntimeError(f"cli bringup launches {counts}, expected "
                           f"{expected}")
    sec = report["seconds"]
    print(f"cli bringup: exit 3 in {wall:.3f} s (convert "
          f"{sec['convert:' + BRINGUP_VARIANT]:.3f}, load "
          f"{sec['load:' + BRINGUP_VARIANT]:.3f}, validators "
          f"{sec['validate:' + BRINGUP_VARIANT]:.3f}, sampler check "
          f"{sec['sampler_check:' + BRINGUP_VARIANT]:.3f}, clip "
          f"{sec['clip']:.3f}, bench {sec['bench']:.3f}); VAE PSNR "
          f"{val['vae_roundtrip_psnr_db']:.4f} dB, eps corr "
          f"{val['eps_corr_mid_t']:.5f}; SSIM vs DDIM-200 "
          f"{json.dumps(ssims)}; CLIP towers on {clip['loaded_on']}; "
          f"launches K1 {counts['fused_transformer_block']}, flash "
          f"{counts['flash_attention']}, K5 {counts['fused_group_norm']}",
          flush=True)
    print(f"bringup bench: {bench['protocol']} batch {bench['batch']}: "
          f"{' '.join(f'{t:.4f}' for t in bench['s_per_batch'])} s/batch, "
          f"{bench['img_per_s']:.3f} img/s on {bench['card']}", flush=True)
    return {"launches": counts, "wall_s": wall, "seconds": sec,
            "validate": val, "sampler_check": sc,
            "bench_img_per_s": bench["img_per_s"],
            "bench_s_per_batch": bench["s_per_batch"],
            "clip_loaded_on": clip["loaded_on"]}


def app_run(dev, card: str, conv: str, work: str) -> dict:
    """The demo app on 127.0.0.1 over the converted checkpoint, with an
    upscale stage of re-drawn full-width weights: the page, two-frame
    generates with a style text override at DDIM-50 and at UniPC-8, the
    upscale of the last one, a 404; each request's images and launches
    against the structure, its latency."""
    import threading

    from upgpt_torch import app
    from upgpt_torch.checkpoint import save_checkpoint
    from upgpt_torch.zoo import build_latent_diffusion

    up = build_latent_diffusion("upscale", dtype="bfloat16", device=dev)
    _redraw(up, seed=107, dev=dev)
    up_ckpt = os.path.join(work, "upscale.pt")
    save_checkpoint(up, up_ckpt)
    del up
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    args = app.parser().parse_args([
        "--base", os.path.join(repo, "configs", "deepfashion",
                               "interp_256.yaml"),
        "--ckpt", conv, "--host", "127.0.0.1", "--port", "0",
        "--upscale-base", os.path.join(repo, "configs", "deepfashion",
                                       "upscale.yaml"),
        "--upscale-ckpt", up_ckpt])
    state, mode = app.build_state(args)
    server = app.serve(state, mode, 0, "127.0.0.1")
    load_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    model, upm = state.model, state.upscale.inner.model
    out = {"load_s": load_s, "latency_s": {}}
    counts = {}
    try:
        with urllib.request.urlopen(url + "/", timeout=60) as reply:
            if reply.status != 200 or b"/api/generate" not in reply.read():
                raise RuntimeError("app: the page did not answer")
        base = {"txt": "a woman in a red dress", "frames": APP_FRAMES,
                "pose": "3", "pose2": "5",
                "style_texts": {"top": "a red shirt"}}
        for label, payload, m, steps, tk in (
                ("generate_ddim50", {**base, "steps": APP_STEPS,
                                     "sampler": "ddim"},
                 model, APP_STEPS, CONTEXT_TOKENS),
                ("generate_unipc8", {**base, "steps": APP_UNIPC_STEPS,
                                     "sampler": "unipc"},
                 model, state.pipe(APP_UNIPC_STEPS, "unipc").num_steps,
                 CONTEXT_TOKENS),
                ("upscale", None, upm, APP_UPSCALE_STEPS,
                 UP_CONTEXT_TOKENS)):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            reply = _http(url + ("/api/upscale" if payload is None
                                 else "/api/generate"), payload or {})
            out["latency_s"][label] = time.perf_counter() - t0
            counts[label] = _read_counts()
            shape = _image_shape(m)
            imgs = [_served_image(b, shape) for b in reply["images"]]
            if len(imgs) != APP_FRAMES:
                raise RuntimeError(f"app {label}: {len(imgs)} images")
            expected = expected_sampling_counts(m, APP_FRAMES, tk, steps)
            if counts[label] != expected:
                raise RuntimeError(f"app {label}: launches {counts[label]},"
                                   f" expected {expected}")
            print(f"app {label}: {len(imgs)} PNGs of {shape} in "
                  f"{out['latency_s'][label]:.3f} s; launches K1 "
                  f"{counts[label]['fused_transformer_block']}, flash "
                  f"{counts[label]['flash_attention']}", flush=True)
        try:
            _http(url + "/api/nope", {})
            raise RuntimeError("app: an unknown endpoint answered 200")
        except urllib.error.HTTPError as err:
            if err.code != 404 or "unknown endpoint" not in json.loads(
                    err.read())["error"]:
                raise RuntimeError(f"app: unknown endpoint gave {err.code}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    print(f"app: models loaded in {load_s:.3f} s on {card}", flush=True)
    out["launches"] = _add_counts(*counts.values())
    return out


def bringup_and_app_run(dev, card: str) -> dict:
    """The bringup phase, then the app phase on its converted checkpoint,
    in a temporary directory under `upgpt_torch/_build` removed after."""
    import shutil
    import tempfile

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "upgpt_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=build_dir, prefix="bringup-")
    try:
        t_phase = time.perf_counter()
        drop_dir = os.path.join(work, "drop")
        os.makedirs(drop_dir)
        t0 = time.perf_counter()
        drop = _write_drop(dev, drop_dir)
        write_s = time.perf_counter() - t0
        print(f"bringup drop: {drop['bytes']} bytes of {BRINGUP_VARIANT}.ckpt"
              f" (raw + EMA U-Net, VAE, pose; float32) written in "
              f"{write_s:.3f} s", flush=True)
        conv = os.path.join(work, f"{BRINGUP_VARIANT}.pt")
        convert = _convert_check(dev, drop, conv)
        del drop["src"]
        torch.cuda.empty_cache()
        bring = bringup_run(dev, card, drop_dir, conv)
        shutil.rmtree(drop_dir, ignore_errors=True)
        bring.update(drop_bytes=drop["bytes"], drop_write_s=write_s,
                     **convert)
        bring["phase_s"] = time.perf_counter() - t_phase
        print(f"bringup phase: {bring['phase_s']:.3f} s", flush=True)
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        served = app_run(dev, card, conv, work)
        served["phase_s"] = time.perf_counter() - t_phase
        print(f"app phase: {served['phase_s']:.3f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bringup_run": bring, "app_run": served}


KERNELS = [
    # name, source, replaces (the TPU kernel's def line)
    ("fused_transformer_block", "upgpt_torch/csrc/fused_transformer.cu",
     "upgpt_tpu/ops/fused_transformer.py:436"),
    ("flash_attention", "upgpt_torch/csrc/flash_attention.cu",
     "upgpt_tpu/ops/flash_attention.py:284"),
    ("flash_backward_dq", "upgpt_torch/csrc/flash_backward.cu",
     "upgpt_tpu/ops/flash_attention.py:179"),
    ("flash_backward_dkv", "upgpt_torch/csrc/flash_backward.cu",
     "upgpt_tpu/ops/flash_attention.py:179"),
    ("fused_group_norm", "upgpt_torch/csrc/fused_gn.cu",
     "upgpt_tpu/ops/fused_gn.py:198"),
    ("tiled_group_norm", "upgpt_torch/csrc/gn_stats.cu",
     "upgpt_tpu/ops/fused_gn.py:119"),
    ("fused_resblock", "upgpt_torch/csrc/fused_resblock.cu",
     "upgpt_tpu/ops/fused_resblock.py:134"),
    ("selfattn_fullwidth", "upgpt_torch/csrc/selfattn_leg.cu",
     "benchmarks/micro_block.py:48"),
    ("selfattn_perhead", "upgpt_torch/csrc/selfattn_leg.cu",
     "benchmarks/micro_block.py:90"),
]


def kernel_entry(name, source, replaces, cases, by_path) -> dict:
    """One kernel's line: launches over one sampling run, one train step,
    one chain run, one UniPC run, the serving phase's batches, the fit
    phase's two `cli train` runs (steps, validation, image logs), its
    `cli sample` run, the eval phase's `cli test` and `cli train-vae`
    runs, the laion phase's runs, the bringup phase's `cli bringup` run
    (`bringup_run`), the app phase's three requests (`app_run`), the
    distill phase's two `cli distill` runs (`distill_run`), its student's
    `cli sample` (`distill_sample`) and served batch (`distill_serve`),
    the ddp phase's `cli train --multihost` ranks (`ddp_run`, every
    rank's own counts), the dp engine's batch (`dp_serve`), and one
    micro_block run (there the
    wrapper's calls, the ones captured in its CUDA graphs included; the
    graphs' replays run the kernels again uncounted); ms, plain_ms,
    library_ms and bound_ms summed over the shapes the paths give it (one
    call each); max_abs_err over every case."""
    on_path = [c for c in cases if c["path"] != "none"]
    libs = [c["library_ms"] for c in on_path]
    by_bytes = sum(c["bound_ms"] for c in on_path if c["bound_by"] == "bytes")
    bound_ms = sum(c["bound_ms"] for c in on_path)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["ms"] for c in on_path),
        "plain_ms": sum(c["plain_ms"] for c in on_path),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if by_bytes > bound_ms / 2 else "operations",
        "library_ms": None if None in libs else sum(libs),
        "cases": cases,
    }
    # the same sums in device time (calls replayed from a CUDA graph)
    dev = [c["device_ms"] for c in on_path]
    entry["device_ms"] = None if None in dev else sum(dev)
    if name == "flash_attention":
        entry["also_replaces"] = "upgpt_tpu/ops/flash_attention.py:310"
    if name == "fused_resblock":
        # the chain's K7 time per run: each shape's time by its launches
        entry["chain_run_ms"] = sum(c["ms"] * c["launches_per_chain_run"]
                                    for c in on_path)
        entry["chain_run_library_ms"] = sum(
            c["library_ms"] * c["launches_per_chain_run"] for c in on_path)
        if None not in dev:
            entry["chain_run_device_ms"] = sum(
                c["device_ms"] * c["launches_per_chain_run"]
                for c in on_path)
    if name in ("fused_group_norm", "tiled_group_norm") and None not in dev:
        # each path's time in these kernels per run: device ms by launches
        entry["run_device_ms"] = {
            path: sum(c["device_ms"] * c["launches_per_run"]
                      for c in on_path if c["path"] == path)
            for path in sorted({c["path"] for c in on_path})}
    if name == "flash_backward_dq":
        entry["library_covers"] = "dq, dk and dv together"
    if name.startswith("selfattn_"):
        entry["exp_ms"] = sum(c["exp_ms"] for c in on_path)
        entry["library_call"] = "F.multi_head_attention_forward"
    return entry


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
    cases.update(selfattn_checks(dev))
    grad_rel = resblock_gradient_check(dev)
    model, sampling = slice_run(dev, card)
    torch.cuda.empty_cache()
    unipc = unipc_run(dev, card, model)
    del model
    torch.cuda.empty_cache()
    training = train_run(dev, card)
    torch.cuda.empty_cache()
    distilled = distill_run(dev, card)
    torch.cuda.empty_cache()
    fitted = fit_eval_and_vae_run(dev, card, training["ms_per_step"])
    torch.cuda.empty_cache()
    laion = clip_and_laion_run(dev, card)
    torch.cuda.empty_cache()
    chain = chain_run(dev, card)
    torch.cuda.empty_cache()
    k7_by_shape = chain.pop("k7_by_shape")
    cases["fused_resblock"] = resblock_checks(dev, k7_by_shape)
    # a data-parallel rank's GroupNorm shapes: the train step's at 6 rows
    ddp_gn = {((DDP_RANK_BATCH,) + shape[1:], kind): n
              for (shape, kind), n in GN_LAUNCHES["training"].items()}
    gn = groupnorm_checks(dev, {"training": training.pop("gn_by_shape"),
                                "chain": chain.pop("gn_by_shape"),
                                "ddp": ddp_gn},
                          sorted({key[:4] for key in k7_by_shape}))
    cases["fused_group_norm"] = gn["fused_group_norm"]
    cases["tiled_group_norm"] = gn["tiled_group_norm"]

    served = serve_run(dev, card)
    dp_served = served.pop("dp_serve")
    torch.cuda.empty_cache()
    brought = bringup_and_app_run(dev, card)
    torch.cuda.empty_cache()
    micro = micro_block_run()
    runs = {"sampling_run": sampling, "train_step": training,
            "chain_run": chain, "unipc_run": unipc, "micro_block": micro,
            "serve_run": served, "dp_serve": dp_served, **fitted, **laion,
            **brought, **distilled}
    kernels = [kernel_entry(k, src, rep, cases[k], {
        path: run["launches"][k] for path, run in runs.items()})
        for k, src, rep in KERNELS]
    next(k for k in kernels if k["name"] == "fused_resblock")[
        "gradient_rel_err"] = grad_rel
    tiled = next(k for k in kernels if k["name"] == "tiled_group_norm")
    tiled["k7_head_cases"] = gn["gn_stats_k7"]
    for k in kernels:
        if k["name"] in ("fused_group_norm", "tiled_group_norm"):
            k["latency_floor_ms"] = gn["latency_floor_ms"]
    next(k for k in kernels if k["name"] == "fused_group_norm")[
        "cluster_floor_ms"] = gn["cluster_floor_ms"]
    print(json.dumps({path: {k: v for k, v in run.items()
                             if k != "launches"}
                      for path, run in runs.items()}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
