"""Profile the PyTorch port's sampling path, train step or 256->512 chain on
one NVIDIA GPU.

    python3 profile_slice.py [batch ...]          (default: 8 32)
    python3 profile_slice.py --train [batch ...]  (default: 12)
    python3 profile_slice.py --chain [batch ...]  (default: 4)

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. For each batch it builds interp_256 at full width with seeded
random weights (as chip_smoke.py does): in bf16 for sampling, or with
float32 masters under bf16 compute and the training kernels on for
`--train`. `--chain` builds interp_256 and upscale in bf16 with the
chain's GroupNorm kernel switches on (as chip_smoke.py's chain phase) and
profiles its two stages one after the other: the 256 stage
(GenerationPipeline(DDIM-50, eta 1) to a float image), then the upscale
stage from that image (UpscalePipeline(DDIM-50, eta 1, uint8)), so that
each profiled run stays near the sampling path's activity count. It runs
the program (GenerationPipeline(DDIM-50, eta 1, uint8), one train step:
VAE encode, U-Net forward and backward, AdamW, EMA, or a chain stage) once
to warm up (twice for a train step), once timed without the profiler, and
once under torch.profiler, then prints

- the unprofiled wall time per batch and img/s;
- device busy time: the length of the union of the intervals of every
  device activity the profiler recorded (kernels, copies, sets; not the
  ranges of user annotations such as an optimizer step), and the
  busy share, busy time / unprofiled wall time (idle share = 1 - busy);
- device time by kind, summed over the device activities alone (the CPU
  operator rows, which carry their kernels' time a second time, are left
  out), each with its share of that sum, and the 15 longest kernels.

The card's name and power limit are printed first.
"""

import collections
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

STEPS = 50

# (kind, test on the lower-cased kernel name), first match wins; the
# optimizer's multi_tensor_apply_kernel comes before K6's apply_kernel
KINDS = [
    ("optimizer and EMA (foreach)", lambda n: "multi_tensor" in n),
    ("attention (csrc, K1 and flash)",
     lambda n: "attention_mma_kernel" in n or "attention_fma_kernel" in n),
    ("K1 GEMMs (csrc)", lambda n: "gemm_kernel<" in n),
    ("K1 GroupNorm stats (csrc)", lambda n: "gn_stats_kernel" in n),
    ("flash backward K4 (csrc)",
     lambda n: any(s in n for s in ("dq_mma_kernel", "dkv_mma_kernel",
                                    "dq_fma_kernel", "dkv_fma_kernel"))),
    ("GroupNorm+SiLU K5 (csrc)", lambda n: "gn_kernel<" in n),
    ("GroupNorm stats K6/K7 (csrc)", lambda n: "partial_kernel<" in n
     or "finalize_kernel" in n),
    ("GroupNorm apply K6 (csrc)", lambda n: "apply_kernel<" in n),
    ("GN+SiLU+conv K7 (csrc)", lambda n: "conv_kernel<" in n),
    ("memcpy / memset", lambda n: n.startswith(("memcpy", "memset"))),
    ("convolutions (cuDNN)",
     lambda n: any(s in n for s in ("conv", "implicit", "fprop", "cudnn"))),
    ("GEMMs (cuBLAS)",
     lambda n: any(s in n for s in ("gemm", "cutlass", "cublas", "xmma"))),
    ("softmax", lambda n: "softmax" in n),
    ("reductions", lambda n: "reduce" in n),
    ("copies and casts", lambda n: "copy" in n),
    ("other elementwise", lambda n: True),
]


def _kind(name: str) -> str:
    low = name.lower()
    return next(kind for kind, test in KINDS if test(low))


def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_run(run, label: str, b: int, card: str) -> None:
    """`run(seed)` once timed without the profiler, once under it."""
    t0 = time.perf_counter()
    run(1)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        profiled_wall = time.perf_counter() - t0
    # device activities, without the profiler's user-annotation ranges
    # (an optimizer step's range spans kernels that are counted themselves)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in device) / 1e6
    by_kind = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in device:
        dur = e.time_range.end - e.time_range.start
        by_kind[_kind(e.name)] += dur
        by_name[e.name] += dur
        calls[e.name] += 1
    total = sum(by_kind.values())
    print(f"batch {b}: {label} wall {wall:.4f} s = {b / wall:.3f} img/s "
          f"(profiled run {profiled_wall:.4f} s) on {card}", flush=True)
    print(f"batch {b}: device busy {busy:.4f} s, busy share {busy / wall:.4f}"
          f", idle share {1 - busy / wall:.4f}; {len(device)} device "
          f"activities summing to {total / 1e6:.4f} s", flush=True)
    for kind, us in by_kind.most_common():
        print(f"  {kind:32s} {us / 1e3:11.3f} ms  {us / total:.4f}")
    print(f"batch {b}: the 15 longest kernels (ms, calls, name)")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3:11.3f} {calls[name]:7d}  {name[:110]}")


def profile_sampling(model, b: int, dev, card: str) -> None:
    from upgpt_torch.inference.pipeline import GenerationPipeline

    h, w = model.config.latent_size
    batch = chip_smoke._batch(b, h, w, dev, seed=4)
    pipe = GenerationPipeline(model, num_steps=STEPS, eta=1.0,
                              output_uint8=True)

    def run(seed):
        pipe.generate(batch, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()

    run(0)
    profile_run(run, f"DDIM-{STEPS} eta 1 per batch", b, card)


def profile_train(model, b: int, dev, card: str) -> None:
    from upgpt_torch.training.train_state import create_train_state, train_step

    state = create_train_state(model, chip_smoke.LEARNING_RATE)
    batch = chip_smoke._train_batch(model, b, dev, seed=24)
    gen = torch.Generator(device=dev).manual_seed(25)

    def run(_seed):
        train_step(model, state, batch, gen)
        torch.cuda.synchronize()

    run(0)
    run(0)
    profile_run(run, "train step", b, card)


def profile_chain(b: int, dev, card: str) -> None:
    from upgpt_torch.inference.pipeline import (
        GenerationPipeline, UpscalePipeline,
    )
    from upgpt_torch.zoo import build_latent_diffusion

    switches = dict(dtype="bfloat16", device=dev, use_fused_groupnorm=True,
                    use_fused_resblock=True, use_fused_vae_groupnorm=True)
    base = build_latent_diffusion("interp_256", **switches)
    up = build_latent_diffusion("upscale", **switches)
    chip_smoke._redraw(base, seed=31, dev=dev)
    chip_smoke._redraw(up, seed=32, dev=dev)
    h, w = base.config.latent_size
    batch = chip_smoke._batch(b, h, w, dev, seed=35)
    first = GenerationPipeline(base, num_steps=STEPS, eta=1.0)
    second = UpscalePipeline(up, num_steps=STEPS, eta=1.0, output_uint8=True)
    image = first.generate(batch, torch.Generator(device=dev).manual_seed(0))

    def run_first(seed):
        first.generate(batch, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()

    def run_second(seed):
        second.upscale(image, batch["text_emb"], batch["style_emb"],
                       torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()

    run_second(0)
    profile_run(run_first, f"chain 256 stage (DDIM-{STEPS} eta 1, kl-f8 "
                f"decode) per batch", b, card)
    profile_run(run_second, f"chain upscale stage (DDIM-{STEPS} eta 1, "
                f"kl-f4 decode, uint8) per batch", b, card)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device; this script only "
                         "runs on a GPU")
    from upgpt_torch.zoo import build_latent_diffusion

    train = "--train" in sys.argv
    chain = "--chain" in sys.argv
    batches = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(card, flush=True)
    if chain:
        for b in batches or [chip_smoke.CHAIN_BATCH]:
            profile_chain(b, dev, card)
        return
    if train:
        model = build_latent_diffusion(
            "interp_256", dtype="bfloat16", param_dtype="float32",
            device=dev, use_fused_groupnorm=True)
    else:
        model = build_latent_diffusion("interp_256", dtype="bfloat16",
                                       device=dev)
    chip_smoke._redraw(model, seed=1, dev=dev)
    for b in batches or ([chip_smoke.TRAIN_BATCH] if train else [8, 32]):
        (profile_train if train else profile_sampling)(model, b, dev, card)


if __name__ == "__main__":
    main()
