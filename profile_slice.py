"""Profile the PyTorch port's DDIM-50 sampling path on one NVIDIA GPU.

    python3 profile_slice.py [batch ...]        (default: 8 32)

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. For each batch it builds interp_256 at full width in bf16 with
seeded random weights (as chip_smoke.py does), runs
GenerationPipeline(DDIM-50, eta 1, uint8) once to warm up, once timed
without the profiler, and once under torch.profiler, then prints

- the unprofiled wall time per batch and img/s;
- device busy time: the length of the union of the intervals of every
  device activity the profiler recorded (kernels, copies, sets), and the
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

# (kind, test on the lower-cased kernel name), first match wins
KINDS = [
    ("attention (csrc, K1 and flash)", lambda n: "attention_kernel" in n),
    ("K1 GEMMs (csrc)", lambda n: "gemm_kernel<" in n),
    ("K1 GroupNorm stats (csrc)", lambda n: "gn_stats_kernel" in n),
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


def profile_batch(model, b: int, dev, card: str) -> None:
    from upgpt_torch.inference.pipeline import GenerationPipeline

    h, w = model.config.latent_size
    batch = chip_smoke._batch(b, h, w, dev, seed=4)
    pipe = GenerationPipeline(model, num_steps=STEPS, eta=1.0,
                              output_uint8=True)

    def run(seed):
        pipe.generate(batch, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()

    run(0)
    t0 = time.perf_counter()
    run(1)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        profiled_wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    print(f"batch {b}: DDIM-{STEPS} eta 1 wall {wall:.4f} s/batch = "
          f"{b / wall:.3f} img/s (profiled run {profiled_wall:.4f} s) on "
          f"{card}", flush=True)
    print(f"batch {b}: device busy {busy:.4f} s, busy share {busy / wall:.4f}"
          f", idle share {1 - busy / wall:.4f}; {len(device)} device "
          f"activities summing to {total / 1e6:.4f} s", flush=True)
    for kind, us in by_kind.most_common():
        print(f"  {kind:32s} {us / 1e3:11.3f} ms  {us / total:.4f}")
    print(f"batch {b}: the 15 longest kernels (ms, calls, name)")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3:11.3f} {calls[name]:7d}  {name[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device; this script only "
                         "runs on a GPU")
    from upgpt_torch.zoo import build_latent_diffusion

    batches = [int(a) for a in sys.argv[1:]] or [8, 32]
    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(card, flush=True)
    model = build_latent_diffusion("interp_256", dtype="bfloat16", device=dev)
    chip_smoke._redraw(model, seed=1, dev=dev)
    for b in batches:
        profile_batch(model, b, dev, card)


if __name__ == "__main__":
    main()
