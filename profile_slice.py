"""Profile the PyTorch port's sampling path, train step or 256->512 chain on
one NVIDIA GPU.

    python3 profile_slice.py [batch ...]          (default: 8 32)
    python3 profile_slice.py --train [batch ...]  (default: 12)
    python3 profile_slice.py --chain [batch ...]  (default: 4)
    python3 profile_slice.py --plans
    python3 profile_slice.py --resblock PARENT_CHECKOUT

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

`--plans` times, in CUDA graphs, every candidate plan of the Hopper
mainloop (`upgpt_torch/ops/gemm_plan.py`) at the paths' shapes: each
(shape, O) the chain gives the half-step kernel (K7), and each product of
the transformer block (K1) at the sampling and chain shapes with the other
products at their chosen plans. It prints where the chosen plan ranks
beside the fastest, and the non-negative least-squares weights of K7's
cost model (`gemm_plan.TERMS`) that fit its times, as `CONV_WEIGHTS` takes
them.

`--resblock PARENT_CHECKOUT` times K7 of this checkout and of another
(an unpacked `git archive` of the parent commit) in turns, in CUDA graphs
on the same inputs, at every (shape, O) the chain launches it at, beside
the library's three calls, with each one's error against the twin.

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
    ("K1 GEMMs (csrc)", lambda n: "product_kernel<" in n),
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


def chain_resblock_shapes(dev) -> list:
    """Every (B, H, W, C, O) the half-step kernel (K7) is launched at in a
    chain at chip_smoke's batch, as its launch counter records them, from a
    2-step chain of both nets with their default weights."""
    from upgpt_torch.inference.pipeline import ChainedUpscalePipeline
    from upgpt_torch.ops import fused_resblock as frb
    from upgpt_torch.zoo import build_latent_diffusion

    switches = dict(dtype="bfloat16", device=dev, use_fused_groupnorm=True,
                    use_fused_resblock=True, use_fused_vae_groupnorm=True)
    base = build_latent_diffusion("interp_256", **switches)
    up = build_latent_diffusion("upscale", **switches)
    h, w = base.config.latent_size
    batch = chip_smoke._batch(chip_smoke.CHAIN_BATCH, h, w, dev, seed=35)
    frb.fused_gn_silu_conv.launches_by_shape = {}
    with torch.inference_mode():
        ChainedUpscalePipeline(base, up, num_steps=2, eta=1.0).generate(
            batch, torch.Generator(device=dev).manual_seed(0))
    del base, up
    torch.cuda.empty_cache()
    return sorted(frb.fused_gn_silu_conv.launches_by_shape)


def _resblock_inputs(key, g):
    n, h, w, c, o = key
    dev = g.device
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    return ((2 * randn(n, h, w, c) + 0.5).bfloat16(), 1 + 0.1 * randn(c),
            0.1 * randn(c), (randn(o, c, 3, 3) / (9 * c) ** 0.5).bfloat16(),
            (0.1 * randn(o)).bfloat16())


def _fit(rows):
    """Non-negative weights of the cost terms that fit the measured times
    in the least-squares sense, and the rms residual."""
    import numpy as np
    from scipy.optimize import nnls

    weights, resid = nnls(np.array([r[0] for r in rows]),
                          np.array([r[1] for r in rows]))
    return weights, resid / len(rows) ** 0.5


def sweep_plans(dev, card: str) -> None:
    from upgpt_torch.ops import fused_resblock as frb
    from upgpt_torch.ops import fused_transformer as ft
    from upgpt_torch.ops import gemm_plan as gp

    g = torch.Generator(device=dev).manual_seed(0)
    conv_rows = []
    conv_plan, k1_plans = gp.cached_conv_plan, gp.cached_transformer_plans
    with torch.no_grad():
        for key in chain_resblock_shapes(dev):
            x, gs, gb, wt, cb = _resblock_inputs(key, g)
            shape, o = key[:4], key[4]
            chosen, timed = gp.plan_conv(shape, o), []
            for p in gp.conv_candidates(shape, o):
                gp.cached_conv_plan = (
                    lambda *a, p=p: (p, gp.int_array(p.as_ints())))
                ms = chip_smoke._graph_ms(lambda: frb.fused_gn_silu_conv(
                    x, gs, gb, wt, cb, 32, 1e-5))
                timed.append((ms, p))
                conv_rows.append((gp.conv_terms(p), ms * 1e6))
            gp.cached_conv_plan = conv_plan
            _report(f"K7 {shape} -> {o}", timed, chosen, card)
        randn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731,E501
        for b, t, c, tk in [(8, 768, 224, 87), (8, 192, 448, 87),
                            (4, 768, 512, 86)]:
            p = chip_smoke._random_block(c, 768, g)
            x = randn(b, t, c).bfloat16()
            kv = (randn(b, tk, c).bfloat16(), randn(b, tk, c).bfloat16())
            base = gp.transformer_plans(b, t, c, tk)
            block = lambda: ft.fused_transformer_block(x, p, 8, kv=kv)  # noqa: E731,E501
            for i, name in enumerate(gp.PRODUCTS):
                if base[i] is None:
                    continue
                q, timed = base[i], []
                for cand in gp.product_candidates(q.M, q.N, q.K, q.parts,
                                                  q.prologue, q.gated):
                    plans = base[:i] + [cand] + base[i + 1:]
                    forced = (plans, gp.int_array(gp.plan_array(plans)),
                              gp.product_workspace(plans))
                    gp.cached_transformer_plans = lambda *a, f=forced: f
                    timed.append((chip_smoke._graph_ms(block), cand))
                gp.cached_transformer_plans = k1_plans
                _report(f"K1 {(b, t, c)} {name} (whole block)", timed, q,
                        card)
    weights, rms = _fit(conv_rows)
    print(f"K7: cost weights (ns per unit of each term) fitted to "
          f"{len(conv_rows)} timed plans, rms residual {rms:.0f} ns, on "
          f"{card}:", flush=True)
    for name, w in zip(gp.TERMS, weights):
        print(f"  {name:28s} {w:12.3f}")


def _report(label, timed, chosen, card) -> None:
    timed.sort(key=lambda r: r[0])
    rank = next(i for i, (_, p) in enumerate(timed) if p == chosen)
    print(f"{label}: {len(timed)} plans; chosen {chosen.as_ints()} "
          f"({chosen.units} units) {timed[rank][0]:.4f} ms, rank {rank + 1}; "
          f"best {timed[0][1].as_ints()} ({timed[0][1].units} units) "
          f"{timed[0][0]:.4f} ms on {card}", flush=True)


def _import_tree(root: str, name: str):
    """Module `name` of the upgpt_torch package in checkout `root`, loaded
    beside this checkout's package (which stays in sys.modules)."""
    import importlib
    import os

    root = os.path.abspath(root)
    ours = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] == "upgpt_torch"}
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if k.split(".")[0] == "upgpt_torch"]:
            del sys.modules[k]
        sys.modules.update(ours)


def resblock_ab(dev, card: str, parent: str) -> None:
    """K7 of this checkout and of the checkout `parent` in turns (parent,
    this, this, parent), in CUDA graphs, at every (shape, O) of the chain,
    on the same inputs, beside the library's three calls."""
    import torch.nn.functional as F

    from upgpt_torch.ops import fused_resblock as ours

    shapes = chain_resblock_shapes(dev)
    theirs = _import_tree(parent, "upgpt_torch.ops.fused_resblock")
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for key in shapes:
            x, gs, gb, wt, cb = _resblock_inputs(key, g)
            args = (x, gs, gb, wt, cb, 32, 1e-5)
            # copies for the parent: both cache their packing on the tensor
            other = tuple(a.clone() for a in args[:5]) + args[5:]
            want = ours._reference(*args).float()
            fns = {"parent": lambda: theirs.fused_gn_silu_conv(*other),
                   "this": lambda: ours.fused_gn_silu_conv(*args)}
            rel = {k: ((f().float() - want).abs().max()
                       / want.abs().max()).item() for k, f in fns.items()}
            ms = {k: [] for k in fns}
            for k in ("parent", "this", "this", "parent"):
                ms[k].append(chip_smoke._graph_ms(fns[k]))
            lib = chip_smoke._graph_ms(lambda: F.conv2d(F.silu(F.group_norm(
                x.permute(0, 3, 1, 2), 32, gs.bfloat16(), gb.bfloat16(),
                1e-5)), wt, cb, padding=1))
            print(f"K7 {key[:4]} -> {key[4]}: parent "
                  f"{' '.join(f'{t:.4f}' for t in ms['parent'])} ms, this "
                  f"{' '.join(f'{t:.4f}' for t in ms['this'])} ms, library "
                  f"{lib:.4f} ms (device time, CUDA graph); max rel err "
                  f"parent {rel['parent']:.3e} this {rel['this']:.3e} on "
                  f"{card}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device; this script only "
                         "runs on a GPU")
    from upgpt_torch.zoo import build_latent_diffusion

    if "--plans" in sys.argv:
        sweep_plans(torch.device("cuda", 0), chip_smoke._card_line())
        return
    if "--resblock" in sys.argv:
        resblock_ab(torch.device("cuda", 0), chip_smoke._card_line(),
                    sys.argv[sys.argv.index("--resblock") + 1])
        return
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
