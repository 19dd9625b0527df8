"""Profile the PyTorch port's sampling path, train step or 256->512 chain on
one NVIDIA GPU.

    python3 profile_slice.py [batch ...]          (default: 8 32)
    python3 profile_slice.py --unipc [batch ...]  (default: 64)
    python3 profile_slice.py --train [batch ...]  (default: 12)
    python3 profile_slice.py --chain [batch ...]  (default: 4)
    python3 profile_slice.py --plans
    python3 profile_slice.py --gn-plans
    python3 profile_slice.py --resblock PARENT_CHECKOUT
    python3 profile_slice.py --groupnorm PARENT_CHECKOUT

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. For each batch it builds interp_256 at full width with seeded
random weights (as chip_smoke.py does): in bf16 for sampling, or with
float32 masters under bf16 compute and the training kernels on for
`--train`. `--unipc` samples with UniPC-8 on the karras grid, eta 0, to
uint8 (`bench.py`'s second row) instead of DDIM-50. `--chain` builds interp_256 and upscale in bf16 with the
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

`--gn-plans` times K5 at every cluster size whose slabs fit and K6's
statistics (with K7's affine) at chunk counts from one to two blocks per
SM, at every shape the paths give them, and prints where the chosen plan
ranks.

`--resblock PARENT_CHECKOUT` times K7 of this checkout and of another
(an unpacked `git archive` of the parent commit) in turns, in CUDA graphs
on the same inputs, at every (shape, O) the chain launches it at, beside
the library's three calls, with each one's error against the twin.
`--groupnorm PARENT_CHECKOUT` does the same for the GroupNorm kernels: K5
and K6 at every shape the train step and the chain launch them at, K6's
statistics alone at K7's chain shapes, each beside its bound, the latency
floor (an empty kernel) and `F.group_norm` + `F.silu`. Both flags may be
given in one call.

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
    ("optimizer and EMA (foreach)", lambda n: "multi_tensor" in n),
    ("attention (csrc, K1 and flash)",
     lambda n: "attention_mma_kernel" in n or "attention_fma_kernel" in n),
    ("K8/K9 products (csrc)", lambda n: "leg_product_kernel<" in n),
    ("K8/K9 flash pass (csrc)", lambda n: "flash_kernel<" in n),
    ("K1 GEMMs (csrc)", lambda n: "product_kernel<" in n),
    ("K1 GroupNorm stats (csrc)", lambda n: "gn_stats_kernel" in n),
    ("flash backward K4 (csrc)",
     lambda n: any(s in n for s in ("dq_mma_kernel", "dkv_mma_kernel",
                                    "dq_fma_kernel", "dkv_fma_kernel"))),
    ("GroupNorm+SiLU K5 (csrc)", lambda n: "cluster_gn_kernel<" in n),
    ("GroupNorm stats K6/K7 (csrc)", lambda n: "tiled_stats_kernel<" in n),
    ("GroupNorm apply K6 (csrc)", lambda n: "tiled_apply_kernel<" in n),
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


def profile_sampling(model, b: int, dev, card: str,
                     unipc: bool = False) -> None:
    from upgpt_torch.inference.pipeline import GenerationPipeline

    h, w = model.config.latent_size
    batch = chip_smoke._batch(b, h, w, dev, seed=4)
    if unipc:
        pipe = GenerationPipeline(
            model, num_steps=chip_smoke.UNIPC_STEPS, eta=0.0, sampler="unipc",
            schedule_method="karras", output_uint8=True)
        label = f"UniPC-{pipe.num_steps}-karras eta 0 per batch"
    else:
        pipe = GenerationPipeline(model, num_steps=STEPS, eta=1.0,
                                  output_uint8=True)
        label = f"DDIM-{STEPS} eta 1 per batch"

    def run(seed):
        pipe.generate(batch, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()

    run(0)
    profile_run(run, label, b, card)


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


def groupnorm_ab(dev, card: str, parent: str) -> None:
    """K5 and K6 of this checkout and of the checkout `parent` in turns
    (parent, this, this, parent), in CUDA graphs, on the same inputs, at
    every shape the train step and the chain launch them at
    (chip_smoke.GN_LAUNCHES), and K6's statistics alone at every shape the
    chain launches the half-step kernel (K7) at, whose first launch they
    are; each beside its bound, the latency floor, the library's
    `F.group_norm` + `F.silu` and its error against the twin."""
    import math

    import torch.nn.functional as F

    from upgpt_torch.ops import fused_gn as ours

    k7_shapes = sorted({key[:4] for key in chain_resblock_shapes(dev)})
    theirs = _import_tree(parent, "upgpt_torch.ops.fused_gn")
    floor = chip_smoke.latency_floor_ms()
    print(f"latency floor: an empty kernel replayed from a CUDA graph "
          f"{floor:.4f} ms on {card}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = [(kind, shape, path, n)
            for path, kernels in chip_smoke.GN_LAUNCHES.items()
            for (shape, kind), n in sorted(kernels.items())]
    rows += [("stats", shape, "chain (K7 head)", None) for shape in k7_shapes]
    with torch.no_grad():
        for kind, shape, path, runs in rows:
            x = (2 * torch.randn(shape, generator=g, device=dev)
                 + 0.5).bfloat16()
            scale = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
            bias = 0.1 * torch.randn(shape[-1], generator=g, device=dev)
            eps = 1e-6 if kind == "tiled_group_norm" else 1e-5
            values = math.prod(shape)
            if kind == "stats":
                fns = {k: (lambda m=m: m._stats_launch(x, 32, eps))
                       for k, m in (("parent", theirs), ("this", ours))}
                want = ours._reference_gn_stats(x, 32, eps)
                work = (4 * values, 2 * values, chip_smoke.PEAK_F32)
                lib = None
            else:
                fns = {k: (lambda m=m: getattr(m, kind)(x, scale, bias, 32,
                                                        eps, True))
                       for k, m in (("parent", theirs), ("this", ours))}
                want = ours._reference_gn(x, scale, bias, 32, eps, True)
                work = chip_smoke._gn_work(
                    shape, 10 if kind == "fused_group_norm" else 9)
                lib = chip_smoke._graph_ms(lambda: F.silu(F.group_norm(
                    x.permute(0, 3, 1, 2), 32, scale.bfloat16(),
                    bias.bfloat16(), eps)))
            _ab_line(f"{kind} {shape} [{path}, {runs} a run]", fns, want,
                     work, lib, card)


def sweep_gn_plans(dev, card: str) -> None:
    """K5 at every cluster size whose slabs fit, and K6's statistics at
    chunk counts from one to the card's two blocks per SM, in CUDA graphs,
    at every shape the paths give them (chip_smoke.GN_LAUNCHES and K7's
    chain shapes): where the chosen plan ranks."""
    from upgpt_torch.ops import fused_gn as fg

    g = torch.Generator(device=dev).manual_seed(0)
    k7_shapes = sorted({key[:4] for key in chain_resblock_shapes(dev)})
    gn = [(shape, kind) for kernels in chip_smoke.GN_LAUNCHES.values()
          for shape, kind in sorted(kernels)]
    chosen_chunks = fg.stats_chunks
    with torch.no_grad():
        for shape, kind in gn + [(s, "k7 head") for s in k7_shapes]:
            x = (2 * torch.randn(shape, generator=g, device=dev)
                 + 0.5).bfloat16()
            scale = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
            bias = 0.1 * torch.randn(shape[-1], generator=g, device=dev)
            timed = []
            if kind == "fused_group_norm":
                chosen = fg.fused_gn_plan(shape, 32, 2).cluster
                for k in (1, 2, 4, 8, 16):
                    plan = fg.cluster_plan(shape, 32, 2, k)
                    if plan is not None:
                        timed.append((chip_smoke._graph_ms(
                            lambda p=plan: fg._launch(x, scale, bias, 32,
                                                      1e-5, True, p)), k))
                what = "K5 blocks per image"
            else:
                chosen = chosen_chunks(shape, 2)
                hw, n = shape[1] * shape[2], shape[0]
                counts = sorted({c for c in (1, 2, 4, 8, 16, 32, 64,
                                             -(-2 * fg.SMS // n), chosen)
                                 if c <= hw})
                for c in counts:
                    fg.stats_chunks = lambda *a, c=c: c
                    timed.append((chip_smoke._graph_ms(
                        lambda: fg._stats_launch(x, 32, 1e-5, scale, bias)),
                        c))
                fg.stats_chunks = chosen_chunks
                what = "K6 statistics chunks per image"
            timed.sort()
            rank = next(i for i, (_, p) in enumerate(timed) if p == chosen)
            print(f"{what} {shape} [{kind}]: "
                  + " ".join(f"{p}:{ms:.4f}" for ms, p in sorted(
                      timed, key=lambda r: r[1]))
                  + f" ms; chosen {chosen} rank {rank + 1} of {len(timed)} "
                  f"on {card}", flush=True)


def _ab_line(label, fns, want, work, lib, card) -> None:
    """Each call's error against `want` and its device time in turns
    (first, second, second, first), printed beside the bound."""
    rel = {k: ((f().float() - want.float()).abs().max()
               / want.float().abs().max()).item() for k, f in fns.items()}
    a, b = list(fns)
    ms = {k: [] for k in fns}
    for k in (a, b, b, a):
        ms[k].append(chip_smoke._graph_ms(fns[k]))
    bound, by = chip_smoke._bound(*work)
    times = "; ".join(f"{k} {' '.join(f'{t:.4f}' for t in v)} ms"
                      for k, v in ms.items())
    library = "" if lib is None else f", library {lib:.4f} ms"
    errs = " ".join(f"{k} {v:.3e}" for k, v in rel.items())
    print(f"{label}: {times} (device time, CUDA graph){library}, bound "
          f"{bound:.4f} ms ({by}); max rel err {errs} on {card}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device; this script only "
                         "runs on a GPU")
    from upgpt_torch.zoo import build_latent_diffusion

    if "--plans" in sys.argv:
        sweep_plans(torch.device("cuda", 0), chip_smoke._card_line())
        return
    if "--gn-plans" in sys.argv:
        sweep_gn_plans(torch.device("cuda", 0), chip_smoke._card_line())
        return
    if "--resblock" in sys.argv or "--groupnorm" in sys.argv:
        for flag, ab in (("--resblock", resblock_ab),
                         ("--groupnorm", groupnorm_ab)):
            if flag in sys.argv:
                ab(torch.device("cuda", 0), chip_smoke._card_line(),
                   sys.argv[sys.argv.index(flag) + 1])
        return
    train = "--train" in sys.argv
    chain = "--chain" in sys.argv
    unipc = "--unipc" in sys.argv
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
    if train:
        for b in batches or [chip_smoke.TRAIN_BATCH]:
            profile_train(model, b, dev, card)
        return
    default = [chip_smoke.UNIPC_BATCH] if unipc else [8, 32]
    for b in batches or default:
        profile_sampling(model, b, dev, card, unipc)


if __name__ == "__main__":
    main()
