"""The weight-drop runbook: first contact with released checkpoints as one
command.

Counterpart of `upgpt_tpu/bringup.py`. `python -m upgpt_torch.cli bringup
--drop DIR` takes a directory of user-supplied files and runs, unattended:

  1. inventory — the four released checkpoints (HuggingFace soonyau/upgpt:
     pt_256, interp_256, mm_512, upscale), an HF CLIP snapshot the CLIP
     step can read (`pytorch_model*.bin`), the BPE merges, the LPIPS VGG
     and pt_inception weights;
  2. convert — each checkpoint through `convert.lightning`, the LitEma
     shadow preferred (the released eval protocol, ddpm.py:179-192), into
     the port's serving layout (`checkpoint.save_checkpoint`):
     `<out>/<geometry>/model.pt`;
  3. validate — checks that trained weights pass and random weights fail,
     on the card by default with the zoo's kernel switches (bf16): the
     VAE's round-trip PSNR on a structured image (a trained kl-f8 > 20 dB)
     and the correlation of the predicted noise with the injected noise at
     mid-t (a trained denoiser > 0.5);
  4. sampler check — DDIM-200 against DDIM-50, UniPC-8-karras and
     DPM++-20 from one shared x_T, scored by SSIM (informational);
  5. CLIP — the HF snapshot's towers as the two `torch.save`d state dicts
     that `clip.text_params` / `clip.vision_params` read, loaded back
     through `CLIPConditioningEncoder.from_files` where the merges are in
     the drop;
  6. bench — DDIM-50, eta 1, batch 8, uint8 on the converted interp_256
     through `GenerationPipeline` (one warm-up, three timed runs): img/s
     and the card's name and power limit;
  7. eval — the port's `cli test` on `--data-root`, with the CLIP step's
     towers where the drop had them, else the debug encoder (then the
     metrics are marked as not parity).

Everything lands in `<out>/report.json` and `<out>/REPORT.md`; a step that
fails is recorded as an `error`, never an abort. Faults of the JAX runbook
that this one does not copy (ROADMAP §3): R13 (its eval step overrides a
`root` key the dataset does not take and passes no encoder, so `cli test`
cannot succeed) and R14 (its inventory counts a CLIP directory that holds
only safetensors, which its CLIP step cannot read).
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

RELEASED_VARIANTS = ("pt_256", "interp_256", "mm_512", "upscale")
EVAL_CONFIG = (Path(__file__).resolve().parent.parent / "configs"
               / "deepfashion" / "interp_256.yaml")
# the bench: the reference protocol on the converted interp_256
BENCH_BATCH, BENCH_STEPS, BENCH_RUNS = 8, 50, 3


@dataclass
class DropInventory:
    ckpts: Dict[str, Path] = field(default_factory=dict)  # variant -> path
    clip_dir: Optional[Path] = None     # HF CLIP snapshot (text + vision)
    bpe_path: Optional[Path] = None     # CLIP byte-BPE merges
    lpips: Optional[Path] = None        # lpips VGG state dict (.pth)
    inception: Optional[Path] = None    # pytorch_fid pt_inception (.pth)
    missing: List[str] = field(default_factory=list)
    # CLIP directories the CLIP step cannot read (safetensors only)
    unreadable: List[str] = field(default_factory=list)


def find_drop_files(drop, variants=RELEASED_VARIANTS) -> DropInventory:
    """The drop's files by their released names: `<drop>/<variant>.ckpt`,
    `<drop>/<variant>/*.ckpt` or `*<variant>*.ckpt`; a `*clip*` directory
    with `pytorch_model*.bin`; `bpe_simple_vocab*` or `merges.txt`;
    `*vgg*.pth` / `*lpips*.pth`; `*inception*.pth`."""
    inv = DropInventory()
    drop = Path(drop)
    for v in variants:
        cands = [drop / f"{v}.ckpt"]
        if (drop / v).is_dir():
            cands += sorted((drop / v).glob("*.ckpt"))
        cands += sorted(drop.glob(f"*{v}*.ckpt"))
        found = next((c for c in cands if c.is_file()), None)
        if found is not None:
            inv.ckpts[v] = found
        else:
            inv.missing.append(f"ckpt:{v}")
    for d in sorted(p for p in drop.glob("*clip*") if p.is_dir()):
        if any(d.glob("pytorch_model*.bin")):
            inv.clip_dir = d
            break
        if any(d.glob("*.safetensors")):
            inv.unreadable.append(str(d))
    if inv.clip_dir is None:
        inv.missing.append("clip")
    bpe = (sorted(drop.rglob("bpe_simple_vocab*"))
           + sorted(drop.rglob("merges.txt")))
    inv.bpe_path = bpe[0] if bpe else None
    if inv.bpe_path is None:
        inv.missing.append("bpe_vocab")
    lp = sorted(drop.rglob("*vgg*.pth")) + sorted(drop.rglob("*lpips*.pth"))
    inv.lpips = lp[0] if lp else None
    if inv.lpips is None:
        inv.missing.append("lpips")
    inc = sorted(drop.rglob("*inception*.pth"))
    inv.inception = inc[0] if inc else None
    if inv.inception is None:
        inv.missing.append("pt_inception")
    return inv


def convert_one(torch_ckpt, variant: str, out_dir) -> Dict[str, Any]:
    """One released checkpoint into `<out_dir>/<variant>/model.pt`, the
    LitEma shadow where the file has one, else the raw weights."""
    from upgpt_torch.checkpoint import save_checkpoint
    from upgpt_torch.convert.lightning import convert_lightning

    model, rec = convert_lightning(torch_ckpt, variant, ema=None)
    path = Path(out_dir) / variant / "model.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(model, path)
    return {"variant": variant, "src": str(torch_ckpt), "ema": rec["ema"],
            "submodels": rec["submodels"], "unread": rec["unread"],
            "out": str(path)}


def load_converted(variant: str, path, device="cuda"):
    """The zoo's `variant` on `device` with its default kernel switches,
    holding `path`'s weights: bf16 on the card, float32 on the CPU."""
    from upgpt_torch.checkpoint import load_checkpoint
    from upgpt_torch.zoo import build_latent_diffusion

    dtype = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    return load_checkpoint(
        build_latent_diffusion(variant, dtype=dtype, device=device), path)


def _test_image(hw) -> np.ndarray:
    """A structured image in [-1, 1] (smooth gradients and a hard-edged
    block), which a trained VAE reconstructs well and a random one
    cannot."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(yy / h * 6.0) * 0.6, np.cos(xx / w * 4.0) * 0.6,
                    ((yy / h + xx / w) - 1.0) * 0.8], axis=-1)
    img[h // 4: h // 2, w // 4: w // 2] = np.float32([0.9, -0.9, 0.2])
    return img[None]


@torch.inference_mode()
def validate_variant(model, eps: Optional[np.ndarray] = None
                     ) -> Dict[str, Any]:
    """The VAE's round-trip PSNR and the mid-t noise correlation of one
    U-Net eval (batch 1, a zero 77-token context, a background mask).
    `eps` is the injected noise (else a draw seeded 0 on the host)."""
    cfg = model.config
    dev = model.device
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    h, w = cfg.latent_size
    img = torch.from_numpy(_test_image((h * f, w * f))).to(dev)
    z = model.encode_first_stage_mode(img)
    rec_img = model.decode_first_stage(z).float()
    mse = float(((rec_img - img) ** 2).mean())
    psnr = 10 * np.log10(4.0 / max(mse, 1e-12))  # peak to peak 2.0
    rec: Dict[str, Any] = {"vae_roundtrip_psnr_db": psnr,
                           "vae_pass": psnr > 20.0}
    if eps is None:
        eps = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
    eps = torch.as_tensor(np.array(eps, np.float32)).to(dev)
    t = torch.full((z.shape[0],), cfg.timesteps // 2, dtype=torch.long,
                   device=dev)
    x_t = model.q_sample(z, t, eps)
    cond = {"c_crossattn": torch.zeros(1, 77, cfg.context_dim, device=dev),
            "c_concat": torch.full(
                (1, h, w, cfg.unet.in_channels - cfg.latent_channels), -1.0,
                device=dev)}
    eps_hat = model.apply_model(x_t, t, cond).float().cpu().numpy().ravel()
    e = eps.float().cpu().numpy().ravel()
    # a constant output (an untrained zero out conv) is no denoiser
    corr = (0.0 if float(eps_hat.std()) < 1e-8
            else float(np.corrcoef(e, eps_hat)[0, 1]))
    rec.update(eps_corr_mid_t=corr, unet_pass=corr > 0.5,
               unet_finite=bool(np.isfinite(eps_hat).all()))
    return rec


def sampler_batch(model, batch: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Neutral conditioning: 0.1 N(0, 1) text (and style) embeddings from a
    seeded host generator, a background mask, a zero SMPL vector."""
    cfg = model.config
    h, w = cfg.latent_size
    rng = np.random.default_rng(seed)
    ctx = cfg.context_dim
    eb = {"text_emb": rng.normal(size=(batch, 77, ctx)) * 0.1,
          "person_mask": np.full(
              (batch, h, w, cfg.unet.in_channels - cfg.latent_channels),
              -1.0)}
    if cfg.pose_input_dim:
        eb["smpl"] = np.zeros((batch, 1, cfg.pose_input_dim))
        eb["style_emb"] = rng.normal(size=(batch, 9, ctx)) * 0.1
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in eb.items()}


def sampler_check(model, batch: int = 2) -> Dict[str, Any]:
    """DDIM-200 (the app's fine grid) against DDIM-50, UniPC-8-karras and
    DPM++-20, all eta 0 from one shared x_T: the batch-mean SSIM of each
    against DDIM-200. Informational: ordering, not acceptance."""
    from upgpt_torch.eval.metrics import ssim
    from upgpt_torch.inference.pipeline import GenerationPipeline

    eb = sampler_batch(model, batch)
    h, w = model.config.latent_size
    x_T = torch.randn((batch, h, w, model.config.latent_channels),
                      generator=torch.Generator().manual_seed(7))

    def run(sampler, steps, method):
        pipe = GenerationPipeline(model, num_steps=steps, eta=0.0,
                                  sampler=sampler, schedule_method=method)
        return pipe.generate(eb, x_T=x_T).float()

    ref = (run("ddim", 200, "uniform") + 1) / 2
    rec: Dict[str, Any] = {}
    for label, sampler, steps, method in (
            ("ddim50", "ddim", 50, "uniform"),
            ("unipc8k", "unipc", 8, "karras"),
            ("dpmpp20", "dpm++", 20, "uniform")):
        imgs = (run(sampler, steps, method) + 1) / 2
        rec[f"ssim_{label}_vs_ddim200"] = float(
            ssim(imgs.cpu(), ref.cpu(), data_range=1.0))
    rec["karras_guidance_holds"] = bool(
        rec["ssim_unipc8k_vs_ddim200"]
        >= rec["ssim_ddim50_vs_ddim200"] - 0.005)
    return rec


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def bench(model) -> Dict[str, Any]:
    """DDIM-50, eta 1, batch 8 to uint8 on the card: one warm-up, three
    timed runs, host clock to a synchronise."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    if model.device.type != "cuda":
        return {"skipped": "the bench times the card; the model is on "
                           f"{model.device}"}
    pipe = GenerationPipeline(model, num_steps=BENCH_STEPS, eta=1.0,
                              output_uint8=True)
    batch = sampler_batch(model, BENCH_BATCH, seed=1)
    times = []
    for i in range(BENCH_RUNS + 1):
        gen = torch.Generator(device=model.device).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.generate(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times[1:])
    return {"protocol": f"DDIM-{BENCH_STEPS} eta 1 uint8",
            "batch": BENCH_BATCH, "shape": list(out.shape),
            "warmup_s": times[0], "s_per_batch": times[1:],
            "img_per_s": BENCH_BATCH / best,
            "device": torch.cuda.get_device_name(model.device),
            "card": card_line()}


def convert_clip(clip_dir, out, bpe_path=None, device="cuda"
                 ) -> Dict[str, Any]:
    """An HF snapshot's `pytorch_model*.bin` -> `<out>/clip_text.pt` and
    `<out>/clip_vision.pt` (the port's tower layout), loaded back through
    `CLIPConditioningEncoder.from_files` on `device` where the merges are
    known."""
    from upgpt_torch.convert.clip_weights import (
        convert_hf_clip_text, convert_hf_clip_vision,
    )

    bins = sorted(Path(clip_dir).glob("pytorch_model*.bin"))
    if not bins:
        return {"error": f"no pytorch_model*.bin in {clip_dir}"}
    sd: Dict[str, torch.Tensor] = {}
    for b in bins:
        sd.update(torch.load(b, map_location="cpu", weights_only=True))
    out = Path(out)
    rec: Dict[str, Any] = {}
    for name, conv in (("text_params", convert_hf_clip_text),
                       ("vision_params", convert_hf_clip_vision)):
        path = out / f"clip_{name.split('_')[0]}.pt"
        torch.save(conv(sd), path)
        rec[name] = str(path)
    if bpe_path is not None:
        from upgpt_torch.inference.encoders import CLIPConditioningEncoder

        rec["bpe_path"] = str(bpe_path)
        enc = CLIPConditioningEncoder.from_files(
            rec["text_params"], rec["vision_params"], rec["bpe_path"],
            device=device)
        rec["loaded_on"] = str(enc.device)
        rec["text_width"] = int(enc.text_tower.position_embedding.shape[1])
        rec["vision_width"] = int(
            enc.style_encoder.vision.class_embedding.shape[0])
    return rec


def eval_step(ckpt, geometry: str, data_root, out, clip: Optional[dict],
              inception=None, device="cuda",
              overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """`cli test` on the converted checkpoint over `data_root`: the
    config's `data.test.params.folder` (the key the dataset takes), the
    CLIP step's towers where it wrote them, else the debug encoder, whose
    metrics are not parity. `overrides` is a dotlist applied last."""
    from upgpt_torch import cli

    argv = ["test", "--base", str(EVAL_CONFIG), "--ckpt", str(ckpt),
            "--out", str(Path(out) / "eval")]
    if inception is not None:
        argv += ["--fid-weights", str(inception)]
    parity = bool(clip and clip.get("bpe_path") and "error" not in clip)
    if not parity:
        argv.append("--debug-encoder")
    argv += [f"data.test.params.folder={data_root}",
             f"model.params.variant={geometry}",
             f"model.params.device={device}"]
    if parity:
        argv += [f"clip.{k}={clip[k]}"
                 for k in ("text_params", "vision_params", "bpe_path")]
    argv += list(overrides)
    res = cli.main(argv)
    return {"metrics": res["metrics"], "seconds": res["seconds"],
            "encoder": "clip" if parity else "debug (not parity)",
            "parity": parity}


def run_bringup(drop_dir, out_dir, variants=None, data_root=None,
                skip_bench: bool = False, skip_eval: bool = False,
                geometry_override: Optional[str] = None,
                fid_reference: Optional[float] = None,
                skip_sampler_check: bool = False, device="cuda",
                eval_overrides: Sequence[str] = (),
                validate_eps: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """The whole drill; returns the acceptance report and writes it.
    `validate_eps` injects the validators' noise (rehearsals against
    another implementation)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report: Dict[str, Any] = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
                              "drop": str(drop_dir), "device": str(device),
                              "steps": {}, "seconds": {}}
    steps, seconds = report["steps"], report["seconds"]
    inv = find_drop_files(drop_dir, variants or RELEASED_VARIANTS)
    steps["inventory"] = {
        "found": {v: str(p) for v, p in inv.ckpts.items()},
        "clip": str(inv.clip_dir) if inv.clip_dir else None,
        "clip_unreadable": inv.unreadable,
        "lpips": str(inv.lpips) if inv.lpips else None,
        "inception": str(inv.inception) if inv.inception else None,
        "missing": inv.missing}

    conversions, validations, checks, models = [], [], [], {}
    for v, ckpt in inv.ckpts.items():
        geom = geometry_override or v
        t0 = time.perf_counter()
        try:
            rec = convert_one(ckpt, geom, out)
            conversions.append(rec)
        except Exception as exc:  # noqa: BLE001 — report, don't abort
            conversions.append({"variant": v, "error": repr(exc)})
            continue
        finally:
            seconds[f"convert:{v}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            models[v] = load_converted(geom, rec["out"], device)
            seconds[f"load:{v}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            validations.append({"variant": v, **validate_variant(
                models[v], validate_eps)})
        except Exception as exc:  # noqa: BLE001
            validations.append({"variant": v, "error": repr(exc)})
        seconds[f"validate:{v}"] = time.perf_counter() - t0
        if skip_sampler_check or v not in models:
            continue
        t0 = time.perf_counter()
        try:
            checks.append({"variant": v, **sampler_check(models[v])})
        except Exception as exc:  # noqa: BLE001
            checks.append({"variant": v, "error": repr(exc)})
        seconds[f"sampler_check:{v}"] = time.perf_counter() - t0
    steps["convert"] = conversions
    steps["validate"] = validations
    steps["sampler_check"] = ({"skipped": True} if skip_sampler_check
                              else checks)

    clip = None
    if inv.clip_dir is not None:
        t0 = time.perf_counter()
        try:
            clip = convert_clip(inv.clip_dir, out, inv.bpe_path, device)
        except Exception as exc:  # noqa: BLE001
            clip = {"error": repr(exc)}
        steps["clip"] = clip
        seconds["clip"] = time.perf_counter() - t0

    if skip_bench:
        steps["bench"] = {"skipped": True}
    elif "interp_256" not in models:
        steps["bench"] = {"skipped": "no converted interp_256"}
    else:
        t0 = time.perf_counter()
        try:
            steps["bench"] = bench(models["interp_256"])
        except Exception as exc:  # noqa: BLE001
            steps["bench"] = {"error": repr(exc)}
        seconds["bench"] = time.perf_counter() - t0
    models.clear()

    interp = next((c for c in conversions if c["variant"] == "interp_256"
                   and "error" not in c), None)
    if skip_eval or not data_root or interp is None:
        steps["eval"] = {"skipped": True}
    else:
        t0 = time.perf_counter()
        try:
            rec_eval = eval_step(
                interp["out"], geometry_override or "interp_256", data_root,
                out, clip, inv.inception, device, eval_overrides)
            if fid_reference is not None:
                # FID within 2% of the reference's own eval pipeline on the
                # same pairs (user-supplied: no published number exists)
                metrics = rec_eval["metrics"]
                measured = metrics.get("fid_inception", metrics.get("fid"))
                rec_eval["fid_gate"] = {
                    "reference": fid_reference, "measured": measured,
                    "pass": bool(measured is not None
                                 and measured <= fid_reference * 1.02)}
            steps["eval"] = rec_eval
        except (Exception, SystemExit) as exc:  # noqa: BLE001 — record
            steps["eval"] = {"error": repr(exc)}
        seconds["eval"] = time.perf_counter() - t0

    ok = (not inv.missing
          and all("error" not in c for c in conversions)
          and all(v.get("vae_pass") and v.get("unet_pass")
                  for v in validations if "error" not in v))
    gate = steps["eval"].get("fid_gate")
    if gate is not None:
        ok = ok and gate["pass"]
    report["accepted"] = bool(ok and conversions)
    report = json.loads(json.dumps(report, default=_json_scalar))
    (out / "report.json").write_text(json.dumps(report, indent=2))
    (out / "REPORT.md").write_text(render_report(report))
    return report


def _json_scalar(o):
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    return str(o)


def render_report(report: Dict[str, Any]) -> str:
    """REPORT.md: the JAX runbook's layout (`_render_report`), with the
    bench's line and the steps' seconds."""
    steps = report["steps"]
    lines = [f"# Weight-drop bring-up report — {report['ts']}", "",
             f"**ACCEPTED: {report['accepted']}**", "",
             f"Drop dir: `{report['drop']}` (device {report['device']})", ""]
    inv = steps["inventory"]
    lines += ["## Inventory", ""]
    for v, p in inv["found"].items():
        lines.append(f"- {v}: `{p}`")
    for k in ("clip", "lpips", "inception"):
        lines.append(f"- {k}: `{inv[k]}`" if inv[k] else f"- {k}: MISSING")
    for d in inv["clip_unreadable"]:
        lines.append(f"- unreadable CLIP directory (no pytorch_model*.bin): "
                     f"`{d}`")
    if inv["missing"]:
        lines.append(f"- missing: {', '.join(inv['missing'])}")
    lines += ["", "## Conversion", ""]
    for c in steps["convert"]:
        if "error" in c:
            lines.append(f"- {c['variant']}: ERROR {c['error']}")
        else:
            lines.append(f"- {c['variant']}: {','.join(c['submodels'])} "
                         f"(ema={c.get('ema')}) -> `{c['out']}`")
    lines += ["", "## Validation", ""]
    for v in steps["validate"]:
        if "error" in v:
            lines.append(f"- {v['variant']}: ERROR {v['error']}")
        else:
            lines.append(
                f"- {v['variant']}: VAE PSNR "
                f"{v['vae_roundtrip_psnr_db']:.2f} dB (pass={v['vae_pass']}),"
                f" eps corr {v['eps_corr_mid_t']:.4f} "
                f"(pass={v['unet_pass']})")
    sc = steps.get("sampler_check")
    if isinstance(sc, list):
        lines += ["", "## Sampler-quality ordering", ""]
        for r in sc:
            if "error" in r:
                lines.append(f"- {r['variant']}: ERROR {r['error']}")
            else:
                lines.append(
                    f"- {r['variant']}: ddim50 "
                    f"{r['ssim_ddim50_vs_ddim200']:.4f}, unipc8k "
                    f"{r['ssim_unipc8k_vs_ddim200']:.4f}, dpmpp20 "
                    f"{r['ssim_dpmpp20_vs_ddim200']:.4f} vs DDIM-200 — "
                    f"karras guidance holds: {r['karras_guidance_holds']}")
    b = steps.get("bench") or {}
    if "img_per_s" in b:
        lines += ["", "## bench", "",
                  f"{b['protocol']} at batch {b['batch']}: "
                  f"{b['img_per_s']:.3f} img/s on {b['card']}"]
    for step in ("clip", "bench", "eval"):
        lines += ["", f"## {step}", "",
                  f"```{json.dumps(steps.get(step), indent=2)}```"]
    lines += ["", "## seconds", "",
              f"```{json.dumps(report['seconds'], indent=2)}```"]
    return "\n".join(lines) + "\n"
