"""Generation: conditioning embeddings -> a sampler -> decoded images.

Port of `upgpt_tpu.inference.pipeline` (reference
ldm/data/generate_utils.py:131-190, app.py:262-409). Conditioning enters as
embeddings: text (77, 768), style slots (9, 768), SMPL (1, 85), with the
person mask (h, w, 1) as the latent channel concat. The cross-attention K/V
of the fixed context are projected once before the step loop
(`model.cross_kv`, per shard on a tensor-parallel model).

Samplers: "ddim" (the reference protocol), "dpm++" (DPM-Solver++(2M)) and
"unipc" (UniPC-2), each on the "uniform", "quad" or "karras" t-grid, and
DDIM also on an explicit grid (`timesteps`, the distilled students').
`num_steps` is the length of the table that runs: a uniform count that
does not divide 1000 runs one step more, and the karras grid can dedupe to
fewer. A v- or x0-parameterised model reaches every sampler through
`model.to_eps`.

Initial noise: one draw from the caller's generator, broadcast over the
batch with `shared_x_T` (the reference's seeded interpolation,
ddpm.py:1433-1437); per sample from a generator seeded by the call's
generator and the sample's `x_T_seed` where the batch has that key, so
equal seeds in one batch share their x_T; else one draw of the batch's
shape. `generate_progressive` returns the decoded x0 predictions of a DDIM
run as a row of frames. `mix_style`, `interpolate_smpl` and the mask
helpers (numpy, on the host) build the inputs of style mixing and pose
interpolation.

The chained 256->512 path (app.py:93-97, 262-278, 379-409) is
`ChainedUpscalePipeline`: the 256 model's float image, `prepare_lr_condition`
to the upscale stage's latent grid, and the upscale model's lr-conditioned
sampler in kl-f4 latent space, decoded to 512x384. `UpscalePipeline` is the
second stage alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from upgpt_torch.diffusion.ddim import ddim_sample
from upgpt_torch.diffusion.dpm_solver import (
    dpm_solver_pp_sample, make_dpm_solver_schedule,
)
from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.diffusion.schedule import make_ddim_schedule
from upgpt_torch.diffusion.unipc import make_unipc_schedule, unipc_sample

# 9 style slots, fixed order (reference deepfashion_inshop.py:21)
STYLE_NAMES = (
    "face", "hair", "headwear", "background", "top",
    "outer", "bottom", "shoes", "accesories",
)

MASK_BG = -1.0
MASK_BOX = -0.99215686  # 253/255-scaled bbox value (generate_utils.py:117)

SAMPLERS = ("ddim", "dpm++", "unipc")
SCHEDULE_METHODS = ("uniform", "quad", "karras")


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round((img + 1.0) * 127.5).to(torch.uint8)


class GenerationPipeline:
    """text + style + pose embeddings -> images for one model."""

    def __init__(
        self,
        model: LatentDiffusion,
        num_steps: int = 200,
        eta: float = 1.0,
        guidance_scale: float = 1.0,
        decode: bool = True,
        output_uint8: bool = False,
        sampler: str = "ddim",
        schedule_method: str = "uniform",
        timesteps=None,
    ):
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if schedule_method not in SCHEDULE_METHODS:
            raise ValueError(f"unknown schedule_method {schedule_method!r}")
        # the distilled students are valid only on their own nested grid,
        # where DDIM is the matching one-eval-per-point sampler
        if timesteps is not None and sampler != "ddim":
            raise ValueError("explicit timesteps require sampler='ddim'")
        self.model = model
        self.eta = eta
        self.guidance_scale = guidance_scale
        self.decode = decode
        self.output_uint8 = output_uint8
        self.sampler = sampler
        self.schedule_method = schedule_method
        self.ddim = make_ddim_schedule(model.schedule, num_steps, eta=eta,
                                       method=schedule_method,
                                       timesteps=timesteps)
        # the ODE solvers ignore eta
        if sampler == "dpm++":
            self.solver = make_dpm_solver_schedule(
                model.schedule, num_steps, method=schedule_method)
        elif sampler == "unipc":
            self.solver = make_unipc_schedule(
                model.schedule, num_steps, method=schedule_method)
        else:
            self.solver = self.ddim
        # the table's length, not the requested count: callers size
        # per-step inputs (`noise`) by what will run
        self.num_steps = self.solver.num_steps

    def _cond(self, context, concat):
        cond = {"c_crossattn": context, "c_concat": concat}
        if self.model.config.conditioning_key in ("hybrid", "crossattn"):
            cond["cross_kv"] = self.model.cross_kv(context)
        return cond

    def _prepare(self, batch: Dict[str, torch.Tensor]):
        """(cond, uncond, latent shape) of a batch."""
        model = self.model
        dev = model.device
        get = lambda k: (None if batch.get(k) is None  # noqa: E731
                         else batch[k].to(dev, torch.float32))
        context = model.build_context(get("text_emb"), get("style_emb"),
                                      get("smpl"))
        cond = self._cond(context, get("person_mask"))
        uncond = batch.get("uncond")
        if uncond is not None:
            concat = uncond.get("c_concat")
            uncond = self._cond(
                uncond["c_crossattn"].to(dev, torch.float32),
                None if concat is None else concat.to(dev, torch.float32))
        return cond, uncond, self._shape(batch)

    def _initial_noise(self, batch, shape, generator, shared_x_T,
                       seed_generator=None):
        dev = self.model.device
        if shared_x_T:
            return torch.randn((1,) + shape[1:], generator=generator,
                               device=dev).expand(shape)
        seeds = batch.get("x_T_seed")
        if seeds is None:
            return torch.randn(shape, generator=generator, device=dev)
        # one base from `seed_generator`, else the call's generator; each
        # distinct seed gets its own generator from (base, seed), so equal
        # seeds give equal rows. A CPU generator keeps the base, and with
        # host seeds the whole draw, off the device's queue: no sync
        src = generator if seed_generator is None else seed_generator
        base = int(torch.randint(
            2**62, (1,), generator=src,
            device=dev if src is None else src.device).item())
        seeds = [int(s) for s in torch.as_tensor(seeds).reshape(-1).tolist()]
        if len(seeds) != shape[0]:
            raise ValueError(f"x_T_seed has {len(seeds)} seeds for a batch "
                             f"of {shape[0]}")
        rows = {}
        for s in seeds:
            if s not in rows:
                g = torch.Generator(device=dev).manual_seed(
                    (base + s * 0x9E3779B97F4A7C15) % 2**63)
                rows[s] = torch.randn(shape[1:], generator=g, device=dev)
        return torch.stack([rows[s] for s in seeds])

    def to(self, device) -> "GenerationPipeline":
        """Move the model to `device` (in place); returns the pipeline."""
        self.model.to(device)
        return self

    @torch.inference_mode()
    def draws(self, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, *,
              seed_generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """The random tensors `generate(batch, generator, seed_generator=
        ...)` draws, drawn here in its order on the model's device:
        `x_T`, then DDIM's per-step `noise` where a step adds noise. Their
        rows, given to `generate` as `x_T=` / `noise=`, give those rows of
        the batch's images: what a replica of a data-parallel engine takes
        of its batch."""
        shape = self._shape(batch)
        out = {"x_T": self._initial_noise(batch, shape, generator, False,
                                          seed_generator)}
        if self.sampler == "ddim" and bool((self.ddim.sigmas != 0).any()):
            out["noise"] = torch.stack([
                torch.randn(shape, generator=generator,
                            device=self.model.device)
                for _ in range(self.ddim.num_steps)])
        return out

    def _shape(self, batch) -> Tuple[int, ...]:
        """The latent shape of a batch."""
        cfg = self.model.config
        return ((batch["text_emb"].shape[0],) + tuple(cfg.latent_size)
                + (cfg.latent_channels,))

    def _eps_model(self):
        model = self.model

        # to_eps: v- and x0-parameterised models (distilled students) reach
        # every sampler as eps
        def eps_model(x, t, c):
            return model.to_eps(model.apply_model(x, t, c), x, t)

        return eps_model

    def _finish(self, z: torch.Tensor) -> torch.Tensor:
        img = torch.clamp(self.model.decode_first_stage(z), -1.0, 1.0)
        return _to_uint8(img) if self.output_uint8 else img

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        *,
        shared_x_T: bool = False,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        seed_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Images NHWC: float32 in [-1, 1], uint8 with `output_uint8`, or
        latents with `decode=False`.

        `batch` holds `text_emb`, optional `style_emb`, `smpl`,
        `person_mask`, `uncond` (a cond dict for guidance) and `x_T_seed`
        ((B,) ints). `x_T` and DDIM's per-step `noise` override draws from
        `generator`. `seed_generator`, where given, draws the base of the
        `x_T_seed` rows instead of `generator`: a CPU generator there, with
        `x_T_seed` on the host, keeps the call free of device syncs.
        """
        cond, uncond, shape = self._prepare(batch)
        if x_T is None:
            x_T = self._initial_noise(batch, shape, generator, shared_x_T,
                                      seed_generator)
        x_T = x_T.to(self.model.device)
        eps_model = self._eps_model()
        kw = dict(x_T=x_T, guidance_scale=self.guidance_scale, uncond=uncond)
        if self.sampler == "ddim":
            z = ddim_sample(eps_model, self.ddim, shape, cond,
                            generator=generator, noise=noise, **kw)
        elif noise is not None:
            raise ValueError(f"{self.sampler} is an ODE solver: no per-step "
                             f"noise")
        elif self.sampler == "dpm++":
            z = dpm_solver_pp_sample(eps_model, self.solver, shape, cond, **kw)
        else:
            z = unipc_sample(eps_model, self.solver, shape, cond, **kw)
        return self._finish(z) if self.decode else z

    @torch.inference_mode()
    def generate_progressive(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        n_frames: int = 6,
        *,
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final images, progression): the reference's denoise-row debug
        surface (ddpm.py:1395-1431). `progression` is (B, n_frames, H, W,
        C) of decoded x0 predictions evenly spaced down the reverse process,
        the last frame the final x0 prediction. DDIM only; `x_T` and `noise`
        override draws from `generator`, x_T first, as in `generate`.
        """
        if self.sampler != "ddim":
            raise ValueError("progressive rows are a DDIM debug surface")
        cond, uncond, shape = self._prepare(batch)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator,
                              device=self.model.device)
        z, inter = ddim_sample(
            self._eps_model(), self.ddim, shape, cond, generator=generator,
            x_T=x_T.to(self.model.device), noise=noise,
            guidance_scale=self.guidance_scale, uncond=uncond,
            return_pred_x0=True)
        idx = np.linspace(0, self.ddim.num_steps - 1,
                          n_frames).round().astype(int)
        prog = torch.stack([self._finish(inter[i]) for i in idx], dim=1)
        return self._finish(z), prog


# ---------------- style mixing ----------------


def mix_style(
    style_image_emb: torch.Tensor,
    text_pooled_emb: Optional[torch.Tensor] = None,
    text_override: Optional[Sequence[bool]] = None,
    drop_slots: Optional[Sequence[int]] = None,
    empty_style_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot text<->image embedding swap (generate_utils.py:172-190).

    style_image_emb: (9, 768) or (B, 9, 768) CLIP image embeddings.
    text_pooled_emb: same shape, pooled CLIP text embeddings per slot.
    text_override[i]: replace slot i's image embedding with its text one.
    drop_slots: slot indices masked to the empty-style embedding.
    """
    out = style_image_emb
    if drop_slots and empty_style_emb is not None:
        out = out.clone()
        for i in drop_slots:
            out[..., i, :] = empty_style_emb
    if text_pooled_emb is not None and text_override is not None:
        sel = torch.as_tensor(list(text_override), dtype=torch.bool,
                              device=out.device).reshape(
            (1,) * (out.dim() - 2) + (-1, 1))
        out = torch.where(sel, text_pooled_emb, out)
    return out


# ---------------- pose / mask interpolation ----------------


def interpolate_smpl(smpl_src: torch.Tensor, smpl_dst: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """(85,)-vector lerp per frame: alpha*src + (1-alpha)*dst
    (reference app.py:298-300). alphas (F,) -> (F, *smpl_src.shape)."""
    a = alphas.reshape(-1, *([1] * smpl_src.dim()))
    return a * smpl_src[None] + (1.0 - a) * smpl_dst[None]


def _mask_bbox(mask: np.ndarray) -> np.ndarray:
    """bbox (rmin, rmax, cmin, cmax) of mask pixels above background
    (generate_utils.py:103-113: -1 is background)."""
    m = np.array(mask, dtype=np.float32)
    m[m == MASK_BG] = 0.0
    rows = np.nonzero(np.mean(m, axis=1))[0]
    cols = np.nonzero(np.mean(m, axis=0))[0]
    return np.array([rows[0], rows[-1], cols[0], cols[-1]], dtype=np.float64)


def interp_mask(src_mask: np.ndarray, dst_mask: np.ndarray,
                alpha: float) -> np.ndarray:
    """bbox-corner lerp with the reference's fill constants
    (generate_utils.py:121-128). Host-side numpy; (h, w) or (h, w, 1)."""
    squeeze = src_mask.ndim == 3
    s = src_mask[..., 0] if squeeze else src_mask
    d = dst_mask[..., 0] if squeeze else dst_mask
    c1, c2 = _mask_bbox(s), _mask_bbox(d)
    rmin, rmax, cmin, cmax = (alpha * c1 + (1 - alpha) * c2).astype(np.int32)
    out = np.full_like(s, MASK_BG, dtype=np.float32)
    out[rmin:rmax + 1, cmin:cmax + 1] = MASK_BOX
    return out[..., None] if squeeze else out


def interpolate_masks(src_mask: np.ndarray, dst_mask: np.ndarray,
                      alphas: Sequence[float]) -> np.ndarray:
    """Stack of F interpolated masks for a batched sampler call."""
    return np.stack([interp_mask(src_mask, dst_mask, float(a))
                     for a in alphas])


# ---------------- 256 -> 512 upscale chain ----------------


def prepare_lr_condition(image_256: torch.Tensor,
                         out_hw: Tuple[int, int] = (128, 96)) -> torch.Tensor:
    """256x192 sample -> low-res concat conditioning for the upscale stage
    (app.py:93-97): edge-pad 4 px left and right, bilinear resize to the
    stage's latent grid, values left in [-1, 1]. NHWC in and out, float32.

    The resize antialiases when it downscales, as `jax.image.resize(...,
    "bilinear")` does; `F.interpolate(antialias=True)` computes the same
    triangle filter scaled to the output spacing.
    """
    x = image_256.float().permute(0, 3, 1, 2)
    x = F.pad(x, (4, 4, 0, 0), mode="replicate")
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


class UpscalePipeline:
    """The 512 stage alone: lr-concat conditioned sampling in kl-f4 latent
    space (app.py:379-409, models/upgpt/upscale/config.yaml)."""

    def __init__(self, model: LatentDiffusion, num_steps: int = 200,
                 eta: float = 1.0, output_uint8: bool = False,
                 sampler: str = "ddim", schedule_method: str = "uniform"):
        self.inner = GenerationPipeline(
            model, num_steps=num_steps, eta=eta, output_uint8=output_uint8,
            sampler=sampler, schedule_method=schedule_method)
        # lr concat grid = this stage's latent size (128x96 released)
        self.lr_hw = model.config.latent_size

    def upscale(self, image_256: torch.Tensor, text_emb: torch.Tensor,
                style_emb: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, *,
                x_T: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = {"text_emb": text_emb, "style_emb": style_emb,
                 # the c_concat slot carries the lr image (3 channels)
                 "person_mask": prepare_lr_condition(image_256, self.lr_hw)}
        return self.inner.generate(batch, generator, x_T=x_T, noise=noise)


class ChainedUpscalePipeline:
    """End-to-end 256->512 generation: the 256 stage to a float image on
    the card, its lr condition, then the upscale stage.

    `batch` is the 256 stage's conditioning (text_emb, style_emb, smpl,
    person_mask, optional x_T_seed); the upscale stage reuses text_emb and
    style_emb (an 86-token context) and takes its c_concat from the
    generated image, resized to `lr_hw` (default: the upscale stage's latent
    grid). The upscale stage runs `upscale_steps` (default `num_steps`);
    both stages use `sampler` on the `schedule_method` grid. Both draw from
    one `generator`, the 256 stage first; `shared_x_T` applies to the 256
    stage; `x_T`, `noise`, `up_x_T` and `up_noise` override the draws of
    each stage; `seed_generator` draws the 256 stage's `x_T_seed` base.
    """

    def __init__(self, base_model: LatentDiffusion,
                 upscale_model: LatentDiffusion, num_steps: int = 50,
                 upscale_steps: Optional[int] = None, eta: float = 1.0,
                 sampler: str = "ddim", output_uint8: bool = False,
                 lr_hw: Optional[Tuple[int, int]] = None,
                 schedule_method: str = "uniform"):
        # the intermediate stays a float image in [-1, 1]; only the final
        # stage honours output_uint8
        self.base = GenerationPipeline(
            base_model, num_steps=num_steps, eta=eta, sampler=sampler,
            schedule_method=schedule_method)
        self.up = GenerationPipeline(
            upscale_model, num_steps=upscale_steps or num_steps, eta=eta,
            sampler=sampler, output_uint8=output_uint8,
            schedule_method=schedule_method)
        self.lr_hw = tuple(lr_hw or upscale_model.config.latent_size)

    def to(self, device) -> "ChainedUpscalePipeline":
        """Move both stages' models to `device` (in place)."""
        self.base.to(device)
        self.up.to(device)
        return self

    @torch.inference_mode()
    def draws(self, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, *,
              seed_generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """`generate`'s draws in its order: the 256 stage's (`x_T`,
        `noise`), then the upscale stage's (`up_x_T`, `up_noise`)."""
        out = self.base.draws(batch, generator,
                              seed_generator=seed_generator)
        up = self.up.draws({"text_emb": batch["text_emb"]}, generator)
        out.update((f"up_{k}", v) for k, v in up.items())
        return out

    def generate(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 shared_x_T: bool = False,
                 x_T: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 up_x_T: Optional[torch.Tensor] = None,
                 up_noise: Optional[torch.Tensor] = None,
                 seed_generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        img256 = self.base.generate(batch, generator, shared_x_T=shared_x_T,
                                    x_T=x_T, noise=noise,
                                    seed_generator=seed_generator)
        up_batch = {"text_emb": batch["text_emb"],
                    "style_emb": batch.get("style_emb"),
                    "person_mask": prepare_lr_condition(img256, self.lr_hw)}
        return self.up.generate(up_batch, generator, x_T=up_x_T,
                                noise=up_noise)
