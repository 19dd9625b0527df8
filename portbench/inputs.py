"""The benchmark's inputs, made from `--seed`.

Conditioning and training batches follow `chip_smoke.py`'s `_batch` and
`_train_batch`: CLIP-width text (77 x 768) and style (9 x 768) embeddings
and an SMPL vector (85) as N(0, 1), a person mask of background (-1) and
box (253/255 scaled) cells, and for training 0.3 N(0, 1) images at the
VAE's input size with unit loss weights. Every tensor comes from a
generator seeded by `sub_seed(seed, ...)`, so a run can draw any batch
again from its seed and index alone.

Arrivals for a served mix are the `n` quantiles of the exponential law at
the mix's rate, in an order drawn from the seed: every seed sends the same
gaps, in another order (an open loop with Poisson-like gaps and no seed
that changes the load).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

MASK_BG, MASK_BOX = -1.0, -0.99215686


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed of (`seed`, keys...), for `torch.Generator`."""
    s = int(seed) % 2**63
    for k in keys:
        s = (s * 0x9E3779B97F4A7C15 + int(k) + 1) % 2**63
    return s


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def conditioning(cfg: dict, b: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """text_emb, style_emb, smpl and person_mask of `b` requests."""
    g = _gen(seed, device)
    h, w = cfg["latent_size"]
    d = cfg["context_dim"]
    mask = torch.where(torch.rand(b, h, w, 1, generator=g, device=device)
                       < 0.5, MASK_BG, MASK_BOX)
    return {"text_emb": torch.randn(b, cfg["text_tokens"], d, generator=g,
                                    device=device),
            "style_emb": torch.randn(b, cfg["style_tokens"], d, generator=g,
                                     device=device),
            "smpl": torch.randn(b, 1, cfg["pose_input_dim"], generator=g,
                                device=device),
            "person_mask": mask}


def sampler_draws(cfg: dict, b: int, steps: int, with_noise: bool, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """x_T, and each step's noise where the sampler adds noise."""
    g = _gen(seed, device)
    h, w = cfg["latent_size"]
    c = cfg["latent_channels"]
    out = {"x_T": torch.randn(b, h, w, c, generator=g, device=device)}
    if with_noise:
        out["noise"] = torch.randn(steps, b, h, w, c, generator=g,
                                   device=device)
    return out


def train_batch(cfg: dict, b: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A training batch: conditioning, 0.3 N(0, 1) images, unit weights."""
    batch = conditioning(cfg, b, seed, device)
    hi, wi = cfg["image_size"]
    g = _gen(sub_seed(seed, 1), device)
    batch["image"] = 0.3 * torch.randn(b, hi, wi, 3, generator=g,
                                       device=device)
    h, w = cfg["latent_size"]
    batch["loss_w"] = torch.ones(b, h, w, 1, device=device)
    return batch


def train_draws(cfg: dict, b: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """One loss's draws, in `LatentDiffusion.training_draws`' layout: the
    posterior noise, t ~ U{0..T-1} and the diffusion noise."""
    g = _gen(seed, device)
    h, w = cfg["latent_size"]
    shape = (b, h, w, cfg["vae"]["embed_dim"])
    return {"posterior_noise": torch.randn(shape, generator=g, device=device),
            "t": torch.randint(0, cfg["timesteps"], (b,), generator=g,
                               device=device),
            "noise": torch.randn(shape, generator=g, device=device)}


def arrival_offsets(rate: float, seconds: float, seed: int) -> List[float]:
    """Due times in [0, seconds) of an open loop at `rate` a second: the
    round(rate * seconds) exponential quantiles as gaps, shuffled by the
    seed, scaled to end inside the window."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    order = np.random.default_rng(sub_seed(seed, 7)).permutation(n)
    gaps = gaps[order]
    due = np.cumsum(gaps) - gaps[0]
    span = due[-1] + float(np.mean(gaps))
    return (due * (seconds / span)).tolist()
