"""Procedural synthetic pose-transfer dataset: the distillation rig's data.

Port of `upgpt_tpu.data.synthetic`: a deterministic conditioning -> image
renderer with a few hundred distinct samples and a held-out split, so a
model can be trained and distilled with no files and scored on
conditioning it never saw.

The task mirrors `DeepFashionPair`'s contract (data/deepfashion.py): the
bbox person mask carries the figure's position and extent at latent
resolution (the reference's input_mask values -1 / -0.99215686), the SMPL
vector carries the figure's geometry (its "pose"), the nine style slots
carry garment colours through a FIXED random projection into embedding
space (face, top and bottom slots live, the rest empty; the slot order of
deepfashion_inshop.py:21), and the text tokens carry the background
colour. A generalising model must route colour from the slots and
geometry from the SMPL vector: the conditioning is never ignorable.

Rendering is a vectorised numpy figure (head circle, torso, legs), a pure
function of the sample index, so every sample is bit-equal to the JAX
package's. Samples are numpy arrays, NHWC; `iterator` yields CPU torch
tensors in the same shuffled-epoch order, and the consumer moves them to
the model's device.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

MASK_BG = -1.0
MASK_BOX = -0.99215686  # the /255 backward-compat constant

_PROJ_SEED = 240817  # fixed projections: same embedding map for every split


class SyntheticPairs:
    """Deterministic procedural dataset.

    Geometry: (img_h, img_w) images over (latent_h, latent_w) masks and a
    `ctx_dim`-wide embedding space; interp_256 is (256, 192), (32, 24),
    768.
    """

    def __init__(
        self,
        img_hw: Tuple[int, int] = (256, 192),
        latent_hw: Tuple[int, int] = (32, 24),
        ctx_dim: int = 768,
        n_samples: int = 384,
        split: str = "train",
        holdout: float = 0.125,
        seed: int = 0,
    ):
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        self.img_hw = img_hw
        self.latent_hw = latent_hw
        self.ctx_dim = ctx_dim
        self.seed = seed
        n_val = max(1, int(n_samples * holdout))
        # held-out = the LAST n_val indices; same universe either way so
        # train/val renderers share every projection and range
        self.indices = (np.arange(n_samples - n_val) if split == "train"
                        else np.arange(n_samples - n_val, n_samples))
        r = np.random.default_rng(_PROJ_SEED)
        d = ctx_dim
        # fixed projections (NOT per-sample): color (3,) -> embedding (d,)
        self._w_style = r.normal(size=(3, d)).astype(np.float32) * 0.5
        self._w_text = r.normal(size=(3, d)).astype(np.float32) * 0.5
        self._pos_text = r.normal(size=(77, d)).astype(np.float32) * 0.2
        self._slot_emb = r.normal(size=(9, d)).astype(np.float32) * 0.2
        self._empty_slot = r.normal(size=(d,)).astype(np.float32) * 0.2

    def __len__(self) -> int:
        return len(self.indices)

    # ---------------- per-sample parameters ----------------

    def _params(self, index: int) -> Dict[str, np.ndarray]:
        """Geometry + colors for global sample `index`, deterministic."""
        r = np.random.default_rng((self.seed << 20) + index)
        return {
            "cx": r.uniform(0.3, 0.7),      # figure center x (frac of W)
            "cy": r.uniform(0.35, 0.5),     # torso top y
            "sw": r.uniform(0.18, 0.34),    # torso width
            "sh": r.uniform(0.2, 0.32),     # torso height
            "head_r": r.uniform(0.05, 0.09),
            "leg_h": r.uniform(0.18, 0.3),
            "c_top": r.uniform(0.1, 0.95, size=3),
            "c_bot": r.uniform(0.1, 0.95, size=3),
            "c_skin": r.uniform(0.55, 0.9, size=3),
            "c_bg": r.uniform(0.05, 0.85, size=3),
        }

    # ---------------- renderer ----------------

    def _render(self, p) -> np.ndarray:
        h, w = self.img_hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy /= h
        xx /= w
        img = np.broadcast_to(
            np.asarray(p["c_bg"], np.float32), (h, w, 3)).copy()
        # torso rectangle
        torso = ((np.abs(xx - p["cx"]) < p["sw"] / 2)
                 & (yy >= p["cy"]) & (yy < p["cy"] + p["sh"]))
        img[torso] = p["c_top"]
        # legs below the torso, 70% of torso width
        legs = ((np.abs(xx - p["cx"]) < 0.35 * p["sw"])
                & (yy >= p["cy"] + p["sh"])
                & (yy < p["cy"] + p["sh"] + p["leg_h"]))
        img[legs] = p["c_bot"]
        # head circle (aspect-corrected so it stays round)
        aspect = w / h
        head_cy = p["cy"] - 1.15 * p["head_r"]
        head = ((xx - p["cx"]) ** 2 / aspect**2
                + (yy - head_cy) ** 2) < p["head_r"] ** 2
        img[head] = p["c_skin"]
        return (img * 2.0 - 1.0).astype(np.float32)

    def _bbox_mask(self, p) -> np.ndarray:
        """Figure bbox at latent resolution, deepfashion bbox-mask values."""
        lh, lw = self.latent_hw
        y0 = p["cy"] - 2.3 * p["head_r"]
        y1 = p["cy"] + p["sh"] + p["leg_h"]
        x0 = p["cx"] - p["sw"] / 2
        x1 = p["cx"] + p["sw"] / 2
        yy, xx = np.mgrid[0:lh, 0:lw].astype(np.float32)
        yy /= lh
        xx /= lw
        box = (yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)
        mask = np.full((lh, lw, 1), MASK_BG, np.float32)
        mask[box] = MASK_BOX
        return mask

    # ---------------- conditioning encoders ----------------

    def _smpl(self, p) -> np.ndarray:
        v = np.zeros((1, 85), np.float32)
        # geometry scaled to roughly unit range; the rest stays zero (the
        # model's LinearProject sees a well-scaled, fully-informative token)
        v[0, :6] = [p["cx"] * 2 - 1, p["cy"] * 2 - 1, p["sw"] * 4 - 1,
                    p["sh"] * 4 - 1, p["head_r"] * 10 - 0.7,
                    p["leg_h"] * 4 - 1]
        return v

    def _style(self, p) -> np.ndarray:
        emb = np.tile(self._empty_slot, (9, 1)).copy()
        emb[0] = np.asarray(p["c_skin"], np.float32) @ self._w_style  # face
        emb[4] = np.asarray(p["c_top"], np.float32) @ self._w_style   # top
        emb[6] = np.asarray(p["c_bot"], np.float32) @ self._w_style   # bottom
        return emb + self._slot_emb

    def _text(self, p) -> np.ndarray:
        content = np.asarray(p["c_bg"], np.float32) @ self._w_text
        return self._pos_text + content[None, :]

    # ---------------- public API ----------------

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        """Sample by SPLIT-LOCAL index i (0..len-1)."""
        p = self._params(int(self.indices[i]))
        lh, lw = self.latent_hw
        return {
            "image": self._render(p),
            "person_mask": self._bbox_mask(p),
            "text_emb": self._text(p),
            "style_emb": self._style(p),
            "smpl": self._smpl(p),
            "loss_w": np.ones((lh, lw, 1), np.float32),
        }

    def batch(self, idxs) -> Dict[str, np.ndarray]:
        samples = [self.sample(int(i)) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def iterator(self, batch_size: int, seed: int = 0
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        """Infinite shuffled-epoch iterator (deterministic per seed) of
        batches as CPU tensors; the tail of an epoch that does not fill a
        batch is dropped."""

        def gen():
            for epoch in itertools.count():
                r = np.random.default_rng((seed << 16) + epoch)
                order = r.permutation(len(self))
                for k in range(0, len(order) - batch_size + 1, batch_size):
                    bt = self.batch(order[k:k + batch_size])
                    yield {n: torch.from_numpy(v) for n, v in bt.items()}

        return gen()

    @classmethod
    def for_model(cls, cfg, **kw) -> "SyntheticPairs":
        """Geometry from a LatentDiffusionConfig (full or tiny)."""
        f = 2 ** (len(cfg.vae.ch_mult) - 1)
        h, w = cfg.latent_size
        return cls(img_hw=(h * f, w * f), latent_hw=(h, w),
                   ctx_dim=cfg.context_dim or 768, **kw)
