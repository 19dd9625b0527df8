"""Segmentation-driven style extraction and loss-weight maps (numpy).

The port's copy of `upgpt_tpu.data.segm`. Re-implements the reference
Segmenter family (ldm/data/segm_utils.py:25-228) in numpy: per-label-group
binary mask -> margin'd bbox crop -> mask-background fill -> square zero-pad
-> short-side 224 resize + center crop; the background slot is instead
filled with its own mean color; face crops taller than 128 px are rejected
(returned as zeros). `get_mask` builds
per-part loss-weight maps (used for the per-pixel weighted eps-loss,
interp_256/config.yaml:118-122).

Outputs are HWC float in the caller's space (crops are produced in [0,1] and
CLIP-normalized by the dataset, mirroring clip_transform at
segm_utils.py:181-185).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
from upgpt_torch.data.transforms import (
    CLIP_MEAN, CLIP_STD, center_crop, resize_short_side,
)

# DeepFashion-MM label table (segm_utils.py:191-215)
DEEPFASHION_MM_LABELS = {
    0: "background", 1: "top", 2: "outer", 3: "skirt", 4: "dress", 5: "pants",
    6: "leggings", 7: "headwear", 8: "eyeglass", 9: "neckwear", 10: "belt",
    11: "footwear", 12: "bag", 13: "hair", 14: "face", 15: "skin", 16: "ring",
    17: "wrist wearing", 18: "socks", 19: "gloves", 20: "necklace",
    21: "rompers", 22: "earrings", 23: "tie",
}

# full 9-slot style grouping used by scripts/segment.py for dataset prep
DEEPFASHION_MM_STYLE_GROUPS = OrderedDict({
    "face": ["eyeglass", "face"],
    "hair": ["hair"],
    "headwear": ["headwear"],
    "background": ["background"],
    "top": ["top", "dress", "rompers"],
    "outer": ["outer"],
    "bottom": ["skirt", "pants", "leggings", "dress", "rompers"],
    "shoes": ["footwear", "socks"],
    "accesories": ["neckwear", "belt", "bag", "necklace", "earrings", "tie",
                   "wrist wearing", "ring", "gloves", "scarf"],
})

# LIP label table (segm_utils.py:155-171)
LIP_LABELS = {
    i: n for i, n in enumerate([
        "background", "hat", "hair", "glove", "eyeglass", "top", "dress",
        "coat", "socks", "pants", "jumpsuits", "scarf", "skirt", "face",
        "left-arm", "right-arm", "left-leg", "right-leg", "left-shoe",
        "right-shoe",
    ])
}

LIP_STYLE_GROUPS = OrderedDict({
    "face": ["eyeglass", "face"],
    "background": ["background"],
    "hair": ["hair"],
    "headwear": ["hat"],
    "top": ["top", "dress", "jumpsuits", "scarf"],
    "bottom": ["skirt", "dress", "pants", "jumpsuits"],
    "shoes": ["left-shoe", "right-shoe", "socks"],
    "outer": ["coat"],
})


class Segmenter:
    def __init__(self, label_dict: Dict[int, str], segm_groups: "OrderedDict"):
        self.label_dict = label_dict
        self.label2id = {v: k for k, v in label_dict.items()}
        self.segm_groups = segm_groups
        self.segm_id_groups = OrderedDict(
            (k, [self.label2id[l] for l in v if l in self.label2id])
            for k, v in segm_groups.items()
        )

    def get_mask(self, segm: np.ndarray, mask_val: Optional[Dict[str, float]],
                 default_value: float = 1.0) -> np.ndarray:
        """Per-part loss-weight map (segm_utils.py:42-47)."""
        mask = np.full(segm.shape, default_value, np.float32)
        if mask_val:
            for label, value in mask_val.items():
                # configs name labels (left-arm/right-arm) missing from the
                # MM table; the reference KeyErrors into skip_sample there —
                # we ignore unknown labels instead of dropping the sample
                lid = self.label2id.get(label)
                if lid is not None:
                    mask[segm == lid] = value
        return mask

    def get_binary_mask(self, segm: np.ndarray, mask_ids) -> np.ndarray:
        mask = np.zeros(segm.shape, bool)
        for mid in mask_ids:
            mask |= segm == mid
        return mask

    @staticmethod
    def _mask_range(mask: np.ndarray, margin: int = 0) -> Dict[str, int]:
        h, w = mask.shape
        vertical = mask.astype(np.float32).sum(0)
        horizontal = mask.astype(np.float32).sum(1)
        cols = np.nonzero(vertical > 0.1)[0]
        rows = np.nonzero(horizontal > 0.1)[0]
        left = int(cols[0]) if len(cols) else 0
        right = int(cols[-1]) if len(cols) else w
        top = int(rows[0]) if len(rows) else 0
        bottom = int(rows[-1]) if len(rows) else h
        return {
            "left": max(0, left - margin), "right": min(w, right + margin),
            "top": max(0, top - margin), "bottom": min(h, bottom + margin),
        }

    def crop(self, image01: np.ndarray, mask: np.ndarray, margin: int = 0,
             is_background: bool = False, mask_background: bool = False,
             name: Optional[str] = None) -> np.ndarray:
        """One 224x224 style crop in [0,1] HWC (segm_utils.py:93-133)."""
        from PIL import Image

        img = image01.copy()
        r = self._mask_range(mask, margin)
        if is_background:
            # fill non-background pixels with the mean background color
            out = img.copy()
            for c in range(3):
                sel = img[..., c][mask]
                mean_color = sel.mean() if sel.size else 0.0
                ch = out[..., c]
                ch[~mask] = mean_color
            cropped = out
        else:
            cropped = img * mask[..., None] if mask_background else img
            cropped = cropped[r["top"]:r["bottom"], r["left"]:r["right"]]
            if name == "face" and (r["bottom"] - r["top"]) > 128:
                return np.zeros((224, 224, 3), np.float32)
            if cropped.sum() <= 0:
                return np.zeros((224, 224, 3), np.float32)
            h, w = cropped.shape[:2]
            pad = (h - w) // 2
            if pad > 0:
                cropped = np.pad(cropped, ((0, 0), (pad, pad), (0, 0)))
            elif pad < 0:
                cropped = np.pad(cropped, ((-pad, -pad), (0, 0), (0, 0)))
        pil = Image.fromarray((np.clip(cropped, 0, 1) * 255).astype(np.uint8))
        pil = center_crop(resize_short_side(pil, 224), (224, 224))
        return np.asarray(pil, np.float32) / 255.0

    def __call__(self, image01: np.ndarray, segm: np.ndarray) -> "OrderedDict":
        """All style crops for one image; [0,1] HWC in, dict of [0,1] crops out."""
        out = OrderedDict()
        for name, ids in self.segm_id_groups.items():
            mask = self.get_binary_mask(segm, ids)
            out[name] = self.crop(
                image01, mask,
                is_background=(name == "background"),
                mask_background=(name != "face"),
                name=name,
            )
        return out

    def clip_crops(self, image01: np.ndarray, segm: np.ndarray) -> "OrderedDict":
        """Crops already CLIP-normalized (segm_utils.py:181-185)."""
        return OrderedDict(
            (k, (v - CLIP_MEAN) / CLIP_STD) for k, v in self(image01, segm).items()
        )


class DeepfashionMMSegmenter(Segmenter):
    """Loss-weight variant used by DeepFashionPair (segm_utils.py:188-228)."""

    def __init__(self):
        groups = OrderedDict({
            "face": ["eyeglass", "face"],
            "background": ["background"],
            "skin": ["skin"],
        })
        super().__init__(DEEPFASHION_MM_LABELS, groups)


class DeepfashionMMStyleSegmenter(Segmenter):
    """Full 9-slot extraction for dataset prep (scripts/segment.py)."""

    def __init__(self):
        super().__init__(DEEPFASHION_MM_LABELS, DEEPFASHION_MM_STYLE_GROUPS)


class LipSegmenter(Segmenter):
    def __init__(self):
        super().__init__(LIP_LABELS, LIP_STYLE_GROUPS)
