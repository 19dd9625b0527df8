"""The evaluation protocol: scripts/eval_metrics.py over a test_step dump.

Port of `upgpt_tpu.eval.harness` (reference scripts/eval_metrics.py:90-136
and test_step, ddpm.py:1327-1377). `dump_test_results` writes paired
`samples/` and `gt/` JPEGs, center-cropped (256x176, or 512x352 for the
512px stages), with the `recon/`, `src/`, `smpl/`, `concats/` and `styles/`
groups beside them, byte for byte as the JAX harness writes them from the
same arrays. `evaluate_dirs` scores the pairs: per-image SSIM and MS-SSIM
(and LPIPS where a callable is given) into metrics.csv, the means and the
FID over the two sets into metrics.txt.

The metrics run on `device` (the card unless the caller names another)
in float32. MS-SSIM follows pytorch_msssim (`metrics.py`, ROADMAP R7); a
crop whose smaller side is 160 pixels or less has no five scales and
scores NaN, as JAX's does. The FID's features come from any
`(N, H, W, C) -> (N, D)` callable; its `fid_name` (or `fid_name=`) keys
the metric, `fid_inception` for the protocol's network
(`eval/inception.py`), which also writes the `fid` alias.
"""

from __future__ import annotations

import csv
import math
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from upgpt_torch.eval.metrics import (
    fid_from_features, ms_ssim, ms_ssim_fits, ssim,
)

# CLIP's normalisation, with the reference's 0.226862954 for R in place of
# 0.26862954 (ddpm.py:1330), kept for byte parity of the styles strips
_STYLE_STD = np.asarray([0.226862954, 0.26130258, 0.27577711], np.float32)
_STYLE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)


def _load_pairs(sample_dir: str, gt_dir: str) -> List[str]:
    names = sorted(os.listdir(sample_dir))
    return [n for n in names if (Path(gt_dir) / n).exists()]


def _center_crop_np(arr: np.ndarray, hw=(256, 176)) -> np.ndarray:
    h, w = arr.shape[:2]
    th, tw = hw
    top = (h - th) // 2
    left = (w - tw) // 2
    return arr[top: top + th, left: left + tw]


def _read(path: Path, crop_hw) -> np.ndarray:
    from PIL import Image

    return _center_crop_np(np.asarray(Image.open(path).convert("RGB"),
                                      np.float32) / 255.0, crop_hw)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def evaluate_dirs(
    results_dir: str,
    crop_hw=(256, 176),
    batch_size: int = 16,
    lpips_fn: Optional[Callable] = None,
    fid_feature_fn: Optional[Callable] = None,
    fid_name: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Score `results_dir/samples` against `results_dir/gt`.

    Returns the metric dict and writes metrics.csv (per image) and
    metrics.txt (the means and the FID) beside the inputs, like
    eval_metrics.py:113-136. The callables receive images in [-1, 1] on
    `device` and may return tensors or arrays."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate_dirs: no CUDA card is available; pass "
                           "device='cpu'")
    sample_dir = Path(results_dir) / "samples"
    gt_dir = Path(results_dir) / "gt"
    names = _load_pairs(str(sample_dir), str(gt_dir))
    if not names:
        raise FileNotFoundError(f"no paired images under {results_dir}")

    rows = []
    feats_s, feats_g = [], []
    for i in range(0, len(names), batch_size):
        chunk = names[i: i + batch_size]
        s = torch.from_numpy(np.stack(
            [_read(sample_dir / n, crop_hw) for n in chunk])).to(device)
        g = torch.from_numpy(np.stack(
            [_read(gt_dir / n, crop_hw) for n in chunk])).to(device)
        ssim_v = _host(ssim(s, g, size_average=False))
        msssim_v = (_host(ms_ssim(s, g, size_average=False))
                    if ms_ssim_fits(s.shape[1:3])
                    else np.full(len(chunk), math.nan))
        lpips_v = (_host(lpips_fn(s * 2 - 1, g * 2 - 1))
                   if lpips_fn is not None else None)
        for j, (n, sv, mv) in enumerate(zip(chunk, ssim_v, msssim_v)):
            row = {"file": n, "ssim": float(sv), "ms_ssim": float(mv)}
            if lpips_v is not None:
                row["lpips"] = float(lpips_v[j])
            rows.append(row)
        if fid_feature_fn is not None:
            feats_s.append(_host(fid_feature_fn(s * 2 - 1)))
            feats_g.append(_host(fid_feature_fn(g * 2 - 1)))

    metrics = {
        "ssim": float(np.mean([r["ssim"] for r in rows])),
        "ms_ssim": float(np.mean([r["ms_ssim"] for r in rows])),
        "n_images": len(rows),
    }
    if lpips_fn is not None:
        metrics["lpips"] = float(np.mean([r["lpips"] for r in rows]))
    if fid_feature_fn is not None:
        # the key names its extractor, so another network's FID is never
        # read as the protocol's
        name = fid_name or getattr(fid_feature_fn, "fid_name", None)
        key = f"fid_{name}" if name else "fid"
        metrics[key] = fid_from_features(np.concatenate(feats_s),
                                         np.concatenate(feats_g))
        if key == "fid_inception":
            # readers keyed on the older 'fid' see the protocol's number
            metrics["fid"] = metrics[key]

    fields = ["file", "ssim", "ms_ssim"] + (["lpips"] if lpips_fn else [])
    with open(Path(results_dir) / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    with open(Path(results_dir) / "metrics.txt", "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
    return metrics


def _save(arr: np.ndarray, path: Path) -> None:
    from PIL import Image

    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def dump_test_results(
    results_dir: str,
    fnames: List[str],
    samples: np.ndarray,
    gt: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
    styles: Optional[np.ndarray] = None,
    make_concats: bool = False,
    crop_hw=(256, 176),
) -> None:
    """test_step's dump (ddpm.py:1327-1377): center-cropped JPEGs of NHWC
    images in [-1, 1] into results/{samples,gt,<extra>}/<fname>.jpg,
    `concats/` (src | sample | recon | smpl, ddpm.py:1362-1363) and
    `styles/` (the nine CLIP-normalised slots side by side, uncropped,
    ddpm.py:1371-1377). Values truncate to uint8, as the reference's."""
    from PIL import Image

    root = Path(results_dir)
    groups = {"samples": samples}
    if gt is not None:
        groups["gt"] = gt
    if extra:
        groups.update(extra)
    cropped: Dict[str, List[np.ndarray]] = {}
    for group, imgs in groups.items():
        d = root / group
        d.mkdir(parents=True, exist_ok=True)
        arrs = []
        for name, img in zip(fnames, imgs):
            arr = _center_crop_np(np.asarray(img, np.float32), crop_hw)
            arr = np.clip((arr + 1.0) / 2.0, 0, 1)
            arrs.append(arr)
            _save(arr, d / f"{name}.jpg")
        cropped[group] = arrs
    if make_concats and all(k in cropped
                            for k in ("samples", "recon", "src", "smpl")):
        d = root / "concats"
        d.mkdir(parents=True, exist_ok=True)
        for i, name in enumerate(fnames):
            ref_hw = cropped["samples"][i].shape[:2]

            def _match(a, hw=ref_hw):
                if a.shape[:2] == hw:
                    return a
                im = Image.fromarray((a * 255).astype(np.uint8))
                return np.asarray(im.resize(hw[::-1]), np.float32) / 255.0

            cat = np.concatenate(
                [_match(cropped["src"][i]), cropped["samples"][i],
                 _match(cropped["recon"][i]), _match(cropped["smpl"][i])],
                axis=1)
            _save(cat, d / f"{name}.jpg")
    if styles is not None:
        d = root / "styles"
        d.mkdir(parents=True, exist_ok=True)
        for name, slots in zip(fnames, np.asarray(styles, np.float32)):
            strip = np.concatenate(list(slots), axis=1)  # (224, 9*224, 3)
            strip = np.clip(strip * _STYLE_STD + _STYLE_MEAN, 0, 1)
            _save(strip, d / f"{name}.jpg")
