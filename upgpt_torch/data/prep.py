"""Offline dataset preparation: segmentation conversion, style crops and
the high-res resize.

Port of `upgpt_tpu.data.prep` (the reference's prep scripts, SURVEY.md
§2.3):
- `convert_segm_image`: an RGB-palette segmentation PNG -> a paletted
  label-id image, by the DeepFashion-MM colour table (utils/segment.py:20-55);
- `extract_styles_for`: per-slot style crops of an (image, segm) pair into
  `<out>/<slot>.jpg` through `data.segm.DeepfashionMMStyleSegmenter`
  (scripts/segment.py);
- `resize_highres_file`: the 750x1101 originals edge-padded by 38 columns
  each side and LANCZOS-resized to size x size*3/4
  (scripts/resize_highres.py);
- `run_parallel`: one job list over a process pool.

numpy and PIL; PIL is imported where an image is read or written, so
importing the module needs neither.
"""

from __future__ import annotations

import os
from multiprocessing import Pool
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# DeepFashion-MM palette -> label ids (utils/segment.py:20-37)
SEGM_COLOR_TABLE: Dict[Tuple[int, int, int], int] = {
    (0, 0, 0): 0,        # background
    (255, 250, 250): 1,  # top
    (250, 235, 215): 3,  # skirt
    (70, 130, 180): 6,   # leggings
    (16, 78, 139): 14,   # face
    (255, 250, 205): 4,  # dress
    (255, 140, 0): 12,   # bag
    (50, 205, 50): 9,    # neckwear
    (220, 220, 220): 2,  # outer
    (255, 0, 0): 13,     # hair
    (127, 255, 212): 7,  # headwear
    (0, 100, 0): 8,      # eyeglass
    (255, 255, 0): 10,   # belt
    (211, 211, 211): 5,  # pants
    (144, 238, 144): 15, # skin
    (245, 222, 179): 11, # footwear
}


def palette() -> list:
    """The flat RGB palette, label 0 first."""
    label2color = {v: k for k, v in SEGM_COLOR_TABLE.items()}
    out = []
    for i in range(len(label2color)):
        out.extend(label2color[i])
    return out


def convert_segm_image(segm_rgb: np.ndarray):
    """RGB segmentation -> paletted label-id PIL image."""
    from PIL import Image

    segm_rgb = segm_rgb[..., :3]
    labels = np.zeros(segm_rgb.shape[:2], np.uint8)
    for color, label in SEGM_COLOR_TABLE.items():
        labels[np.all(segm_rgb == color, axis=2)] = label
    img = Image.fromarray(labels).convert("P")
    img.putpalette(palette())
    return img


def convert_segm_file(args: Tuple[str, str]) -> None:
    """(src RGB segmentation, dst paletted PNG)."""
    from PIL import Image

    src, dst = args
    out = convert_segm_image(np.asarray(Image.open(src).convert("RGB")))
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    out.save(dst)


def extract_styles_for(args: Tuple[str, str, str]) -> None:
    """(image, segm, out_dir) -> a JPEG per present style slot; an absent
    slot writes no file (a zero slot at load time)."""
    from PIL import Image

    from upgpt_torch.data.segm import DeepfashionMMStyleSegmenter

    image_path, segm_path, out_dir = args
    img = np.asarray(Image.open(image_path).convert("RGB"),
                     np.float32) / 255.0
    crops = DeepfashionMMStyleSegmenter()(img, np.asarray(Image.open(segm_path)))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, crop in crops.items():
        if crop.sum() == 0:
            continue
        Image.fromarray((np.clip(crop, 0, 1) * 255).astype(np.uint8)).save(
            out / f"{name}.jpg")


def resize_highres_file(args: Tuple[str, str, int]) -> None:
    """(src, dst, size): edge-pad 38 columns each side, LANCZOS to
    size x size*3/4, JPEG quality 95."""
    from PIL import Image

    src, dst, size = args
    arr = np.asarray(Image.open(src).convert("RGB"))
    arr = np.pad(arr, ((0, 0), (38, 38), (0, 0)), mode="edge")
    img = Image.fromarray(arr).resize((size * 3 // 4, size), Image.LANCZOS)
    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    img.save(dst, quality=95)


def run_parallel(fn, jobs: Iterable, workers: Optional[int] = None) -> None:
    """`fn` over `jobs` in a process pool (`workers`, default the cores)."""
    jobs = list(jobs)
    with Pool(workers or os.cpu_count()) as pool:
        pool.map(fn, jobs)
