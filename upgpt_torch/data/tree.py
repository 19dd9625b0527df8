"""A DeepFashion-shaped tree of random content, for smoke runs and tests
where no DeepFashion data exists.

It holds what `DeepFashionPair` reads, in the layout of the released tree
(the JAX package's tests build the same by hand, `tests/test_data.py`):

    img_256/{MEN,WOMEN}/<id>_1_front.jpg   person images at `image_hw`
    smpl_256/pose<i>.jpg, pose<i>_mask.png  SMPL render (256x192) and its
                                            silhouette at `image_hw`
    smpl_256/pose<i>.p                      SMPL pickle (72 + 10 + 3)
    smpl/pose<i>.jpg, pose<i>.p             the same render and pickle where
                                            the 'smpl' mask type reads them
    segm_256/{MEN,WOMEN}/<id>_1_front_segm.png  DeepFashion-MM labels
    styles/s<i>/<slot>.jpg                  224x224 crops, some slots empty
    captions.json, map.csv, pairs-<split>.csv

Images are smooth random fields with mild noise (a photograph's JPEG is
neither flat nor white noise). Every file is a pure function of `seed`.
"""

from __future__ import annotations

import csv
import json
import pickle
import shutil
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

from upgpt_torch.data.deepfashion import STYLE_NAMES

_WORDS = ("a", "woman", "man", "wears", "red", "blue", "striped", "cotton",
          "shirt", "dress", "jacket", "denim", "skirt", "short", "long",
          "sleeves", "pants")


def _smooth(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    h, w = hw
    coarse = rng.integers(0, 256, (max(2, h // 32), max(2, w // 32), 3),
                          np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR),
                     np.int16)
    noise = rng.integers(-12, 13, (h, w, 3), np.int16)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _person(rng, hw, i: int, root: Path, gender: str) -> Dict[str, str]:
    """One person's files; returns its map row."""
    from PIL import Image

    h, w = hw
    name = f"{gender}/id_{i:05d}_1_front.jpg"
    path = root / "img_256" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(_smooth(rng, hw)).save(path, quality=90)

    pose = f"pose{i}"
    Image.fromarray(_smooth(rng, (256, 192))).save(
        root / "smpl_256" / f"{pose}.jpg", quality=90)
    top = int(rng.integers(0, h // 4 + 1))
    left = int(rng.integers(0, w // 4 + 1))
    mask = np.zeros((h, w), np.uint8)
    mask[top:h - top // 2, left:w - left // 2] = 255
    Image.fromarray(mask).save(root / "smpl_256" / f"{pose}_mask.png")
    with open(root / "smpl_256" / f"{pose}.p", "wb") as f:
        pickle.dump([{
            "pred_body_pose": rng.normal(size=(1, 72)).astype(np.float32),
            "pred_betas": rng.normal(size=(1, 10)).astype(np.float32),
            "pred_camera": rng.normal(size=(3,)).astype(np.float32),
        }], f)
    for ext in (".jpg", ".p"):
        shutil.copyfile(root / "smpl_256" / f"{pose}{ext}",
                        root / "smpl" / f"{pose}{ext}")

    # labels: background 0, top 1, pants 5, hair 13, face 14, skin 15
    segm = np.zeros((h, w), np.uint8)
    segm[top:h - top // 2, left:w - left // 2] = 1
    segm[(h * 5) // 8:h - top // 2, left:w - left // 2] = 5
    segm[top:top + h // 8, w // 3:(2 * w) // 3] = 13
    segm[top + h // 16:top + h // 6, w // 3:(2 * w) // 3] = 14
    segm[h // 3:h // 2, left:left + max(1, w // 10)] = 15
    seg_path = root / "segm_256" / name.replace(".jpg", "_segm.png")
    seg_path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(segm).save(seg_path)

    styles = f"s{i}"
    (root / "styles" / styles).mkdir(parents=True)
    for slot in STYLE_NAMES:
        if rng.random() < 0.6:
            Image.fromarray(_smooth(rng, (224, 224))).save(
                root / "styles" / styles / f"{slot}.jpg", quality=90)
    return {"image": name, "text": f"t{i}", "pose": pose, "styles": styles}


def write_fashion_tree(root, splits: Mapping[str, Tuple[int, int]],
                       image_hw: Tuple[int, int] = (256, 192),
                       seed: int = 0) -> Dict[str, str]:
    """Write the tree under `root`. `splits` maps a split's name to its
    count of pairs (from a WOMEN source, from a MEN source); each split has
    its own people, half as many of each gender as it has pairs of that
    source (two at least). Returns the paths a `DeepFashionPair` takes:
    `folder`, `data_file` and, per split, its pair file."""
    root = Path(root)
    for d in ("smpl_256", "smpl"):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, captions, out = [], {}, {"folder": str(root),
                                   "data_file": str(root / "map.csv")}
    for split, counts in splits.items():
        people = {}
        for gender, n_pairs in zip(("WOMEN", "MEN"), counts):
            people[gender] = []
            for _ in range(max(2, -(-n_pairs // 2)) if n_pairs else 0):
                i = len(rows)
                rows.append(_person(rng, image_hw, i, root, gender))
                captions[f"t{i}"] = " ".join(
                    rng.choice(_WORDS, size=int(rng.integers(4, 9))))
                people[gender].append(rows[-1]["image"])
        everyone = people["WOMEN"] + people["MEN"]
        pairs = []
        for gender, n_pairs in zip(("WOMEN", "MEN"), counts):
            for _ in range(n_pairs):
                src = people[gender][int(rng.integers(len(people[gender])))]
                dst = src
                while dst == src:
                    dst = everyone[int(rng.integers(len(everyone)))]
                pairs.append({"from": src, "to": dst})
        pair_file = root / f"pairs-{split}.csv"
        with open(pair_file, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["from", "to"])
            w.writeheader()
            w.writerows(pairs)
        out[split] = str(pair_file)
    with open(root / "map.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "text", "pose", "styles"])
        w.writeheader()
        w.writerows(rows)
    with open(root / "captions.json", "w") as f:
        json.dump(captions, f)
    return out
