"""Real-data readiness drill: walk a DeepFashion root and validate every
file/schema the loaders will touch, BEFORE the first training/eval run.

The port's copy of `upgpt_tpu.data.verify`, behind `cli data-verify`.

All dataset tests run against synthesized trees; a schema mismatch against
the actual DeepFashion/UPGPT release (CSV columns, caption keys, SMPL pickle
fields, styles/segm/smpl tree completeness) would otherwise surface only as
`skip_sample` storms mid-run (the loader's exception path silently redirects
bad items — deepfashion_inshop.py:28-39). `cli data-verify` walks the same
paths `DeepFashionPair.__getitem__` does (deepfashion_inshop.py:64-272,
DATA_README.md) and emits a count/missing report.

Checked per pair row (from,to,multimodal,segm — pairs-test-all.csv:1):
  - both endpoints present in the map CSV (columns image,text,pose,styles);
  - target image file; caption key; SMPL pickle loadable with
    pred_body_pose (72) + pred_betas (10) + pred_camera (3) = 85;
  - pose render .jpg + _mask.png;
  - styles dir (per-slot jpgs are OPTIONAL — empty slots are legal);
  - segm_256 _segm.png when --loss-weight paths are in play.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from upgpt_torch.data.smpl_pickle import load_smpl_pickle

PAIR_COLUMNS = {"from", "to"}          # multimodal/segm are optional filters
MAP_COLUMNS = {"image", "text", "pose", "styles"}
SMPL_FIELDS = ("pred_body_pose", "pred_betas", "pred_camera")


def _read_csv(path: Path) -> List[Dict[str, str]]:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def verify_root(
    root: str,
    image_dir: str = "img_256",
    pair_files: Sequence[str] = ("data/deepfashion/pairs-test-all.csv",),
    data_file: str = "data/deepfashion/deepfashion_map.csv",
    input_mask_type: str = "bbox",
    check_loss_weight: bool = True,
    limit: Optional[int] = None,
    max_examples: int = 20,
    deep_smpl_every: int = 50,
) -> Dict:
    """Walk the tree; returns the report dict (also printed by the CLI).

    `deep_smpl_every`: unpickle + field-check every Nth SMPL file (full
    unpickling of 100k files would take hours on one core; presence is
    checked for all, schema for the sample).
    """
    root_p = Path(root)
    rep: Dict = {"root": str(root_p), "ok": False, "errors": [],
                 "counts": Counter(), "missing": {}, "examples": {}}
    miss: Dict[str, List[str]] = {}

    def record_missing(kind: str, what: str) -> None:
        rep["counts"][f"missing_{kind}"] += 1
        miss.setdefault(kind, [])
        if len(miss[kind]) < max_examples:
            miss[kind].append(what)

    if not root_p.is_dir():
        rep["errors"].append(f"root {root} is not a directory")
        return _finish(rep, miss)

    # captions
    captions = {}
    cap_path = root_p / "captions.json"
    if cap_path.exists():
        try:
            captions = json.load(open(cap_path))
            rep["counts"]["captions"] = len(captions)
        except Exception as exc:  # noqa: BLE001
            rep["errors"].append(f"captions.json unreadable: {exc!r}")
    else:
        rep["errors"].append("captions.json missing")

    # map CSV
    df_path = Path(data_file)
    if not df_path.exists():
        df_path = root_p / data_file
    if not df_path.exists():
        rep["errors"].append(f"data_file not found: {data_file}")
        return _finish(rep, miss)
    map_rows = _read_csv(df_path)
    if not map_rows or not MAP_COLUMNS <= set(map_rows[0]):
        rep["errors"].append(
            f"map CSV schema mismatch: have {sorted(map_rows[0]) if map_rows else []}, "
            f"need {sorted(MAP_COLUMNS)}")
        return _finish(rep, miss)
    mapping = {r["image"]: r for r in map_rows}
    rep["counts"]["map_rows"] = len(map_rows)

    # pair CSVs
    pairs: List[Dict[str, str]] = []
    for pf in pair_files:
        p = Path(pf) if Path(pf).exists() else root_p / pf
        if not p.exists():
            rep["errors"].append(f"pair_file not found: {pf}")
            continue
        rows = _read_csv(p)
        if rows and not PAIR_COLUMNS <= set(rows[0]):
            rep["errors"].append(
                f"pair CSV {pf} schema mismatch: have {sorted(rows[0])}")
            continue
        pairs.extend(rows)
    rep["counts"]["pair_rows"] = len(pairs)
    if limit:
        pairs = pairs[:limit]

    image_root = root_p / image_dir
    pose_root = (root_p / "smpl_256"
                 if input_mask_type in ("mask", "bbox") else root_p / "smpl")
    style_root = root_p / "styles"
    segm_root = root_p / "segm_256"
    for name, d in (("image_dir", image_root), ("pose_dir", pose_root),
                    ("styles_dir", style_root)):
        if not d.is_dir():
            rep["errors"].append(f"{name} missing: {d}")
    if check_loss_weight and not segm_root.is_dir():
        rep["errors"].append(f"segm_256 missing: {segm_root}")

    seen_smpl = 0
    for i, row in enumerate(pairs):
        for end in ("from", "to"):
            if row[end] not in mapping:
                record_missing("map_entry", row[end])
        tgt = mapping.get(row["to"])
        src = mapping.get(row["from"])
        if tgt is None or src is None:
            continue
        if not (image_root / tgt["image"]).exists():
            record_missing("image", tgt["image"])
        if tgt["text"] not in captions:
            record_missing("caption", tgt["text"])
        pose = pose_root / tgt["pose"]
        for suffix, kind in ((".p", "smpl_pickle"), (".jpg", "smpl_render"),
                             ("_mask.png", "smpl_mask")):
            if not Path(str(pose) + suffix).exists():
                record_missing(kind, tgt["pose"] + suffix)
        if Path(str(pose) + ".p").exists() and i % deep_smpl_every == 0:
            seen_smpl += 1
            err = _check_smpl(Path(str(pose) + ".p"))
            if err:
                record_missing("smpl_schema", f"{tgt['pose']}.p: {err}")
        styles_rel = src.get("styles") or ""
        if styles_rel and not (style_root / styles_rel).is_dir():
            record_missing("styles_dir", styles_rel)
        if check_loss_weight:
            sp = str(segm_root / tgt["image"]).replace(".jpg", "_segm.png")
            if not Path(sp).exists():
                record_missing("segm", sp)
    rep["counts"]["pairs_checked"] = len(pairs)
    rep["counts"]["smpl_deep_checked"] = seen_smpl
    return _finish(rep, miss)


def _check_smpl(path: Path) -> Optional[str]:
    """Unpickle one SMPL file; the 85-vector layout the model consumes
    (pred_body_pose 72 + pred_betas 10 + pred_camera 3,
    deepfashion_inshop.py smpl vector assembly)."""
    import numpy as np

    try:
        params = load_smpl_pickle(path)
        p0 = params[0]
        total = 0
        for f in SMPL_FIELDS:
            if f not in p0:
                return f"field {f} missing (have {sorted(p0)})"
            total += int(np.asarray(p0[f]).size)
        if total != 85:
            return f"vector size {total} != 85"
    except Exception as exc:  # noqa: BLE001
        return repr(exc)
    return None


def _finish(rep: Dict, miss: Dict[str, List[str]]) -> Dict:
    rep["missing"] = {k: {"count": rep["counts"][f"missing_{k}"],
                          "examples": v} for k, v in miss.items()}
    rep["counts"] = dict(rep["counts"])
    rep["ok"] = not rep["errors"] and not rep["missing"]
    return rep
