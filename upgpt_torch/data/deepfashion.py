"""DeepFashion in-shop datasets: pair / solo / super-resolution variants.

The port's copy of `upgpt_tpu.data.deepfashion` (reference Datasets,
ldm/data/deepfashion_inshop.py:64-479), numpy and PIL only, so its items and
batches equal the JAX package's byte for byte (tests/test_torch_data.py).
Emits HWC float32 numpy dicts ready for `np.stack` batching and the copy to
the card:

    image (H, W, 3) in [-1,1] | txt str | src_image | fname |
    styles (9, 224, 224, 3) CLIP-normalized (zeros-slot for missing) |
    smpl (1, 85) = pred_body_pose(72) + pred_betas(10) + pred_camera(3) |
    smpl_image | person_mask (h, w, 1) at latent res (one of 3 RPM modes,
    incl. the bbox /255 bug) | loss_w (h, w, 1) optional

Layout differences from the reference are deliberate (NHWC instead of CHW);
value semantics are identical. Failure handling mirrors `skip_sample`
(deepfashion_inshop.py:36-39,269-272): broken sample -> next (or random when
shuffle). `men_factor` oversampling (109-112) and `df_filter` (103-104)
preserved.
"""

from __future__ import annotations

import json
import os
import random as _random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from upgpt_torch.data.segm import DeepfashionMMSegmenter
from upgpt_torch.data.smpl_pickle import load_smpl_pickle
from upgpt_torch.data.transforms import (
    center_crop,
    clip_normalize_image,
    empty_style,
    mask_transform_binary,
    mask_transform_smpl,
    open_rgb,
    pad_image,
    resize_bilinear,
    resize_nearest,
    resize_short_side,
    silhouette_bbox,
    to_tensor_range,
    to_uint8,
)

# the name of the loaders' producer threads, and the prefix of the
# prefetching loader's decode pool, so their threads can be told apart
PRODUCER_THREAD = "upgpt-loader"

STYLE_NAMES = (
    "face", "hair", "headwear", "background", "top",
    "outer", "bottom", "shoes", "accesories",
)


def convert_fname(x: str) -> str:
    """Image path -> flat fashion id (deepfashion_inshop.py:45-49)."""
    a, b = os.path.split(x)
    i = b.rfind("_")
    x = a + "/" + b[:i] + b[i + 1:]
    return "fashion" + x.split(".jpg")[0].replace("id_", "id").replace("/", "")


def get_name(src: str, dst: str) -> str:
    return convert_fname(src) + "___" + convert_fname(dst)


def _read_csv(path: str) -> List[Dict[str, str]]:
    """Minimal CSV reader (header + rows) — avoids a pandas dependency in
    the hot loader path."""
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class DeepFashionPair:
    """Pose-transfer pair dataset (deepfashion_inshop.py:64-272)."""

    def __init__(
        self,
        folder: str,
        image_dir: str,
        pair_file: Sequence[str] | str,
        data_file: str,
        df_filter: Optional[str] = None,
        image_size: Tuple[int, int] = (256, 192),
        f: int = 8,
        resize_size: Optional[int] = None,
        pad: Optional[Sequence[int]] = None,
        input_mask_type: str = "mask",
        loss_weight: Optional[Dict[str, float]] = None,
        image_only: bool = False,
        dropout: Optional[float] = None,
        men_factor: Optional[int] = None,
        shuffle: bool = False,
        seed: int = 0,
        compact: bool = False,
    ):
        """`compact=True` emits uint8 image/src_image/smpl_image/styles
        instead of float32, deferring [-1,1] and CLIP normalization to the
        consumer (the trainer's jitted step / the jitted CLIP encoder —
        i.e. the device). EXACT: every such tensor is uint8-sourced, so
        v/127.5-1 == v/255*2-1 and (v/255-mean)/std match the f32 pipeline
        bit-for-bit (the empty style slot is normalize(black) = uint8
        zeros). 4x less worker-IPC and host->device traffic."""
        if input_mask_type not in ("mask", "smpl", "bbox"):
            raise ValueError(f"input_mask_type {input_mask_type!r}: expected "
                             f"'mask', 'smpl' or 'bbox'")
        self.compact = compact
        self.root = Path(folder)
        self.image_root = self.root / image_dir
        # 'mask'/'bbox' read 256-res smpl renders; 'smpl' the full-res ones
        self.pose_root = (
            self.root / "smpl_256" if input_mask_type in ("mask", "bbox")
            else self.root / "smpl"
        )
        self.style_root = self.root / "styles"
        self.segm_root = self.root / "segm_256"
        self.texts = json.load(open(self.root / "captions.json"))
        self.input_mask_type = input_mask_type
        self.image_only = image_only
        self.loss_weight = loss_weight
        self.dropout = dropout
        self.shuffle = shuffle
        self.latent_hw = (image_size[0] // f, image_size[1] // f)
        self.resize_size = resize_size
        self.pad = tuple(pad) if pad else None
        self.seed = seed
        self._epoch = 0

        self.map: Dict[str, Dict[str, str]] = {}
        for row in _read_csv(data_file):
            self.map[row["image"]] = row

        files = [pair_file] if isinstance(pair_file, str) else list(pair_file)
        rows: List[Dict[str, str]] = []
        for pf in files:
            rows.extend(_read_csv(str(self.root / pf) if not os.path.exists(pf) else pf))
        if df_filter:
            rows = [r for r in rows if str(r.get(df_filter)).lower() == "true"]
        if men_factor:
            men = [r for r in rows if r["from"].split("/")[0] == "MEN"]
            rows = rows + men * men_factor
        self.rows = rows
        self.segmenter = DeepfashionMMSegmenter()

    def __len__(self) -> int:
        return len(self.rows)

    def set_epoch(self, epoch: int) -> None:
        """Epoch context for the per-item RNG (torch set_epoch convention).

        Loaders call this at epoch start so stochastic per-item decisions
        (style dropout, skip-sample redirects) are fresh each epoch yet a
        pure function of (seed, epoch, index) — identical across serial /
        thread / worker-process loaders and across runs. A shared stateful
        RNG would instead be consumed in thread-completion order (threads)
        or cloned into every worker (processes), silently changing the
        dropout statistics."""
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> _random.Random:
        # str seeding uses the deterministic sha512 path (never PYTHONHASHSEED)
        return _random.Random(f"{self.seed}:{self._epoch}:{index}")

    # -- skip_sample semantics (deepfashion_inshop.py:28-39)
    def _skip(self, index: int):
        if self.shuffle:
            return self[self._item_rng(index).randint(0, len(self) - 1)]
        return self[0 if index >= len(self) - 1 else index + 1]

    def _prep_image(self, img: Image.Image) -> np.ndarray:
        if self.resize_size:
            img = resize_short_side(img, self.resize_size)
        if self.pad:
            img = pad_image(img, self.pad)
        if self.compact:
            return to_uint8(img)
        return to_tensor_range(img)

    def _load_styles(self, styles_rel: str, drop_style: bool) -> np.ndarray:
        base = self.style_root / styles_rel
        out = []
        if self.compact:
            for name in STYLE_NAMES:
                p = base / f"{name}.jpg"
                if p.exists() and not drop_style:
                    out.append(to_uint8(open_rgb(p)))
                else:
                    # empty slot = normalize(black) in the f32 pipeline
                    out.append(np.zeros((224, 224, 3), np.uint8))
            return np.stack(out)
        for name in STYLE_NAMES:
            p = base / f"{name}.jpg"
            if p.exists() and not drop_style:
                out.append(clip_normalize_image(open_rgb(p)))
            else:
                out.append(empty_style())
        return np.stack(out)

    def _load_smpl(self, pose_path: str):
        params = load_smpl_pickle(pose_path + ".p")
        vec = np.concatenate(
            (
                np.asarray(params[0]["pred_body_pose"], np.float32).reshape(1, -1),
                np.asarray(params[0]["pred_betas"], np.float32).reshape(1, -1),
                np.asarray(params[0]["pred_camera"], np.float32).reshape(1, -1),
            ),
            axis=1,
        )
        return vec  # (1, 85)

    def _person_mask(self, pose_path: str, smpl_img: Image.Image) -> np.ndarray:
        from PIL import Image

        if self.input_mask_type == "mask":
            m = np.asarray(Image.open(pose_path + "_mask.png"))
            return mask_transform_binary(m, self.latent_hw)
        if self.input_mask_type == "bbox":
            m = silhouette_bbox(np.asarray(Image.open(pose_path + "_mask.png")))
            return mask_transform_binary(m, self.latent_hw)
        return mask_transform_smpl(smpl_img, self.latent_hw)

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image

        try:
            row = self.rows[index]
            target = self.map[row["to"]]
            data: Dict = {
                "image": self._prep_image(open_rgb(self.image_root / target["image"])),
                "txt": self.texts.get(target["text"], ""),
            }
            if self.image_only:
                return data

            source = self.map[row["from"]]
            styles_rel = source.get("styles") or ""
            if not styles_rel:
                return self._skip(index)
            drop_style = (bool(self.dropout)
                          and self._item_rng(index).random() < self.dropout)

            data.update(
                fname=get_name(row["from"], row["to"]),
                src_image=self._prep_image(open_rgb(self.image_root / source["image"])),
                styles=self._load_styles(styles_rel, drop_style),
            )

            pose_path = str(self.pose_root / target["pose"])
            smpl_img = center_crop(open_rgb(pose_path + ".jpg"), (256, 192))
            data["person_mask"] = self._person_mask(pose_path, smpl_img)
            if self.compact:
                data["smpl_image"] = to_uint8(smpl_img)
            else:
                data["smpl_image"] = to_tensor_range(smpl_img)
            data["smpl"] = self._load_smpl(pose_path)

            if self.loss_weight:
                segm_path = str(self.segm_root / target["image"]).replace(
                    ".jpg", "_segm.png"
                )
                segm = np.asarray(Image.open(segm_path))
                lw = self.segmenter.get_mask(segm, self.loss_weight)
                data["loss_w"] = resize_nearest(lw, self.latent_hw)[..., None]
            return data
        except Exception:
            return self._skip(index)


class DeepFashionSample(DeepFashionPair):
    """Solo (same-image) variant keyed by image id
    (deepfashion_inshop.py:275-362); powers notebook/app dataset access."""

    def __init__(self, **kwargs):
        super().__init__(pair_file=kwargs.pop("pair_file", []), **kwargs)
        self.ids = list(self.map.keys())

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        key = self.ids[index] if isinstance(index, int) else index
        return self._solo({"from": key, "to": key})

    def _solo(self, row):
        source = self.map[row["from"]]
        data = {
            "image": self._prep_image(open_rgb(self.image_root / source["image"])),
            "txt": self.texts.get(source["text"], ""),
            "src_image": self._prep_image(open_rgb(self.image_root / source["image"])),
            "styles": self._load_styles(source.get("styles") or "", False),
        }
        pose_path = str(self.pose_root / source["pose"])
        smpl_img = center_crop(open_rgb(pose_path + ".jpg"), (256, 192))
        data["person_mask"] = self._person_mask(pose_path, smpl_img)
        if self.compact:
            data["smpl_image"] = to_uint8(smpl_img)
        else:
            data["smpl_image"] = to_tensor_range(smpl_img)
        data["smpl"] = self._load_smpl(pose_path)
        return data


class DeepFashionSuperRes(DeepFashionPair):
    """Upscale-stage training set: adds the low-res recon conditioning
    (deepfashion_inshop.py:365-416)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.lr_root = self.root / "recon_256"

    def _lr(self, img: Image.Image) -> np.ndarray:

        rgb = resize_bilinear(img, self.latent_hw)
        return (rgb * 2.0 - 1.0).astype(np.float32)

    def __getitem__(self, index):
        try:
            row = self.rows[index]
            source = self.map[row["from"]]
            drop_style = (bool(self.dropout)
                          and self._item_rng(index).random() < self.dropout)
            lr = self._lr(open_rgb(self.lr_root / source["image"]))
            return {
                "lr": lr,
                "person_mask": lr,  # c_concat slot carries the lr image
                "image": self._prep_image(open_rgb(self.image_root / source["image"])),
                "styles": self._load_styles(source.get("styles") or "", drop_style),
                "txt": self.texts.get(source["text"], ""),
            }
        except Exception:
            return self._skip(index)


class DeepFashionSuperResSampling(DeepFashionSuperRes):
    """Upscale-stage eval over generated 256 samples in `lr_dir`
    (deepfashion_inshop.py:419-479): lr gets edge-pad (8,0) then resize."""

    def __init__(self, lr_dir: str, **kwargs):
        super().__init__(**kwargs)
        self.lr_root = Path(lr_dir)

    def _lr(self, img: Image.Image) -> np.ndarray:

        img = pad_image(img, (8, 0), mode="edge")
        rgb = resize_bilinear(img, self.latent_hw)
        return (rgb * 2.0 - 1.0).astype(np.float32)

    def __getitem__(self, index):
        try:
            row = self.rows[index]
            source = self.map[row["from"]]
            fname = get_name(row["from"], row["to"])
            lr = self._lr(open_rgb(str(self.lr_root / fname) + ".jpg"))
            return {
                "fname": fname,
                "lr": lr,
                "person_mask": lr,
                "image": self._prep_image(open_rgb(self.image_root / source["image"])),
                "styles": self._load_styles(source.get("styles") or "", False),
                "txt": self.texts.get(source["text"], ""),
            }
        except Exception:
            return self._skip(index)


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack numpy sample dicts into a batch dict; strings become lists."""
    out: Dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class DataLoader:
    """Minimal shuffling batch loader over an indexable dataset.

    Replaces torch DataLoader + worker seeding (main.py:157-250) with a
    deterministic numpy permutation per epoch. Prefetch/multiprocessing can
    be layered on later; DeepFashion decode cost is modest next to a
    train step.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, batch_transform=None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # host-side post-processing (e.g. conditioning encode + transport
        # pack) applied to each collated batch INSIDE the producer, so it
        # overlaps the device step instead of serializing the train loop
        self.batch_transform = batch_transform
        # multi-host sharding (DistributedSampler equivalent): every host
        # computes the SAME per-epoch permutation and global batch split,
        # then loads only its disjoint slice of each global batch.
        # batch_size stays the GLOBAL batch size; each host yields
        # batch_size // process_count items per step.
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{process_count} processes")
        self.process_index = process_index
        self.process_count = process_count

    def _finalize(self, batch: Dict) -> Dict:
        return self.batch_transform(batch) if self.batch_transform else batch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _permutation(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        return idx

    def _set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _batch_indices(self, idx: np.ndarray, i: int) -> np.ndarray:
        """This host's slice of global batch `i` (whole batch single-host).

        A drop_last=False tail batch that does not divide process_count is
        wrap-padded with its own leading indices so every host yields the
        same count — torch DistributedSampler's padding semantics; no
        sample is silently dropped.
        """
        sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
        if self.process_count > 1:
            per = -(-len(sel) // self.process_count)  # ceil
            if per * self.process_count != len(sel):
                sel = np.resize(sel, per * self.process_count)  # wrap-pad
            sel = sel[self.process_index * per : (self.process_index + 1) * per]
        return sel

    def epoch(self, epoch: int = 0):
        self._set_epoch(epoch)
        idx = self._permutation(epoch)
        for i in range(len(self)):
            sel = self._batch_indices(idx, i)
            yield self._finalize(collate([self.dataset[int(j)] for j in sel]))


class PrefetchDataLoader(DataLoader):
    """Parallel-decode, prefetching loader: the worker-process DataLoader
    equivalent (reference main.py:208-250, num_workers = 2*bs).

    Items of a batch decode concurrently on a thread pool, a producer
    thread assembles collated batches, and a bounded queue keeps
    `prefetch_batches` ready ahead of the consumer — so host-side decode
    overlaps the device step instead of serializing with it. JPEG decode
    goes through the native C++ core (upgpt_torch/native) whose ctypes call
    releases the GIL for the whole decode, so the pool parallelizes across
    real cores; with the PIL fallback (no g++/libjpeg) decode holds the
    GIL and the pool degrades to roughly serial rate — select
    data.loader: "process" there. Determinism: identical per-epoch
    permutation (and therefore identical batches) to the sequential
    DataLoader.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, prefetch_batches: int = 2,
                 batch_transform=None, process_index: int = 0,
                 process_count: int = 1):
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed,
                         drop_last=drop_last, batch_transform=batch_transform,
                         process_index=process_index,
                         process_count=process_count)
        self.num_workers = num_workers or min(32, 2 * batch_size)
        self.prefetch_batches = max(1, prefetch_batches)

    def epoch(self, epoch: int = 0):
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._set_epoch(epoch)
        idx = self._permutation(epoch)
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        _END = object()

        def producer():
            try:
                with ThreadPoolExecutor(
                        self.num_workers,
                        thread_name_prefix=f"{PRODUCER_THREAD}-decode") as ex:
                    for i in range(n_batches):
                        if stop.is_set():
                            return
                        sel = self._batch_indices(idx, i)
                        futs = [ex.submit(self.dataset.__getitem__, int(j))
                                for j in sel]
                        q.put(self._finalize(collate([f.result() for f in futs])))
                q.put(_END)
            except BaseException as e:  # propagate decode errors to consumer
                q.put(e)

        t = threading.Thread(target=producer, name=PRODUCER_THREAD,
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:  # pragma: no cover
                    break


# ---- worker-process loader ----

_WORKER_DATASET = None


def _worker_init(ds_bytes: bytes) -> None:
    global _WORKER_DATASET
    import pickle as _pickle

    _WORKER_DATASET = _pickle.loads(ds_bytes)


def _worker_getitem(job):
    epoch, i = job
    if getattr(_WORKER_DATASET, "_epoch", None) != epoch and hasattr(
            _WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(epoch)
    return _WORKER_DATASET[int(i)]


class ProcessDataLoader(DataLoader):
    """True worker-PROCESS loader — the reference DataLoader's
    `num_workers = 2*bs` semantics (main.py:208-250), GIL-free.

    With PIL decode the thread-pool PrefetchDataLoader tops out near the
    serial decode rate (PIL/numpy hold the GIL through most of the
    DeepFashion item assembly: measured 274 ms/batch threaded vs 225
    serial at bs 12); the native C++ decode core (upgpt_torch/native) fixes
    that for JPEGs, but non-JPEG-heavy or CPU-starved setups may still
    prefer processes. Worker processes decode truly in parallel; the pool
    persists across epochs and receives the pickled dataset once per
    worker at startup. Batches are `prefetch_batches`-deep software
    pipelined via map_async, with the same deterministic per-epoch
    permutation (identical batch contents to DataLoader). Worker
    exceptions surface in the consumer at the offending batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, prefetch_batches: int = 2,
                 batch_transform=None, process_index: int = 0,
                 process_count: int = 1):
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed,
                         drop_last=drop_last, batch_transform=batch_transform,
                         process_index=process_index,
                         process_count=process_count)
        self.num_workers = num_workers or min(16, os.cpu_count() or 8)
        self.prefetch_batches = max(1, prefetch_batches)
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            import pickle as _pickle

            # spawn, not fork: the pool is created lazily from a process
            # whose CUDA and loader threads are already live, and forking a
            # multithreaded runtime deadlocks (os.fork warns exactly this).
            # Spawn startup cost (~4 s/worker, sitecustomize imports) is
            # paid once; the pool persists across epochs.
            import sys

            main = sys.modules.get("__main__")
            main_file = getattr(main, "__file__", None)
            if main_file in ("<stdin>", "<string>") or (
                    main_file and not os.path.exists(main_file)):
                # spawn re-imports __main__ in each worker; an un-importable
                # main (heredoc/-c) makes the pool respawn-loop forever
                raise RuntimeError(
                    "ProcessDataLoader requires an importable __main__ "
                    f"(got {main_file!r}); run from a script/module or use "
                    "PrefetchDataLoader")
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                self.num_workers, initializer=_worker_init,
                initargs=(_pickle.dumps(self.dataset),),
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def epoch(self, epoch: int = 0):
        import queue
        import threading
        from collections import deque

        pool = self._ensure_pool()
        idx = self._permutation(epoch)
        n = len(self)
        chunk = max(1, self.batch_size // self.num_workers)
        # collate + batch_transform run in a producer THREAD feeding a
        # bounded queue, so they overlap the consumer's device step just
        # like PrefetchDataLoader's
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        _END = object()

        def submit(pending, i: int) -> None:
            sel = [(epoch, int(j)) for j in self._batch_indices(idx, i)]
            pending.append(
                pool.map_async(_worker_getitem, sel, chunksize=chunk))

        def producer():
            pending: "deque" = deque()
            try:
                for i in range(min(self.prefetch_batches, n)):
                    submit(pending, i)
                for i in range(n):
                    if stop.is_set():
                        return
                    items = pending.popleft().get()
                    nxt = i + self.prefetch_batches
                    if nxt < n:
                        submit(pending, nxt)
                    q.put(self._finalize(collate(items)))
                q.put(_END)
            except BaseException as e:  # surface worker errors in consumer
                q.put(e)

        t = threading.Thread(target=producer, name=PRODUCER_THREAD,
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:  # pragma: no cover
                    break
