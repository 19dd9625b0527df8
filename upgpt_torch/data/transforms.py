"""Host-side image transforms (numpy/PIL), matching the reference's
torchvision pipelines bit-for-purpose (ldm/data/deepfashion_inshop.py:114-156).

The port's copy of `upgpt_tpu.data.transforms`. All outputs are HWC float32
numpy (the NHWC layout the port's models take):
- `to_tensor_range`: PIL -> [-1, 1] HWC (T.ToTensor + x*2-1 + rearrange).
- `clip_normalize_image`: PIL 224x224 -> CLIP-normalized HWC
  (T.ToTensor + T.Normalize with the CLIP mean/std).
- `empty_style`: CLIP-normalized all-zeros image — the zero-slot semantics
  (deepfashion_inshop.py:213-214: clip_norm(torch.zeros(3,224,224))).
- mask transforms for the three RPM modes, INCLUDING the bbox /255
  backward-compat bug (deepfashion_inshop.py:232-239): the 0/1 bbox is fed
  through ToTensor's /255, so in-box becomes 1/255*2-1 = -0.99215686.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def open_rgb(path) -> Image.Image:
    """Open an image file for the pipeline; JPEGs go through the native
    GIL-free decoder when it is available (upgpt_torch.native, bit-exact
    with PIL — same libjpeg), anything else (or any decode hiccup) falls
    back to PIL. Thread-pool loaders parallelize for real through this
    path because the foreign decode call releases the GIL."""
    from PIL import Image

    p = str(path)
    if p.lower().endswith((".jpg", ".jpeg")):
        from upgpt_torch import native
        if native.available():
            arr = native.decode_jpeg_file(p)
            if arr is not None:
                return Image.fromarray(arr)
    return Image.open(path)


def to_float01(img: Image.Image) -> np.ndarray:
    """PIL -> HWC float32 in [0, 1] (torchvision ToTensor semantics)."""
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr


def to_tensor_range(img: Image.Image) -> np.ndarray:
    """PIL -> HWC float32 in [-1, 1]."""
    return to_float01(img) * 2.0 - 1.0


def clip_normalize_image(img: Image.Image) -> np.ndarray:
    return (to_float01(img) - CLIP_MEAN) / CLIP_STD


def to_uint8(img: Image.Image) -> np.ndarray:
    """PIL -> HWC uint8: the compact-pipeline transport form. Exact:
    uint8 v round-trips to the same v/255-derived floats the f32 pipeline
    produces, whether the consumer applies [-1,1] or CLIP normalization."""
    return np.asarray(img.convert("RGB"), np.uint8)


def empty_style() -> np.ndarray:
    """CLIP-normalized zeros: the embedding-space 'no style' slot."""
    return np.broadcast_to((-CLIP_MEAN / CLIP_STD), (224, 224, 3)).astype(np.float32).copy()


def resize_nearest(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """NEAREST resize of an HW or HWC float array to (h, w)."""
    from PIL import Image

    img = Image.fromarray(arr.squeeze() if arr.ndim == 3 and arr.shape[-1] == 1 else arr)
    out = np.asarray(img.resize((hw[1], hw[0]), Image.NEAREST), np.float32)
    return out


def resize_bilinear(img: Image.Image, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        img.resize((hw[1], hw[0]), Image.BILINEAR).convert("RGB"), np.float32
    ) / 255.0


def center_crop(img: Image.Image, hw: Tuple[int, int]) -> Image.Image:
    w, h = img.size
    th, tw = hw
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def silhouette_bbox(mask: np.ndarray) -> np.ndarray:
    """0/1 uint8 bbox of the nonzero region (deepfashion_inshop.py:164-171)."""
    x = np.nonzero(np.mean(mask, 1))[0]
    y = np.nonzero(np.mean(mask, 0))[0]
    bbox = np.zeros_like(mask, np.uint8)
    bbox[x[0] : x[-1] + 1, y[0] : y[-1] + 1] = 1
    return bbox


def mask_transform_binary(mask01: np.ndarray, latent_hw: Tuple[int, int]) -> np.ndarray:
    """'mask'/'bbox' RPM: NEAREST resize to latent res, /255 (ToTensor on a
    uint8 array), then *2-1. Feeding a 0/1 bbox through reproduces the
    deliberate -0.99215686 in-box value. Returns (h, w, 1)."""
    resized = resize_nearest(mask01.astype(np.uint8), latent_hw)
    return (resized.astype(np.float32) / 255.0 * 2.0 - 1.0)[..., None]


def mask_transform_smpl(smpl_img: Image.Image, latent_hw: Tuple[int, int]) -> np.ndarray:
    """'smpl' RPM: BILINEAR resize, channel mean, *2-1 -> (h, w, 1)
    (deepfashion_inshop.py:147-152)."""
    rgb = resize_bilinear(smpl_img, latent_hw)
    return (np.mean(rgb, axis=-1, keepdims=True) * 2.0 - 1.0).astype(np.float32)


def pad_image(img: Image.Image, pad: Tuple[int, ...], mode: str = "constant") -> Image.Image:
    """torchvision T.Pad semantics: (lr, tb) or (l, t, r, b)."""
    from PIL import Image

    arr = np.asarray(img)
    if len(pad) == 2:
        l = r = pad[0]
        t = b = pad[1]
    else:
        l, t, r, b = pad
    pads = ((t, b), (l, r)) + (((0, 0),) if arr.ndim == 3 else ())
    np_mode = {"constant": "constant", "edge": "edge"}[mode]
    return Image.fromarray(np.pad(arr, pads, mode=np_mode))


def resize_short_side(img: Image.Image, size: int) -> Image.Image:
    """torchvision T.Resize(int): short side to `size`, keep aspect."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = size, int(round(size * h / w))
    else:
        nh, nw = size, int(round(size * w / h))
    return img.resize((nw, nh), Image.BILINEAR)
