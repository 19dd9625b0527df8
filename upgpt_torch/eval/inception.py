"""InceptionV3 pool3 features: the FID protocol's network, on NHWC
tensors.

Port of `upgpt_tpu.eval.inception`. The reference computes FID with
`python -m pytorch_fid` (scripts/eval_metrics.py:100-112), whose network
is the TF-ported pt_inception-2015-12-05 InceptionV3: torchvision's graph
with pytorch_fid's patches (pytorch_fid/inception.py):

- the InceptionA/C/E pool branches average with count_include_pad=False;
- the second InceptionE block (Mixed_7c) max-pools in its pool branch;
- a 1008-way classifier, unused: FID reads the 2048-d global average.

Inference only, float32 with TF32 off (`metrics.float32_exact`), each
BasicConv2d's BatchNorm (eps 1e-3) folded into a per-channel scale and
bias (`bn_scale`, `bn_bias`, JAX's names). `convert_inception_state_dict`
reads the pt_inception state dict's layout; the weights themselves are
not in the repository. `preprocess_fid` is pytorch_fid's input transform:
[0, 1] pixels, a bilinear resize to 299x299 (align_corners False, no
antialiasing, downscaling too), then [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from upgpt_torch.eval.metrics import float32_exact
from upgpt_torch.models.layers import Conv2d

FID_FEATURE_DIM = 2048
FID_NUM_CLASSES = 1008  # the TF-ported weights' head; unused by pool3
_BN_EPS = 1e-3


def _pooled(x: torch.Tensor, pool, *args, **kw) -> torch.Tensor:
    return pool(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def avg_pool_3x3_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1, over the real elements of each
    window (count_include_pad=False), NHWC."""
    return _pooled(x, F.avg_pool2d, 3, 1, 1, count_include_pad=False)


def max_pool(x: torch.Tensor, window: int, stride: int,
             pad: int = 0) -> torch.Tensor:
    return _pooled(x, F.max_pool2d, window, stride, pad)


class BasicConv2d(nn.Module):
    """Conv (no bias) + folded BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x) * self.bn_scale + self.bn_bias)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_nopad_count(x))
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_nopad_count(x))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=-1)


class InceptionE(nn.Module):
    """Mixed_7b averages in its pool branch (count_include_pad=False),
    Mixed_7c max-pools (pytorch_fid's FIDInceptionE_2)."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        if pool_mode not in ("avg", "max"):
            raise ValueError(f"pool_mode {pool_mode!r}: expected avg or max")
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], -1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       -1)
        bp = (max_pool(x, 3, 1, 1) if self.pool_mode == "max"
              else avg_pool_3x3_nopad_count(x))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=-1)


class InceptionV3Features(nn.Module):
    """The FID InceptionV3's pool3 trunk: NHWC 299x299 in [-1, 1] ->
    (N, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2))


def resize299(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> (N, 299, 299, C), bilinear, align_corners False, no
    antialiasing (pytorch_fid's F.interpolate)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                         mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)


def preprocess_fid(images: torch.Tensor) -> torch.Tensor:
    """pytorch_fid's input transform: [0, 1] NHWC of any size -> 299x299
    in [-1, 1]. No crop."""
    return resize299(torch.as_tensor(images).float()) * 2.0 - 1.0


def _fold_bn(sd: Mapping, prefix: str):
    gamma, beta, mean, var = (
        np.asarray(sd[f"{prefix}.bn.{k}"], np.float32)
        for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + _BN_EPS)
    return scale, beta - mean * scale


def _np(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def convert_inception_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A pt_inception (pytorch_fid) state dict, torchvision's names, ->
    the state dict of `InceptionV3Features`: each BasicConv2d's kernel as
    it is, its BatchNorm's running statistics folded into `bn_scale` and
    `bn_bias`; the 1008-way `fc` is dropped. Strict: a missing key or a
    shape that disagrees raises."""
    sd = {k: _np(v) for k, v in sd.items()}
    target = InceptionV3Features().state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key in target:
        if not key.endswith(".conv.weight"):
            continue
        prefix = key[:-len(".conv.weight")]
        scale, bias = _fold_bn(sd, prefix)
        for k, v in ((key, np.asarray(sd[key], np.float32)),
                     (f"{prefix}.bn_scale", scale),
                     (f"{prefix}.bn_bias", bias)):
            if tuple(v.shape) != tuple(target[k].shape):
                raise ValueError(f"{k}: shape {v.shape}, the network has "
                                 f"{tuple(target[k].shape)}")
            out[k] = torch.from_numpy(np.ascontiguousarray(v))
    missing = sorted(set(target) - set(out))
    if missing:
        raise ValueError(f"unconverted Inception keys {missing[:8]}")
    return out


def load_pt_inception(path: str) -> Dict[str, torch.Tensor]:
    """The pt_inception-2015-12-05 .pth (a torch state dict) ->
    `InceptionV3Features`'s state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_inception_state_dict(sd.get("state_dict", sd))


class InceptionFeatureFn:
    """`(N, H, W, C)` in [-1, 1] -> (N, 2048) float32 pool3 features on
    `device`, for `harness.evaluate_dirs` (its images arrive as x*2-1 of
    [0, 1] pixels, pytorch_fid's normalize_input, so only the resize is
    applied here). `fid_name` keys the metric as `fid_inception`."""

    fid_name = "inception"

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 device: Union[str, torch.device] = "cuda"):
        self.model = InceptionV3Features()
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(device).eval().requires_grad_(False)
        self.device = torch.device(device)

    @torch.inference_mode()
    def __call__(self, images_pm1) -> torch.Tensor:
        x = torch.as_tensor(images_pm1).to(self.device).float()
        with float32_exact():
            return self.model(resize299(x))
