"""LPIPS (VGG16) on NHWC tensors: the perceptual metric of
scripts/eval_metrics.py and of the first stage's training loss
(contperceptual.py:7-110, taming's LPIPS).

Port of `upgpt_tpu.eval.lpips`: images in [-1, 1], the published shift and
scale, VGG16's conv stack tapped at relu1_2, relu2_2, relu3_3, relu4_3 and
relu5_3, each tap unit-normalised over its channels, the squared
difference through a bias-free 1x1 `lin` head, the spatial mean, the sum
over the five taps. Float32, TF32 off (`metrics.float32_exact`).

The published weights (torchvision's VGG16 and the lpips heads) are not in
the repository: `load_lpips_fn` reads a `lpips.LPIPS(net='vgg')` state
dict (`convert_lpips_weights`), `rehearsal_lpips_fn` seeds random ones.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from upgpt_torch.eval.metrics import float32_exact
from upgpt_torch.models.layers import Conv2d

# published LPIPS input scaling constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (out_channels, pool_before)
_VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAPS = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# the lpips package's VGG slices: torchvision feature indices per slice
_SLICES = (("net.slice1", (0, 2)), ("net.slice2", (5, 7)),
           ("net.slice3", (10, 12, 14)), ("net.slice4", (17, 19, 21)),
           ("net.slice5", (24, 26, 28)))


class VGG16Features(nn.Module):
    """VGG16's conv stack (`conv_0` .. `conv_12`); returns the five taps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, _) in enumerate(_VGG16_PLAN):
            self.add_module(f"conv_{i}", Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, (_, pool) in enumerate(_VGG16_PLAN):
            if pool:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            x = torch.relu(getattr(self, f"conv_{i}")(x))
            if i in _TAPS:
                feats.append(x)
        return feats


class LPIPS(nn.Module):
    """lpips(a, b) of NHWC images in [-1, 1]: (B,) distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, ch in enumerate(LPIPS_CHANNELS):
            self.add_module(f"lin_{i}", Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dev = self.shift.device
        with float32_exact():
            fa = self.vgg((a.to(dev).float() - self.shift) / self.scale)
            fb = self.vgg((b.to(dev).float() - self.shift) / self.scale)
            total = 0.0
            for i, (xa, xb) in enumerate(zip(fa, fb)):
                na = xa * torch.rsqrt(xa.square().sum(-1, keepdim=True)
                                      + 1e-10)
                nb = xb * torch.rsqrt(xb.square().sum(-1, keepdim=True)
                                      + 1e-10)
                w = getattr(self, f"lin_{i}")((na - nb).square())
                total = total + w.mean(dim=(1, 2, 3))
        return total


def convert_lpips_weights(
        sd: Mapping[str, Union[np.ndarray, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """A `lpips.LPIPS(net='vgg')` state dict (`net.sliceK.<idx>.weight/
    bias`, `linK.model.1.weight`) -> the state dict of `LPIPS`."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    for prefix, idxs in _SLICES:
        for idx in idxs:
            for leaf in ("weight", "bias"):
                out[f"vgg.conv_{i}.{leaf}"] = torch.as_tensor(
                    np.asarray(sd[f"{prefix}.{idx}.{leaf}"], np.float32))
            i += 1
    for k in range(len(LPIPS_CHANNELS)):
        out[f"lin_{k}.weight"] = torch.as_tensor(
            np.asarray(sd[f"lin{k}.model.1.weight"], np.float32))
    return out


def _lpips_on(state: Dict[str, torch.Tensor], device) -> LPIPS:
    mod = LPIPS()
    mod.load_state_dict(state, strict=True)
    return mod.to(device).eval().requires_grad_(False)


def load_lpips_fn(path: str, device: Union[str, torch.device] = "cuda"
                  ) -> LPIPS:
    """A weights file (a torch `lpips.LPIPS(net='vgg')` state dict, or an
    .npz of the same keys) -> `LPIPS` on `device`, callable as
    `(a, b) -> (B,)` (`evaluate_dirs(lpips_fn=...)`)."""
    if str(path).endswith(".npz"):
        sd = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v.numpy() for k, v in sd.get("state_dict", sd).items()}
    return _lpips_on(convert_lpips_weights(sd), device)


def rehearsal_lpips_fn(seed: int = 0,
                       device: Union[str, torch.device] = "cuda") -> LPIPS:
    """LPIPS with seeded random weights, for runs without the published
    ones (JAX's `rehearsal_lpips_fn`): the same code path, each conv
    kernel normal with std 1/sqrt(fan_in) from a CPU generator, biases
    zero, the lin heads' absolute values (the published heads are
    non-negative), so the distance is zero on identical inputs and never
    negative. Its numbers are not the published LPIPS: label them
    `lpips_rehearsal`. The draws are not JAX's (another generator), so the
    two rehearsals differ; weights loaded through the bridge agree."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in LPIPS().state_dict().items():
        if name.endswith("bias"):
            state[name] = torch.zeros_like(p)
            continue
        fan_in = p[0].numel()
        w = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
        state[name] = w.abs() if name.startswith("lin_") else w
    return _lpips_on(state, device)
