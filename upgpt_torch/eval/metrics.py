"""Quality metrics: SSIM, MS-SSIM and the Fréchet distance.

Port of `upgpt_tpu.eval.metrics`. The reference scores with pytorch_msssim
(SSIM, MS-SSIM), lpips (`eval/lpips.py`) and pytorch_fid
(`eval/inception.py`; scripts/eval_metrics.py:100-112):

- `ssim` / `ms_ssim` over NHWC images, float32, with pytorch_msssim's
  defaults: a gaussian window of 11 taps and sigma 1.5 as two grouped
  valid convolutions, K1 0.01, K2 0.03, `data_range` 1; five MS-SSIM
  scales with the standard weights and a 2x2 average pool between them,
  which pads an odd side by one.
- MS-SSIM keeps (level, batch, channel), takes the weighted product over
  the levels per channel and averages the channels after, as
  pytorch_msssim does. JAX's `ms_ssim` averages each level's terms over
  the channels first (ROADMAP R7), so the two differ on coloured images
  and agree on grey ones. Like pytorch_msssim, it needs a smaller side
  above 160 pixels (the window after four poolings); JAX returns NaN below
  that.
- `frechet_distance` / `fid_from_features`: float64 numpy with scipy's
  `sqrtm` on the host, pytorch_fid's calculation.

`float32_exact()` turns TF32 off for cuDNN convolutions and cuBLAS
products for the length of a metric call and restores the flags after:
cuDNN takes float32 convolutions in TF32 by default, which would move the
card's metrics away from the CPU's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_WIN, _SIGMA, _K1, _K2 = 11, 1.5, 0.01, 0.03


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _gaussian_kernel1d(device) -> torch.Tensor:
    coords = (torch.arange(_WIN, dtype=torch.float32, device=device)
              - (_WIN - 1) / 2.0)
    g = torch.exp(-(coords ** 2) / (2 * _SIGMA ** 2))
    return g / g.sum()


def _gaussian_blur(x: torch.Tensor) -> torch.Tensor:
    """Separable valid gaussian filter over NCHW, one channel at a time."""
    c = x.shape[1]
    g = _gaussian_kernel1d(x.device)
    x = F.conv2d(x, g.view(1, 1, _WIN, 1).expand(c, 1, _WIN, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, _WIN).expand(c, 1, 1, _WIN),
                    groups=c)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).float().permute(0, 3, 1, 2)


def _ssim_per_channel(a: torch.Tensor, b: torch.Tensor, data_range: float):
    """(ssim, cs) of NCHW images, each (B, C): the spatial means of the
    SSIM map and of its contrast-structure term."""
    c1 = (_K1 * data_range) ** 2
    c2 = (_K2 * data_range) ** 2
    mu_a, mu_b = _gaussian_blur(a), _gaussian_blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    va = _gaussian_blur(a * a) - mu_aa
    vb = _gaussian_blur(b * b) - mu_bb
    vab = _gaussian_blur(a * b) - mu_ab
    cs_map = (2 * vab + c2) / (va + vb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs_map
    return ssim_map.flatten(2).mean(-1), cs_map.flatten(2).mean(-1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of NHWC images: the batch mean, or (B,) per image."""
    with float32_exact():
        s, _ = _ssim_per_channel(_nchw(a), _nchw(b), data_range)
    per_image = s.mean(1)
    return per_image.mean() if size_average else per_image


def ms_ssim_fits(hw) -> bool:
    """Whether an image of `hw` has MS-SSIM's five scales."""
    return min(hw) > (_WIN - 1) * 2 ** (len(_MSSSIM_WEIGHTS) - 1)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
            size_average: bool = True) -> torch.Tensor:
    """Multi-scale SSIM of NHWC images (pytorch_msssim's): the batch mean,
    or (B,) per image. Raises ValueError where the smaller side is 160
    pixels or less."""
    x, y = _nchw(a), _nchw(b)
    if not ms_ssim_fits(x.shape[2:]):
        raise ValueError(f"ms_ssim: images of {tuple(x.shape[2:])} need a "
                         f"smaller side above 160 for five scales")
    w = torch.tensor(_MSSSIM_WEIGHTS, dtype=torch.float32, device=x.device)
    levels = len(_MSSSIM_WEIGHTS)
    mcs = []
    with float32_exact():
        for i in range(levels):
            s, cs = _ssim_per_channel(x, y, data_range)
            if i < levels - 1:
                mcs.append(torch.relu(cs))
                pad = [d % 2 for d in x.shape[2:]]
                x = F.avg_pool2d(x, 2, padding=pad)
                y = F.avg_pool2d(y, 2, padding=pad)
    vals = torch.stack(mcs + [torch.relu(s)])  # (levels, B, C)
    per_image = torch.prod(vals ** w.view(-1, 1, 1), dim=0).mean(1)
    return per_image.mean() if size_average else per_image


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """FID between two gaussians (pytorch_fid's calculation, host-side)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    """FID of two (N, D) activation sets (InceptionV3 pool3 for the
    protocol's number; any consistent embedding for relative
    comparisons), in float64."""
    feats1 = np.asarray(feats1, np.float64)
    feats2 = np.asarray(feats2, np.float64)
    mu1, s1 = feats1.mean(0), np.cov(feats1, rowvar=False)
    mu2, s2 = feats2.mean(0), np.cov(feats2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)
