"""Image metrics (port of nerf_simple_tpu/train/metrics.py).

The reference's PSNR takes ``max(gt)`` as its peak (train.py:25);
``peak=1.0`` gives the standard metric. SSIM is Wang et al. 2004: an
11x11 Gaussian window with sigma 1.5, K1=0.01, K2=0.03, VALID padding,
channels averaged. Everything is computed in float64 (on the CPU for
numpy inputs, on the tensor's device otherwise), so no TF32 convolution
enters the numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _t(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.float64)


def img_mse(gt, pred) -> float:
    return float(torch.mean((_t(pred) - _t(gt)) ** 2))


def img_psnr(gt, pred, peak: float | None = None) -> float:
    """PSNR with the reference's peak = max(gt) unless ``peak`` is given."""
    p = float(_t(gt).max()) if peak is None else peak
    return float(20.0 * torch.log10(torch.tensor(p)) - 10.0 * torch.log10(torch.tensor(img_mse(gt, pred))))


def _gauss_filter(x: torch.Tensor, win: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian filter over the last two dims of (B, H, W)."""
    r = torch.arange(win, dtype=x.dtype, device=x.device) - (win - 1) / 2.0
    w = torch.exp(-(r**2) / (2.0 * sigma**2))
    w = w / w.sum()
    x = F.conv2d(x[:, None], w.reshape(1, 1, win, 1))
    return F.conv2d(x, w.reshape(1, 1, 1, win))[:, 0]


def img_ssim(gt, pred, peak: float = 1.0, win: int = 11, sigma: float = 1.5) -> float:
    """Mean SSIM of (H, W), (H, W, C) or (N, H, W, C) images."""
    gt, pred = _t(gt), _t(pred).to(_t(gt).device)
    if gt.dim() == 2:
        gt, pred = gt[..., None], pred[..., None]
    if gt.dim() == 3:
        gt, pred = gt[None], pred[None]
    n, h, w, c = gt.shape
    x = gt.permute(0, 3, 1, 2).reshape(n * c, h, w)
    y = pred.permute(0, 3, 1, 2).reshape(n * c, h, w)
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    mu_x, mu_y = _gauss_filter(x, win, sigma), _gauss_filter(y, win, sigma)
    var_x = _gauss_filter(x * x, win, sigma) - mu_x**2
    var_y = _gauss_filter(y * y, win, sigma) - mu_y**2
    cov = _gauss_filter(x * y, win, sigma) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * cov + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
    return float(torch.mean(num / den))
