"""Image-quality metrics: SSIM and PSNR (numpy, float64).

Counterpart of ``diffute_tpu/eval/quality.py``, the same arithmetic: they
score edit fidelity (``eval/run.py``) and the acceptance bar of SSIM >= 0.99
against a reference stack's edit (``eval/acceptance.py``).  SSIM follows
Wang et al. 2004 with the 11x11 Gaussian window (sigma 1.5), skimage's
``structural_similarity(..., gaussian_weights=True,
use_sample_covariance=False)`` configuration.
"""

from __future__ import annotations

import numpy as np


def _filter2d_nearest(x: np.ndarray, g1d: np.ndarray) -> np.ndarray:
    """Separable 2D correlation with 'nearest' (edge-replicate) boundaries —
    numpy only, as scipy.ndimage's gaussian_filter(mode='nearest')."""
    k = len(g1d)
    pad = k // 2
    xp = np.pad(x, pad, mode="edge")
    # rows
    out = np.zeros_like(x, dtype=np.float64)
    for i in range(k):
        out += g1d[i] * xp[pad : pad + x.shape[0], i : i + x.shape[1]]
    xp = np.pad(out, ((pad, pad), (0, 0)), mode="edge")
    out2 = np.zeros_like(out)
    for i in range(k):
        out2 += g1d[i] * xp[i : i + x.shape[0], :]
    return out2


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM over channels (HWC or HW uint8/float arrays).

    Matches skimage's configuration: 'nearest' boundary handling (its
    gaussian_filter default) and the (win_size-1)//2 border crop before
    averaging — edge pixels see padded neighborhoods and are excluded.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    g = _gaussian_1d()
    pad = len(g) // 2
    if min(a.shape[0], a.shape[1]) <= 2 * pad:
        raise ValueError(
            f"image {a.shape[:2]} smaller than the 11x11 SSIM window")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = _filter2d_nearest(x, g)
        mu_y = _filter2d_nearest(y, g)
        mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
        sig_x = _filter2d_nearest(x * x, g) - mu_x2
        sig_y = _filter2d_nearest(y * y, g) - mu_y2
        sig_xy = _filter2d_nearest(x * y, g) - mu_xy
        num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
        den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
        s = num / den
        vals.append(np.mean(s[pad:-pad, pad:-pad]))
    return float(np.mean(vals))
