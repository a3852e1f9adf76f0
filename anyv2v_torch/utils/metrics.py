"""Reconstruction metrics on videos in [0, 1] (the port's own copy of the
parts of ``anyv2v_tpu/utils/metrics.py`` its CLIs report): PSNR, windowed
SSIM, the temporal consistency of consecutive frames, and the Frechet
distance between two Gaussians."""

from __future__ import annotations

from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win: int = 7) -> float:
    """Mean SSIM over [H, W, C] (or [F, H, W, C], averaged) images in [0,1].
    Uniform window (the standard Gaussian-window variant differs by <1e-2 on
    natural images; uniform keeps this dependency-free)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 4:
        return float(np.mean([ssim(x, y, data_range, win) for x, y in zip(a, b)]))

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        # separable uniform filter with edge-crop (valid region only)
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda v: np.convolve(v, k, mode="valid"), 0, x)
        x = np.apply_along_axis(lambda v: np.convolve(v, k, mode="valid"), 1, x)
        return x

    mu_a, mu_b = box(a), box(b)
    sa = box(a * a) - mu_a**2
    sb = box(b * b) - mu_b**2
    sab = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (sa + sb + c2))
    return float(s.mean())


def temporal_consistency(video: np.ndarray, data_range: float = 1.0
                         ) -> Dict[str, float]:
    """Mean PSNR/SSIM between consecutive frames of [F, H, W, C]."""
    video = np.asarray(video)
    pairs = zip(video[:-1], video[1:])
    ps, ss = [], []
    for x, y in pairs:
        ps.append(psnr(x, y, data_range))
        ss.append(ssim(x, y, data_range))
    return {"psnr_t": float(np.mean(ps)), "ssim_t": float(np.mean(ss))}


def video_report(recon: np.ndarray, source: np.ndarray) -> Dict[str, float]:
    """The standard reconstruction report: frame-wise fidelity vs the source
    plus temporal consistency of the reconstruction."""
    out = {
        "psnr": psnr(recon, source),
        "ssim": ssim(recon, source),
    }
    out.update(temporal_consistency(recon))
    return out


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Frechet distance between two Gaussians (the FID formula; the features
    are the caller's: the reference's ``util.py:101-135`` used a downloaded
    InceptionV3)."""
    from scipy import linalg

    diff = np.asarray(mu1) - np.asarray(mu2)
    covmean = linalg.sqrtm(np.asarray(sigma1) @ np.asarray(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
