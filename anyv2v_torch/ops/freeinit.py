"""FreeInit spectral noise re-initialisation (ConsistI2V ``use_frameinit``;
counterpart of ``anyv2v_tpu/ops/freeinit.py``).

Reference: ``consisti2v/consisti2v/utils/frameinit_utils.py``:
``freq_mix_3d`` (:7-32) blends the low frequencies of a diffused ground-truth
latent with the high frequencies of fresh noise through a 3-D FFT over
(F, H, W); the low-pass filters are at :35-141.

The layout is channels-last video ``[B, F, H, W, C]``; the FFT axes are
(1, 2, 3). The transform is ``torch.fft``: the JAX package computes it with
``jnp.fft`` and no Pallas kernel, so no hand-written kernel stands behind it.
The low-pass filters are numpy, copied from the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_AXES = (1, 2, 3)


def freq_mix_3d(x: torch.Tensor, noise: torch.Tensor,
                low_pass_filter: torch.Tensor) -> torch.Tensor:
    """low-frequency(x) + high-frequency(noise), FFT over (F, H, W) in fp32.

    ``low_pass_filter``: ``[F, H, W]`` in [0, 1], broadcast over batch and
    channels. Returns ``x``'s dtype."""
    lpf = torch.as_tensor(low_pass_filter, dtype=torch.float32,
                          device=x.device)[None, :, :, :, None]
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=_AXES), dim=_AXES)
    noise_freq = torch.fft.fftshift(torch.fft.fftn(noise.float(), dim=_AXES), dim=_AXES)
    mixed = x_freq * lpf + noise_freq * (1.0 - lpf)
    mixed = torch.fft.ifftn(torch.fft.ifftshift(mixed, dim=_AXES), dim=_AXES).real
    return mixed.to(x.dtype)


def _normalized_grid(shape):
    """Coordinates in [-1, 1] per axis for a centred (fftshifted) spectrum."""
    f, h, w = shape
    fs = (np.arange(f) * 2.0 / f - 1.0) if f > 1 else np.zeros(1)
    hs = np.arange(h) * 2.0 / h - 1.0
    ws = np.arange(w) * 2.0 / w - 1.0
    return np.meshgrid(fs, hs, ws, indexing="ij")


def gaussian_low_pass_filter(shape, d_s: float = 0.25, d_t: float = 0.25) -> np.ndarray:
    """Reference ``gaussian_low_pass_filter`` (frameinit_utils.py:35-62)."""
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, dtype=np.float32)
    gf, gh, gw = _normalized_grid(shape)
    d_square = ((gf / d_t) ** 2 + (gh / d_s) ** 2 + (gw / d_s) ** 2)
    return np.exp(-0.5 * d_square).astype(np.float32)


def ideal_low_pass_filter(shape, d_s: float = 0.25, d_t: float = 0.25) -> np.ndarray:
    gf, gh, gw = _normalized_grid(shape)
    d_square = ((gf / d_t) ** 2 + (gh / d_s) ** 2 + (gw / d_s) ** 2)
    return (d_square <= 1.0).astype(np.float32)


def butterworth_low_pass_filter(shape, n: int = 4, d_s: float = 0.25,
                                d_t: float = 0.25) -> np.ndarray:
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, dtype=np.float32)
    gf, gh, gw = _normalized_grid(shape)
    d_square = ((gf / d_t) ** 2 + (gh / d_s) ** 2 + (gw / d_s) ** 2)
    return (1.0 / (1.0 + d_square**n)).astype(np.float32)


def box_low_pass_filter(shape, d_s: float = 0.25, d_t: float = 0.25) -> np.ndarray:
    f, h, w = shape
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, dtype=np.float32)
    filt = np.zeros(shape, dtype=np.float32)
    cf, ch, cw = f // 2, h // 2, w // 2
    tf, th, tw = (
        max(1, math.ceil(f * d_t / 2)),
        max(1, math.ceil(h * d_s / 2)),
        max(1, math.ceil(w * d_s / 2)),
    )
    filt[max(0, cf - tf):cf + tf, max(0, ch - th):ch + th, max(0, cw - tw):cw + tw] = 1.0
    return filt


FILTERS = {
    "gaussian": gaussian_low_pass_filter,
    "ideal": ideal_low_pass_filter,
    "box": box_low_pass_filter,
    "butterworth": butterworth_low_pass_filter,
}
