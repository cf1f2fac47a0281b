"""SSIM on mel-spectrogram images (the port's copy of
``tacotron2_subword_tpu/ops/ssim.py``; reference ssim.py:39-73).

The five windowed means are depthwise ``F.conv2d`` (one group per channel,
zero padding ``window_size // 2``) in f32.  The JAX package computes them
with ``lax.conv_general_dilated`` outside any Pallas kernel, so this is no
kernel port: the convolutions are cuDNN's on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """[W, W] outer product of a normalised 1-D Gaussian, f32."""
    x = np.arange(window_size)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _window_on(window_size: int, sigma: float, channels: int,
               device: torch.device) -> torch.Tensor:
    """The window as a depthwise conv weight [C, 1, W, W] on ``device``,
    made once per (size, sigma, channels, device)."""
    w = torch.from_numpy(_gaussian_window(window_size, sigma))
    with torch.inference_mode(False):   # usable by autograd, as ops/stft's
        return w.expand(channels, 1, window_size,
                        window_size).contiguous().to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """img1/img2: [B, C, H, W] f32 -> the mean SSIM (scalar), or per sample
    [B] when ``size_average`` is false."""
    C = img1.shape[1]
    w = _window_on(window_size, float(sigma), C, img1.device)
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x, w, padding=pad, groups=C)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu12

    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu12 + C1) * (2 * sigma12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
