"""PSNR / SSIM of the challenge's scoring code (counterpart of
``ntire2022_esr_tpu/utils/metrics.py``).

PSNR on [0, 255] float64 with a border crop; SSIM with the 11x11,
sigma 1.5 Gaussian window and the 5-pixel valid crop. The window is the
outer product of one normalised 11-tap Gaussian, so each filter is two 1-D
correlations (``scipy.ndimage.correlate1d``) per channel. The JAX
module's 2-D filter (OpenCV) sums in another order and its window differs
in the last bit, so the two agree to about 1e-12, not bit for bit. The
crop drops every pixel the border mode reaches.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def calculate_psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border : h - border, border : w - border]
    img2 = img2[border : h - border, border : w - border]
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def gaussian_kernel(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1-D Gaussian (OpenCV's ``getGaussianKernel``, whose
    own exp differs from numpy's in the last bit)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def _filter(img: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Correlate H and W (each channel on its own) with ``outer(g, g)``,
    then drop the 5-pixel border."""
    out = ndimage.correlate1d(img, g, axis=0, mode="reflect")
    out = ndimage.correlate1d(out, g, axis=1, mode="reflect")
    return out[5:-5, 5:-5]


def _ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    g = gaussian_kernel(11, 1.5)

    mu1 = _filter(img1, g)
    mu2 = _filter(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter(img1**2, g) - mu1_sq
    sigma2_sq = _filter(img2**2, g) - mu2_sq
    sigma12 = _filter(img1 * img2, g) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """MATLAB-style SSIM on [0, 255] images, border-cropped. An RGB image
    is scored as one HWC evaluation, which equals the reference's mean of
    three identical ones."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border : h - border, border : w - border]
    img2 = img2[border : h - border, border : w - border]
    if img1.ndim == 2:
        return _ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return _ssim(img1, img2)
        if img1.shape[2] == 1:
            return _ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")
