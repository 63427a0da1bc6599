"""Host-side image preprocessing: Fourier downsample, crop, ring-normalize
(mirror of targetvae_tpu/data/image.py, numpy only).

Same behavior as reference src/image.py:5-60, vectorized (the reference
normalizes in a per-image Python loop).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def downsample(x: np.ndarray, factor: float = 1,
               shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Fourier-crop downsample of (..., H, W) to `shape` (or by `factor`).

    The output band is assembled by an explicit frequency lookup: for every
    output bin, gather the input half-spectrum bin carrying the same signed
    frequency, then inverse-transform at the target size. For even output
    sizes this matches the reference's band selection exactly (behavioral
    match point: src/image.py:5-28; parity asserted in
    tests/test_image_ops.py); for odd output sizes it keeps the full set of
    out_h distinct row frequencies (the reference drops one row and
    misaligns the rest). The pixel-count rescale keeps the mean intensity
    of the input.
    """
    in_h, in_w = x.shape[-2:]
    if shape is None:
        shape = (int(in_h / factor), int(in_w / factor))
    out_h, out_w = shape
    half = np.fft.rfft2(x)
    # Each output row/col frequency is looked up at the input bin holding the
    # same signed frequency: fftfreq enumerates the output bins in transform
    # order, and % maps negative frequencies onto the tail of the input axis.
    row_freqs = np.fft.fftfreq(out_h, d=1.0 / out_h).astype(np.int64)
    band = half[..., row_freqs % in_h, : out_w // 2 + 1]
    band = band * (out_h * out_w / (in_h * in_w))  # preserve mean intensity
    out = np.fft.irfft2(band, s=shape)
    return out.astype(x.dtype, copy=False)


def crop(stack: np.ndarray, size: int) -> np.ndarray:
    """Center crop the last two axes to (size, size)."""
    n, m = stack.shape[-2:]
    si = (n - size) // 2
    sj = (m - size) // 2
    return stack[..., si:si + size, sj:sj + size]


def normalize(stack: np.ndarray, radius: Optional[float] = None) -> np.ndarray:
    """Standardize each image using the outside-radius background ring."""
    n, m = stack.shape[-2:]
    if radius is None:
        radius = min(n, m) / 2
    center = np.array([n / 2, m / 2])
    yc, xc = np.ogrid[:n, :m]
    dist = np.sqrt((center[0] - yc) ** 2 + (center[1] - xc) ** 2)
    ring = dist >= radius
    flat = stack.reshape(-1, n * m)
    sel = flat[:, ring.ravel()]
    mu = sel.mean(axis=1, keepdims=True)
    std = sel.std(axis=1, keepdims=True)
    out = (flat - mu) / std
    return out.reshape(stack.shape)
