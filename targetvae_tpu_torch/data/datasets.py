"""Dataset loading for the training CLIs (mirror of
targetvae_tpu/data/datasets.py, the MNIST loaders), numpy only.

Same default paths as the reference loaders (train_mnist.py:440-470),
returning channels-last (N, H, W, C) float32 arrays in [0, 1]. Nothing is
downloaded: plain MNIST is read from `mnist_{split}.npy` under the data
root.
"""

from __future__ import annotations

import os

import numpy as np


def _to_nhwc(arr: np.ndarray, in_channels: int = 1) -> np.ndarray:
    if arr.ndim == 3:
        arr = arr[..., None]
    if arr.ndim == 4 and arr.shape[-1] != in_channels and arr.shape[1] == in_channels:
        arr = np.transpose(arr, (0, 2, 3, 1))
    return np.ascontiguousarray(arr, dtype=np.float32)


def load_mnist(dataset: str, image_dim: int, data_root: str = "data",
               split: str = "train") -> np.ndarray:
    """mnist | mnist-U | mnist-N -> (N, image_dim, image_dim, 1) in [0, 1]."""
    if dataset == "mnist":
        arr = _load_plain_mnist(image_dim, data_root, split)
    elif dataset in ("mnist-U", "mnist-N"):
        sub = "mnist_U" if dataset == "mnist-U" else "mnist_N"
        arr = np.load(os.path.join(data_root, sub, f"images_{split}.npy"))
    else:
        raise ValueError(f"unknown mnist variant: {dataset}")
    return _to_nhwc(arr.astype(np.float32) / 255.0)


def _load_plain_mnist(image_dim: int, data_root: str, split: str) -> np.ndarray:
    """Plain MNIST centred on an image_dim canvas, from `mnist_{split}.npy`."""
    npy = os.path.join(data_root, f"mnist_{split}.npy")
    if not os.path.exists(npy):
        raise FileNotFoundError(
            f"no {npy}: plain MNIST is read from that file (N, 28, 28) "
            "uint8; nothing is downloaded")
    digits = np.load(npy)
    if digits.shape[-1] == image_dim:
        return digits
    # centre-pad the 28x28 digits onto the canvas
    out = np.zeros((len(digits), image_dim, image_dim), dtype=digits.dtype)
    off = (image_dim - digits.shape[-1]) // 2
    out[:, off:off + digits.shape[-2], off:off + digits.shape[-1]] = digits
    return out
