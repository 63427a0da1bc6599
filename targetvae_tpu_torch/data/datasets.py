"""Dataset loading for the training and clustering CLIs (mirror of
targetvae_tpu/data/datasets.py), numpy only.

Same default paths as the reference loaders (train_mnist.py:440-470,
train_dsprites.py:436, train_galaxy.py:438-442, train_particles.py:454-475),
returning channels-last (N, H, W, C) float32 arrays (particles: (N, H, W)).
Nothing is downloaded: plain MNIST is read from `mnist_{split}.npy` under
the data root. MRC particle stacks are read by the native loader
(data/native.py: memory-mapped, decoded on several threads), as the JAX
package reads them.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import native
from .image import crop as crop_fn


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


def load_npy_split(train_path: str, test_path: str, scale255: bool = True,
                   limit: Optional[Tuple[int, int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A train/test pair of npy image files (dSprites, galaxy) -> two
    (N, H, W, C) float32 arrays, the first limit[0] / limit[1] images of
    each, divided by 255 with scale255."""
    tr = np.load(train_path)
    te = np.load(test_path)
    if limit is not None:
        tr = tr[:limit[0]]
        te = te[:limit[1]]
    tr = tr.astype(np.float32)
    te = te.astype(np.float32)
    if scale255:
        tr /= 255.0
        te /= 255.0
    return _to_nhwc(tr, tr.shape[-1] if tr.ndim == 4 else 1), \
        _to_nhwc(te, te.shape[-1] if te.ndim == 4 else 1)


def load_particles(path: str) -> np.ndarray:
    """A particle stack (N, H, W) float32: a .mrc/.mrcs/.npy file, or a
    directory of .mrc/.mrcs files read in name order and concatenated."""
    def _load_one(p: str) -> np.ndarray:
        return native.load_mrc_f32(p)     # mmap + multithreaded decode

    if os.path.isdir(path):
        stacks = [
            _load_one(os.path.join(path, name))
            for name in sorted(os.listdir(path))
            if name.endswith((".mrc", ".mrcs"))
        ]
        if not stacks:
            raise FileNotFoundError(f"no .mrc/.mrcs files in {path}")
        images = np.concatenate(stacks, axis=0)
    elif path.endswith((".mrc", ".mrcs")):
        images = _load_one(path)
    elif path.endswith(".npy"):
        images = np.load(path).astype(np.float32)
    else:
        raise ValueError(f"unrecognized particle stack: {path}")
    if images.ndim == 2:
        images = images[None]
    return images


def preprocess_particles(images: np.ndarray, crop: int = 0,
                         normalize: bool = False) -> np.ndarray:
    """Centre crop, then per-image standardisation by the plain mean and
    std of the whole image (train_particles.py:584-600, not the ring
    normalize)."""
    if crop > 0:
        images = crop_fn(images, crop)
    if normalize:
        mu = images.mean(axis=(-2, -1), keepdims=True)
        std = images.std(axis=(-2, -1), keepdims=True)
        images = (images - mu) / std
    return images


def train_test_split(images: np.ndarray, train_portion: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The first floor(N * portion) images train, the rest test
    (train_particles.py:553-559)."""
    n_train = int(len(images) * train_portion)
    return images[:n_train], images[n_train:]
