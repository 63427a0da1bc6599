#!/usr/bin/env python
"""Synthetic heterogeneous cryo-EM particles (the EMPIAR-10025 stand-in of
QUALITY.md) written with the PyTorch port's own data modules: the same
generator, draws and file layout as tools/make_synthetic_particles.py, on
targetvae_tpu_torch.data.ctf.ctf_filter and .mrc.write, without pandas or
the JAX package, so that it runs where only the port is installed. For one
seed both tools write identical files.

K structurally distinct projection-like classes are rendered as soft
Gaussian-blob densities, posed with recorded ground-truth in-plane rotations
and translations, corrupted by a per-particle CTF (applied as the exact
linear 'same' convolution with the ctf_filter kernels the likelihood uses)
and additive white noise at a cryo-EM-plausible SNR:

  <out>/particles_{train,test}.mrcs   float32 MRC stacks
  <out>/ctf_{train,test}.txt          8-column whitespace CTF tables
  <out>/transforms_{split}.npy        (N, 3) [theta, dx_px, dy_px]
  <out>/labels_{split}.npy            (N,) class ids

    python tools/make_synthetic_particles_torch.py --out-root DIR
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blob_layout(cls: int, rng) -> list:
    """[(cy, cx, sigma, amp)] blob placements (class frame, origin centre):
    an asymmetric barbell, a trimer with an appendage, a hexameric ring with
    a core, each with per-instance jitter."""
    j = lambda s: rng.normal(0, s)
    if cls == 0:      # asymmetric barbell: big head, small head, offset arm
        return [(-20 + j(1.5), 0 + j(1.5), 13.0, 1.0),
                (22 + j(1.5), 0 + j(1.5), 8.0, 0.75),
                (0 + j(1.5), 1 + j(1.5), 5.5, 0.55),
                (8 + j(1.5), 16 + j(1.5), 6.0, 0.6 + j(0.05))]
    if cls == 1:      # trimer + appendage
        out = []
        for k in range(3):
            a = 2 * np.pi * k / 3
            out.append((24 * np.cos(a) + j(1.5), 24 * np.sin(a) + j(1.5),
                        10.0, 0.9 + j(0.05)))
        out.append((0 + j(1.0), 0 + j(1.0), 6.0, 0.5))
        return out
    out = []          # hexamer ring + core
    for k in range(6):
        a = 2 * np.pi * k / 6
        out.append((26 * np.cos(a) + j(1.2), 26 * np.sin(a) + j(1.2),
                    7.0, 0.8 + j(0.04)))
    out.append((j(1.0), j(1.0), 9.0, 0.7))
    return out


def render(cls: int, theta: float, shift, d: int, rng) -> np.ndarray:
    """The posed density drawn analytically: blob centres rotated by theta
    and shifted, then drawn as Gaussians."""
    yy, xx = np.mgrid[:d, :d].astype(np.float32)
    cy0, cx0 = (d - 1) / 2.0, (d - 1) / 2.0
    ct, st = np.cos(theta), np.sin(theta)
    img = np.zeros((d, d), np.float32)
    for (by, bx, sig, amp) in _blob_layout(cls, rng):
        ry = ct * by - st * bx + cy0 + shift[1]
        rx = st * by + ct * bx + cx0 + shift[0]
        img += amp * np.exp(-((yy - ry) ** 2 + (xx - rx) ** 2)
                            / (2.0 * sig * sig)).astype(np.float32)
    return img


def draw_ctf_params(n: int, rng) -> dict:
    """Per-particle draws with an EMPIAR-plausible defocus spread, the
    columns in the CTF tables' order."""
    return {
        "defocus": rng.uniform(1.0, 2.5, n),       # um
        "cs": np.full(n, 2.7),
        "voltage": np.full(n, 300.0),
        "apix": np.full(n, 1.5),
        "bfactor": np.zeros(n),
        "ampcont": np.full(n, 7.0),                # percent (ctf.py /100)
        "dfdiff": rng.uniform(0.0, 0.04, n),       # astigmatism spread, um
        "dfang": rng.uniform(0.0, 360.0, n),
    }


def write_ctf_table(path: str, params: dict) -> None:
    """One whitespace-separated line a particle, each value as Python's
    shortest round-trip repr (the format pandas' to_csv writes)."""
    cols = list(params.values())
    with open(path, "w") as f:
        for i in range(len(cols[0])):
            f.write(" ".join(repr(float(c[i])) for c in cols) + "\n")


def apply_ctf(images: np.ndarray, kerns: np.ndarray) -> np.ndarray:
    """Exact linear 'same' convolution with per-particle kernels by
    zero-padded FFT (the kernels are symmetric under a half turn, so this
    is also the likelihood's correlation)."""
    n = images.shape[-1]
    k = kerns.shape[-1]
    s = n + k - 1
    out = np.fft.irfft2(np.fft.rfft2(images, s=(s, s))
                        * np.fft.rfft2(kerns, s=(s, s)), s=(s, s))
    o = (k - 1) // 2
    return out[:, o:o + n, o:o + n].astype(np.float32)


def make_split(n, k_classes, d, max_shift, snr, rng):
    from targetvae_tpu_torch.data.ctf import ctf_filter

    labels = rng.randint(0, k_classes, n)
    thetas = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    shifts = rng.uniform(-max_shift, max_shift, (n, 2)).astype(np.float32)
    clean = np.stack([render(labels[i], thetas[i], shifts[i], d, rng)
                      for i in range(n)])
    params = draw_ctf_params(n, rng)
    kd = d - 1 if d % 2 == 0 else d
    kerns = ctf_filter(params, kd, kd)
    sig = apply_ctf(clean, kerns)
    # additive white noise at the requested SNR (per-particle signal power)
    pw = sig.var(axis=(1, 2), keepdims=True)
    noise = rng.randn(*sig.shape).astype(np.float32) * np.sqrt(pw / snr)
    images = (sig + noise).astype(np.float32)
    transforms = np.concatenate([thetas[:, None], shifts], 1)
    return images, params, transforms, labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-root", default="data/particles")
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--image-dim", type=int, default=110)
    ap.add_argument("--max-shift", type=float, default=8.0)
    ap.add_argument("--snr", type=float, default=0.2,
                    help="signal-power / noise-power of the additive noise "
                         "(cryo-EM-plausible range ~0.05-0.3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from targetvae_tpu_torch.data import mrc

    rng = np.random.RandomState(args.seed)
    os.makedirs(args.out_root, exist_ok=True)
    for split, n in [("train", args.n_train), ("test", args.n_test)]:
        images, params, transforms, labels = make_split(
            n, args.classes, args.image_dim, args.max_shift, args.snr, rng)
        with open(os.path.join(args.out_root,
                               f"particles_{split}.mrcs"), "wb") as f:
            mrc.write(f, images)
        write_ctf_table(os.path.join(args.out_root, f"ctf_{split}.txt"),
                        params)
        np.save(os.path.join(args.out_root, f"transforms_{split}.npy"),
                transforms)
        np.save(os.path.join(args.out_root, f"labels_{split}.npy"), labels)
        print(f"# wrote {n} {split} particles (dim {args.image_dim}, "
              f"snr {args.snr})", file=sys.stderr)


if __name__ == "__main__":
    main()
