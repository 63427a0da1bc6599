"""Embed a particle stack to latents and poses, without clustering (mirror
of tools/embed_stack.py). Runs on cuda:0 by default (-d i for cuda:i, -d -1
for the CPU):

    python -m targetvae_tpu_torch.cli.embed_stack --input particles.mrcs \\
        --path-to-encoder RUN/inference.sav --out latents/run1 --normalize

It reads an MRC stack, a directory of .mrc/.mrcs files or a .npy image
array, bins (--downsample), crops and standardises it as the training run
did, embeds it with the encoder (this package's checkpoint or the
reference's pickled inference.sav) and writes `<out>_z.npy` (N, 2 z_dim:
[z_mu; z_std]), `<out>_rot.npy` (N, 1) and `<out>_trans.npy` (N, 2).
--compute-dtype bfloat16 (the default, as in the JAX tool) runs the
encoder's kernel once a batch; float32 the reference protocol.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..data.datasets import load_particles, preprocess_particles
from .clustering_common import embed_dataset, load_encoder
from .common import select_device
from .train_particles import maybe_downsample


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "Embed a particle stack to latent/pose arrays (no clustering)")
    ap.add_argument("--input", required=True,
                    help="MRC stack, directory of .mrcs, or .npy image array")
    ap.add_argument("--path-to-encoder", required=True,
                    help="trained encoder checkpoint (this package's or a "
                         "reference pickled inference.sav)")
    ap.add_argument("--out", required=True,
                    help="output prefix; writes <out>_z.npy, <out>_rot.npy, "
                         "<out>_trans.npy")
    ap.add_argument("--normalize", action="store_true",
                    help="per-particle standardization (match training)")
    ap.add_argument("--crop", default=0, type=int,
                    help="center-crop to this size (match training)")
    ap.add_argument("--downsample", default=0, type=int,
                    help="Fourier-crop (bin) to this size (match a "
                         "--downsample training run)")
    ap.add_argument("--minibatch-size", type=int, default=100)
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="bfloat16 (default): the encoder kernels on the "
                         "card; float32 bit-matches the reference protocol")
    ap.add_argument("-d", "--device", type=int, default=0)
    return ap


def load_stack(path: str, downsample: int = 0, crop: int = 0,
               normalize: bool = False) -> np.ndarray:
    """The stack at path, preprocessed as a training run: (N, H, W, 1)
    float32 (or (N, H, W, C) for an .npy array of channels)."""
    if path.endswith(".npy"):
        images = np.load(path).astype(np.float32)
    else:
        images = load_particles(path)
    images = maybe_downsample(images, downsample)
    images = preprocess_particles(images, crop, normalize)
    return images[..., None] if images.ndim == 3 else images


def main(argv=None) -> dict:
    """Returns {"z", "rot", "trans"} (the arrays written) and "seconds",
    the embedding's host-clock time (the stack's read excluded)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)
    images = load_stack(args.input, args.downsample, args.crop,
                        args.normalize)
    model, params = load_encoder(args.path_to_encoder, device)
    t0 = time.perf_counter()
    z, rot, tr = embed_dataset(model, params, images, args.minibatch_size,
                               args.compute_dtype)           # on the host
    dt = time.perf_counter() - t0
    print(f"# embedded {len(images)} particles in {dt:.2f}s "
          f"({len(images) / dt:.0f} images/sec)", file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.save(args.out + "_z.npy", z)
    np.save(args.out + "_rot.npy", rot)
    np.save(args.out + "_trans.npy", tr)
    print(f"# wrote {args.out}_{{z,rot,trans}}.npy", file=sys.stderr)
    return {"z": z, "rot": rot, "trans": tr, "seconds": dt}


if __name__ == "__main__":
    main()
