"""Reconstructions and pose-normalised content of a trained model (mirror
of tools/reconstruct.py). Runs on cuda:0 by default (-d i for cuda:i, -d -1
for the CPU):

    python -m targetvae_tpu_torch.cli.reconstruct \\
        --path-to-encoder RUN/inference.sav \\
        --path-to-generator RUN/generator.sav --images data.npy --n 8

For each image the encoder infers (z, theta, dx) and the generator decodes
z twice, in float32: on the grid at the inferred pose (the reconstruction)
and on the plain grid (the content without its pose). Each checkpoint may
be this package's or the reference's pickled .sav; a generator of this
package brings its own generator config. It writes a grey PNG of three
rows (inputs, reconstructions, pose-normalised), each tile scaled to its
own range as matplotlib's imshow scales it, to --out (default:
reconstructions.png beside the encoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Tuple

import numpy as np
import torch

from ..data.datasets import load_particles
from ..models.targetvae import TargetVAE
from ..ops.coords import transform_coords
from ..train.checkpoint import load_checkpoint
from ..utils.jax_params import params_from_jax
from ..utils.png import write_png
from ..utils.torch_import import generator_from_sav, is_torch_checkpoint
from .clustering_common import load_encoder
from .common import select_device

GAP = 2    # white pixels between tiles and around the grid


def reconstruct(model: TargetVAE, params: dict, images: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """images (b, H, W, C) -> (recon, canon), each (b, H, W) float32: the
    first output channel decoded at the inferred pose and on the plain
    grid, through a sigmoid for the Bernoulli likelihood."""
    cfg = model.cfg
    b, n = len(images), cfg.encoder.image_dim
    y = torch.as_tensor(np.asarray(images, np.float32), device=model.device)
    with torch.inference_mode():
        emb = model.embed(params, y)
        theta = emb["theta_mu"][:, 0]
        z = emb["z_content"][:, :cfg.encoder.z_dim]
        grid = model.base_grid()
        x_pose = transform_coords(grid, emb["dx"], theta)
        x_plain = grid[None].expand(b, -1, -1)
        recon = model.decode(params, x_pose, z)[..., 0]
        canon = model.decode(params, x_plain, z)[..., 0]
        if cfg.likelihood.kind == "bernoulli":
            recon, canon = torch.sigmoid(recon), torch.sigmoid(canon)
    return (recon.reshape(b, n, n).cpu().numpy(),
            canon.reshape(b, n, n).cpu().numpy())


def grid_image(rows) -> np.ndarray:
    """Rows of (b, H, W) images as one grey (H', W', 3) uint8 image, each
    tile scaled from its least to its greatest value."""
    nrow, (b, h, w) = len(rows), rows[0].shape
    img = np.full((GAP + nrow * (h + GAP), GAP + b * (w + GAP), 3), 255,
                  np.uint8)
    for r, tiles in enumerate(rows):
        for i, tile in enumerate(np.asarray(tiles, np.float64)):
            lo, hi = tile.min(), tile.max()
            t = (tile - lo) / (hi - lo) if hi > lo else np.zeros_like(tile)
            y0, x0 = GAP + r * (h + GAP), GAP + i * (w + GAP)
            img[y0:y0 + h, x0:x0 + w] = np.round(255 * t).astype(
                np.uint8)[..., None]
    return img


def load_model(path_to_encoder: str, path_to_generator: str, device
               ) -> Tuple[TargetVAE, dict]:
    """The model and params of an encoder and a generator file, each in
    either format."""
    model, params = load_encoder(path_to_encoder, device)
    if is_torch_checkpoint(path_to_generator):
        gen_cfg, gparams = generator_from_sav(path_to_generator)
    else:
        gp, gcfg, _ = load_checkpoint(path_to_generator)
        gen_cfg, gparams = gcfg.generator, gp["generator"]
    model = TargetVAE(dataclasses.replace(model.cfg, generator=gen_cfg),
                      device)
    return model, {"encoder": params["encoder"],
                   "generator": params_from_jax(gparams, model.device)}


def main(argv=None) -> dict:
    """Returns {"recon", "canon", "out"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--path-to-encoder", required=True)
    ap.add_argument("--path-to-generator", required=True)
    ap.add_argument("--images", required=True,
                    help="npy (N,H,W[,C]) or .mrc/.mrcs stack")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="output png (default: <run>/reconstructions.png)")
    ap.add_argument("--scale255", action="store_true",
                    help="divide inputs by 255")
    ap.add_argument("-d", "--device", type=int, default=0)
    args = ap.parse_args(argv)
    device = select_device(args.device)
    model, params = load_model(args.path_to_encoder, args.path_to_generator,
                               device)
    if args.images.endswith((".mrc", ".mrcs")):
        imgs = load_particles(args.images)
    else:
        imgs = np.load(args.images).astype(np.float32)
    if args.scale255:
        imgs = imgs / 255.0
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    imgs = imgs[:args.n].astype(np.float32)
    recon, canon = reconstruct(model, params, imgs)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.path_to_encoder)),
        "reconstructions.png")
    write_png(out, grid_image([imgs[..., 0], recon, canon]))
    print(f"# wrote {out}", file=sys.stderr)
    return {"recon": recon, "canon": canon, "out": out}


if __name__ == "__main__":
    main()
