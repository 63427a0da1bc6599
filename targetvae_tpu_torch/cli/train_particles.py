"""Train TARGET-VAE on cryo-EM particle stacks with CTF correction (mirror of
targetvae_tpu/cli/train_particles.py, the reference train_particles.py CLI
surface). Runs on cuda:0 by default (-d i for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.train_particles \\
        --train-path particles_train.mrcs --test-path particles_test.mrcs \\
        --ctf-train ctf_train.txt --ctf-test ctf_test.txt --normalize \\
        --mask-radius 45 --fourier-expansion --compute-dtype bfloat16

Gaussian likelihood (--fit-noise: a second output channel, the log
variance), per-particle CTF kernels of odd size from the 8-column CTF
tables, the circular mask; a uniform theta prior.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data import ctf as ctf_mod
from ..data.datasets import (load_particles, preprocess_particles,
                             train_test_split)
from ..data.image import downsample
from ..models.targetvae import TargetVAE
from ..train import run_dir_name
from ..utils.config import LikelihoodConfig
from .common import (add_model_args, add_train_args, launch_training,
                     model_config_from_args, select_device,
                     train_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Train TARGET_VAE on particle stacks (MRC/npy) with optional CTF")
    parser.add_argument("--train-path",
                        help="path to training data; or path to the whole data")
    parser.add_argument("--test-path", help="path to testing data")
    parser.add_argument("--ctf-train",
                        help="path to CTF parameters for training images; or "
                             "path to CTF parameters of whole set")
    parser.add_argument("--ctf-test",
                        help="path to CTF parameters for testing images")
    parser.add_argument("--scale", default=1, type=float,
                        help="used to scale the ang/pix if images were binned "
                             "(default: 1)")
    parser.add_argument("--train-portion", default=0.9, type=float,
                        help="portion of dataset used for training "
                             "(default: 0.9)")
    parser.add_argument("--fit-noise", action="store_true",
                        help="also learn the standard deviation of the noise "
                             "in the generative model")
    parser.add_argument("--normalize", action="store_true",
                        help="normalize the images before training")
    parser.add_argument("--mask-radius", default=0, type=int,
                        help="radius of the circular mask for the "
                             "reconstructed images (default:0)")
    parser.add_argument("--crop", default=0, type=int,
                        help="size of the cropped images (default:0)")
    parser.add_argument("--downsample", default=0, type=int,
                        help="Fourier-crop (bin) particles to this size "
                             "before training; the CTF pixel size is "
                             "rescaled automatically (default: 0 = off)")
    add_model_args(parser, kernel_size=64, padding=16)
    add_train_args(parser)
    return parser


def _ctf_kernels(path, n: int, m: int, scale: float) -> np.ndarray:
    """The CTF kernels of a table, of odd size: n - 1 for an even n
    (train_particles.py:543-546, which leaves odd n undefined: n here)."""
    ctf_n = n - 1 if n % 2 == 0 else n
    ctf_m = m - 1 if m % 2 == 0 else m
    params = ctf_mod.parse_ctf(path)
    return ctf_mod.ctf_filter(params, ctf_n, ctf_m, scale=scale)


def maybe_downsample(images: np.ndarray, size: int) -> np.ndarray:
    """Fourier-crop binning to size x size (data/image.py::downsample); the
    stack as it is when size is 0 or not below the images' size."""
    if not size or size >= images.shape[-1]:
        return images
    return np.ascontiguousarray(
        downsample(images, shape=(size, size)).astype(np.float32))


def main(argv=None):
    """Returns the final TrainState (None without --train-path)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    ctf_train = ctf_test = None
    if args.train_path and args.test_path:
        images_train = load_particles(args.train_path)
        images_test = load_particles(args.test_path)
        orig_n = images_train.shape[-1]
        images_train = maybe_downsample(images_train, args.downsample)
        images_test = maybe_downsample(images_test, args.downsample)
        n, m = images_train.shape[1:]
        # binning multiplies the pixel size: apix_new = apix * orig / new
        ctf_scale = args.scale * (orig_n / n)
        if args.ctf_train and args.ctf_test:
            print(f"# loading CTF filters: {args.ctf_train}", file=sys.stderr)
            ctf_train = _ctf_kernels(args.ctf_train, n, m, ctf_scale)
            ctf_test = _ctf_kernels(args.ctf_test, n, m, ctf_scale)
    elif args.train_path:
        images = load_particles(args.train_path)
        orig_n = images.shape[-1]
        images = maybe_downsample(images, args.downsample)
        n, m = images.shape[1:]
        ctf_scale = args.scale * (orig_n / n)
        images_train, images_test = train_test_split(images,
                                                     args.train_portion)
        if args.ctf_train:
            print(f"# loading CTF filters: {args.ctf_train}", file=sys.stderr)
            kernels = _ctf_kernels(args.ctf_train, n, m, ctf_scale)
            ctf_train = kernels[:len(images_train)]
            ctf_test = kernels[len(images_train):]
    else:
        print("# --train-path is required", file=sys.stderr)
        return None

    images_train = preprocess_particles(images_train, args.crop,
                                        args.normalize)
    images_test = preprocess_particles(images_test, args.crop, args.normalize)
    n, m = images_train.shape[1:]
    if n != m:
        raise ValueError(f"particle images must be square, not {n}x{m}")
    print(f"# {len(images_train)} train / {len(images_test)} test particles "
          f"of {n}x{m}", file=sys.stderr)

    fourier_sigma = max(2.0 / (m - 1), 2.0 / (n - 1))
    n_out = 2 if args.fit_noise else 1
    likelihood = LikelihoodConfig(kind="gaussian", fit_noise=args.fit_noise,
                                  mask_radius=args.mask_radius,
                                  use_ctf=ctf_train is not None)
    # uniform theta prior (train_particles.py:684-686)
    cfg = model_config_from_args(
        args, n, n_out=n_out, likelihood=likelihood, theta_prior=np.pi,
        normal_prior_over_r=False, fourier_sigma=fourier_sigma)
    model = TargetVAE(cfg, device)
    train_cfg = train_config_from_args(args, min_lr=1e-6)

    tags = []
    if ctf_train is not None:
        tags.append("ctf")
    if args.fourier_expansion:
        tags.append("Fr_sigma" + str(fourier_sigma))
    dataset_tag = (args.train_path or "particles").replace("/", "-")
    name = run_dir_name(dataset_tag, args.z_dim, args.t_inf, args.r_inf,
                        args.groupconv, extra_tags=tags)
    return launch_training(args, model, train_cfg, name,
                           images_train[..., None], images_test[..., None],
                           ctf_train=ctf_train, ctf_test=ctf_test)


if __name__ == "__main__":
    main()
