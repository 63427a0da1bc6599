"""Train TARGET-VAE on MNIST / MNIST-U / MNIST-N (mirror of
targetvae_tpu/cli/train_mnist.py).

Same CLI surface as reference train_mnist.py:401-433; same run-dir, log and
checkpoint contract as the JAX package's CLI. Runs on cuda:0 by default
(-d i for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.train_mnist --dataset mnist-U \\
        --fourier-expansion --compute-dtype bfloat16 --num-epochs 60

--t-inf unimodal --r-inf unimodal trains mode A, --t-inf attention
--r-inf unimodal --groupconv 0|4|8|16 mode B, the defaults mode C.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data.datasets import load_mnist
from ..models.targetvae import TargetVAE
from ..train import run_dir_name
from ..utils.config import LikelihoodConfig
from .common import (add_model_args, add_train_args, launch_training,
                     model_config_from_args, select_device,
                     train_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Train TARGET_VAE on MNIST/MNIST-N/MNIST-U datasets")
    parser.add_argument("--dataset", choices=["mnist", "mnist-U", "mnist-N"],
                        default="mnist-U",
                        help="MNIST datset to train/validate(default: mnist-U)")
    add_model_args(parser, kernel_size=28, padding=8, image_dim=50)
    add_train_args(parser)
    parser.add_argument("--data-root", default="data",
                        help="root directory holding the datasets")
    return parser


def main(argv=None):
    """Returns the final TrainState."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    print(f"# training on {args.dataset}", file=sys.stderr)
    y_train = load_mnist(args.dataset, args.image_dim, args.data_root, "train")
    y_test = load_mnist(args.dataset, args.image_dim, args.data_root, "test")

    # theta prior per dataset (reference train_mnist.py:538-543)
    if args.dataset == "mnist-N":
        theta_prior = np.pi / 4
        normal_prior_over_r = True
    else:
        theta_prior = np.pi
        normal_prior_over_r = False

    cfg = model_config_from_args(
        args, args.image_dim, n_out=1, likelihood=LikelihoodConfig(),
        theta_prior=theta_prior, normal_prior_over_r=normal_prior_over_r)
    model = TargetVAE(cfg, device)
    train_cfg = train_config_from_args(args)

    name = run_dir_name(args.dataset, args.z_dim, args.t_inf, args.r_inf,
                        args.groupconv)
    return launch_training(args, model, train_cfg, name, y_train, y_test)


if __name__ == "__main__":
    main()
