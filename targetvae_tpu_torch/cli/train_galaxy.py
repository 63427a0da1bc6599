"""Train TARGET-VAE on Galaxy Zoo RGB images (mirror of
targetvae_tpu/cli/train_galaxy.py, the reference train_galaxy.py CLI
surface). Runs on cuda:0 by default (-d i for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.train_galaxy \\
        --train-path galaxy_zoo_train.npy --test-path galaxy_zoo_test.npy \\
        --fourier-expansion --compute-dtype bfloat16

An RGB Bernoulli likelihood (three output channels), a 4-layer generator,
a uniform theta prior and plateau patience 10.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data.datasets import load_npy_split
from ..models.targetvae import TargetVAE
from ..train import run_dir_name
from ..utils.config import LikelihoodConfig
from .common import (add_model_args, add_train_args, launch_training,
                     model_config_from_args, select_device,
                     train_config_from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Train TARGET_VAE on galaxy-zoo")
    parser.add_argument("--train-path",
                        default="data/galaxy_zoo/galaxy_zoo_train.npy",
                        help="path to training data")
    parser.add_argument("--test-path",
                        default="data/galaxy_zoo/galaxy_zoo_test.npy",
                        help="path to testing data")
    add_model_args(parser, kernel_size=65, padding=16, in_channels=3,
                   image_dim=64, generator_num_layers=4)
    add_train_args(parser)
    return parser


def main(argv=None):
    """Returns the final TrainState."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    y_train, y_test = load_npy_split(args.train_path, args.test_path,
                                     scale255=True)
    print(f"# training on galaxy zoo: {len(y_train)} train / {len(y_test)} "
          f"test", file=sys.stderr)

    # uniform theta prior (train_galaxy.py:510-511); RGB Bernoulli likelihood;
    # plateau patience 10 (:538)
    cfg = model_config_from_args(
        args, args.image_dim, n_out=3, likelihood=LikelihoodConfig(),
        theta_prior=np.pi, normal_prior_over_r=False)
    model = TargetVAE(cfg, device)
    train_cfg = train_config_from_args(args, plateau_patience=10)

    name = run_dir_name("galaxy", args.z_dim, args.t_inf, args.r_inf,
                        args.groupconv)
    return launch_training(args, model, train_cfg, name, y_train, y_test)


if __name__ == "__main__":
    main()
