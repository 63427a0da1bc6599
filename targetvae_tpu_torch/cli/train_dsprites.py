"""Train TARGET-VAE on dSprites (mirror of targetvae_tpu/cli/train_dsprites.py,
the reference train_dsprites.py CLI surface). Runs on cuda:0 by default (-d
i for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.train_dsprites \\
        --train-path imgs_train.npy --test-path imgs_test.npy \\
        --fourier-expansion --compute-dtype bfloat16

Without --full-dataset it trains on the first 1000 / 100 images, as the
reference does (train_dsprites.py:436-437).
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
    parser = argparse.ArgumentParser("Train TARGET_VAE on dSprites")
    parser.add_argument("--train-path",
                        help="path to training data; or path to the whole data")
    parser.add_argument("--test-path", help="path to testing data")
    add_model_args(parser, kernel_size=64, padding=32, image_dim=64)
    add_train_args(parser)
    parser.add_argument("--full-dataset", action="store_true",
                        help="train on the full dataset (the reference "
                             "silently trains on 1000/100 images, "
                             "train_dsprites.py:436-437; that remains the "
                             "default for parity)")
    return parser


def main(argv=None):
    """Returns the final TrainState."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    limit = None if args.full_dataset else (1000, 100)
    # dsprites npy images are binary {0,1}: no /255 scaling in the reference
    y_train, y_test = load_npy_split(args.train_path, args.test_path,
                                     scale255=False, limit=limit)
    print(f"# training on dsprites: {len(y_train)} train / {len(y_test)} test",
          file=sys.stderr)

    # the reference dsprites generator omits sigma -> default 0.01
    # (train_dsprites.py:492); scheduler min_lr=1e-6 (:537)
    cfg = model_config_from_args(
        args, args.image_dim, n_out=1, likelihood=LikelihoodConfig(),
        theta_prior=np.pi, normal_prior_over_r=False, fourier_sigma=0.01)
    model = TargetVAE(cfg, device)
    train_cfg = train_config_from_args(args, min_lr=1e-6)

    name = run_dir_name("dsprites", args.z_dim, args.t_inf, args.r_inf,
                        args.groupconv)
    return launch_training(args, model, train_cfg, name, y_train, y_test)


if __name__ == "__main__":
    main()
