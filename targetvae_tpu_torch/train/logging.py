"""Run directory + TSV logging contract (mirror of
targetvae_tpu/train/logging.py).

Reproduces the reference's observable logging surface (train_mnist.py:589-660):
a run directory named
  <timestamp>_<dataset>_zDim_<z>_translation_<t>_rotation_<r>[_groupconvP]...
under --log-root, a `train_log.txt` that mirrors stdout (args, model summary,
then TSV `Epoch Split ELBO Error KL` lines), and stderr progress.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional


def run_dir_name(dataset: str, z_dim: int, t_inf: str, r_inf: str,
                 groupconv: int = 0, extra_tags: Optional[list] = None,
                 timestamp: Optional[str] = None) -> str:
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")
    name = "_".join([ts, dataset, "zDim", str(z_dim), "translation", t_inf,
                     "rotation", r_inf])
    if groupconv > 0:
        name += "_groupconv" + str(groupconv)
    for tag in (extra_tags or []):
        name += "_" + tag
    return name


class RunLogger:
    HEADER = "\t".join(["Epoch", "Split", "ELBO", "Error", "KL"])

    def __init__(self, log_root: str, run_name: str, args_repr: str = "",
                 model_repr: str = "", append: bool = False):
        os.makedirs(log_root, exist_ok=True)
        self.path_prefix = os.path.join(log_root, run_name, "")
        os.makedirs(self.path_prefix, exist_ok=True)
        self.log_file = open(os.path.join(self.path_prefix, "train_log.txt"),
                             "a" if append else "w", buffering=1)
        if not append:
            print(run_name + "\n", file=self.log_file)
            if args_repr:
                print("\n\nargs:", file=self.log_file)
                print(args_repr, file=self.log_file)
            if model_repr:
                print(model_repr, file=self.log_file)
            print("\n\n", file=self.log_file)
            print(self.HEADER + "\n", file=self.log_file)
        print(self.HEADER)

    def epoch(self, epoch: int, split: str, elbo: float, gen_loss: float,
              kl: float) -> str:
        line = "\t".join([str(epoch), split, str(elbo), str(gen_loss), str(kl)])
        print(line)
        print(line, file=self.log_file)
        return line

    def line(self, msg: str) -> None:
        print(msg)
        print(msg, file=self.log_file)

    def progress(self, msg: str) -> None:
        print(msg, end="\r", file=sys.stderr)

    def close(self) -> None:
        self.log_file.close()


class NullLogger:
    """RunLogger's surface writing nothing: what the ranks other than rank
    0 log to, so that one run directory is written."""
    path_prefix = None

    def epoch(self, epoch: int, split: str, elbo: float, gen_loss: float,
              kl: float) -> str:
        return "\t".join([str(epoch), split, str(elbo), str(gen_loss),
                          str(kl)])

    def line(self, msg: str) -> None:
        pass

    def progress(self, msg: str) -> None:
        pass

    def close(self) -> None:
        pass
