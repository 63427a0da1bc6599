#!/usr/bin/env python
"""QUALITY.md's cryo-EM particles protocol on the PyTorch port, end to end:
the synthetic stand-in (tools/make_synthetic_particles_torch.py: 3 classes
at 110 x 110, per-particle CTF, SNR 0.2), then train_particles with the
protocol's flags (--normalize --mask-radius 45 -z 2 --groupconv 8
--fourier-expansion --compute-dtype bfloat16, CTF tables for both splits),
then clustering_particles on the test split (--n-clusters 3 --normalize,
the ground-truth transforms), scored against the labels by Hungarian
matching. Prints one JSON line: the accuracy, the translation Pearson
correlations (x, y), the rotation's circular correlation of each class
modulo its symmetry (the barbell at theta, the trimer at 3 theta, the
hexamer at 6 theta), the test ELBO of every epoch and the CLI's epoch
img/s.

    python tools/particles_protocol_torch.py --root DIR [--tier patch]

Runs on cuda:0 (--device -1: the CPU). Nothing here imports JAX or pandas.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each class's in-plane symmetry order (tools/make_synthetic_particles*.py)
SYMMETRY = {0: 1, 1: 3, 2: 6}


class _Tee(io.TextIOBase):
    """stderr that also keeps a copy (the CLI's epoch lines)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="directory for the data and the run")
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--image-dim", type=int, default=110)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--tier", choices=["conv", "patch"], default="conv",
                    help="the bf16 encoder tier (TARGETVAE_ENCODER_TIER)")
    ap.add_argument("--device", default="0",
                    help="-d of the CLIs: a CUDA index, or -1 for the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extra", default="",
                    help="more train_particles flags, one string (small "
                         "widths on the CPU: --extra='--minibatch-size 10')")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    os.environ["TARGETVAE_ENCODER_TIER"] = args.tier
    from targetvae_tpu_torch.cli import clustering_particles, train_particles
    from targetvae_tpu_torch.cli.clustering_common import (
        circular_corrcoef, cluster_acc, embed_dataset, load_encoder)
    from targetvae_tpu_torch.data.datasets import (load_particles,
                                                   preprocess_particles)

    data = os.path.join(args.root, "particles")
    if not os.path.exists(os.path.join(data, "labels_test.npy")):
        subprocess.run([sys.executable, os.path.join(
            REPO, "tools", "make_synthetic_particles_torch.py"), "--out-root",
            data, "--n-train", str(args.n_train), "--n-test",
            str(args.n_test), "--image-dim", str(args.image_dim), "--seed",
            str(args.seed)], check=True)
    path = lambda name: os.path.join(data, name)
    logs = os.path.join(args.root, f"logs_{args.tier}")
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        train_particles.main([
            "--train-path", path("particles_train.mrcs"),
            "--test-path", path("particles_test.mrcs"),
            "--ctf-train", path("ctf_train.txt"),
            "--ctf-test", path("ctf_test.txt"), "--normalize",
            "--mask-radius", "45", "-z", "2", "--groupconv", "8",
            "--t-inf", "attention", "--r-inf", "attention+offsets",
            "--fourier-expansion", "--compute-dtype", "bfloat16",
            "--num-epochs", str(args.epochs), "--seed", str(args.seed),
            "--log-root", logs, "-d", args.device] + args.extra.split())
    run = os.path.join(logs, sorted(os.listdir(logs))[-1])
    enc = os.path.join(run, "inference.sav")
    res = clustering_particles.main([
        "--test-path", path("particles_test.mrcs"), "--path-to-encoder", enc,
        "--path-to-transformations", path("transforms_test.npy"),
        "--normalize", "--n-clusters", "3", "--compute-dtype", "bfloat16",
        "-d", args.device])
    labels = np.load(path("labels_test.npy"))
    _, acc = cluster_acc(labels, res["cluster"])

    # the rotation, class by class, modulo each class's symmetry
    model, params = load_encoder(
        enc, "cpu" if args.device == "-1" else f"cuda:{args.device}")
    images = preprocess_particles(load_particles(path("particles_test.mrcs")),
                                  0, True)[..., None]
    _, rot, _ = embed_dataset(model, params, images, 100, "bfloat16")
    theta = np.load(path("transforms_test.npy"))[:, 0]
    rot_by_class = {}
    for cls, order in SYMMETRY.items():
        keep = labels == cls
        if keep.sum() > 2:
            rot_by_class[str(cls)] = abs(circular_corrcoef(
                order * theta[keep], order * rot[keep, 0]))
    text = "".join(tee.parts)
    test_elbo = [float(m[1]) for m in re.finditer(
        r"^\d+\ttest\t(\S+)\t", open(os.path.join(run, "train_log.txt"))
        .read(), re.M)]
    out = {"tier": args.tier, "n_train": args.n_train, "n_test": args.n_test,
           "epochs_run": len(test_elbo), "accuracy": float(acc),
           "translation_pearson": [float(v) for v in res["tr_corr"]],
           "translation_pearson_abs": [abs(float(v))
                                       for v in res["tr_corr"]],
           "rotation_circular_all": float(res["rot_corr"]),
           "rotation_circular_by_class": rot_by_class,
           "test_elbo": test_elbo,
           "epoch_img_s": [int(m[1]) for m in re.finditer(
               r"# epoch \d+: [\d.]+s, (\d+) images/sec", text)],
           "run": os.path.basename(run)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
