"""Cluster MNIST test-set latents from a trained encoder (mirror of
targetvae_tpu/cli/clustering_mnist.py, the reference clustering_mnist.py CLI
surface). Runs on cuda:0 by default (-d i for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.clustering_mnist --dataset mnist-U \\
        --path-to-encoder RUN_DIR/inference.sav --n-clusters 5 \\
        --path-to-labels DATA/mnist_U/labels_test.npy --compute-dtype bfloat16

It embeds the test images (argmax posterior cell), corrects the pose
predictions by those on the plain images (mnist_test.npy), measures the
rotation's circular and the translation's Pearson correlations against
transforms_test.npy, clusters the content latents (k-means on the device or
Ward's), matches the clusters to the labels and writes results.txt beside
the encoder, with the confusion matrix (where there are labels) and the
t-SNE of the content latents as PNG figures (cli/figures.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from ..data.datasets import load_mnist
from .clustering_common import (add_clustering_args, cluster_acc,
                                embed_dataset, load_encoder,
                                measure_correlations, run_clustering,
                                write_results)
from .common import select_device
from .figures import save_confusion_matrix, save_tsne


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Clustering the latent representations of MNIST datasets")
    parser.add_argument("--dataset", choices=["mnist", "mnist-U", "mnist-N"],
                        default="mnist-U",
                        help="which MNIST datset to train/validate on "
                             "(default:mnist-U)")
    parser.add_argument("--path-to-mnist-test",
                        default="./data/MNIST/processed/test.pt",
                        help="path to the file that has labels of the test "
                             "images")
    parser.add_argument("--path-to-labels", default=None,
                        help="npy file of integer test labels (alternative to "
                             "--path-to-mnist-test)")
    parser.add_argument("--image-dim", type=int, default=50)
    parser.add_argument("--data-root", default="data")
    return add_clustering_args(parser, "k-means", 10)


def _load_labels(args) -> Optional[np.ndarray]:
    if args.path_to_labels and os.path.exists(args.path_to_labels):
        return np.load(args.path_to_labels)
    if os.path.exists(args.path_to_mnist_test):
        try:
            import torch
            return np.asarray(torch.load(args.path_to_mnist_test,
                                         weights_only=True)[1])
        except Exception as e:  # pragma: no cover
            print(f"# could not load labels: {e}", file=sys.stderr)
    return None


def main(argv=None) -> dict:
    """Returns {"acc", "rot_corr", "tr_corr", "z_values", "cluster"} (the
    correlations None without transforms, acc None without labels)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    y_test = load_mnist(args.dataset, args.image_dim, args.data_root, "test")
    transforms_path = None
    if args.dataset in ("mnist-U", "mnist-N"):
        sub = "mnist_U" if args.dataset == "mnist-U" else "mnist_N"
        transforms_path = os.path.join(args.data_root, sub,
                                       "transforms_test.npy")

    model, params = load_encoder(args.path_to_encoder, device)
    path_prefix = os.path.dirname(os.path.abspath(args.path_to_encoder))

    z_values, rot_pred, tr_pred = embed_dataset(model, params, y_test,
                                                args.minibatch_size,
                                                args.compute_dtype)

    rot_corr = tr_corr = None
    if args.dataset != "mnist" and transforms_path and \
            os.path.exists(transforms_path):
        # reference-frame correction: subtract the predictions on the plain
        # images (reference clustering_mnist.py:331-354); mnist_{split}.npy
        # must hold the same instances, index-aligned, as real MNIST-U/N and
        # tools/make_synthetic_shapes.py both guarantee
        print("# calculating the correlation for the rotation and "
              "translation ... ", file=sys.stderr)
        y_plain = load_mnist("mnist", args.image_dim, args.data_root, "test")
        _, rot_plain, tr_plain = embed_dataset(model, params, y_plain,
                                               args.minibatch_size,
                                               args.compute_dtype)
        rot_corr, tr_corr = measure_correlations(
            transforms_path, rot_pred - rot_plain, tr_pred - tr_plain)

    cluster = run_clustering(z_values, args.clustering, args.n_clusters,
                             device=device)

    labels = _load_labels(args)
    acc = None
    if labels is not None:
        mapping, acc = cluster_acc(labels, cluster)
        save_confusion_matrix(os.path.join(path_prefix,
                                           "confusion_matrix.png"),
                              labels, cluster, mapping)
    save_tsne(os.path.join(path_prefix, "tsne.png"), z_values, labels,
              device=device)
    write_results(os.path.join(path_prefix, "results.txt"),
                  args.path_to_encoder, acc=acc, rot_corr=rot_corr,
                  tr_corr=tr_corr)
    if acc is not None:
        print(f"# clustering accuracy: {acc}")
    return {"acc": acc, "rot_corr": rot_corr, "tr_corr": tr_corr,
            "z_values": z_values, "cluster": cluster}


if __name__ == "__main__":
    main()
