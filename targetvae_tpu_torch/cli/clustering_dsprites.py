"""Cluster dSprites latents from a trained encoder (mirror of
targetvae_tpu/cli/clustering_dsprites.py, the reference
clustering_dsprites.py CLI surface with its undefined `y_labels` fixed by
the shape labels). Runs on cuda:0 by default (-d i for cuda:i, -d -1 for
the CPU):

    python -m targetvae_tpu_torch.cli.clustering_dsprites \\
        --train-path imgs_train.npy --test-path imgs_test.npy \\
        --train-labels latent_train.npy --test-labels latent_test.npy \\
        --path-to-encoder RUN/inference.sav --compute-dtype bfloat16

It embeds the train and test images, measures the rotation's circular and
the translation's Pearson correlations against the latent labels (columns
3 and 4:), clusters the content latents, matches the clusters to the shape
labels (column 1) and writes results.txt and the t-SNE (coloured by shape)
and confusion-matrix PNG figures (cli/figures.py) beside the encoder.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .clustering_common import (add_clustering_args, circular_corrcoef,
                                cluster_acc, embed_dataset, load_encoder,
                                run_clustering, write_results)
from .common import select_device
from .figures import save_confusion_matrix, save_tsne


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Clustering the latent representations of dSprites")
    parser.add_argument("--train-path",
                        default="data/dsprites-dataset-master/imgs_train.npy")
    parser.add_argument("--test-path",
                        default="data/dsprites-dataset-master/imgs_test.npy")
    parser.add_argument("--train-labels",
                        default="./data/dsprites-dataset-master/latent_train.npy")
    parser.add_argument("--test-labels",
                        default="./data/dsprites-dataset-master/latent_test.npy")
    return add_clustering_args(parser, n_clusters=3,
                               channels=("--inp-channel", 1))


def main(argv=None) -> dict:
    """Returns {"acc", "rot_corr", "tr_corr", "z_values", "cluster"}."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    images = np.concatenate([np.load(args.train_path),
                             np.load(args.test_path)]).astype(np.float32)
    labels = np.concatenate([np.load(args.train_labels),
                             np.load(args.test_labels)])
    shape_labels = labels[:, 1].astype(np.int64)
    r_gt = labels[:, 3:4]          # ground-truth rotation
    t_gt = labels[:, 4:]           # ground-truth translation
    images = images[..., None] if images.ndim == 3 else images

    model, params = load_encoder(args.path_to_encoder, device)
    path_prefix = os.path.dirname(os.path.abspath(args.path_to_encoder))

    z_values, r_pred, t_pred = embed_dataset(model, params, images,
                                             args.minibatch_size,
                                             args.compute_dtype)

    r_corr = circular_corrcoef(r_gt, r_pred)
    t_corr = [np.corrcoef(t_gt[:, 0], t_pred[:, 0])[0][1],
              np.corrcoef(t_gt[:, 1], t_pred[:, 1])[0][1]]

    cluster = run_clustering(z_values, args.clustering, args.n_clusters,
                             device=device)
    mapping, acc = cluster_acc(shape_labels, cluster)

    save_tsne(os.path.join(path_prefix, "tsne.png"), z_values, shape_labels,
              device=device)
    save_confusion_matrix(os.path.join(path_prefix, "confusion_matrix.png"),
                          shape_labels, cluster, mapping)
    write_results(os.path.join(path_prefix, "results.txt"),
                  args.path_to_encoder, acc=acc, rot_corr=r_corr,
                  tr_corr=t_corr)
    print(f"# clustering accuracy: {acc}", file=sys.stderr)
    return {"acc": acc, "rot_corr": r_corr, "tr_corr": t_corr,
            "z_values": z_values, "cluster": cluster}


if __name__ == "__main__":
    main()
