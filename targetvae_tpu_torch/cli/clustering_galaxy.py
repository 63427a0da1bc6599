"""Cluster Galaxy Zoo latents from a trained encoder (mirror of
targetvae_tpu/cli/clustering_galaxy.py, the reference clustering_galaxy.py
CLI surface; Galaxy Zoo ships no labels). Runs on cuda:0 by default (-d i
for cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.clustering_galaxy \\
        --train-path galaxy_zoo_train.npy --test-path galaxy_zoo_test.npy \\
        --path-to-encoder RUN/inference.sav --compute-dtype bfloat16

It embeds the train and test images, clusters the content latents and
writes cluster_assignments.npy, z_values.npy (for scoring against an
external label set), results.txt and the t-SNE (coloured by cluster) and,
at z_dim 2, the z-scatter as PNG figures (cli/figures.py) beside the
encoder.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .clustering_common import (add_clustering_args, embed_dataset,
                                load_encoder, run_clustering, write_results)
from .common import select_device
from .figures import save_tsne, save_z_scatter


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Clustering the latent representations of galaxy-zoo")
    parser.add_argument("--train-path",
                        default="data/galaxy_zoo/galaxy_zoo_train.npy")
    parser.add_argument("--test-path",
                        default="data/galaxy_zoo/galaxy_zoo_test.npy")
    return add_clustering_args(parser, channels=("--in-channels", 3))


def main(argv=None) -> dict:
    """Returns {"z_values", "cluster"}."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    images = np.concatenate([np.load(args.train_path),
                             np.load(args.test_path)]).astype(np.float32) / 255.0
    if images.ndim == 3:
        images = images[..., None]

    model, params = load_encoder(args.path_to_encoder, device)
    path_prefix = os.path.dirname(os.path.abspath(args.path_to_encoder))

    z_values, _, _ = embed_dataset(model, params, images, args.minibatch_size,
                                   args.compute_dtype)
    cluster = run_clustering(z_values, args.clustering, args.n_clusters,
                             device=device)

    # galaxy zoo ships no labels (the reference colours its z-scatter by
    # cluster id only, clustering_galaxy.py:303-310): the assignments and
    # the embeddings are kept so that external label sets can score them
    np.save(os.path.join(path_prefix, "cluster_assignments.npy"), cluster)
    np.save(os.path.join(path_prefix, "z_values.npy"), z_values)
    save_tsne(os.path.join(path_prefix, "tsne.png"), z_values, cluster,
              device=device)
    if args.z_dim == 2 and z_values.shape[1] >= 2:
        save_z_scatter(os.path.join(path_prefix, "z_vals.png"), z_values,
                       cluster)
    write_results(os.path.join(path_prefix, "results.txt"),
                  args.path_to_encoder)
    print("# done", file=sys.stderr)
    return {"z_values": z_values, "cluster": cluster}


if __name__ == "__main__":
    main()
