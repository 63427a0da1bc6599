"""Cluster cryo-EM particle latents from a trained encoder (mirror of
targetvae_tpu/cli/clustering_particles.py, the reference
clustering_particles.py CLI surface). Runs on cuda:0 by default (-d i for
cuda:i, -d -1 for the CPU):

    python -m targetvae_tpu_torch.cli.clustering_particles \\
        --test-path particles_test.mrcs --path-to-encoder RUN/inference.sav \\
        --normalize --n-clusters 3 --compute-dtype bfloat16

It preprocesses the stack as the training run did (--downsample, --crop,
--normalize), embeds it (argmax posterior cell), measures the rotation's
circular and the translation's Pearson correlations against
--path-to-transformations where given, clusters the content latents (Ward's
or k-means on the device) and writes cluster_assignments.npy, results.txt
and the t-SNE (coloured by cluster), rotation and translation histograms
as PNG figures (cli/figures.py) beside the encoder.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.datasets import load_particles, preprocess_particles
from .clustering_common import (add_clustering_args, embed_dataset,
                                load_encoder, measure_correlations,
                                run_clustering, write_results)
from .common import select_device
from .figures import save_histograms, save_tsne
from .train_particles import maybe_downsample


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Clustering the latent representations of particles")
    parser.add_argument("--test-path",
                        help="path to the whole data; or path to testing data")
    parser.add_argument("--path-to-transformations",
                        help="path to a file with ground-truth rotation "
                             "(col 0) and x/y translations (cols 1:3)")
    parser.add_argument("--normalize", action="store_true")
    parser.add_argument("--crop", default=0, type=int)
    parser.add_argument("--downsample", default=0, type=int,
                        help="Fourier-crop (bin) particles to this size, "
                             "matching a --downsample training run "
                             "(default: 0 = off)")
    return add_clustering_args(parser)


def main(argv=None) -> dict:
    """Returns {"rot_corr", "tr_corr", "z_values", "cluster"} (the
    correlations None without --path-to-transformations)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)

    images = maybe_downsample(load_particles(args.test_path), args.downsample)
    images = preprocess_particles(images, args.crop, args.normalize)
    images = images[..., None]

    model, params = load_encoder(args.path_to_encoder, device)
    path_prefix = os.path.dirname(os.path.abspath(args.path_to_encoder))

    z_values, rot_pred, tr_pred = embed_dataset(model, params, images,
                                                args.minibatch_size,
                                                args.compute_dtype)

    rot_corr = tr_corr = None
    if args.path_to_transformations:
        rot_corr, tr_corr = measure_correlations(
            args.path_to_transformations, rot_pred, tr_pred)

    cluster = run_clustering(z_values, args.clustering, args.n_clusters,
                             device=device)
    save_tsne(os.path.join(path_prefix, "tsne.png"), z_values, cluster,
              device=device)
    save_histograms(os.path.join(path_prefix, "rotation_hist.png"),
                    [rot_pred])
    save_histograms(os.path.join(path_prefix, "translation_hist.png"),
                    [tr_pred[:, 0], tr_pred[:, 1]])
    np.save(os.path.join(path_prefix, "cluster_assignments.npy"), cluster)
    write_results(os.path.join(path_prefix, "results.txt"),
                  args.path_to_encoder, rot_corr=rot_corr, tr_corr=tr_corr)
    print("# done", file=sys.stderr)
    return {"rot_corr": rot_corr, "tr_corr": tr_corr, "z_values": z_values,
            "cluster": cluster}


if __name__ == "__main__":
    main()
