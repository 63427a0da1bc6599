"""Dataset loading (mirror of targetvae_tpu/data), numpy only: the MNIST,
dSprites, galaxy and particle loaders, MRC stacks, CTF kernels and image
preprocessing."""

from .datasets import (load_mnist, load_npy_split, load_particles,
                       preprocess_particles, train_test_split)

__all__ = ["load_mnist", "load_npy_split", "load_particles",
           "preprocess_particles", "train_test_split"]
