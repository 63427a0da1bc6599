"""Dataset loading (mirror of targetvae_tpu/data): the MNIST variants. The
MRC, CTF and image modules are not ported yet (ROADMAP.md, queue 1, item
18)."""

from .datasets import load_mnist

__all__ = ["load_mnist"]
