#!/usr/bin/env python
"""Hungarian-score saved cluster assignments against external label files,
with the port's cluster_acc (targetvae_tpu_torch/cli/clustering_common.py;
no JAX).

The galaxy pipeline has no ground-truth labels in the reference contract,
so the clustering CLIs save `cluster_assignments.npy`; this scores that
file against any label arrays (e.g. tools/make_synthetic_galaxies.py's
galaxy_labels_{train,test}.npy):

  python tools/score_clusters_torch.py RUN_DIR/cluster_assignments.npy \\
      labels_train.npy [labels_test.npy ...]

Labels are concatenated in the order given, which must be the image order
the clustering CLI used (train, then test).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from targetvae_tpu_torch.cli.clustering_common import cluster_acc  # noqa: E402


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    pred = np.load(argv[0])
    labels = np.concatenate([np.load(p) for p in argv[1:]])
    if len(pred) != len(labels):
        print(f"length mismatch: {len(pred)} assignments vs {len(labels)} "
              f"labels", file=sys.stderr)
        return 2
    _, acc = cluster_acc(labels, pred)
    print(f"clustering accuracy (Hungarian, {int(labels.max()) + 1} classes): "
          f"{acc:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
