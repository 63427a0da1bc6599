"""The port's clustering against the JAX package's: the accuracy and pose
correlation functions, k-means and Ward's agglomeration against
scikit-learn's (which the JAX package calls), and the clustering CLI
against the JAX package's CLI on one small checkpoint.

Tolerances: the numpy functions are the JAX module's formulas, 1e-12; the
CLI's z_values rtol 2e-4 / atol 1e-4 (the float32 encoders of the two
packages sum in other orders, tests/test_torch_port_slice.py's bound); the
clusterings the same partition, and on overlapping data a k-means inertia
at most 1e-3 relative above scikit-learn's (each keeps the best of 100
seeded restarts, from other random draws, which end in other local minima:
the port's may be lower).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import targetvae_tpu.cli.clustering_common as jax_cc
from targetvae_tpu.cli import clustering_mnist as jax_clustering_mnist
from targetvae_tpu.cli import train_mnist as jax_train_mnist

from targetvae_tpu_torch.cli import clustering_common as cc
from targetvae_tpu_torch.cli import clustering_mnist
from targetvae_tpu_torch.cli.clustering_algorithms import kmeans, ward


def _same_partition(a, b) -> bool:
    """a and b split the points alike, up to the clusters' names."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_accuracy_and_correlations_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 5, 200)
    y_pred = (y_true + (rng.uniform(size=200) < 0.2)) % 5
    m1, a1 = cc.cluster_acc(y_true, y_pred)
    m2, a2 = jax_cc.cluster_acc(y_true, y_pred)
    assert a1 == a2 and np.array_equal(m1, m2)
    a, b = rng.uniform(-np.pi, np.pi, (2, 300))
    b = a + 0.3 * b
    assert abs(cc.circular_corrcoef(a, b)
               - jax_cc.circular_corrcoef(a, b)) < 1e-12
    t = np.stack([a, rng.normal(size=300), rng.normal(size=300)], axis=1)
    np.save(tmp_path / "t.npy", t)
    r_pred = (a + 0.1 * rng.normal(size=300))[:, None]
    t_pred = t[:, 1:3] + 0.2 * rng.normal(size=(300, 2))
    got = cc.measure_correlations(str(tmp_path / "t.npy"), r_pred, t_pred)
    ref = jax_cc.measure_correlations(str(tmp_path / "t.npy"), r_pred,
                                      t_pred)
    assert abs(got[0] - ref[0]) < 1e-12
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-12)


def test_ward_matches_scikit_learn():
    sklearn = pytest.importorskip("sklearn.cluster")
    z = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    for k in (2, 5, 10):
        got = ward(z, k)
        ref = sklearn.AgglomerativeClustering(
            n_clusters=k, linkage="ward").fit_predict(z)
        assert sorted(set(got.tolist())) == list(range(k))
        assert _same_partition(got, ref), k
    assert _same_partition(cc.run_clustering(z, "agglomerative", 5),
                           ward(z, 5))


def test_kmeans_matches_scikit_learn():
    sklearn = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(2)
    centres = rng.normal(size=(5, 4)) * 6
    blobs = np.concatenate([c + rng.normal(size=(120, 4)) for c in centres])
    blobs = blobs.astype(np.float32)
    got, _ = kmeans(blobs, 5, seed=0, device="cpu")
    ref = sklearn.KMeans(5, n_init=100, random_state=0).fit_predict(blobs)
    assert _same_partition(got, ref)
    assert _same_partition(
        cc.run_clustering(blobs, "k-means", 5, device="cpu"), ref)
    # on overlapping data the restarts end in other local minima: the best
    # of 100 is at most 1e-3 relative above scikit-learn's best of 100
    overlap = rng.normal(size=(600, 4)).astype(np.float32)
    for k in (3, 10):
        _, inertia = kmeans(overlap, k, seed=1, device="cpu")
        ref = sklearn.KMeans(k, n_init=100, random_state=1).fit(overlap)
        assert inertia <= (1 + 1e-3) * ref.inertia_, (k, inertia,
                                                      ref.inertia_)


def test_kmeans_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """As every entry point of the port: device=None means cuda:0, and with
    no CUDA device k-means raises rather than running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.random.default_rng(3).normal(size=(40, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kmeans(z, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cc.run_clustering(z, "k-means", 3)
    assert sorted(set(kmeans(z, 3, device="cpu")[0].tolist())) == [0, 1, 2]


def _shapes(n, seed, d=14):
    """n images of three classes (a square, a bar, a cross) at random
    shifts, and their labels."""
    r = np.random.RandomState(seed)
    ys = np.zeros((n, d, d), np.uint8)
    labels = r.randint(0, 3, n)
    for i, c in enumerate(labels):
        cx, cy = r.randint(4, d - 4, 2)
        if c == 0:
            ys[i, cy - 2:cy + 2, cx - 2:cx + 2] = 255
        elif c == 1:
            ys[i, cy - 1:cy + 1, cx - 4:cx + 4] = 255
        else:
            ys[i, cy - 1:cy + 1, cx - 3:cx + 3] = 255
            ys[i, cy - 3:cy + 3, cx - 1:cx + 1] = 255
    return ys, labels


def test_clustering_cli_matches_jax(tmp_path):
    """Both packages' clustering_mnist on one checkpoint (trained two epochs
    by the JAX package's CLI), Ward's clustering: the same accuracy and
    correlations in results.txt, and the port's z_values those of the JAX
    package's embed_dataset."""
    d = 14
    root = tmp_path / "data"
    (root / "mnist_U").mkdir(parents=True)
    np.save(root / "mnist_U" / "images_train.npy", _shapes(60, 0)[0])
    test, labels = _shapes(40, 1)
    np.save(root / "mnist_U" / "images_test.npy", test)
    np.save(root / "mnist_test.npy", _shapes(40, 2)[0])
    np.save(root / "mnist_U" / "transforms_test.npy", np.random.default_rng(
        3).normal(size=(40, 3)).astype(np.float32))
    np.save(root / "labels.npy", labels)
    logs = tmp_path / "logs"
    jax_train_mnist.main([
        "--dataset", "mnist-U", "--image-dim", str(d), "--z-dim", "2",
        "--groupconv", "4", "--encoder-kernel-number", "16",
        "--encoder-kernel-size", "8", "--encoder-padding", "2",
        "--generator-hidden-dim", "32", "--num-epochs", "2",
        "--minibatch-size", "20", "-d", "-1", "--data-root", str(root),
        "--log-root", str(logs)])
    (run,) = os.listdir(logs)
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        shutil.copy(logs / run / "inference.sav", dirs[name])
    flags = ["--dataset", "mnist-U", "--image-dim", str(d), "--data-root",
             str(root), "--path-to-labels", str(root / "labels.npy"),
             "--clustering", "agglomerative", "--n-clusters", "3", "-d", "-1"]
    jax_clustering_mnist.main(
        flags + ["--path-to-encoder", str(dirs["jax"] / "inference.sav")])
    out = clustering_mnist.main(
        flags + ["--path-to-encoder", str(dirs["port"] / "inference.sav")])
    lines = {name: open(dirs[name] / "results.txt").read().splitlines()[2:]
             for name in dirs}
    assert len(lines["port"]) == len(lines["jax"]) == 3
    for a, b in zip(lines["port"], lines["jax"]):
        head = a[:a.rindex(" is ")]
        assert head == b[:b.rindex(" is ")]
        got = np.array(eval(a[len(head) + 4:].strip()), np.float64)
        ref = np.array(eval(b[len(head) + 4:].strip()), np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4,
                                   err_msg=head)
    jm, jp = jax_cc.load_encoder(str(dirs["jax"] / "inference.sav"))
    z_ref, _, _ = jax_cc.embed_dataset(jm, jp,
                                       np.load(root / "mnist_U" /
                                               "images_test.npy")[..., None]
                                       .astype(np.float32) / 255.0)
    np.testing.assert_allclose(out["z_values"], z_ref, rtol=2e-4, atol=1e-4)
    assert out["acc"] is not None and np.isfinite(out["acc"])
