"""The clustering figures of the port (targetvae_tpu_torch/utils/png.py,
cli/tsne.py, cli/figures.py) against what the JAX package calls:
matplotlib's image reader and colour maps, scikit-learn's t-SNE; and the
four clustering CLIs writing their figures as .png on the CPU.

Tolerances: PNG pixels bitwise; colour maps 1/255 of matplotlib's; the
t-SNE's P 1e-6 of scikit-learn's _joint_probabilities_nn (both float64
searches, the port's distances float64 where scikit-learn's are float32);
at N = 300 the final KL at most 1.1x scikit-learn's and the
trustworthiness at least scikit-learn's - 0.02 (the port's repulsion is
exact where scikit-learn's is Barnes-Hut's, and its random start another
draw).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg")

from targetvae_tpu_torch import TargetVAE  # noqa: E402
from targetvae_tpu_torch.cli import figures, tsne  # noqa: E402
from targetvae_tpu_torch.cli import (clustering_dsprites,  # noqa: E402
                                     clustering_galaxy, clustering_mnist,
                                     clustering_particles)
from targetvae_tpu_torch.data import mrc  # noqa: E402
from targetvae_tpu_torch.train.checkpoint import save_model_pair  # noqa: E402
from targetvae_tpu_torch.utils.config import (EncoderConfig,  # noqa: E402
                                              GeneratorConfig,
                                              LikelihoodConfig, ModelConfig)
from targetvae_tpu_torch.utils.png import (encode_png, png_size,  # noqa: E402
                                           write_png)


def _decode_by_hand(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG of filter-0 rows, read with struct and zlib."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc, kind
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, colour, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, colour) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 40)])
def test_png_round_trip(tmp_path, shape):
    import matplotlib.image as mimage

    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, rgb)
    assert np.array_equal(_decode_by_hand(open(path, "rb").read()), rgb)
    back = mimage.imread(path)
    assert back.shape == rgb.shape
    assert np.array_equal(np.round(back * 255).astype(np.uint8), rgb)
    assert png_size(path) == shape
    assert encode_png(rgb) == open(path, "rb").read()


def test_png_size_refuses_what_is_not_a_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        png_size(str(path))
    good = bytearray(encode_png(np.zeros((3, 4, 3), np.uint8)))
    good[20] ^= 1                                  # inside IHDR's width
    path.write_bytes(bytes(good))
    with pytest.raises(ValueError, match="CRC"):
        png_size(str(path))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((3, 4, 3), np.float32))


@pytest.mark.parametrize("name", ["rainbow", "Blues"])
def test_colour_maps_match_matplotlib(name):
    x = np.concatenate([np.linspace(0, 1, 1001), np.random.default_rng(
        0).uniform(size=5000), [1 / 256, 255 / 256, -0.1, 1.1]])
    ref = matplotlib.colormaps[name](x)[:, :3]
    got = {"rainbow": figures.rainbow, "Blues": figures.blues}[name](x)
    assert np.abs(got - ref).max() <= 1 / 255


def test_label_colours_follow_the_boundary_norm():
    from matplotlib import colors

    cmap = matplotlib.colormaps["rainbow"]
    norm = colors.BoundaryNorm(np.arange(0, 11, 1), cmap.N)
    labels = np.arange(-2, 15)
    ref = cmap(norm(labels))[:, :3]
    got = figures.label_colours(labels) / 255.0
    assert np.abs(got - ref).max() <= 1 / 255


def test_confusion_counts_match_scikit_learn():
    from sklearn.metrics import confusion_matrix

    from targetvae_tpu_torch.cli.clustering_common import cluster_acc

    rng = np.random.default_rng(2)
    labels = rng.integers(0, 4, 200)
    cluster = (labels + (rng.uniform(size=200) < 0.3)) % 4
    mapping, _ = cluster_acc(labels, cluster)
    ref = confusion_matrix(labels, cluster)[:, np.array(mapping[1])]
    np.testing.assert_array_equal(
        figures.confusion_counts(labels, cluster, mapping), ref)
    img = figures.confusion_image(ref)
    assert img.dtype == np.uint8 and img.shape[0] == img.shape[1]
    # the heat map's darkest cell holds the greatest count
    cell = (img.shape[0] - 80) // 4
    i, j = np.unravel_index(np.argmax(ref), ref.shape)
    corner = img[40 + i * cell + 1, 40 + j * cell + 1]
    np.testing.assert_array_equal(corner, figures._to_uint8(figures.blues(
        1.0)))


def test_histograms_take_numpys_edges(tmp_path):
    import matplotlib.pyplot as plt

    v = np.random.default_rng(3).normal(size=500)
    counts, edges = np.histogram(v, bins=50)
    n, bins, _ = plt.hist(v, bins=50)
    plt.close()
    np.testing.assert_array_equal(edges, bins)
    np.testing.assert_array_equal(counts, n)
    path = str(tmp_path / "h.png")
    figures.save_histograms(path, [v, v + 1])
    assert png_size(path) == (500, 800)


@pytest.fixture
def one_thread():
    """One thread for torch and for scikit-learn's OpenMP pools while a test
    runs t-SNEs on the CPU: their thousands of small operations, threaded,
    contend for the cores with the suite's other workers and take minutes
    instead of seconds."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def _clusters(n_per=60, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(5, 4)) * 3
    return np.concatenate([c + rng.normal(size=(n_per, 4))
                           for c in centres]).astype(np.float32)


def test_joint_probabilities_match_scikit_learn():
    from sklearn.manifold._t_sne import _joint_probabilities_nn
    from sklearn.neighbors import NearestNeighbors

    x = _clusters()
    n = len(x)
    for perplexity in (30.0, 5.0):
        k = min(n - 1, int(3 * perplexity + 1))
        dist = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
            mode="distance")
        dist.data **= 2
        ref = _joint_probabilities_nn(dist, perplexity, 0).toarray()
        r, c, v = tsne.joint_probabilities(torch.from_numpy(x), perplexity)
        got = np.zeros((n, n))
        got[r.numpy(), c.numpy()] = v.numpy()
        assert np.abs(got - ref).max() <= 1e-6
        assert abs(got.sum() - 1) < 1e-12 and np.array_equal(got, got.T)


def test_binary_search_matches_scikit_learn():
    from sklearn.manifold._utils import _binary_search_perplexity

    d = np.random.default_rng(4).uniform(0, 20, (50, 31)).astype(np.float32)
    d[0] = 0.0                                      # a row of duplicates
    d[1, :3] = 1e-30                                # near-zero distances
    ref = _binary_search_perplexity(d, 10.0, 0)
    got = tsne.binary_search_perplexity(torch.from_numpy(d.astype(
        np.float64)), 10.0).numpy()
    assert np.abs(got - ref).max() <= 1e-6


def test_tsne_matches_scikit_learn_quality(one_thread):
    from sklearn.manifold import TSNE, trustworthiness

    x = _clusters()
    ref = TSNE(2, learning_rate=200.0, init="random", random_state=0)
    emb_ref = ref.fit_transform(x)
    emb, kl = tsne.tsne(x, device="cpu", seed=0)
    assert emb.shape == (300, 2) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    assert kl <= 1.1 * ref.kl_divergence_, (kl, ref.kl_divergence_)
    assert trustworthiness(x, emb) >= trustworthiness(x, emb_ref) - 0.02
    again, kl2 = tsne.tsne(x, device="cpu", seed=0)
    assert np.array_equal(again, emb) and kl2 == kl


def test_tsne_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsne.tsne(_clusters(10))
    with pytest.raises(ValueError, match="perplexity"):
        tsne.tsne(_clusters(4)[:20], device="cpu")


# ---- the clustering CLIs' figures ----

D = 14


def _checkpoint(root, in_channels=1, n_out=1, kind="bernoulli"):
    cfg = ModelConfig(
        GeneratorConfig(hidden_dim=32, n_out=n_out),
        EncoderConfig(image_dim=D, in_channels=in_channels, kernels_num=16,
                      kernels_size=7, padding=3, groupconv=4),
        LikelihoodConfig(kind=kind))
    params = TargetVAE(cfg, "cpu").init(torch.Generator().manual_seed(0))
    os.makedirs(root, exist_ok=True)
    save_model_pair(str(root), params, cfg)
    return str(root / "inference.sav")


def _blobs(n, seed, channels=None):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:D, :D]
    imgs = np.stack([np.exp(-((xx - rng.uniform(4, 10)) ** 2
                              + (yy - rng.uniform(4, 10)) ** 2) / 6)
                     for _ in range(n)])
    imgs = (255 * imgs).astype(np.uint8)
    return imgs if channels is None else np.repeat(imgs[..., None],
                                                   channels, -1)


def _assert_pngs(run, names, capsys):
    for name in names:
        h, w = png_size(os.path.join(run, name))
        assert h > 0 and w > 0, name
    assert not any(f.endswith(".jpg") for f in os.listdir(run))
    assert "not written" not in capsys.readouterr().err


def test_clustering_clis_write_their_png_figures(tmp_path, capsys,
                                                one_thread):
    # MNIST: labels, so the confusion matrix too
    data = tmp_path / "data"
    (data / "mnist_U").mkdir(parents=True)
    np.save(data / "mnist_U" / "images_test.npy", _blobs(40, 0))
    np.save(data / "labels.npy", np.arange(40) % 3)
    enc = _checkpoint(tmp_path / "mnist")
    clustering_mnist.main([
        "--dataset", "mnist-U", "--image-dim", str(D), "--data-root",
        str(data), "--path-to-encoder", enc, "--path-to-labels",
        str(data / "labels.npy"), "--n-clusters", "3", "-d", "-1"])
    _assert_pngs(tmp_path / "mnist", ["tsne.png", "confusion_matrix.png"],
                 capsys)

    # particles: the histograms
    stack = _blobs(40, 1).astype(np.float32)
    mrc.write(str(tmp_path / "stack.mrcs"), stack)
    enc = _checkpoint(tmp_path / "particles", kind="gaussian")
    clustering_particles.main([
        "--test-path", str(tmp_path / "stack.mrcs"), "--normalize",
        "--path-to-encoder", enc, "--n-clusters", "3", "-d", "-1"])
    run = tmp_path / "particles"
    _assert_pngs(run, ["tsne.png", "rotation_hist.png",
                       "translation_hist.png"], capsys)
    assert png_size(str(run / "rotation_hist.png")) == (500, 800)

    # dSprites: the shape labels' confusion matrix
    imgs = (_blobs(40, 2) > 128).astype(np.uint8)
    np.save(tmp_path / "ds_train.npy", imgs[:30])
    np.save(tmp_path / "ds_test.npy", imgs[30:])
    lat = np.random.default_rng(5).uniform(size=(40, 6)).astype(np.float32)
    lat[:, 1] = np.arange(40) % 3
    np.save(tmp_path / "lat_train.npy", lat[:30])
    np.save(tmp_path / "lat_test.npy", lat[30:])
    enc = _checkpoint(tmp_path / "dsprites")
    clustering_dsprites.main([
        "--train-path", str(tmp_path / "ds_train.npy"),
        "--test-path", str(tmp_path / "ds_test.npy"),
        "--train-labels", str(tmp_path / "lat_train.npy"),
        "--test-labels", str(tmp_path / "lat_test.npy"),
        "--path-to-encoder", enc, "--n-clusters", "3", "-d", "-1"])
    _assert_pngs(tmp_path / "dsprites", ["tsne.png", "confusion_matrix.png"],
                 capsys)

    # galaxy: RGB, the z-scatter at z_dim 2
    rgb = _blobs(40, 3, channels=3)
    np.save(tmp_path / "g_train.npy", rgb[:30])
    np.save(tmp_path / "g_test.npy", rgb[30:])
    enc = _checkpoint(tmp_path / "galaxy", in_channels=3, n_out=3)
    clustering_galaxy.main([
        "--train-path", str(tmp_path / "g_train.npy"),
        "--test-path", str(tmp_path / "g_test.npy"),
        "--path-to-encoder", enc, "--n-clusters", "3", "-d", "-1"])
    _assert_pngs(tmp_path / "galaxy", ["tsne.png", "z_vals.png"], capsys)
    assert png_size(str(tmp_path / "galaxy" / "z_vals.png")) == (1000, 1000)
