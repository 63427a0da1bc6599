"""The port's particles, dSprites and galaxy CLIs against the JAX package's:
the parsers, what each train CLI builds from its flags and data (config,
train config, run name, arrays, CTF kernels), whole runs of the train and
clustering CLIs on the CPU (-d -1) at tests/test_cli.py's small widths, the
synthetic particles tool, and the port's imports.
"""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from targetvae_tpu.cli import clustering_dsprites as jax_clustering_dsprites
from targetvae_tpu.cli import clustering_galaxy as jax_clustering_galaxy
from targetvae_tpu.cli import clustering_particles as jax_clustering_particles
from targetvae_tpu.cli import train_dsprites as jax_train_dsprites
from targetvae_tpu.cli import train_galaxy as jax_train_galaxy
from targetvae_tpu.cli import train_particles as jax_train_particles

import targetvae_tpu_torch
from targetvae_tpu_torch.cli import (clustering_dsprites, clustering_galaxy,
                                     clustering_particles, train_dsprites,
                                     train_galaxy, train_particles)
from targetvae_tpu_torch.data import mrc
from targetvae_tpu_torch.train import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 14
# tests/test_cli.py's small widths
COMMON = ["--z-dim", "2", "--groupconv", "4", "--encoder-kernel-number", "16",
          "--encoder-kernel-size", "8", "--encoder-padding", "2",
          "--generator-hidden-dim", "32", "--num-epochs", "2",
          "--minibatch-size", "25", "-d", "-1"]

PAIRS = {"train_particles": (train_particles, jax_train_particles),
         "train_dsprites": (train_dsprites, jax_train_dsprites),
         "train_galaxy": (train_galaxy, jax_train_galaxy),
         "clustering_particles": (clustering_particles,
                                  jax_clustering_particles),
         "clustering_dsprites": (clustering_dsprites, jax_clustering_dsprites),
         "clustering_galaxy": (clustering_galaxy, jax_clustering_galaxy)}


def _actions(parser):
    return sorted((a.option_strings, a.dest, a.default, a.choices, a.type,
                   a.nargs, type(a).__name__) for a in parser._actions)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parser_matches_jax(name):
    """Every flag with the JAX CLI's names, defaults, choices and types (in
    any order: the clustering CLIs declare their shared flags in one
    place)."""
    ours, ref = PAIRS[name]
    assert _actions(ours.build_parser()) == _actions(ref.build_parser())


def _blobs(n, d=D, channels=1, seed=0):
    """tests/test_cli.py's blobs: a 4x4 square a image, uint8."""
    rng = np.random.RandomState(seed)
    ys = np.zeros((n, d, d) + ((channels,) if channels > 1 else ()),
                  np.uint8)
    for i in range(n):
        cx, cy = rng.randint(3, d - 3, 2)
        ys[i, cy - 2:cy + 2, cx - 2:cx + 2] = 255
    return ys


def _ctf_rows(n, seed=0):
    """Astigmatic CTF rows at a 14-px stand-in's physical box (apix ~10)."""
    rng = np.random.RandomState(seed)
    return "\n".join(
        f"{rng.uniform(1, 2.5)} 2.7 300 {rng.uniform(8, 12)} 50 7 "
        f"{rng.uniform(0, 0.5)} {rng.uniform(0, 360)}" for _ in range(n))


@pytest.fixture
def particles(tmp_path):
    """A 60-particle stack (and a 20-px one for --downsample), one CTF table
    for the whole stack and a train/test pair of each, the transforms."""
    rng = np.random.RandomState(0)
    mrc.write(str(tmp_path / "stack.mrcs"),
              rng.randn(60, D, D).astype(np.float32))
    mrc.write(str(tmp_path / "big.mrcs"),
              rng.randn(40, 20, 20).astype(np.float32))
    mrc.write(str(tmp_path / "test.mrcs"),
              rng.randn(20, D, D).astype(np.float32))
    (tmp_path / "ctf.txt").write_text(_ctf_rows(60))
    (tmp_path / "ctf_big.txt").write_text(_ctf_rows(40, 1))
    (tmp_path / "ctf_test.txt").write_text(_ctf_rows(20, 2))
    np.save(tmp_path / "transforms.npy",
            rng.randn(60, 3).astype(np.float32))
    return tmp_path


def _capture(module, monkeypatch):
    """Replace a train CLI's launch_training with one that records what it
    was handed."""
    seen = {}

    def launch(args, model, train_cfg, name, y_train, y_test, ctf_train=None,
               ctf_test=None):
        seen.update(cfg=model.cfg.to_json(), train={
            f: getattr(train_cfg, f) for f in train_cfg.__dataclass_fields__},
            name=name.split("_", 1)[1], arrays=(y_train, y_test, ctf_train,
                                                ctf_test))
    monkeypatch.setattr(module, "launch_training", launch)
    return seen


def _train_cases(root):
    p = lambda f: str(root / f)
    return {
        "particles": (train_particles, jax_train_particles, [
            "--train-path", p("stack.mrcs"), "--ctf-train", p("ctf.txt"),
            "--train-portion", "0.75", "--mask-radius", "5", "--fit-noise",
            "--fourier-expansion", "--normalize"]),
        "particles-pair": (train_particles, jax_train_particles, [
            "--train-path", p("stack.mrcs"), "--test-path", p("test.mrcs"),
            "--ctf-train", p("ctf.txt"), "--ctf-test", p("ctf_test.txt"),
            "--crop", "12"]),
        "particles-downsample": (train_particles, jax_train_particles, [
            "--train-path", p("big.mrcs"), "--ctf-train", p("ctf_big.txt"),
            "--downsample", str(D), "--scale", "1.5", "--train-portion",
            "0.75"]),
        "particles-no-ctf": (train_particles, jax_train_particles, [
            "--train-path", p("stack.mrcs"), "--train-portion", "0.5"]),
        "dsprites": (train_dsprites, jax_train_dsprites, [
            "--train-path", p("ds_train.npy"), "--test-path",
            p("ds_test.npy"), "--image-dim", str(D), "--fourier-expansion"]),
        "dsprites-full": (train_dsprites, jax_train_dsprites, [
            "--train-path", p("ds_train.npy"), "--test-path",
            p("ds_test.npy"), "--image-dim", str(D), "--full-dataset"]),
        "galaxy": (train_galaxy, jax_train_galaxy, [
            "--train-path", p("g_train.npy"), "--test-path", p("g_test.npy"),
            "--image-dim", str(D), "--fourier-expansion",
            "--compute-dtype", "bfloat16"])}


@pytest.mark.parametrize("case", ["particles", "particles-pair",
                                  "particles-downsample", "particles-no-ctf",
                                  "dsprites", "dsprites-full", "galaxy"])
def test_train_cli_builds_what_jax_builds(particles, monkeypatch, case):
    """The port's train CLI and the JAX package's, on the same flags and
    files, hand launch_training the same model config, train config and
    run name (its timestamp aside), the same images and the same CTF
    kernels: float32 arrays equal, the kernels within 1e-6 relative L2 (the
    two CTF table parsers may read a value one ulp apart)."""
    np.save(particles / "ds_train.npy", (_blobs(1200) > 0).astype(np.uint8))
    np.save(particles / "ds_test.npy", (_blobs(150, seed=1) > 0).astype(
        np.uint8))
    np.save(particles / "g_train.npy", _blobs(30, channels=3))
    np.save(particles / "g_test.npy", _blobs(10, channels=3, seed=1))
    ours, ref, flags = _train_cases(particles)[case]
    argv = flags + COMMON
    got, want = _capture(ours, monkeypatch), _capture(ref, monkeypatch)
    ours.main(argv)
    ref.main(argv)
    assert got["cfg"] == want["cfg"]
    assert got["train"] == want["train"]
    assert got["name"] == want["name"]
    for g, w in zip(got["arrays"], want["arrays"]):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        if g.ndim == 3:       # CTF kernels
            assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w)
        else:
            np.testing.assert_array_equal(g, w)


def _runs(log_root):
    return [os.path.join(log_root, r) for r in sorted(os.listdir(log_root))]


def _metric_lines(run):
    log = open(os.path.join(run, "train_log.txt")).read()
    return [line for line in log.splitlines()
            if "\ttrain\t" in line or "\ttest\t" in line]


def _finite_tsv(run, epochs):
    lines = _metric_lines(run)
    assert len(lines) == 2 * epochs
    values = [float(v) for line in lines for v in line.split("\t")[2:]]
    assert np.isfinite(values).all()


def test_train_and_cluster_particles(particles):
    """tests/test_cli.py:186's run on the port: CTF, mask and fit-noise
    through two epochs on the CPU, then clustering_particles on its
    inference.sav with the transforms: finite TSV lines, the _ctf tag, the
    assignments and results.txt with finite correlations."""
    log_root = str(particles / "logs")
    state = train_particles.main([
        "--train-path", str(particles / "stack.mrcs"),
        "--ctf-train", str(particles / "ctf.txt"), "--train-portion", "0.75",
        "--mask-radius", "5", "--fit-noise", "--fourier-expansion",
        "--log-root", log_root] + COMMON)
    (run,) = _runs(log_root)
    assert "_ctf" in os.path.basename(run) and state.step == 4
    _finite_tsv(run, 2)
    _, cfg, _ = load_checkpoint(os.path.join(run, "inference.sav"))
    assert cfg.likelihood.fit_noise and cfg.likelihood.mask_radius == 5
    assert cfg.generator.n_out == 2 and cfg.likelihood.use_ctf

    out = clustering_particles.main([
        "--test-path", str(particles / "stack.mrcs"),
        "--path-to-encoder", os.path.join(run, "inference.sav"),
        "--path-to-transformations", str(particles / "transforms.npy"),
        "--n-clusters", "3", "-d", "-1"])
    cluster = np.load(os.path.join(run, "cluster_assignments.npy"))
    assert cluster.shape == (60,) and set(cluster) <= {0, 1, 2}
    np.testing.assert_array_equal(cluster, out["cluster"])
    assert np.isfinite([out["rot_corr"], *out["tr_corr"]]).all()
    results = open(os.path.join(run, "results.txt")).read()
    assert "circular correlation" in results and "Pearson" in results
    assert not os.path.exists(os.path.join(run, "rotation_hist.jpg"))
    for name in ("tsne.png", "rotation_hist.png", "translation_hist.png"):
        assert os.path.getsize(os.path.join(run, name)) > 0, name


def test_train_and_cluster_particles_downsampled(particles):
    """tests/test_cli.py:258's run on the port: --downsample bins the
    20-px stack to 14 px before training (the CTF pixel size scaled with
    it); the checkpoint carries the binned size, and clustering_particles
    bins the same way and embeds every particle."""
    log_root = str(particles / "logs")
    train_particles.main([
        "--train-path", str(particles / "big.mrcs"),
        "--ctf-train", str(particles / "ctf_big.txt"), "--downsample",
        str(D), "--train-portion", "0.75", "--log-root", log_root] + COMMON)
    (run,) = _runs(log_root)
    _finite_tsv(run, 2)
    _, cfg, _ = load_checkpoint(os.path.join(run, "inference.sav"))
    assert cfg.encoder.image_dim == D
    out = clustering_particles.main([
        "--test-path", str(particles / "big.mrcs"), "--downsample", str(D),
        "--path-to-encoder", os.path.join(run, "inference.sav"),
        "--n-clusters", "3", "--clustering", "k-means", "-d", "-1"])
    assert out["z_values"].shape == (40, 4) and out["rot_corr"] is None
    assert os.path.exists(os.path.join(run, "cluster_assignments.npy"))


def test_train_and_cluster_dsprites(tmp_path):
    """tests/test_cli.py:211's run on the port: dSprites' binary images
    (no /255), 40 / 20 images, then clustering_dsprites against the latent
    labels: results.txt with a finite accuracy and correlations."""
    imgs = (_blobs(60) > 0).astype(np.uint8)
    np.save(tmp_path / "imgs_train.npy", imgs[:40])
    np.save(tmp_path / "imgs_test.npy", imgs[40:])
    lat = np.random.RandomState(0).rand(60, 6).astype(np.float32)
    lat[:, 1] = np.random.RandomState(1).randint(0, 3, 60)
    np.save(tmp_path / "lat_train.npy", lat[:40])
    np.save(tmp_path / "lat_test.npy", lat[40:])
    log_root = str(tmp_path / "logs")
    train_dsprites.main([
        "--train-path", str(tmp_path / "imgs_train.npy"),
        "--test-path", str(tmp_path / "imgs_test.npy"), "--image-dim",
        str(D), "--log-root", log_root] + COMMON[:-4]
        + ["-d", "-1", "--minibatch-size", "20"])
    (run,) = _runs(log_root)
    assert "dsprites" in os.path.basename(run)
    _finite_tsv(run, 2)
    out = clustering_dsprites.main([
        "--train-path", str(tmp_path / "imgs_train.npy"),
        "--test-path", str(tmp_path / "imgs_test.npy"),
        "--train-labels", str(tmp_path / "lat_train.npy"),
        "--test-labels", str(tmp_path / "lat_test.npy"),
        "--path-to-encoder", os.path.join(run, "inference.sav"),
        "--n-clusters", "3", "--minibatch-size", "30", "-d", "-1"])
    assert 0 < out["acc"] <= 1 and out["cluster"].shape == (60,)
    assert np.isfinite([out["rot_corr"], *out["tr_corr"]]).all()
    assert "accuracy for clustering" in open(
        os.path.join(run, "results.txt")).read()


def test_train_and_cluster_galaxy(tmp_path):
    """tests/test_cli.py:240's run on the port: RGB images, three outputs a
    pixel, a 4-layer generator, then clustering_galaxy: the assignments,
    the embeddings and results.txt."""
    imgs = _blobs(60, channels=3)
    np.save(tmp_path / "g_train.npy", imgs[:40])
    np.save(tmp_path / "g_test.npy", imgs[40:])
    log_root = str(tmp_path / "logs")
    train_galaxy.main([
        "--train-path", str(tmp_path / "g_train.npy"),
        "--test-path", str(tmp_path / "g_test.npy"), "--image-dim", str(D),
        "--log-root", log_root] + COMMON[:-4]
        + ["-d", "-1", "--minibatch-size", "20"])
    (run,) = _runs(log_root)
    _finite_tsv(run, 2)
    _, cfg, _ = load_checkpoint(os.path.join(run, "inference.sav"))
    assert cfg.generator.n_out == 3 and cfg.generator.num_layers == 4
    assert cfg.encoder.in_channels == 3
    out = clustering_galaxy.main([
        "--train-path", str(tmp_path / "g_train.npy"),
        "--test-path", str(tmp_path / "g_test.npy"),
        "--path-to-encoder", os.path.join(run, "inference.sav"),
        "--n-clusters", "3", "--minibatch-size", "30", "-d", "-1"])
    np.testing.assert_array_equal(
        np.load(os.path.join(run, "cluster_assignments.npy")), out["cluster"])
    np.testing.assert_array_equal(
        np.load(os.path.join(run, "z_values.npy")), out["z_values"])
    assert os.path.exists(os.path.join(run, "results.txt"))


@pytest.mark.parametrize("module,flags", [
    (train_particles, ["--train-path", "stack.mrcs"]),
    (train_dsprites, ["--train-path", "ds.npy", "--test-path", "ds.npy"]),
    (train_galaxy, [])])
def test_train_clis_run_on_cuda_by_default(particles, module, flags):
    """Without -d each CLI asks for cuda:0; with no CUDA device it raises
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([str(particles / f) if f.endswith((".mrcs", ".npy"))
                     else f for f in flags]
                    + ["--log-root", str(particles / "logs")])
    assert not os.path.exists(particles / "logs")


def test_synthetic_particles_tools_write_identical_files(tmp_path):
    """tools/make_synthetic_particles_torch.py (the port's ctf_filter and
    mrc.write, no pandas) and tools/make_synthetic_particles.py (the JAX
    package's, pandas) write the same bytes for one seed."""
    for tool, out in (("make_synthetic_particles.py", "jax"),
                      ("make_synthetic_particles_torch.py", "port")):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", tool), "--out-root",
             str(tmp_path / out), "--n-train", "6", "--n-test", "4",
             "--image-dim", "16", "--seed", "3"], check=True,
            capture_output=True)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 8
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_port_imports_neither_jax_nor_pandas():
    """Every module of the port imported in a fresh interpreter leaves jax,
    the JAX package and pandas out of sys.modules (the card has none of
    them)."""
    modules = [m.name for m in pkgutil.walk_packages(
        targetvae_tpu_torch.__path__, "targetvae_tpu_torch.")]
    assert "targetvae_tpu_torch.cli.train_particles" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'targetvae_tpu', 'pandas')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_particles_protocol_tool_runs(tmp_path):
    """tools/particles_protocol_torch.py end to end on the CPU at a tiny
    size (36-px stand-in, one epoch, narrow widths): its JSON line holds a
    finite accuracy and correlations, one test ELBO and one epoch rate."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "particles_protocol_torch.py"),
         "--root", str(tmp_path), "--n-train", "30", "--n-test", "12",
         "--image-dim", "36", "--epochs", "1", "--device", "-1",
         "--extra=--encoder-kernel-number 16 --generator-hidden-dim 32 "
         "--minibatch-size 10"], check=True, capture_output=True, text=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["epochs_run"] == 1 and len(res["epoch_img_s"]) == 1
    assert 0 < res["accuracy"] <= 1
    assert np.isfinite([res["rotation_circular_all"],
                        *res["translation_pearson"], *res["test_elbo"],
                        *res["rotation_circular_by_class"].values()]).all()
