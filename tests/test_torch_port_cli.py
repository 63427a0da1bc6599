"""The port's MNIST train CLI against the JAX package's: the parsers, the
configs built from them, the data loaders, the run directory a run writes,
device selection and resume.

Runs on the CPU (-d -1) at the small widths of tests/test_cli.py and
tests/test_resume.py. The resume test holds the resumed run to the
uninterrupted one at rtol 1e-5, as tests/test_resume.py does.
"""

import os

import numpy as np
import pytest
import torch

from targetvae_tpu.cli import common as jax_common
from targetvae_tpu.cli import train_mnist as jax_train_mnist
from targetvae_tpu.data import datasets as jax_datasets

from targetvae_tpu_torch.cli import common, train_mnist
from targetvae_tpu_torch.cli.clustering_common import load_encoder
from targetvae_tpu_torch.data import datasets

D = 12
ARGS = ["--dataset", "mnist-U", "--image-dim", str(D), "--z-dim", "2",
        "--groupconv", "4", "--encoder-kernel-number", "16",
        "--encoder-kernel-size", "8", "--encoder-padding", "2",
        "--generator-hidden-dim", "32", "--minibatch-size", "20", "-d", "-1"]


def _blobs(n, seed, d=D):
    r = np.random.RandomState(seed)
    ys = np.zeros((n, d, d), np.uint8)
    for i in range(n):
        cx, cy = r.randint(3, d - 3, 2)
        ys[i, cy - 2:cy + 2, cx - 2:cx + 2] = 255
    return ys


@pytest.fixture
def data_root(tmp_path):
    root = tmp_path / "data"
    for sub in ("mnist_U", "mnist_N"):
        (root / sub).mkdir(parents=True)
        np.save(root / sub / "images_train.npy", _blobs(50, 0))
        np.save(root / sub / "images_test.npy", _blobs(30, 1))
    np.save(root / "mnist_train.npy", _blobs(10, 2, 8))
    np.save(root / "mnist_test.npy", _blobs(10, 3, 8))
    return str(root)


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.type, a.nargs,
             type(a).__name__) for a in parser._actions]


def test_parser_matches_jax():
    """Every flag with the JAX CLI's names, defaults, choices and types."""
    assert _actions(train_mnist.build_parser()) == \
        _actions(jax_train_mnist.build_parser())


@pytest.mark.parametrize("extra", [
    [], ["--dataset", "mnist-N", "-z", "3", "--fourier-expansion",
         "--compute-dtype", "bfloat16", "--activation", "tanh",
         "--generator-resid-layers", "--seed", "4", "-l", "1e-3"]])
def test_configs_from_args_match_jax(extra):
    args = train_mnist.build_parser().parse_args(ARGS + extra)
    jargs = jax_train_mnist.build_parser().parse_args(ARGS + extra)
    kw = dict(n_out=1, theta_prior=np.pi / 4, normal_prior_over_r=True)
    cfg = common.model_config_from_args(
        args, D, likelihood=common.LikelihoodConfig(), **kw)
    jcfg = jax_common.model_config_from_args(
        jargs, D, likelihood=jax_common.LikelihoodConfig(), **kw)
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.generator.fourier_sigma == 2.0 / (D - 1)
    ours = common.train_config_from_args(args)
    ref = jax_common.train_config_from_args(jargs)
    assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
        {f: getattr(ref, f) for f in ref.__dataclass_fields__}


@pytest.mark.parametrize("dataset,dim", [("mnist-U", D), ("mnist-N", D),
                                         ("mnist", D), ("mnist", 8)])
def test_load_mnist_matches_jax(data_root, dataset, dim):
    for split in ("train", "test"):
        got = datasets.load_mnist(dataset, dim, data_root, split)
        ref = jax_datasets.load_mnist(dataset, dim, data_root, split)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_load_mnist_names_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="mnist_train.npy"):
        datasets.load_mnist("mnist", D, str(tmp_path), "train")


def test_select_device_never_falls_back_to_the_cpu():
    assert common.select_device(-1) == torch.device("cpu")
    if torch.cuda.is_available():
        assert common.select_device(0) == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.select_device(0)


def test_train_mnist_runs_on_cuda_by_default(data_root, tmp_path):
    """Without -d the CLI asks for cuda:0; with no CUDA device it raises
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only refusal")
    args = [a for a in ARGS if a not in ("-d", "-1")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mnist.main(args + ["--data-root", data_root,
                                 "--log-root", str(tmp_path / "logs")])
    assert not os.path.exists(tmp_path / "logs")


def _one_run(log_root):
    runs = os.listdir(log_root)
    assert len(runs) == 1
    return os.path.join(log_root, runs[0])


def test_train_mnist_writes_the_jax_run_dir(data_root, tmp_path):
    """The same args (-d -1, 4 epochs, snapshots every 2) give the same
    run-directory name (past its minute), files and log: the header byte
    for byte and the same TSV rows, in order."""
    runs = {}
    for name, cli in (("ours", train_mnist), ("ref", jax_train_mnist)):
        log_root = str(tmp_path / name)
        cli.main(ARGS + ["--data-root", data_root, "--log-root", log_root,
                         "--num-epochs", "4", "--save-interval", "2"])
        runs[name] = _one_run(log_root)
    ours, ref = runs["ours"], runs["ref"]
    stamp = len("2026-10-17-12-00")
    assert os.path.basename(ours)[stamp:] == os.path.basename(ref)[stamp:]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == sorted(
        ["train_log.txt", "training_state.sav", "inference.sav",
         "generator.sav", "inference_epoch2.sav", "generator_epoch2.sav",
         "inference_epoch4.sav", "generator_epoch4.sav"])

    def shape(run):
        """(the header, with the run name's timestamp and the log root in
        the args taken out; the (epoch, split) of each TSV row). The
        controllers' lines follow each package's own ELBOs."""
        text = open(os.path.join(run, "train_log.txt")).read()
        head, _, rows = text.partition("Epoch\tSplit")
        head = head[stamp:].replace(os.path.dirname(run), "LOG_ROOT")
        return head, [tuple(l.split("\t")[:2]) for l in rows.split("\n")
                      if l[:1].isdigit()]
    assert shape(ours) == shape(ref)
    assert len(shape(ours)[1]) == 8


def test_cli_resume_continues(data_root, tmp_path):
    """tests/test_resume.py for the port: 2 epochs, then a resume to 4,
    against 4 epochs straight through."""
    base = ARGS + ["--data-root", data_root, "--seed", "7"]
    log_a, log_b = str(tmp_path / "logs_a"), str(tmp_path / "logs_b")
    train_mnist.main(base + ["--log-root", log_a, "--num-epochs", "4"])
    train_mnist.main(base + ["--log-root", log_b, "--num-epochs", "2"])
    run_b = _one_run(log_b)
    state = train_mnist.main(base + ["--log-root", log_b, "--num-epochs", "4",
                                     "--resume", run_b])
    assert state.step == 4 * 3

    def tsv(run):
        rows = {}
        for line in open(os.path.join(run, "train_log.txt")):
            parts = line.strip().split("\t")
            if len(parts) == 5 and parts[1] in ("train", "test"):
                rows[(int(parts[0]), parts[1])] = float(parts[2])
        return rows

    a, b = tsv(_one_run(log_a)), tsv(run_b)
    assert (4, "train") in b and (4, "test") in b
    for key in [(3, "train"), (4, "train"), (3, "test"), (4, "test")]:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-5)
    # the CLI's handoff: the encoder of the run's best epoch
    model, params = load_encoder(os.path.join(run_b, "inference.sav"),
                                 device="cpu")
    assert model.cfg.encoder.image_dim == D and "encoder" in params


def test_profile_dir_and_debug_nans(data_root, tmp_path):
    """--profile-dir writes one epoch's torch.profiler trace; --debug-nans
    turns on autograd's anomaly detection."""
    prof = str(tmp_path / "prof")
    try:
        train_mnist.main(ARGS + ["--data-root", data_root, "--log-root",
                                 str(tmp_path / "logs"), "--num-epochs", "2",
                                 "--profile-dir", prof, "--debug-nans"])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
