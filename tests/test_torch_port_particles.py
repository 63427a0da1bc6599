"""The port's particles vertical against the JAX package on the CPU: MRC IO,
the CTF tables and kernels, the image preprocessing, the Gaussian / fit-noise
/ CTF / mask likelihood, the particles ELBO and its gradients, and the
Trainer's epochs with CTF kernels.

Inputs are made with numpy from a seed and handed to both sides. Every
tolerance is stated where it is used, with its reason.
"""

import io
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

import targetvae_tpu.models.encoders as jax_enc
from targetvae_tpu.data import ctf as jax_ctf
from targetvae_tpu.data import datasets as jax_datasets
from targetvae_tpu.data import image as jax_image
from targetvae_tpu.data import mrc as jax_mrc
from targetvae_tpu.losses import likelihoods as jax_lik
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.utils import config as jcfg

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.data import ctf, datasets, image, mrc
from targetvae_tpu_torch.losses import likelihoods as lik
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.train import Trainer
from targetvae_tpu_torch.utils.config import TrainConfig
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

REPO_TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
D = 16          # the particles config's image size (kc = D - 1 = 15)
B = 4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _ctf_table(n, seed=0):
    """n CTF rows at a 16-px stand-in's physical box (apix ~10 A, as
    tests/test_quality.py keeps it), with astigmatic dfdiff / dfang draws
    and B-factors."""
    rng = np.random.RandomState(seed)
    return {"defocus": rng.uniform(1.0, 2.5, n), "cs": np.full(n, 2.7),
            "voltage": np.full(n, 300.0), "apix": rng.uniform(8.0, 12.0, n),
            "bfactor": rng.uniform(0.0, 100.0, n),
            "ampcont": np.full(n, 7.0), "dfdiff": rng.uniform(0.0, 0.5, n),
            "dfang": rng.uniform(0.0, 360.0, n)}


def _write_table(path, table):
    pd.DataFrame(table).to_csv(path, sep=" ", header=False, index=False)


# ---- MRC ----

@pytest.mark.parametrize("dtype,shape", [
    (np.float32, (5, 7, 9)), (np.float32, (6, 8)), (np.int16, (3, 4, 4)),
    (np.uint16, (2, 5, 3)), (np.int8, (4, 6, 6))])
def test_mrc_write_is_byte_identical_to_jax(tmp_path, dtype, shape):
    rng = np.random.RandomState(0)
    arr = (rng.randn(*shape) * 50).astype(dtype)
    buf_ours, buf_ref = io.BytesIO(), io.BytesIO()
    mrc.write(buf_ours, arr)
    jax_mrc.write(buf_ref, arr)
    assert buf_ours.getvalue() == buf_ref.getvalue()
    mrc.write(str(tmp_path / "a.mrcs"), arr, ax=2.5, gamma=90.0)
    jax_mrc.write(str(tmp_path / "b.mrcs"), arr, ax=2.5, gamma=90.0)
    assert (tmp_path / "a.mrcs").read_bytes() == (tmp_path / "b.mrcs").read_bytes()


@pytest.mark.parametrize("ext", [b"", b"EXTENDED-HEADER!" * 4])
def test_mrc_parse_and_read_mmap_round_trip(tmp_path, ext):
    arr = np.random.RandomState(1).randn(4, 6, 5).astype(np.float32)
    path = str(tmp_path / "s.mrcs")
    mrc.write(path, arr, extended_header=ext)
    with open(path, "rb") as f:
        content = f.read()
    got, header, extended = mrc.parse(content)
    np.testing.assert_array_equal(got, arr)
    assert extended == ext and int(header["next"]) == len(ext)
    assert (int(header["nx"]), int(header["ny"]), int(header["nz"])) == (5, 6, 4)
    assert header.tobytes() == jax_mrc.parse_header(content).tobytes()
    mm, mh = mrc.read_mmap(path)
    np.testing.assert_array_equal(np.asarray(mm), arr)
    assert float(mh["amax"]) == pytest.approx(float(arr.max()))
    # a one-image stack parses to 2-D, as the reference squeezes it
    mrc.write(path, arr[0])
    assert mrc.parse(open(path, "rb").read())[0].shape == (6, 5)


# ---- CTF ----

def test_parse_ctf_reads_the_columns_without_pandas(tmp_path):
    """The table's float64 values back exactly (the file holds their
    round-trip reprs); pandas' default C parser, which the JAX package
    reads with, is not correctly rounded and may sit one ulp away."""
    table = _ctf_table(7)
    path = str(tmp_path / "ctf.txt")
    _write_table(path, table)
    got = ctf.parse_ctf(path)
    ref = jax_ctf.parse_ctf(path)
    assert list(got) == ctf.CTF_COLUMNS == list(ref.columns)
    for name in ctf.CTF_COLUMNS:
        assert got[name].dtype == np.float64
        np.testing.assert_array_equal(got[name], table[name])
        np.testing.assert_allclose(got[name], ref[name].to_numpy(),
                                   rtol=1e-15, atol=0)


@pytest.mark.parametrize("n,m,scale", [(15, 15, 1.0), (9, 13, 1.0),
                                       (15, 15, 110 / 16)])
def test_ctf_filter_matches_jax(n, m, scale):
    """The same float64 phase on both sides: within 1e-6 relative L2, per
    particle, of the JAX package's kernels from a DataFrame of the same
    columns (astigmatic rows included)."""
    table = _ctf_table(6, seed=2)
    got = ctf.ctf_filter(table, n, m, scale=scale)
    ref = jax_ctf.ctf_filter(pd.DataFrame(table), n, m, scale=scale)
    assert got.shape == ref.shape == (6, n, m) and got.dtype == np.float32
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-6


def test_ctf_kernels_are_half_turn_symmetric():
    """A CTF is even in frequency, so each odd-sized kernel equals itself
    turned by half a turn: correlation and convolution agree on it, and the
    flip convention of ctf_apply needs another kernel to be tested."""
    kern = ctf.ctf_filter(_ctf_table(3, seed=4), 15, 15)
    np.testing.assert_allclose(kern, kern[:, ::-1, ::-1], atol=1e-6)


# ---- image preprocessing ----

@pytest.mark.parametrize("size,out", [((20, 20), (14, 14)), ((20, 20), (13, 13)),
                                      ((21, 21), (15, 15)), ((16, 16), (9, 9))])
def test_downsample_matches_jax(size, out):
    x = np.random.RandomState(3).randn(5, *size).astype(np.float32)
    got = image.downsample(x, shape=out)
    ref = jax_image.downsample(x, shape=out)
    assert got.shape == (5,) + out and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius", [None, 5.0])
def test_crop_and_normalize_match_jax(radius):
    x = np.random.RandomState(4).randn(6, 18, 18).astype(np.float32) * 3 + 1
    np.testing.assert_array_equal(image.crop(x, 12), jax_image.crop(x, 12))
    np.testing.assert_allclose(image.normalize(x, radius),
                               jax_image.normalize(x, radius),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("crop,normalize", [(0, False), (10, True), (0, True)])
def test_preprocess_and_split_match_jax(crop, normalize):
    x = np.random.RandomState(5).randn(9, 14, 14).astype(np.float32) * 2 + 3
    got = datasets.preprocess_particles(x, crop, normalize)
    ref = jax_datasets.preprocess_particles(x, crop, normalize)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for g, r in zip(datasets.train_test_split(x, 0.7),
                    jax_datasets.train_test_split(x, 0.7)):
        np.testing.assert_array_equal(g, r)


def test_load_particles_matches_jax(tmp_path):
    """A .mrcs file, a .npy file and a directory of stacks (in name
    order), read through the port's mmap against the JAX package's
    loader."""
    rng = np.random.RandomState(6)
    a, b = rng.randn(3, 8, 8).astype(np.float32), rng.randn(2, 8, 8).astype(
        np.float32)
    (tmp_path / "dir").mkdir()
    mrc.write(str(tmp_path / "dir" / "b.mrcs"), b)
    mrc.write(str(tmp_path / "dir" / "a.mrc"), a)
    np.save(tmp_path / "s.npy", a)
    for path in ("dir", "dir/a.mrc", "s.npy"):
        got = datasets.load_particles(str(tmp_path / path))
        ref = jax_datasets.load_particles(str(tmp_path / path))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        datasets.load_particles(str(tmp_path / "dir")), np.concatenate([a, b]))
    with pytest.raises(ValueError, match="unrecognized"):
        datasets.load_particles(str(tmp_path / "s.txt"))


@pytest.mark.parametrize("scale255,limit,channels", [
    (False, (5, 3), 1), (True, None, 3)])
def test_load_npy_split_matches_jax(tmp_path, scale255, limit, channels):
    rng = np.random.RandomState(7)
    shape = (8, 10, 10) + ((channels,) if channels > 1 else ())
    np.save(tmp_path / "tr.npy", rng.randint(0, 256, shape).astype(np.uint8))
    np.save(tmp_path / "te.npy", rng.randint(0, 256, shape).astype(np.uint8))
    got = datasets.load_npy_split(str(tmp_path / "tr.npy"),
                                  str(tmp_path / "te.npy"), scale255, limit)
    ref = jax_datasets.load_npy_split(str(tmp_path / "tr.npy"),
                                      str(tmp_path / "te.npy"), scale255, limit)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape[-1] == channels
        np.testing.assert_array_equal(g, r)


# ---- the likelihood ----

def _asymmetric_kernels(b, kc, seed=8):
    """Random kernels with no symmetry: a flipped (convolution) or shifted
    kernel gives another answer."""
    return np.random.RandomState(seed).randn(b, kc, kc).astype(np.float32)


@pytest.mark.parametrize("n,kc", [(16, 15), (15, 15), (12, 7), (9, 13)])
def test_ctf_apply_by_fft_matches_the_exact_convolution(n, kc):
    """The FFT route against the JAX package's exact grouped convolution (a
    cross-correlation, as torch's conv2d), asymmetric kernels: float32
    transforms of sums of n^2 terms, within 1e-5 relative L2 per image. The
    flipped kernel (a convolution) is far from it."""
    y = np.random.RandomState(9).randn(3, n, n).astype(np.float32)
    k = _asymmetric_kernels(3, kc)
    got = lik.ctf_apply(torch.from_numpy(y), torch.from_numpy(k)).numpy()
    ref = np.asarray(jax_lik.ctf_apply(jnp.asarray(y), jnp.asarray(k)))
    assert got.shape == ref.shape == (3, n, n)
    for g, r in zip(got, ref):
        assert _rel(g, r) < 1e-5
    flipped = lik.ctf_apply(torch.from_numpy(y),
                            torch.from_numpy(k[:, ::-1, ::-1].copy())).numpy()
    assert _rel(flipped, ref) > 0.1
    # torch's own grouped conv2d computes the same correlation
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(y)[None], torch.from_numpy(k)[:, None],
        padding=kc // 2, groups=3)[0].numpy()
    assert _rel(got, conv) < 1e-5


@pytest.mark.parametrize("n", [16, 15])
def test_circular_mask_matches_jax(n):
    dx = np.random.RandomState(10).uniform(-0.3, 0.3, (5, 2)).astype(
        np.float32)
    btw = 2.0 / (n - 1)
    got = lik.circular_mask(torch.from_numpy(dx), n, 5, btw).numpy()
    ref = np.asarray(jax_lik.circular_mask(jnp.asarray(dx), n, 5, btw))
    assert got.shape == (5, n * n) and got.dtype == bool
    np.testing.assert_array_equal(got, ref)


def _lik_inputs(fit_noise, seed=11):
    rng = np.random.RandomState(seed)
    n_out = 2 if fit_noise else 1
    y_hat = rng.randn(B, D * D, n_out).astype(np.float32) * 0.5
    if fit_noise:
        y_hat[..., 1] = rng.uniform(-1.0, 1.0, (B, D * D))
    y = rng.randn(B, D, D, 1).astype(np.float32)
    dx = rng.uniform(-0.3, 0.3, (B, 2)).astype(np.float32)
    return y_hat, y, dx


def _jax_filtered(monkeypatch):
    """The port's likelihood fed the JAX package's exact convolution in
    place of its FFT route: both sides then filter to the same values, and
    what is compared is the likelihood's assembly alone."""
    monkeypatch.setattr(lik, "ctf_apply", lambda y, k: torch.from_numpy(
        np.array(jax_lik.ctf_apply(jnp.asarray(y.detach().numpy()),
                                     jnp.asarray(k.numpy())))))


@pytest.mark.parametrize("fit_noise", [False, True])
@pytest.mark.parametrize("use_ctf", [False, True])
@pytest.mark.parametrize("mask_radius", [0, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_gaussian_log_prob_matches_jax(monkeypatch, fit_noise, use_ctf,
                                       mask_radius, weighted):
    """Each combination of fit_noise x CTF x mask, batch mean or row weights,
    with the CTF kernels ctf_filter makes (the filtered variance goes
    negative in places, as in the JAX package).

    On the same filtered values (the JAX convolution on both sides):
    float32 sums of 256 terms, within 1e-5 relative. Through the port's
    own FFT route: without fit_noise within 1e-5 relative as well; with
    fit_noise and the CTF the filtered variance v crosses zero, where
    (mu - y)^2 / v turns the two filters' rounding (ctf_apply's 1e-5 of
    each image's largest |v|) into any size, so there the bound adds that
    rounding carried through 1 / v^2 pixel by pixel."""
    y_hat, y, dx = _lik_inputs(fit_noise)
    k = ctf.ctf_filter(_ctf_table(B), D - 1, D - 1) if use_ctf else None
    w = np.asarray([0.5, 0.25, 0.25, 0.0], np.float32) if weighted else None
    btw = 2.0 / (D - 1)
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    kw = dict(fit_noise=fit_noise, mask_radius=mask_radius,
              btw_pixels_space=btw)
    ref = float(jax_lik.reconstruction_log_prob(
        j(y_hat), j(y), "gaussian", ctf=j(k), dx=j(dx), row_weights=j(w),
        **kw))
    own = float(lik.reconstruction_log_prob(
        t(y_hat), t(y), "gaussian", ctf=t(k), dx=t(dx), row_weights=t(w),
        **kw))
    slack = 0.0
    if fit_noise and use_ctf:
        mu = np.asarray(jax_lik.ctf_apply(jnp.asarray(y_hat[..., 0].reshape(
            B, D, D)), jnp.asarray(k))).reshape(B, -1)
        var = np.asarray(jax_lik.ctf_apply(jnp.asarray(np.exp(y_hat[..., 1])
                         .reshape(B, D, D)), jnp.asarray(k))).reshape(B, -1)
        keep = (np.asarray(jax_lik.circular_mask(jnp.asarray(dx), D,
                                                  mask_radius, btw))
                if mask_radius else np.ones_like(var, bool))
        err = 1e-5 * np.abs(var).max(axis=1, keepdims=True)
        per_row = np.where(keep, (mu - y.reshape(B, -1)) ** 2 * err
                           / var.astype(np.float64) ** 2, 0.0).sum(axis=1)
        slack = 0.5 * (per_row.mean() if w is None else w @ per_row)
    assert np.isfinite(own)
    assert abs(own - ref) <= 1e-5 * abs(ref) + slack
    _jax_filtered(monkeypatch)
    same = float(lik.reconstruction_log_prob(
        t(y_hat), t(y), "gaussian", ctf=t(k), dx=t(dx), row_weights=t(w),
        **kw))
    assert abs(same - ref) <= 1e-5 * abs(ref)


def test_ctf_filtered_variance_goes_non_positive_in_the_mask_as_in_jax():
    """The variance under the CTF, the reference's pairing that both
    packages keep: at the EMPIAR shape with the stand-in's physical CTF
    (tools/make_synthetic_particles_torch.py's table: 1.0-2.5 um defocus,
    1.5 A/px), even a uniform variance filters to values <= 0 on a fifth of
    the mask's pixels (the 'same' correlation's windows near the edge hold
    a part of the kernel only), in the port as in the JAX package: the
    Gaussian's (mu - y)^2 / var is unbounded there, which is why a
    --fit-noise run with CTF diverges in both. The two filters agree to
    1e-5 of the largest value."""
    sys.path.insert(0, str(REPO_TOOLS))
    import make_synthetic_particles_torch as tool
    kern = ctf.ctf_filter(tool.draw_ctf_params(2, np.random.RandomState(0)),
                          109, 109)
    ones = np.ones((2, 110, 110), np.float32)
    got = lik.ctf_apply(torch.from_numpy(ones),
                        torch.from_numpy(kern)).numpy().reshape(2, -1)
    ref = np.asarray(jax_lik.ctf_apply(jnp.asarray(ones),
                                       jnp.asarray(kern))).reshape(2, -1)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    mask = lik.circular_mask(torch.zeros(2, 2), 110, 45, 2.0 / 109).numpy()
    for v in (got, ref):
        assert (v[mask] <= 0).mean() > 0.15
        np.testing.assert_allclose(v.reshape(2, 110, 110)[:, 55, 55], 0.07,
                                   rtol=1e-4)   # the kernel's sum, ampcont


@pytest.mark.parametrize("apix", [None, 3.0])
def test_fit_noise_with_ctf_diverges_in_jax_as_in_the_port(zero_noise, apix):
    """Twenty deterministic train steps (Adam, lr 1e-2) of the 16-px
    fit-noise model with the mask, from the same weights and particles, in
    the JAX Trainer and the port's. Without CTF the variance is exp(logvar)
    > 0: both runs stay finite and agree to 1e-4. With the stand-in's CTF
    table at 3 A/px, a uniform variance filters to <= 0 on a sixth of the
    mask's pixels, so the Gaussian's (mu - y)^2 / var term is unbounded
    above: both ELBOs run away past 1e6, agree to 1e-2 while finite, and
    turn NaN at the same step. This is the reference's variance-under-CTF
    pairing, which both packages keep, and why a --fit-noise run with CTF
    at the EMPIAR shape diverges in both."""
    sys.path.insert(0, str(REPO_TOOLS))
    import make_synthetic_particles_torch as tool
    from targetvae_tpu.train.loop import Trainer as JaxTrainer
    from targetvae_tpu.train.state import create_train_state as jax_state
    from targetvae_tpu_torch.train.state import create_train_state
    lr = 1e-2
    jm, jp, tm = _pair(True, 6)
    y, _ = _particles(8)
    k = None
    if apix is not None:
        table = tool.draw_ctf_params(8, np.random.RandomState(0))
        table["apix"] = np.full(8, apix)
        k = ctf.ctf_filter(table, D - 1, D - 1)
        ones = lik.ctf_apply(torch.ones(8, D, D), torch.from_numpy(k))
        mask = lik.circular_mask(torch.zeros(8, 2), D, 6, 2.0 / (D - 1))
        assert float((ones.reshape(8, -1)[mask] <= 0).float().mean()) > 0.15
    jtr = JaxTrainer(jm, jcfg.TrainConfig(learning_rate=lr))
    jst = jax_state(jax.tree.map(jnp.asarray, jp), lr, jax.random.key(2))
    tr = Trainer(tm, TrainConfig(learning_rate=lr), device="cpu")
    st = create_train_state(tm, lr, None)
    ref, got = [], []
    for _ in range(20):
        jst, jm_ = jtr._train_step(jst, jnp.asarray(y),
                                   None if k is None else jnp.asarray(k))
        st, m = tr.train_step(st, torch.from_numpy(y),
                              ctf=None if k is None else torch.from_numpy(k))
        ref.append(np.asarray(jm_, np.float64))
        got.append(m.numpy().astype(np.float64))
    ref, got = np.asarray(ref), np.asarray(got)
    if apix is None:
        assert np.isfinite(ref).all() and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
        return
    bad_ref = ~np.isfinite(ref[:, 0])
    bad_got = ~np.isfinite(got[:, 0])
    assert bad_ref.any() and np.array_equal(bad_ref, bad_got)
    first = int(np.argmax(bad_ref))
    assert ref[first - 1, 0] > 1e6 and got[first - 1, 0] > 1e6
    np.testing.assert_allclose(got[:first], ref[:first], rtol=1e-2)


@pytest.mark.parametrize("channels,weighted", [(1, False), (3, True)])
def test_bernoulli_log_prob_matches_jax(channels, weighted):
    """The Bernoulli head (galaxy's RGB: three outputs a pixel), batch mean
    or row weights: within 1e-6 relative."""
    rng = np.random.RandomState(12)
    y_hat = rng.randn(B, D * D, channels).astype(np.float32)
    y = rng.uniform(0, 1, (B, D, D, channels)).astype(np.float32)
    w = np.asarray([0.5, 0.5, 0.0, 0.0], np.float32) if weighted else None
    got = float(lik.reconstruction_log_prob(
        torch.from_numpy(y_hat), torch.from_numpy(y), "bernoulli",
        row_weights=None if w is None else torch.from_numpy(w)))
    ref = float(jax_lik.reconstruction_log_prob(
        jnp.asarray(y_hat), jnp.asarray(y), "bernoulli",
        row_weights=None if w is None else jnp.asarray(w)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


# ---- the particles ELBO ----

def _particles_config(fit_noise, mask_radius, hidden=32):
    """A 16-px particles model: mode C at P4, k = 8, padding 3 (15 x 15
    cells), z = 2, a Fourier decoder (F 64), Gaussian."""
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=hidden,
                                       n_out=2 if fit_noise else 1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / (D - 1),
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=D, z_dim=2, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4,
                                   theta_prior=np.pi),
        likelihood=jcfg.LikelihoodConfig(kind="gaussian", fit_noise=fit_noise,
                                         mask_radius=mask_radius,
                                         use_ctf=True))


@pytest.fixture
def zero_noise(monkeypatch):
    """The JAX side without sampling noise, as tests/test_elbo.py does: the
    reparameterisation normals are zero and the Gumbel sample is the plain
    softmax. The port's counterpart is generator=None."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))


def _particles(n, seed=13):
    """Standardised noisy blobs (n, D, D, 1) and their CTF kernels."""
    rng = np.random.RandomState(seed)
    g = np.linspace(-1, 1, D, dtype=np.float32)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    c = rng.uniform(-0.3, 0.3, (2, n, 1, 1)).astype(np.float32)
    img = np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / 0.1)
    img = img + 0.3 * rng.randn(n, D, D).astype(np.float32)
    img = datasets.preprocess_particles(img.astype(np.float32), 0, True)
    return img[..., None], ctf.ctf_filter(_ctf_table(n, seed), D - 1, D - 1)


def _pair(fit_noise, mask_radius):
    jc = _particles_config(fit_noise, mask_radius)
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    return jm, jp, tm


def _port_grads(tm, y, k, compute_dtype=None):
    """-ELBO (no noise) and its gradients as the JAX pytree (no Fourier
    buffers, which get none)."""
    params = tm.params()
    elbo = compute_elbo(params, tm.cfg, tm.base_grid(), torch.from_numpy(y),
                        None, compute_dtype, ctf=torch.from_numpy(k))
    (-elbo[0]).backward()
    trained = {"encoder": params["encoder"],
               "generator": {n: v for n, v in params["generator"].items()
                             if n != "fourier"}}
    grads = params_to_jax(jax.tree.map(lambda p: p.grad, trained,
                                       is_leaf=torch.is_tensor))
    return [float(e.detach()) for e in elbo], grads


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fit_noise,mask_radius", [
    (False, 0), (False, 5), (True, 0), (True, 6)])
def test_particles_elbo_and_gradients_match_jax(zero_noise, fit_noise,
                                                mask_radius):
    """The float32 tier's ELBO with CTF kernels (by FFT) against the JAX
    package's (the exact convolution), no noise: within 1e-5 relative on
    (elbo, log_p, kl), and every gradient leaf within 1e-4 relative L2 of
    jax.grad's. The attention head's bias is the exception: the joint
    softmax is invariant to a shift of every logit, so its exact gradient
    is zero and both sides hold rounding noise (|g| < 1e-3 of the largest
    gradient entry)."""
    jm, jp, tm = _pair(fit_noise, mask_radius)
    y, k = _particles(B)
    ref_e = jax_compute_elbo(jp, jm.cfg, jm.base_grid(), jnp.asarray(y),
                             jax.random.key(1), ctf=jnp.asarray(k))
    ref_g = jax.grad(lambda p: -jax_compute_elbo(
        p, jm.cfg, jm.base_grid(), jnp.asarray(y), jax.random.key(1),
        ctf=jnp.asarray(k))[0])(jax.tree.map(jnp.asarray, jp))
    got_e, got_g = _port_grads(tm, y, k)
    for g, r in zip(got_e, ref_e):
        assert abs(g - float(r)) <= 1e-5 * max(abs(float(r)), 1.0)
    top = max(float(np.abs(np.asarray(v)).max()) for _, v in _leaves(ref_g))
    for keys, g in _leaves(got_g):
        r = np.asarray(_at(ref_g, keys))
        if keys == ("encoder", "conv_a", "b"):
            assert np.abs(g).max() < 1e-3 * top
        else:
            assert _rel(g, r) < 1e-4, (keys, _rel(g, r))


@pytest.mark.parametrize("fit_noise,mask_radius", [(False, 5), (True, 6)])
def test_particles_bf16_tier_tracks_jax_bf16_tier(fit_noise, mask_radius):
    """The port's bf16 tier (the kernels' plain versions on the CPU; hidden
    64 and F 64 take the pose decoder's plain version) against the JAX
    package's bf16 tier on the CPU (its XLA bf16 recipe), no noise: the
    ELBO within PERF.md's 2e-2 relative; the port's bf16 gradients are
    finite."""
    jc = _particles_config(fit_noise, mask_radius, hidden=64)
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    y, k = _particles(B)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32:
                   jnp.zeros(shape, dtype))
        mp.setattr(jax_enc, "gumbel_softmax",
                   lambda key, logits, tau=1.0, axis=-1:
                   jax.nn.softmax(logits, axis=axis))
        ref = jax_compute_elbo(jp, jm.cfg, jm.base_grid(), jnp.asarray(y),
                               jax.random.key(1), ctf=jnp.asarray(k),
                               compute_dtype=jnp.bfloat16)
    got, grads = _port_grads(tm, y, k, torch.bfloat16)
    for g, r in zip(got, ref):
        assert abs(g - float(r)) <= 2e-2 * max(abs(float(r)), 1.0)
    assert all(np.isfinite(v).all() for _, v in _leaves(grads))


# ---- the Trainer with CTF kernels ----

def _trainer(fit_noise=True):
    cfg = ModelConfig.from_json(_particles_config(fit_noise, 5).to_json())
    tr = Trainer(cfg, TrainConfig(minibatch_size=4, learning_rate=1e-3),
                 device="cpu")
    return tr, tr.init_state(0)


def test_train_epoch_with_ctf_equals_its_steps():
    """train_epoch over 10 particles (two batches of 4 and a tail of 2) with
    a state that keeps the data's order, against train_step on the same
    rows and kernels, gathered as the epoch gathers them (the CPU's conv
    picks its path by the input's alignment, which moves sums by ~4e-6),
    from the same weights: the same parameters and metrics bit for bit."""
    y, k = _particles(10)
    tr_a, st_a = _trainer()
    st_a.generator = None
    st_a, (elbo, gen_loss, kl) = tr_a.train_epoch(st_a, y, k)
    tr_b, st_b = _trainer()
    st_b.generator = None
    ms = []
    rows = lambda a, sl: torch.from_numpy(a).index_select(
        0, torch.arange(sl.start, sl.stop))
    for sl in (slice(0, 4), slice(4, 8), slice(8, 10)):
        st_b, m = tr_b.train_step(st_b, rows(y, sl), ctf=rows(k, sl))
        ms.append(m.numpy().astype(np.float64) * (sl.stop - sl.start))
    mean = np.sum(ms, axis=0) / 10
    assert st_a.step == st_b.step == 3
    np.testing.assert_allclose([elbo, -gen_loss, kl], mean, rtol=1e-12)
    for a, b in zip(st_a.model.parameters(), st_b.model.parameters()):
        assert torch.equal(a, b)


def test_eval_epoch_with_ctf_equals_its_steps():
    """eval_epoch over 10 particles (batches of 4 and a tail of 2), sampled
    from a generator seeded 3, against eval_step on the same slices of the
    same tensors with a generator of the same seed: equal bit for bit, and
    unlike the same pass with the kernels of other particles."""
    y, k = _particles(10)
    tr, st = _trainer()
    got = tr.eval_epoch(st, y, k, seed=3)
    gen = torch.Generator().manual_seed(3)
    # the full batches as slices, the tail gathered, as eval_epoch takes them
    yt, kt = torch.from_numpy(y), torch.from_numpy(k)
    tail = torch.arange(8, 10)
    ms = [tr.eval_step(st, yy, gen, ctf=kk).numpy().astype(np.float64)
          * yy.shape[0]
          for yy, kk in ((yt[0:4], kt[0:4]), (yt[4:8], kt[4:8]),
                         (yt.index_select(0, tail), kt.index_select(0, tail)))]
    mean = np.sum(ms, axis=0) / 10
    np.testing.assert_allclose([got[0], -got[1], got[2]], mean, rtol=1e-12)
    other = tr.eval_epoch(st, y, k[::-1].copy(), seed=3)
    assert other[1] != got[1]


def test_train_step_with_ctf_trains():
    """Twenty deterministic steps on one batch of particles with CTF
    kernels, fit_noise and the mask: finite metrics, a rising ELBO. (A
    sampled step's noise moves this tiny model's ELBO by more than twenty
    steps of learning do; chip_smoke.py checks sampled steps at full
    width.)"""
    y, k = _particles(8)
    tr, st = _trainer()
    st.generator = None
    ms = []
    for _ in range(20):
        st, m = tr.train_step(st, y, ctf=k)
        ms.append(m.numpy())
    ms = np.asarray(ms)
    assert np.isfinite(ms).all()
    assert ms[-5:, 0].mean() > ms[:5, 0].mean()
