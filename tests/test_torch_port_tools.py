"""The port's serving tools (targetvae_tpu_torch/cli/{embed_stack,
reconstruct,export_torch_checkpoint}.py) against the JAX package's
(tools/embed_stack.py, tools/reconstruct.py's decode,
targetvae_tpu/utils/torch_import.py), on the CPU at small widths.

Tolerances: float32 embeds and decodes of the two packages 1e-5 (the same
weights at these widths; tests/test_torch_port_interop.py's bound); the
bf16 tier against the port's own float32 2e-2 absolute (chip_smoke.py's
TOL_DX, half an attention-grid pitch), z and the rotation on the rows
whose argmax attention cell both tiers pick (a row whose cell differs
must be a float32 near tie, which bf16's rounding turns); files and
params bitwise.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.ops.coords import image_grid as jax_image_grid
from targetvae_tpu.ops.coords import transform_coords as jax_transform_coords
from targetvae_tpu.train import checkpoint as jax_checkpoint
from targetvae_tpu.utils import torch_import as jax_import
from targetvae_tpu.utils.config import ModelConfig as JaxModelConfig

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.cli import embed_stack, export_torch_checkpoint
from targetvae_tpu_torch.cli import reconstruct
from targetvae_tpu_torch.data import mrc
from targetvae_tpu_torch.train.checkpoint import save_model_pair
from targetvae_tpu_torch.utils.config import (EncoderConfig, GeneratorConfig,
                                              LikelihoodConfig)
from targetvae_tpu_torch.utils.jax_params import params_to_jax
from targetvae_tpu_torch.utils.png import png_size

REPO = Path(__file__).resolve().parents[1]
D = 16          # the model's image size
RAW = 24        # the stack's, binned to 20 and cropped to D


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model_cfg(likelihood="gaussian", **enc):
    e = dict(image_dim=D, kernels_num=16, kernels_size=7, padding=3,
             groupconv=4)
    e.update(enc)
    return ModelConfig(
        GeneratorConfig(hidden_dim=32, fourier_expansion=True,
                        embedding_dim=32, fourier_sigma=2.0 / (D - 1)),
        EncoderConfig(**e), LikelihoodConfig(kind=likelihood))


@pytest.fixture
def run_dir(tmp_path):
    """A port run directory (inference.sav, generator.sav) of random
    weights."""
    cfg = _model_cfg()
    params = TargetVAE(cfg, "cpu").init(torch.Generator().manual_seed(0))
    run = tmp_path / "run"
    run.mkdir()
    save_model_pair(str(run), params, cfg)
    return run


@pytest.fixture
def stack(tmp_path):
    """The same 30 particles as .mrcs and .npy."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:RAW, :RAW] - RAW / 2
    imgs = np.stack([np.exp(-((xx - rng.uniform(-3, 3)) ** 2
                              + (yy - rng.uniform(-3, 3)) ** 2 * s) / 12)
                     for s in rng.uniform(0.3, 3, 30)])
    imgs = (imgs + 0.2 * rng.normal(size=imgs.shape)).astype(np.float32)
    mrc.write(str(tmp_path / "stack.mrcs"), imgs)
    np.save(tmp_path / "stack.npy", imgs)
    return tmp_path


PREP = ["--downsample", "20", "--crop", str(D), "--normalize",
        "--minibatch-size", "8"]


def _argmax_cells(run_dir, images):
    """Each image's argmax attention cell on the float32 and the bf16 tier,
    and the float32 logits' and the two tiers' greatest logit gap."""
    from targetvae_tpu_torch.cli.clustering_common import load_encoder
    from targetvae_tpu_torch.models.encoders import encoder_apply

    model, params = load_encoder(str(run_dir / "inference.sav"), "cpu")
    y = torch.from_numpy(images)
    with torch.inference_mode():
        a32, a16 = (encoder_apply(params["encoder"], model.cfg.encoder, y,
                                  None, compute_dtype=dt)["attn"]
                    .reshape(len(y), -1) for dt in (None, torch.bfloat16))
    return (a32.argmax(1).numpy(), a16.argmax(1).numpy(), a32.numpy(),
            float((a32 - a16).abs().max()))


@pytest.mark.parametrize("ext", ["mrcs", "npy"])
def test_embed_stack_matches_jax_tool(run_dir, stack, monkeypatch, ext):
    """float32 against the JAX tool's arrays at 1e-5; the bf16 tier against
    the port's float32 at 2e-2: dx on every row, z and the rotation on the
    rows whose argmax cell the tiers share. A row whose cell differs must
    be a float32 near tie: its two cells' float32 logits closer than twice
    the tiers' greatest logit difference."""
    monkeypatch.setenv("TARGETVAE_COMPILE_CACHE", "")
    jax_tool = _jax_tool("embed_stack")
    enc = str(run_dir / "inference.sav")
    flags = ["--input", str(stack / f"stack.{ext}"), "--path-to-encoder",
             enc, "-d", "-1"] + PREP
    jax_tool.main(flags + ["--out", str(stack / "jax"),
                           "--compute-dtype", "float32"])
    got = embed_stack.main(flags + ["--out", str(stack / "port"),
                                    "--compute-dtype", "float32"])
    bf16 = embed_stack.main(flags + ["--out", str(stack / "port16")])
    c32, c16, logits, gap = _argmax_cells(run_dir, embed_stack.load_stack(
        str(stack / f"stack.{ext}"), 20, D, True))
    same = c32 == c16
    assert same.mean() >= 0.9
    rows = np.arange(len(c32))[~same]
    assert (logits[rows, c32[rows]] - logits[rows, c16[rows]]
            <= 2 * gap).all()
    for part, key in (("z", "z"), ("rot", "rot"), ("trans", "trans")):
        ours = np.load(stack / f"port_{part}.npy")
        ref = np.load(stack / f"jax_{part}.npy")
        assert ours.shape == ref.shape and ours.shape[0] == 30
        np.testing.assert_array_equal(ours, got[key])
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=part)
        keep = slice(None) if key == "trans" else same
        np.testing.assert_allclose(bf16[key][keep], ours[keep], rtol=0,
                                   atol=2e-2, err_msg=part)
    assert np.load(stack / "port_z.npy").shape == (30, 4)


def test_embed_stack_reads_a_reference_sav(run_dir, stack):
    """The same stack through the exported inference_torch.sav gives the
    run's own latents bitwise."""
    (path,) = export_torch_checkpoint.main([str(run_dir / "inference.sav")])
    flags = ["--input", str(stack / "stack.mrcs"), "-d", "-1",
             "--compute-dtype", "float32"] + PREP
    a = embed_stack.main(flags + ["--path-to-encoder", path, "--out",
                                  str(stack / "a")])
    b = embed_stack.main(flags + ["--path-to-encoder",
                                  str(run_dir / "inference.sav"), "--out",
                                  str(stack / "b")])
    for k in ("z", "rot", "trans"):
        np.testing.assert_array_equal(a[k], b[k])


def _jax_reconstruct(jm, params, imgs):
    """tools/reconstruct.py's decode: embed, transform_coords, decode."""
    emb = jm.embed(params, jnp.asarray(imgs))
    zd = jm.cfg.encoder.z_dim
    grid = jnp.asarray(jax_image_grid(jm.cfg.encoder.image_dim))
    b, n = len(imgs), jm.cfg.encoder.image_dim
    x_pose = jax_transform_coords(grid, emb["dx"], emb["theta_mu"][:, 0])
    x_plain = jnp.tile(grid[None], (b, 1, 1))
    z = emb["z_content"][:, :zd]
    recon = np.asarray(jm.decode(params, x_pose, z))[..., 0]
    canon = np.asarray(jm.decode(params, x_plain, z))[..., 0]
    if jm.cfg.likelihood.kind == "bernoulli":
        recon, canon = 1 / (1 + np.exp(-recon)), 1 / (1 + np.exp(-canon))
    return recon.reshape(b, n, n), canon.reshape(b, n, n)


@pytest.mark.parametrize("likelihood,enc", [
    ("bernoulli", {}),
    ("gaussian", {"r_inf": "attention"}),
    ("bernoulli", {"t_inf": "attention", "r_inf": "unimodal",
                   "groupconv": 0}),
    ("gaussian", {"t_inf": "unimodal", "r_inf": "unimodal"})])
def test_reconstruct_matches_jax_decode(likelihood, enc):
    cfg = _model_cfg(likelihood, **enc)
    model = TargetVAE(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(6))
    imgs = np.random.default_rng(7).uniform(size=(4, D, D, 1)).astype(
        np.float32)
    recon, canon = reconstruct.reconstruct(model, params, imgs)
    jm = JaxTargetVAE(JaxModelConfig.from_json(cfg.to_json()))
    ref_r, ref_c = _jax_reconstruct(jm, params_to_jax(params), imgs)
    assert recon.shape == canon.shape == (4, D, D)
    np.testing.assert_allclose(recon, ref_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(canon, ref_c, rtol=1e-5, atol=1e-5)


def test_reconstruct_cli_in_either_format(run_dir, stack):
    """The CLI writes its 3 x n grid as a PNG, and a pair of exported
    reference .sav files gives the same decode as the run's own files."""
    images = str(stack / "crop.npy")
    np.save(images, np.load(stack / "stack.npy")[:, 4:4 + D, 4:4 + D])
    out = reconstruct.main([
        "--path-to-encoder", str(run_dir / "inference.sav"),
        "--path-to-generator", str(run_dir / "generator.sav"),
        "--images", images, "--n", "5", "-d", "-1"])
    assert out["out"] == str(run_dir / "reconstructions.png")
    gap = reconstruct.GAP
    assert png_size(out["out"]) == (gap + 3 * (D + gap), gap + 5 * (D + gap))
    written = export_torch_checkpoint.main([str(run_dir), "--out-dir",
                                            str(stack / "ref")])
    mixed = reconstruct.main([
        "--path-to-encoder", written[0], "--path-to-generator", written[1],
        "--images", images, "--n", "5", "-d", "-1",
        "--out", str(stack / "ref" / "r.png")])
    # the reference files hold no likelihood: the mixed model decodes
    # through the Bernoulli sigmoid, the run's own through none
    assert mixed["recon"].shape == out["recon"].shape == (5, D, D)
    np.testing.assert_allclose(mixed["recon"],
                               1 / (1 + np.exp(-out["recon"])), rtol=1e-6,
                               atol=1e-6)
    own = reconstruct.main([
        "--path-to-encoder", written[0],
        "--path-to-generator", str(run_dir / "generator.sav"),
        "--images", images, "--n", "5", "-d", "-1",
        "--out", str(stack / "ref" / "own.png")])
    np.testing.assert_array_equal(own["canon"], mixed["canon"])


def test_export_torch_checkpoint_reads_back_in_jax(run_dir):
    written = export_torch_checkpoint.main([str(run_dir)])
    assert [os.path.basename(p) for p in written] == [
        "inference_torch.sav", "generator_torch.sav"]
    params, cfg, _ = jax_checkpoint.load_checkpoint(
        str(run_dir / "inference.sav"))
    ecfg, eparams = jax_import.encoder_from_sav(written[0])
    gcfg, gparams = jax_import.generator_from_sav(written[1])
    assert dataclasses.asdict(ecfg) == dataclasses.asdict(cfg.encoder)
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(dataclasses.replace(
        cfg.generator, fourier_sigma=float(np.float32(
            cfg.generator.fourier_sigma))))
    gp, _, _ = jax_checkpoint.load_checkpoint(str(run_dir / "generator.sav"))
    for a, b in ((eparams, params["encoder"]), (gparams, gp["generator"])):
        flat_a = jax.tree_util.tree_leaves(a)
        flat_b = jax.tree_util.tree_leaves(b)
        assert len(flat_a) == len(flat_b)
        assert all(np.array_equal(x, y) for x, y in zip(flat_a, flat_b))
    only = export_torch_checkpoint.main([str(run_dir / "inference.sav"),
                                         "--out-dir", str(run_dir / "x")])
    assert only == [str(run_dir / "x" / "inference_torch.sav")]


@pytest.mark.parametrize("tool,flags", [
    (embed_stack, ["--input", "stack.npy", "--path-to-encoder",
                   "inference.sav", "--out", "o"]),
    (reconstruct, ["--path-to-encoder", "inference.sav",
                   "--path-to-generator", "generator.sav", "--images",
                   "stack.npy"])])
def test_tools_run_on_cuda_by_default(tmp_path, tool, flags):
    """Without -d a tool asks for cuda:0; with no CUDA device it raises
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([str(tmp_path / f) if "." in f else f for f in flags])
