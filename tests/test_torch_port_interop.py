"""The port's reading and writing of the reference's pickled .sav modules
(targetvae_tpu_torch/utils/torch_{import,export}.py) against the JAX
package's (targetvae_tpu/utils/torch_{import,export}.py), both ways, in
modes A, B (groupconv 0 and 4) and C (rot_refinement both ways) and for
the generator (Fourier; resid + tanh). The reference's own files are stood
in for by the JAX package's exporter, which needs no reference checkout.

Configs must be equal field by field and params bitwise. load_encoder's
float32 embed of a .sav is held against the JAX package's at 1e-5 (the
float32 encoders of the two packages at these widths; the port's
tests/test_torch_port_checkpoint.py holds the same bound). No test leaves
a `src` module in sys.modules: the JAX package's interop tests import the
real one in the same worker.
"""

import dataclasses
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import targetvae_tpu.cli.clustering_common as jax_cc
from targetvae_tpu.models.encoders import encoder_init as jax_encoder_init
from targetvae_tpu.models.generator import generator_init as jax_generator_init
from targetvae_tpu.utils import config as jax_config
from targetvae_tpu.utils import torch_export as jax_export
from targetvae_tpu.utils import torch_import as jax_import

from targetvae_tpu_torch.cli.clustering_common import load_encoder
from targetvae_tpu_torch.models.encoders import encoder_init
from targetvae_tpu_torch.models.generator import generator_init
from targetvae_tpu_torch.utils import config as port_config
from targetvae_tpu_torch.utils import torch_export, torch_import
from targetvae_tpu_torch.utils.jax_params import params_to_jax

REPO = Path(__file__).resolve().parents[1]

ENCODERS = {
    "A": dict(t_inf="unimodal", r_inf="unimodal", image_dim=12, z_dim=2,
              kernels_num=32, num_layers=2),
    "A-tanh-resid": dict(t_inf="unimodal", r_inf="unimodal", image_dim=10,
                         z_dim=3, kernels_num=24, num_layers=3,
                         activation="tanh", resid=True),
    "B0": dict(t_inf="attention", r_inf="unimodal", image_dim=11, z_dim=2,
               kernels_num=16, groupconv=0),
    "B4": dict(t_inf="attention", r_inf="unimodal", image_dim=11, z_dim=2,
               kernels_num=16, groupconv=4, activation="tanh"),
    "C-offsets": dict(t_inf="attention", r_inf="attention+offsets",
                      image_dim=12, z_dim=2, kernels_num=16, kernels_size=7,
                      padding=3, groupconv=4, theta_prior=math.pi / 2,
                      normal_prior_over_r=True),
    "C": dict(t_inf="attention", r_inf="attention", image_dim=12, z_dim=3,
              kernels_num=16, kernels_size=7, padding=3, groupconv=8),
}
GENERATORS = {
    "fourier": dict(z_dim=2, hidden_dim=32, n_out=1, num_layers=2,
                    fourier_expansion=True, fourier_sigma=0.01,
                    embedding_dim=16),
    "resid-tanh": dict(z_dim=2, hidden_dim=16, n_out=3, num_layers=3,
                       activation="tanh", resid=True),
}


def _assert_trees_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32, path
        assert a.shape == b.shape and np.array_equal(a, b), path


def _assert_configs_equal(port_cfg, jax_cfg):
    """Field by field, values and types."""
    pa, ja = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert pa == ja
    assert [type(v) for v in pa.values()] == [type(v) for v in ja.values()]


def _jax_encoder(name, seed=0):
    cfg = jax_config.EncoderConfig(**ENCODERS[name])
    return cfg, jax.tree.map(np.asarray,
                             jax_encoder_init(jax.random.key(seed), cfg))


def _jax_generator(name, seed=0):
    cfg = jax_config.GeneratorConfig(**GENERATORS[name])
    return cfg, jax.tree.map(np.asarray,
                             jax_generator_init(jax.random.key(seed), cfg))


@pytest.mark.parametrize("name", list(ENCODERS))
def test_jax_export_port_import_encoder(tmp_path, name):
    cfg, params = _jax_encoder(name)
    path = str(tmp_path / "inference.sav")
    jax_export.export_encoder_sav(path, cfg, params)
    assert torch_import.is_torch_checkpoint(path)
    got_cfg, got = torch_import.encoder_from_sav(path)
    ref_cfg, ref = jax_import.encoder_from_sav(path)
    _assert_configs_equal(got_cfg, ref_cfg)
    _assert_trees_equal(got, ref)
    _assert_trees_equal(got, params)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_port_export_jax_import_encoder(tmp_path, name):
    cfg = port_config.EncoderConfig(**ENCODERS[name])
    params = encoder_init(torch.Generator().manual_seed(1), cfg, "cpu")
    path = str(tmp_path / "inference_torch.sav")
    torch_export.export_encoder_sav(path, cfg, params)
    ref_cfg, ref = jax_import.encoder_from_sav(path)
    got_cfg, got = torch_import.encoder_from_sav(path)
    _assert_configs_equal(got_cfg, ref_cfg)
    _assert_trees_equal(ref, params_to_jax(params))
    _assert_trees_equal(got, ref)
    # the JAX exporter writes the same modules from the same weights
    jpath = str(tmp_path / "inference_jax.sav")
    jax_export.export_encoder_sav(jpath, jax_config.EncoderConfig(
        **ENCODERS[name]), params_to_jax(params))
    _assert_configs_equal(torch_import.encoder_from_sav(jpath)[0], got_cfg)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_both_ways(tmp_path, name):
    jcfg, jparams = _jax_generator(name)
    jpath = str(tmp_path / "generator.sav")
    jax_export.export_generator_sav(jpath, jcfg, jparams)
    got_cfg, got = torch_import.generator_from_sav(jpath)
    ref_cfg, ref = jax_import.generator_from_sav(jpath)
    _assert_configs_equal(got_cfg, ref_cfg)
    _assert_trees_equal(got, ref)
    _assert_trees_equal(got, jparams)
    if jcfg.fourier_expansion:
        # the float32 sigma as the JAX import reads it, not 0.01
        assert got_cfg.fourier_sigma == float(np.float32(0.01)) != 0.01

    pcfg = port_config.GeneratorConfig(**GENERATORS[name])
    pparams = generator_init(torch.Generator().manual_seed(2), pcfg, "cpu")
    ppath = str(tmp_path / "generator_torch.sav")
    torch_export.export_generator_sav(ppath, pcfg, pparams)
    ref_cfg, ref = jax_import.generator_from_sav(ppath)
    got_cfg, got = torch_import.generator_from_sav(ppath)
    _assert_configs_equal(got_cfg, ref_cfg)
    _assert_trees_equal(ref, params_to_jax(pparams))
    _assert_trees_equal(got, ref)


@pytest.mark.parametrize("name", ["A", "B0", "B4", "C-offsets", "C"])
def test_load_encoder_on_a_sav_matches_jax_embed(tmp_path, capsys, name):
    cfg, params = _jax_encoder(name, seed=3)
    path = str(tmp_path / "inference.sav")
    jax_export.export_encoder_sav(path, cfg, params)
    model, p = load_encoder(path, device="cpu")
    assert "reference torch checkpoint, importing" in capsys.readouterr().err
    jm, jp = jax_cc.load_encoder(path)
    _assert_configs_equal(model.cfg, jm.cfg)
    d = cfg.image_dim
    y = np.random.default_rng(4).uniform(size=(5, d, d, 1)).astype(np.float32)
    ref = jm.embed(jp, jax.numpy.asarray(y))
    with torch.inference_mode():
        got = model.embed(p, torch.from_numpy(y))
    for k in ("z_content", "theta_mu", "dx"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_model_from_savs_without_a_generator(tmp_path):
    """The decoder is drawn from torch.Generator().manual_seed(0) (the JAX
    package draws from jax.random.key(0)): the same config, and the
    encoder as the file holds it."""
    cfg, params = _jax_encoder("C")
    path = str(tmp_path / "inference.sav")
    jax_export.export_encoder_sav(path, cfg, params)
    got_cfg, got = torch_import.model_from_savs(path)
    ref_cfg, ref = jax_import.model_from_savs(path)
    _assert_configs_equal(got_cfg, ref_cfg)
    _assert_trees_equal(got["encoder"], ref["encoder"])
    again = torch_import.model_from_savs(path)[1]
    _assert_trees_equal(got["generator"], again["generator"])
    gpath = str(tmp_path / "generator.sav")
    gcfg, gparams = _jax_generator("fourier")
    jax_export.export_generator_sav(gpath, gcfg, gparams)
    both_cfg, both = torch_import.model_from_savs(path, gpath)
    _assert_configs_equal(both_cfg, jax_import.model_from_savs(path, gpath)[0])
    _assert_trees_equal(both["generator"], gparams)


def test_a_torch_file_without_a_reference_network_is_refused(tmp_path):
    path = str(tmp_path / "inference.sav")
    torch.save(torch.nn.Linear(2, 3), path)
    with pytest.raises(ValueError, match="Linear, not a reference inference"):
        torch_import.encoder_from_sav(path)
    with pytest.raises(ValueError, match="expected SpatialGenerator"):
        torch_import.generator_from_sav(path)


def test_import_and_export_leave_sys_modules_alone(tmp_path):
    """In a fresh interpreter: after the port's export and import of every
    kind of module, sys.modules holds no `src`, `src.*` or `models` key."""
    code = (
        "import sys, torch\n"
        "from targetvae_tpu_torch.utils import torch_export as te, "
        "torch_import as ti\n"
        "from targetvae_tpu_torch.utils.config import EncoderConfig, "
        "GeneratorConfig\n"
        "from targetvae_tpu_torch.models.encoders import encoder_init\n"
        "from targetvae_tpu_torch.models.generator import generator_init\n"
        f"for i, kw in enumerate({list(ENCODERS.values())!r}):\n"
        "    cfg = EncoderConfig(**kw)\n"
        "    p = encoder_init(torch.Generator().manual_seed(0), cfg, 'cpu')\n"
        "    path = sys.argv[1] + f'/e{i}.sav'\n"
        "    te.export_encoder_sav(path, cfg, p)\n"
        "    assert ti.encoder_from_sav(path)[0] == cfg\n"
        "g = GeneratorConfig(hidden_dim=16, fourier_expansion=True, "
        "embedding_dim=8)\n"
        "te.export_generator_sav(sys.argv[1] + '/g.sav', g, generator_init("
        "torch.Generator().manual_seed(0), g, 'cpu'))\n"
        "ti.model_from_savs(sys.argv[1] + '/e0.sav', sys.argv[1] + '/g.sav')\n"
        "bad = [m for m in sys.modules if m in ('src', 'models') or "
        "m.startswith('src.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_a_planted_src_models_is_neither_used_nor_touched(tmp_path):
    """With a dummy `src.models` (whose classes would raise) in sys.modules,
    the port still resolves the file's classes to its placeholders, and the
    dummy comes out as it went in."""
    cfg, params = _jax_encoder("C-offsets")
    path = str(tmp_path / "inference.sav")
    jax_export.export_encoder_sav(path, cfg, params)

    class _Refuse:
        def __new__(cls, *a, **k):
            raise AssertionError("the planted class was used")

    dummy = types.ModuleType("src.models")
    dummy.InferenceNetwork_AttentionTranslation_AttentionRotation = _Refuse
    dummy.GroupConv = _Refuse
    before = dict(vars(dummy))
    keys = ("src", "src.models", "models")
    saved = {k: sys.modules[k] for k in keys if k in sys.modules}
    try:
        sys.modules["src"] = types.ModuleType("src")
        sys.modules["src.models"] = dummy
        sys.modules["models"] = dummy
        enc = torch_import._load_torch_module(path)
        got_cfg, got = torch_import.encoder_from_sav(path)
        assert sys.modules["src.models"] is dummy
        assert sys.modules["models"] is dummy
        assert dict(vars(dummy)) == before
    finally:
        for k in keys:
            sys.modules.pop(k, None)
        sys.modules.update(saved)
    assert type(enc).__module__ == \
        "targetvae_tpu_torch.utils.torch_import._reference_placeholders"
    assert type(enc.conv1).__name__ == "GroupConv"
    _assert_configs_equal(got_cfg, jax_import.encoder_from_sav(path)[0])
    _assert_trees_equal(got, params)


def test_exported_pickle_names_the_reference_classes(tmp_path):
    """The file names src.models' classes by name, and the port's params may
    lie on any device or require gradients."""
    import zipfile

    cfg = port_config.EncoderConfig(**ENCODERS["B4"])
    params = encoder_init(torch.Generator().manual_seed(5), cfg, "cpu")
    params = {k: {n: t.requires_grad_() for n, t in v.items()}
              for k, v in params.items()}
    path = str(tmp_path / "inference_torch.sav")
    torch_export.export_encoder_sav(path, cfg, params)
    with zipfile.ZipFile(path) as z:
        data = z.read(next(n for n in z.namelist() if n.endswith("data.pkl")))
    for name in (b"InferenceNetwork_AttentionTranslation_UnimodalRotation",
                 b"GroupConv"):
        assert b"src.models\n" + name + b"\n" in data
    _assert_trees_equal(jax_import.encoder_from_sav(path)[1],
                        params_to_jax(params))
