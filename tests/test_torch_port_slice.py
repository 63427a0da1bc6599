"""The port's inference slice (embed, held-out ELBO, embed_dataset) against
the JAX package's float32 tier, with the same params and the same noise.

Tolerance rtol 2e-4 / atol 1e-4 throughout: the two sides sum the float32
lift convolution (and the matmuls after it) in different orders, and the
ELBO adds up thousands of such terms.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import targetvae_tpu.models.encoders as jax_enc
from targetvae_tpu.cli.clustering_common import embed_dataset as jax_embed_dataset
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.utils import config as jcfg

from targetvae_tpu_torch import TargetVAE, ModelConfig
from targetvae_tpu_torch.cli.clustering_common import embed_dataset
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.utils.jax_params import params_from_jax

RTOL, ATOL = 2e-4, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=64, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / 13,
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=14, z_dim=2, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


@pytest.fixture(scope="module")
def pair():
    jc = _config()
    jm = JaxTargetVAE(jc)
    jp = jm.init(jax.random.key(0))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    images = np.random.default_rng(0).uniform(0, 1, (10, 14, 14, 1)).astype(
        np.float32)
    return jm, jp, tm, images


def test_embed_matches_jax(pair):
    jm, jp, tm, images = pair
    ref = jm.embed(jp, jnp.asarray(images[:5]))
    with torch.inference_mode():
        got = tm.embed(tm.params(), torch.from_numpy(images[:5]))
    for name in ("z_content", "theta_mu", "dx"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_elbo_matches_jax_with_zero_noise(pair, monkeypatch):
    """JAX side: the reparameterisation normals are zeroed and the Gumbel
    sample is the plain softmax, as tests/test_elbo.py does; port side:
    generator=None, which means exactly that."""
    jm, jp, tm, images = pair
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    y = images[:6]
    ref = jax_compute_elbo(jp, jm.cfg, jm.base_grid(), jnp.asarray(y),
                           jax.random.key(1))
    with torch.inference_mode():
        got = compute_elbo(tm.params(), tm.cfg, tm.base_grid(),
                           torch.from_numpy(y), None)
    np.testing.assert_allclose([float(t) for t in got],
                               [float(t) for t in ref], rtol=RTOL, atol=ATOL)


def test_embed_dataset_ragged_tail_matches_jax(pair):
    jm, jp, tm, images = pair
    ref = jax_embed_dataset(jm, jp, images, minibatch_size=4)
    got = embed_dataset(tm, tm.params(), images, minibatch_size=4)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_bf16_kernel_tier_tracks_f32_tier(pair):
    """On the CPU the bf16 tier runs the kernels' plain versions: same
    model, bf16 lift conv and matmul operands; the ELBO moves by much less
    than the 2e-2 bound chip_smoke.py holds the card to. bf16 decode (the
    decoder_mlp kernel's plain version here) tracks float32 decode to 2e-2
    of its scale, the same bf16-operand bound."""
    _, _, tm, images = pair
    y = torch.from_numpy(images[:6])
    x = tm.base_grid()[None].expand(2, -1, -1)
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 2)).astype(
        np.float32))
    with torch.inference_mode():
        e32 = tm.elbo(tm.params(), tm.base_grid(), y, None)
        e16 = tm.elbo(tm.params(), tm.base_grid(), y, None, torch.bfloat16)
        d16 = tm.decode(tm.params(), x, z, compute_dtype=torch.bfloat16)
        d32 = tm.decode(tm.params(), x, z)
        sampled = tm(y, torch.Generator().manual_seed(0), torch.bfloat16)
    assert abs(float(e16[0]) - float(e32[0])) < 2e-2 * abs(float(e32[0]))
    assert d16.shape == d32.shape == (2, 14 * 14, 1)
    assert float((d16 - d32).abs().max()) < 2e-2 * float(d32.abs().max())
    assert all(np.isfinite(float(t)) for t in sampled)


def test_port_runs_without_jax(tmp_path):
    """The package, its train and clustering CLIs (with their PNG figures
    and t-SNE), modes A and B, its checkpoints, the reference .sav import
    and export, the serving tools (embed_stack, reconstruct,
    export_torch_checkpoint) and the mesh's modules (the TP state, the
    float32 SP posterior, the dry run) with jax, flax, optax, msgpack,
    scikit-learn, matplotlib, PIL and the JAX package all blocked from
    import; then the measurement layer (utils/flops.py, utils/bench_log.py,
    the configs and CTF table of tools/bench_config_torch.py,
    tools/score_clusters_torch.py)."""
    code = (
        "import os, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', "
        "'targetvae_tpu', 'sklearn', 'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from targetvae_tpu_torch import TargetVAE, ModelConfig\n"
        "from targetvae_tpu_torch.utils.config import EncoderConfig, "
        "GeneratorConfig\n"
        "cfg = ModelConfig(GeneratorConfig(hidden_dim=64, "
        "fourier_expansion=True, embedding_dim=64), EncoderConfig("
        "image_dim=14, kernels_num=16, kernels_size=8, padding=3, "
        "groupconv=4))\n"
        "m = TargetVAE(cfg, device='cpu')\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "out = m.embed(p, torch.rand(2, 14, 14, 1))\n"
        "assert out['z_content'].shape == (2, 4)\n"
        "import targetvae_tpu_torch.parallel.pjit\n"
        "import targetvae_tpu_torch.parallel.dryrun\n"
        "from targetvae_tpu_torch.parallel.grid_softmax import "
        "posterior_block, sharded_log_softmax\n"
        "from targetvae_tpu_torch.train import Trainer\n"
        "from targetvae_tpu_torch.utils.config import TrainConfig\n"
        "tr = Trainer(m, TrainConfig(compute_dtype='bfloat16'))\n"
        "st, met = tr.train_step(tr.init_state(0), torch.rand(2, 14, 14, 1))\n"
        "assert st.step == 1 and bool(torch.isfinite(met).all())\n"
        "root = sys.argv[1]\n"
        "os.makedirs(root + '/data/mnist_U')\n"
        "for split, n in (('train', 30), ('test', 10)):\n"
        "    np.save(root + f'/data/mnist_U/images_{split}.npy', np.random."
        "default_rng(n).integers(0, 256, (n, 12, 12), dtype=np.uint8))\n"
        "from targetvae_tpu_torch.cli import train_mnist\n"
        "st = train_mnist.main(['--image-dim', '12', '--groupconv', '4', "
        "'--encoder-kernel-number', '16', '--encoder-kernel-size', '8', "
        "'--encoder-padding', '2', '--generator-hidden-dim', '32', "
        "'--minibatch-size', '20', '--num-epochs', '1', '-d', '-1', "
        "'--data-root', root + '/data', '--log-root', root + '/logs'])\n"
        "run = root + '/logs/' + os.listdir(root + '/logs')[0]\n"
        "from targetvae_tpu_torch.cli.clustering_common import load_encoder\n"
        "em, ep = load_encoder(run + '/inference.sav', device='cpu')\n"
        "y = torch.rand(3, 12, 12, 1)\n"
        "assert torch.equal(em.embed(ep, y)['dx'], "
        "st.model.embed(st.model.params(), y)['dx'])\n"
        "from targetvae_tpu_torch.train import load_train_state\n"
        "fresh = train_mnist.TargetVAE(st.model.cfg, 'cpu')\n"
        "st2, _, host = load_train_state(run + '/training_state.sav', "
        "Trainer(fresh, TrainConfig()).init_state(1))\n"
        "assert st2.step == st.step == 2 and int(host['epoch']) == 1\n"
        "rng = np.random.default_rng(1)\n"
        "np.save(root + '/data/mnist_test.npy', rng.integers(0, 256, "
        "(10, 12, 12), dtype=np.uint8))\n"
        "np.save(root + '/data/mnist_U/transforms_test.npy', "
        "rng.normal(size=(10, 3)))\n"
        "np.save(root + '/labels.npy', np.arange(10) % 2)\n"
        "from targetvae_tpu_torch.cli import clustering_mnist\n"
        "res = clustering_mnist.main(['--image-dim', '12', '--data-root', "
        "root + '/data', '--path-to-encoder', run + '/inference.sav', "
        "'--path-to-labels', root + '/labels.npy', '--n-clusters', '2', "
        "'-d', '-1'])\n"
        "assert res['acc'] >= 0.5 and os.path.exists(run + '/results.txt')\n"
        "from targetvae_tpu_torch.utils.png import png_size\n"
        "assert png_size(run + '/tsne.png') == (1000, 1000)\n"
        "assert png_size(run + '/confusion_matrix.png')[0] > 0\n"
        "from targetvae_tpu_torch.cli import (embed_stack, reconstruct, "
        "export_torch_checkpoint)\n"
        "sav, gsav = export_torch_checkpoint.main([run, '--out-dir', "
        "root + '/ref'])\n"
        "rm, rp = load_encoder(sav, device='cpu')\n"
        "assert torch.equal(rm.embed(rp, y)['dx'], em.embed(ep, y)['dx'])\n"
        "np.save(root + '/y.npy', np.random.default_rng(2).uniform(size=("
        "6, 12, 12)).astype(np.float32))\n"
        "out = embed_stack.main(['--input', root + '/y.npy', "
        "'--path-to-encoder', sav, '--out', root + '/emb/a', '-d', '-1'])\n"
        "assert np.load(root + '/emb/a_z.npy').shape == (6, 4)\n"
        "rec = reconstruct.main(['--path-to-encoder', sav, "
        "'--path-to-generator', gsav, '--images', root + '/y.npy', "
        "'--n', '3', '-d', '-1'])\n"
        "assert png_size(rec['out']) == (44, 44)\n"
        "for t, g in (('unimodal', 4), ('attention', 0), ('attention', 8)):\n"
        "    mb = TargetVAE(ModelConfig(GeneratorConfig(hidden_dim=64, "
        "fourier_expansion=True, embedding_dim=64), EncoderConfig("
        "t_inf=t, r_inf='unimodal', image_dim=14, kernels_num=16, "
        "groupconv=g)), device='cpu')\n"
        "    pb = mb.init(torch.Generator().manual_seed(0))\n"
        "    o = mb.embed(pb, torch.rand(2, 14, 14, 1), torch.bfloat16)\n"
        "    assert o['dx'].shape == (2, 2)\n"
        "    tb = Trainer(mb, TrainConfig(compute_dtype='bfloat16'))\n"
        "    sb, mt = tb.train_step(tb.init_state(0), torch.rand(2, 14, 14, 1))\n"
        "    assert bool(torch.isfinite(mt).all())\n"
        "from targetvae_tpu_torch.utils import bench_log, flops\n"
        "import importlib.util\n"
        "def tool(name):\n"
        "    spec = importlib.util.spec_from_file_location(name, "
        "'tools/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "bct = tool('bench_config_torch')\n"
        "for name in bct.CONFIGS:\n"
        "    c, n, ch, with_ctf = bct.build(name)\n"
        "    tf = flops.step_flops(c, 100, n - 1 if with_ctf else None)\n"
        "    assert tf['total'] > 0 and flops.kernel_products(c, 100)\n"
        "assert bct.ctf_table(3, 110).shape == (3, 109, 109)\n"
        "bench_log.record({'config': 'x', 'batch': 1, 'dtype': 'float32', "
        "'tier': 'conv', 'device': 'cpu'}, root + '/h.jsonl')\n"
        "assert len(bench_log.load_history(root + '/h.jsonl')) == 1\n"
        "assert tool('score_clusters_torch').main([root + '/labels.npy', "
        "root + '/labels.npy']) == 0\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
