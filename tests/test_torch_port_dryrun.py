"""The multi-rank dry run (parallel/dryrun.py, the counterpart of
__graft_entry__.py::dryrun_multichip) on 4 CPU gloo ranks, one spawn for
the module, at the JAX dry run's shapes: the DP x TP step, the --sp step
(the float32 tier's grid-sharded posterior), a ragged-tail epoch at tp = 2
and mode B with the Gaussian likelihood, CTF kernels and the mask; and the
new modules import no JAX.
"""

import numpy as np
import pytest

from targetvae_tpu_torch.parallel import dryrun


@pytest.fixture(scope="module")
def reports():
    return dryrun.dryrun_multichip(4, "cpu")


def test_four_scenarios_run_on_a_data_2_model_2_layout(reports):
    """Each rank sits at (data, model) = (r // 2, r % 2); every scenario's
    metrics are finite and equal on the 4 ranks (dryrun_multichip raises
    otherwise), with elbo = log_p - kl (the epoch reports gen_loss =
    -log_p), and its steps taken: one step each, two for the ragged epoch
    of 2 B - 1 = 7 rows at B = 4."""
    assert [r["mesh"] for r in reports] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key, (_, steps) in dryrun.SCENARIOS.items():
        for r in reports:
            m = r[key]["metrics"] * ([1, -1, 1] if key == "ragged" else 1)
            assert r[key]["steps"] == steps
            assert np.isfinite(m).all()
            np.testing.assert_allclose(m[0], m[1] - m[2], rtol=1e-5,
                                       atol=1e-4)


def test_dryrun_refuses_a_layout_without_a_model_pair():
    """The dry run's layout is (world // 2, 2): fewer than 4 ranks or an
    odd count is refused before anything is spawned."""
    for world in (2, 3, 5):
        with pytest.raises(ValueError, match="even world"):
            dryrun.dryrun_multichip(world, "cpu")


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """With no device named the dry run's ranks share cuda:0; where there
    is no CUDA device it raises before anything is spawned, and never
    falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)


def test_scenario_four_ctf_in_physical_units():
    """Scenario 4's CTF kernels come from ctf_filter in its own units
    (defocus in um, amplitude contrast in percent), as the JAX package's
    ctf_filter reads the same table: the two packages' kernels agree, and
    the spread of defocus makes them differ image to image."""
    import pandas as pd
    from targetvae_tpu.data.ctf import ctf_filter as jax_ctf_filter
    got = dryrun.ctf_kernels(4, 16, 8.0)
    table = pd.DataFrame({
        "defocus": np.linspace(1.0, 2.5, 4), "cs": 2.0, "voltage": 300.0,
        "apix": 8.0, "bfactor": 0.0, "ampcont": 7.0, "dfdiff": 0.0,
        "dfang": 0.0})
    ref = np.asarray(jax_ctf_filter(table, 15, 15), np.float32)
    assert got.shape == (4, 15, 15)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(got[0] - got[-1]).max() > 1e-3


def test_new_modules_import_no_jax():
    """The TP layout, the sharded state, the float32 SP posterior and the
    dry run import with JAX and the JAX package blocked, and a one-rank
    group runs the float32 grid-sharded ELBO."""
    import subprocess
    import sys
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, tempfile\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'targetvae_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch, torch.distributed as dist\n"
        "import targetvae_tpu_torch.parallel.pjit\n"
        "import targetvae_tpu_torch.parallel.dryrun as d\n"
        "from targetvae_tpu_torch import TargetVAE\n"
        "from targetvae_tpu_torch.losses.elbo import compute_elbo\n"
        "dist.init_process_group('gloo', init_method='file://' + "
        "tempfile.mktemp(), rank=0, world_size=1)\n"
        "cfg = d.mode_b_config()\n"
        "m = TargetVAE(cfg, 'cpu')\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "out = compute_elbo(p, cfg, m.base_grid(), torch.rand(2, 16, 16, 1), "
        "torch.Generator().manual_seed(1), sp=dist.group.WORLD)\n"
        "assert all(bool(torch.isfinite(t)) for t in out)\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
