"""The multi-rank dry run (the counterpart of __graft_entry__.py::
dryrun_multichip): the training step's four sharded scenarios on a (data,
model = 2) layout of ranks, each a check that the composition runs and
reports finite metrics, at the JAX dry run's shapes (16 x 16 images, 32
kernels, hidden 64, 2 rows a data shard, 15 x 15 CTF kernels at 8 A/px).

1. the DP x TP step: the batch split over every rank, the parameters and
   Adam's moments sharded over the model axis;
2. the --sp step: the posterior's cells sharded over the model axis (the
   float32 tier's posterior_block);
3. a ragged-tail epoch at tp = 2: 2 B - 1 rows, a full batch and a tail
   padded with zero-weight rows, two steps;
4. mode B (attention x unimodal, an image-sized conv) with the Gaussian
   likelihood, per-image CTF kernels and the mask, TP-sharded.

The ranks run on one host (run_local over gloo), sharing one card, or on
the CPU where the caller asks for it. The CTF table of scenario 4 is in
ctf_filter's units (defocus in um, amplitude contrast in percent).
"""

from __future__ import annotations

import numpy as np

ROWS = 2            # rows of a batch a data shard holds
APIX = 8.0          # scenario 4's pixel size (A)
TIMEOUT = 600.0     # seconds the ranks may take in all


def flagship_config():
    """Scenarios 1-3's model: the JAX dry run's mode C at 16 x 16, 32
    kernels, hidden 64, the Bernoulli likelihood."""
    from ..utils.config import (EncoderConfig, GeneratorConfig,
                                LikelihoodConfig, ModelConfig)
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=64, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / 15),
        encoder=EncoderConfig(image_dim=16, in_channels=1, z_dim=2,
                              kernels_num=32, kernels_size=9, padding=4,
                              groupconv=4),
        likelihood=LikelihoodConfig(kind="bernoulli"))


def mode_b_config():
    """Scenario 4's model: mode B (attention x unimodal) at the same widths
    with the Gaussian likelihood and a mask."""
    from ..utils.config import (EncoderConfig, GeneratorConfig,
                                LikelihoodConfig, ModelConfig)
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=64, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / 15),
        encoder=EncoderConfig(t_inf="attention", r_inf="unimodal",
                              image_dim=16, in_channels=1, z_dim=2,
                              kernels_num=32, kernels_size=9, padding=4,
                              groupconv=0, theta_prior=np.pi),
        likelihood=LikelihoodConfig(kind="gaussian", mask_radius=6))


def ctf_kernels(n: int, size: int, apix: float) -> np.ndarray:
    """(n, size - 1, size - 1) real-space CTF kernels (ctf_filter) over the
    JAX dry run's defocus spread, 1.0-2.5 um, cs 2.0 mm, 300 kV, amplitude
    contrast 7 %, no B-factor."""
    from ..data.ctf import ctf_filter
    full = lambda v: np.full(n, v)
    table = {"defocus": np.linspace(1.0, 2.5, n), "cs": full(2.0),
             "voltage": full(300.0), "apix": full(apix),
             "bfactor": full(0.0), "ampcont": full(7.0),
             "dfdiff": full(0.0), "dfang": full(0.0)}
    return ctf_filter(table, size - 1, size - 1).astype(np.float32)


def dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank's run of the four scenarios on a (world // 2, 2) layout, on
    the float32 tier: each scenario's metrics, its steps and the rank's
    place."""
    import torch
    from ..train import Trainer
    from ..utils.config import TrainConfig
    data = world // 2
    batch = ROWS * data
    dev = torch.device(device)
    flagship, mode_b = flagship_config(), mode_b_config()
    d = flagship.encoder.image_dim
    g = torch.Generator().manual_seed(1)
    y = torch.rand((batch, d, d, 1), generator=g).to(dev)
    make = lambda model, **kw: Trainer(model, TrainConfig(
        learning_rate=1e-3, minibatch_size=batch, dp=data, tp=2, **kw), device=dev)
    out = {}

    tr = make(flagship)
    state = tr.init_state(0)
    state, m = tr.train_step(state, y)
    out["mesh"] = (tr.mesh.data_index, tr.mesh.rank)
    out["dp_tp"] = {"metrics": m.cpu().numpy(), "steps": state.step}

    tr = make(flagship, sp=True)
    state = tr.init_state(0)
    state, m = tr.train_step(state, y)
    out["sp"] = {"metrics": m.cpu().numpy(), "steps": state.step}

    tr = make(flagship)
    state = tr.init_state(0)
    rows = torch.rand((2 * batch - 1, d, d, 1), generator=g).to(dev)
    state, means = tr.train_epoch(state, rows)
    out["ragged"] = {"metrics": np.asarray(means), "steps": state.step}

    n = mode_b.encoder.image_dim
    yb = torch.rand((batch, n, n, 1), generator=g).to(dev)
    ctf = torch.from_numpy(ctf_kernels(batch, n, APIX)).to(dev)
    tr = make(mode_b)
    state = tr.init_state(0)
    state, m = tr.train_step(state, yb, ctf=ctf)
    out["mode_b"] = {"metrics": m.cpu().numpy(), "steps": state.step}
    return out


SCENARIOS = {"dp_tp": ("DP x TP step", 1), "sp": ("--sp step", 1),
             "ragged": ("ragged-tail epoch (2 B - 1 rows)", 2),
             "mode_b": ("mode-B + gaussian/CTF/mask step", 1)}


def dryrun_multichip(world: int = 4, device=None) -> list:
    """Run the four scenarios on `world` ranks (an even number, at least 4:
    a (world // 2, 2) layout) on this host over gloo, all on `device` (None:
    cuda:0, which they share, raising without CUDA; pass "cpu" for the
    CPU), and check them: every scenario's metrics finite and equal on the
    ranks, its steps taken. Prints a line for each; returns the ranks'
    reports."""
    from ..models.targetvae import resolve_device
    from .distributed import run_local
    if world < 4 or world % 2:
        raise ValueError(f"the dry run takes an even world of 4 or more "
                         f"ranks (data x model = 2), got {world}")
    device = str(resolve_device(device))
    ranks = run_local(dryrun_rank, world, backend="gloo", timeout=TIMEOUT,
                      args=(device,))
    for line in check_reports(ranks):
        print(f"# dryrun_multichip({world}): {line}", flush=True)
    return ranks


def check_reports(ranks: list) -> list:
    """The ranks' reports of dryrun_rank, checked: every scenario's
    metrics finite and equal on the ranks, its steps taken; raises
    otherwise. Returns a line for each scenario."""
    lines = []
    for key, (label, steps) in SCENARIOS.items():
        got = [r[key] for r in ranks]
        m = got[0]["metrics"]
        if not (all(np.isfinite(x["metrics"]).all() for x in got)
                and all(np.array_equal(x["metrics"], m) for x in got)
                and all(x["steps"] == steps for x in got)):
            raise RuntimeError(f"dry run: {label}: {got}")
        lines.append(f"mesh (data={len(ranks) // 2}, model=2), {label} ok, "
                     f"elbo={float(m[0]):.3f}")
    return lines
