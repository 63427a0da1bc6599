"""tools/bench_config_torch.py (the port's per-config train-step bench) held
against tools/bench_config.py, and tools/score_clusters_torch.py against
tools/score_clusters.py, on the CPU."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from targetvae_tpu_torch.data.ctf import ctf_filter
from targetvae_tpu_torch.utils import bench_log, flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("bench_config_torch")

# tools/bench_config.py sets JAX's compilation cache when it is imported, so
# it is read in a process of its own, with the cache in a temporary folder
_JAX_BUILDS = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1] + '/tools')\n"
    "import bench_config\n"
    "out = {}\n"
    "for name in json.loads(sys.argv[2]):\n"
    "    cfg, n, c, ctf = bench_config.build(name)\n"
    "    out[name] = [json.loads(cfg.to_json()), n, c,\n"
    "                 None if ctf is None else list(ctf.shape)]\n"
    "print(json.dumps(out))\n")


@pytest.fixture(scope="module")
def jax_builds(tmp_path_factory):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path_factory.mktemp("jc")))
    res = subprocess.run([sys.executable, "-c", _JAX_BUILDS, REPO,
                          json.dumps(TOOL.CONFIGS)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", TOOL.CONFIGS)
def test_configs_equal_the_jax_tools(name, jax_builds):
    """Each config equals tools/bench_config.py::build's field by field
    (model config, image size, channels), with a CTF table where that
    tool has one, of its kernel size; the default batches are that
    tool's."""
    cfg, n, c, with_ctf = TOOL.build(name)
    ref_cfg, ref_n, ref_c, ref_ctf = jax_builds[name]
    assert json.loads(cfg.to_json()) == ref_cfg
    assert (n, c) == (ref_n, ref_c)
    assert with_ctf == (ref_ctf is not None)
    if with_ctf:
        assert TOOL.ctf_table(2, n).shape[1:] == tuple(ref_ctf[1:])
    assert TOOL.DEFAULT_BATCH[name] == (100 if name.startswith("mnist")
                                        else 50)


def test_ctf_table_covers_the_batch_in_ctf_filters_units():
    """particles-ctf's table is built for the whole batch (600 rows, past
    the JAX tool's 512-row table it slices), in ctf_filter's units: each
    row's defocus in um (1.0-2.5) and the amplitude contrast in percent
    (7), unlike the JAX tool's A and fraction (read as 1-2.5 cm)."""
    b, n = 600, 110
    got = TOOL.ctf_table(b, n)
    assert got.shape == (b, n - 1, n - 1) and got.dtype == np.float32
    assert np.isfinite(got).all()

    def one(defocus, ampcont):
        return ctf_filter({"defocus": [defocus], "cs": [2.0],
                           "voltage": [300.0], "apix": [1.5],
                           "bfactor": [0.0], "ampcont": [ampcont],
                           "dfdiff": [0.0], "dfang": [0.0]}, n - 1, n - 1)[0]

    for i in (0, 511, 599):
        um = 1.0 + 1.5 * i / (b - 1)
        np.testing.assert_allclose(got[i], one(um, 7.0), rtol=0, atol=1e-6)
    jax_units = one(10000.0, 0.07)
    assert np.abs(got[0] - jax_units).max() > 0.1 * np.abs(got[0]).max()


def test_cpu_run_prints_and_records_its_line(tmp_path, capsys):
    """One --device cpu --f32 --steps 1 --batch 4 run of mnist-a prints its
    JSON line (host-clock ms/step, img/s, TFLOP/step, no MFU on the CPU)
    and records it, with dtype and tier, to the given history."""
    hist = str(tmp_path / "h.jsonl")
    TOOL.main(["mnist-a", "--device", "cpu", "--f32", "--steps", "1",
               "--batch", "4", "--history", hist])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = TOOL.build("mnist-a")[0]
    assert (line["config"], line["batch"], line["dtype"], line["tier"],
            line["device"]) == ("mnist-a", 4, "float32", "conv", "cpu")
    assert line["tflops_per_step"] == flops.step_flops(cfg, 4)["total"] / 1e12
    assert line["ms_per_step"] > 0 and len(line["ms_windows"]) == 5
    assert line["images_per_sec"] == pytest.approx(
        4e3 / line["ms_per_step"])
    assert line["mfu"] is None and line["card"] is None \
        and line["power_limit"] is None
    assert line["launches_per_step"] == {}     # plain versions on the CPU
    assert bench_log.load_history(hist) == [line]


def test_tool_refuses_what_it_cannot_run():
    """--tier patch is mode C's bf16 encoder; the card is the default
    device, and without one the tool raises rather than run elsewhere."""
    for name, f32 in (("mnist-a", False), ("mnist-b", False),
                      ("mnist", True)):
        with pytest.raises(ValueError, match="patch"):
            TOOL.bench(name, f32=f32, tier="patch", device="cpu")
    import torch
    if torch.cuda.is_available():
        assert str(TOOL._device("cuda")) == "cuda:0"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TOOL._device("cuda")


def test_score_clusters_matches_the_jax_tool(tmp_path, capsys):
    """tools/score_clusters_torch.py (the port's cluster_acc) prints what
    tools/score_clusters.py prints on a random assignment scored against
    two label files, and both refuse a length mismatch."""
    rng = np.random.default_rng(5)
    pred = tmp_path / "pred.npy"
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    np.save(pred, rng.integers(0, 7, 300))
    np.save(a, rng.integers(0, 6, 200))
    np.save(b, rng.integers(0, 6, 100))
    mine, theirs = _load("score_clusters_torch"), _load("score_clusters")
    outs = []
    for tool in (mine, theirs):
        assert tool.main([str(pred), str(a), str(b)]) == 0
        outs.append(capsys.readouterr().out)
        assert tool.main([str(pred), str(a)]) == 2
    assert outs[0] == outs[1] and "clustering accuracy" in outs[0]
