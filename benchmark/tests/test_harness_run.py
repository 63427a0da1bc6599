"""A run end to end on the CPU, past the run's look for a card: the last
line's format, a cell added from new files only, the import guard, and
`correct` coming out false with the timed path broken underneath."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import guard, spec
from benchmark.run import run_cell
from benchmark.tests.conftest import ROOT, make_root

SEED = 2 ** 31 + 3


def _run(root, cell, trace=False, seconds=0.3):
    import time
    c = spec.load_cell(cell, root)
    return run_cell(c, SEED, seconds, trace, torch.device("cpu"),
                    time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tiny.train", "tiny.embed"])
def test_result_line(tiny_root, cell, trace):
    r = _run(tiny_root, cell, trace)
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    names = {m["name"] for m in (spec.load_cell(cell, tiny_root).per_layer
                                 if trace else
                                 spec.load_cell(cell, tiny_root).end_to_end)}
    assert set(r["metrics"]) <= names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        kind = "train" if cell.endswith("train") else "embed"
        want = {m["name"] for m in spec.load_cell(cell, tiny_root).end_to_end}
        assert set(r["metrics"]) == want
        assert {m.split(".")[0] for m in want} == {"setup_s", f"{kind}_img_s"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def test_a_cell_from_new_files_only_is_picked_up(tmp_path):
    root = make_root(tmp_path, "mnist-u-p8")
    names = [w["name"] for w in spec.load_benchmark(root)["workloads"]]
    assert "tiny.train" in names
    cell = spec.load_cell("tiny.train", root)
    assert cell.config["model"]["encoder"]["image_dim"] == 16
    assert "count.steps" in [m["name"] for m in cell.per_layer]
    r = _run(root, "tiny.train", trace=True)
    assert r["metrics"]["count.steps"]["value"] > 0
    assert r["correct"]


def _break_step_state(monkeypatch):
    """A step that returns its state unchanged."""
    from targetvae_tpu_torch.train import loop
    real = loop.Trainer._step

    def step(self, state, y, w=None, ctf=None):
        saved = [p.detach().clone() for p in state.model.parameters()]
        state, m = real(self, state, y, w, ctf)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        state.optimizer.state.clear()
        return state, m
    monkeypatch.setattr(loop.Trainer, "_step", step)


def _break_step_half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from targetvae_tpu_torch.train import loop
    real = loop.Trainer._step

    def step(self, state, y, w=None, ctf=None):
        h = max(1, y.shape[0] // 2)
        return real(self, state, y[:h], None if w is None else w[:h],
                    None if ctf is None else ctf[:h])
    monkeypatch.setattr(loop.Trainer, "_step", step)


def _break_answer(monkeypatch):
    """An answer altered where it is produced: one image's z moved."""
    from targetvae_tpu_torch.models import targetvae
    real = targetvae.TargetVAE.embed

    def embed(self, params, y, compute_dtype=None):
        out = real(self, params, y, compute_dtype)
        out["z_content"][0] += 0.5
        return out
    monkeypatch.setattr(targetvae.TargetVAE, "embed", embed)


@pytest.mark.parametrize("fault,cell", [
    (_break_step_state, "tiny.train"), (_break_step_half, "tiny.train"),
    (_break_answer, "tiny.embed")])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            cell):
    """With the limits each cell's file holds for its own size: a fault
    reads far above them (the program at this size reads below)."""
    limits = {"tiny.train": "mnist-u-p8.train",
              "tiny.embed": "mnist-u-p8.embed"}
    root = make_root(tmp_path, "mnist-u-p8")
    real = json.loads((ROOT / "benchmark/limits" / f"{limits[cell]}.json")
                      .read_text())
    (root / "benchmark/limits" / f"{cell}.json").write_text(json.dumps(real))
    assert _run(root, cell)["correct"] is True
    fault(monkeypatch)
    assert _run(root, cell)["correct"] is False


def test_guard_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen",
             "targetvae_tpu.models", "targetvae_tpu_torch.kernels",
             "jaxtyping", "flaxen", "benchmark.guard"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla",
        "targetvae_tpu.models"]
    assert guard.reference_violations() == []


def test_guard_finds_a_reference_that_imports_the_port(tmp_path):
    (tmp_path / "bad.py").write_text(
        "import torch\nfrom targetvae_tpu_torch.kernels import x\n"
        "from . import model\n")
    assert guard.reference_violations(tmp_path) == [
        ("bad.py", "targetvae_tpu_torch")]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run in a fresh process (on the CPU, past the look for a
    card), then the guard over its modules."""
    root = make_root(tmp_path, "empiar-10025")
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from benchmark import guard, spec\n"
        "from benchmark.run import run_cell\n"
        "for c in ('tiny.train', 'tiny.embed'):\n"
        "    run_cell(spec.load_cell(c, __import__('pathlib').Path(%r)), 5,"
        " 0.2, True, torch.device('cpu'), time.perf_counter())\n"
        "print(guard.forbidden_modules())\n") % (str(ROOT), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_a_card_or_outside_a_checkout(tmp_path, alone):
    """Without a CUDA device the run exits 2 and prints nothing; in a
    directory holding only BENCHMARK.json and the benchmark's files it
    fails too (the port is not there)."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("this machine has a card")
    cwd = ROOT
    if alone:
        import shutil
        shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mnist-u-p8.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=cwd)
    assert out.returncode != 0 and out.stdout.strip() == ""
    if not alone:
        assert out.returncode == 2
