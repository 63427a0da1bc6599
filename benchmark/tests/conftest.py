"""Fixtures of the benchmark's tests: a checkout root holding a throwaway
cell made from new files only, at a size the CPU runs in seconds, and the
card for the tests that need it.

Run them from the repository's root: `python -m pytest benchmark/tests
-q`; on the card the same command also runs the tests that need it.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAIN_NUMBERS = ("loss_gap", "kl_gap", "grad_gap", "update_gap",
                 "decoder_diff", "decoder_worst")
EMBED_NUMBERS = ("cell_gap", "z_gap", "theta_gap", "dx_gap")


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")
    return torch.device("cuda", 0)


def tiny_config(source: str) -> dict:
    """A configuration file of the benchmark cut to a CPU test's size (the
    widths the port's kernel tier takes: K 16, R 4)."""
    cfg = json.loads((ROOT / "benchmark/configs" / f"{source}.json")
                     .read_text())
    e, g = cfg["model"]["encoder"], cfg["model"]["generator"]
    if cfg["data"]["kind"] == "particles":
        e.update(image_dim=20, kernels_size=9, padding=3)
        cfg["ctf_dim"] = 19
        cfg["model"]["likelihood"]["mask_radius"] = 8
        cfg["data"]["micrographs"] = 5
    else:
        e.update(image_dim=16, kernels_size=7, padding=2)
    e.update(kernels_num=16, groupconv=4)
    g.update(hidden_dim=32, embedding_dim=64,
             fourier_sigma=2.0 / (e["image_dim"] - 1))
    cfg["train_images"], cfg["minibatch_size"] = 44, 8
    return cfg


def make_root(tmp: Path, source: str, limit: float = 1.0) -> Path:
    """A checkout root with the benchmark and, added as new files and new
    entries only, the cells tiny.train and tiny.embed of a cut copy of
    configuration `source`, a traffic mix of their own, their limits and
    a per-layer metric of their own (count.steps)."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    (b / "configs/tiny.json").write_text(json.dumps(tiny_config(source)))
    mix = json.loads((b / "traffic/embed-stack.json").read_text())
    mix.update(stack="train_images", minibatch_size=8)
    (b / "traffic/tiny-embed.json").write_text(json.dumps(mix))
    (b / "metrics/count.steps.py").write_text(
        "def read(trace):\n    return float(trace.run.steps)\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test's cut"})
    cells = {"tiny.train": "train-resident", "tiny.embed": "tiny-embed"}
    bench["workloads"] += [{"name": n, "config": "tiny", "traffic": t,
                            "chips": 1, "why": "a test's cell"}
                           for n, t in cells.items()]
    # the tiny cells report what the cells of `source` of their kind report
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in cells
                               if f"{source}.{c.split('.')[1]}"
                               in m["workloads"]]
    bench["per_layer"].append({
        "name": "count.steps", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_img_s", "workloads": ["tiny.train"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, names in (("tiny.train", TRAIN_NUMBERS),
                        ("tiny.embed", EMBED_NUMBERS)):
        (b / "limits" / f"{cell}.json").write_text(
            json.dumps({k: {"limit": limit} for k in names}))
    return tmp


@pytest.fixture(params=["mnist-u-p8", "empiar-10025"])
def tiny_root(request, tmp_path):
    return make_root(tmp_path, request.param)
