"""BENCHMARK.json and the files it names: the benchmark's contract, and
each configuration loaded into the port's config classes."""

import json
import re

import pytest

from benchmark import spec
from benchmark.tests.conftest import EMBED_NUMBERS, ROOT, TRAIN_NUMBERS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for key, keys in allowed.items():
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
        for e in BENCH[key]:
            assert set(e) <= keys and NAME.match(e["name"]), e
            for text in ("why", "layer", "source"):
                if text in e and key != "end_to_end" and key != "per_layer":
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        c = spec.load_cell(cell)
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            # the end-to-end metric it moves is reported in the cell
            assert m["moves"] in names, (cell, m["name"])
        assert c.chips == 1
        assert c.traffic["kind"] in ("train", "embed")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_limits_name_numbers_the_judge_reads(cell):
    c = spec.load_cell(cell)
    read = TRAIN_NUMBERS if c.traffic["kind"] == "train" else EMBED_NUMBERS
    assert c.limits and set(c.limits) <= set(read)
    for entry in c.limits.values():
        assert entry["limit"] is not None and entry["limit"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_loads_into_the_port(config):
    from targetvae_tpu_torch.utils.config import ModelConfig, TrainConfig
    cfg = json.loads((ROOT / config["file"]).read_text())
    model = ModelConfig.from_json(json.dumps(cfg["model"]))
    assert model.encoder.mode == "C" and model.generator.fourier_expansion
    assert model.encoder.kernels_num == 128 and model.encoder.groupconv == 8
    assert model.generator.hidden_dim == 512
    TrainConfig(learning_rate=cfg["learning_rate"],
                minibatch_size=cfg["minibatch_size"],
                compute_dtype=cfg["compute_dtype"])
    assert cfg["encoder_tier"] in ("conv", "patch")
    assert sorted(cfg["reduced"]) == sorted(config["reduced"])
    assert all(k in cfg for k in config["reduced"])
    assert config["file"].startswith("benchmark/")
