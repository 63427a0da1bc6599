"""The port's bench history (targetvae_tpu_torch/utils/bench_log.py): entries
round-trip, the key keeps dtype and encoder tier apart, each entry carries
the card's name and power limit (None on the CPU), and the JAX package's
bench_results.jsonl and BENCH_NOTES.md are never written."""

from __future__ import annotations

import hashlib
import os
import types

import pytest

from targetvae_tpu_torch.utils import bench_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry(**kw):
    e = {"config": "mnist", "batch": 100, "dtype": "bfloat16",
         "tier": "conv", "device": "cpu", "ms_per_step": 30.5,
         "images_per_sec": 3278.7, "tflops_per_step": 1.795, "mfu": None}
    e.update(kw)
    return e


def test_entries_round_trip(tmp_path):
    path = str(tmp_path / "h.jsonl")
    a = bench_log.record(_entry(), path)
    b = bench_log.record(_entry(config="particles-ctf", batch=600,
                                ms_per_step=4512.25), path)
    hist = bench_log.load_history(path)
    assert hist == [a, b]
    for e in hist:
        assert e["ts"] and e["card"] is None and e["power_limit"] is None
    assert hist[1]["batch"] == 600 and hist[1]["ms_per_step"] == 4512.25
    assert bench_log.load_history(str(tmp_path / "none.jsonl")) == []


@pytest.mark.parametrize("field,other", [("dtype", "float32"),
                                         ("tier", "patch"), ("batch", 256)])
def test_key_separates_dtype_tier_and_batch(tmp_path, field, other):
    """Two runs of one config differing in dtype, tier or batch keep their
    own rows; a rerun with the same key replaces its row."""
    path = str(tmp_path / "h.jsonl")
    bench_log.record(_entry(ms_per_step=30.0), path)
    bench_log.record(_entry(**{field: other, "ms_per_step": 8.3}), path)
    bench_log.record(_entry(ms_per_step=31.0), path)
    latest = bench_log.latest_per_config(path)
    assert len(latest) == 2
    assert latest[("mnist", 100, "bfloat16", "conv")]["ms_per_step"] == 31.0
    key = bench_log.history_key(_entry(**{field: other}))
    assert latest[key]["ms_per_step"] == 8.3
    table = bench_log.render_table(latest)
    assert table.count("\n| mnist |") == 2 and "| cpu |" in table


def test_record_refuses_an_entry_without_its_key(tmp_path):
    e = _entry()
    del e["tier"]
    with pytest.raises(ValueError, match="tier"):
        bench_log.record(e, str(tmp_path / "h.jsonl"))


def test_card_stamp_reads_nvidia_smi(monkeypatch, tmp_path):
    """A run on the card is stamped with nvidia-smi's name and power limit;
    where nvidia-smi is missing (this machine), both are None."""
    out = "NVIDIA H100 80GB HBM3, 700.00 W\n"
    monkeypatch.setattr(bench_log.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=out))
    e = bench_log.record(_entry(device="NVIDIA H100 80GB HBM3", mfu=0.06),
                         str(tmp_path / "h.jsonl"))
    assert (e["card"], e["power_limit"]) == ("NVIDIA H100 80GB HBM3",
                                             "700.00 W")
    assert "| 6.0% | NVIDIA H100 80GB HBM3, 700.00 W |" in \
        bench_log.render_table(bench_log.latest_per_config(
            str(tmp_path / "h.jsonl")))

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(bench_log.subprocess, "run", missing)
    assert bench_log.card_stamp() == {"card": None, "power_limit": None}


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_jax_bench_files_keep_their_bytes(tmp_path, monkeypatch):
    """record() at its default path writes the port's own history file and
    nothing of the JAX package's (bench_results.jsonl, BENCH_NOTES.md)."""
    theirs = [os.path.join(REPO, f) for f in ("bench_results.jsonl",
                                              "BENCH_NOTES.md")]
    before = [_digest(p) for p in theirs]
    assert bench_log.RESULTS_PATH == os.path.join(REPO,
                                                  "bench_results_torch.jsonl")
    mine = str(tmp_path / "bench_results_torch.jsonl")
    monkeypatch.setattr(bench_log, "RESULTS_PATH", mine)
    bench_log.record(_entry())
    assert [_digest(p) for p in theirs] == before
    assert len(bench_log.load_history()) == 1
