"""The port's spans (utils/trace.py) under a CPU-only torch.profiler: the
train step's and the embed request's span trees, their scope, and the
kernel tier's fallback counters (kernels.launch_counts' "fallback.*")."""

import json
import os

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig, TargetVAE, kernels
from targetvae_tpu_torch.cli.clustering_common import embed_dataset
from targetvae_tpu_torch.train import RunLogger, Trainer, fit
from targetvae_tpu_torch.utils.config import TrainConfig
from targetvae_tpu_torch.utils.trace import span

D = 14
STEP_CHILDREN = {"tvae.forward", "tvae.backward", "tvae.optimizer"}


def _config(**widths):
    enc = dict(image_dim=D, z_dim=2, kernels_num=16, kernels_size=8,
               padding=3, groupconv=4)
    gen = dict(z_dim=2, hidden_dim=64, n_out=1, num_layers=2,
               fourier_expansion=True, fourier_sigma=2.0 / (D - 1),
               embedding_dim=64)
    for k, v in widths.items():
        (gen if k == "hidden_dim" else enc)[k] = v
    gen["z_dim"] = enc["z_dim"]
    return ModelConfig.from_json(json.dumps(
        {"encoder": enc, "generator": gen,
         "likelihood": {"kind": "bernoulli"}}))


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, D, D, 1)).astype(
        np.float32)


def _trainer(dtype, **widths):
    tr = Trainer(_config(**widths),
                 TrainConfig(minibatch_size=8, compute_dtype=dtype),
                 device="cpu")
    return tr, tr.init_state(0)


def _spans(fn):
    """Run fn under a CPU-only profiler: [(name, parent name or None,
    is_user_annotation)] of every tvae.* event in start order, the parent
    the innermost tvae.* event around it on its thread."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("tvae.")),
                    key=lambda e: (e.start_ns(), -e.end_ns()))
    out, stacks = [], {}
    for e in events:
        stack = stacks.setdefault(e.start_thread_id(), [])
        while stack and stack[-1].end_ns() <= e.start_ns():
            stack.pop()
        out.append((e.name(), stack[-1].name() if stack else None,
                    e.is_user_annotation()))
        stack.append(e)
    return out


def _children(spans, parent):
    return {name for name, p, _ in spans if p == parent}


@pytest.mark.parametrize("dtype,tier,lift", [
    (None, "conv", "tvae.lift"),
    ("bfloat16", "conv", "tvae.lift"),
    ("bfloat16", "patch", "tvae.patches")])
def test_a_train_epoch_emits_the_step_tree(monkeypatch, dtype, tier, lift):
    """20 images at B = 8: one tvae.epoch around three tvae.step (two
    batches and the tail), each of forward, backward and optimizer, the
    model's stages inside the forward and the encoder's lift or patches
    inside the encoder; the metrics' reads in tvae.collect."""
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", tier)
    tr, st = _trainer(dtype)
    spans = _spans(lambda: tr.train_epoch(st, _images(20)))
    count = lambda n: sum(name == n for name, _, _ in spans)
    assert count("tvae.epoch") == 1
    assert count("tvae.step") == 3 and count("tvae.forward") == 3
    assert _children(spans, "tvae.epoch") == {"tvae.step", "tvae.collect"}
    assert _children(spans, "tvae.step") == STEP_CHILDREN
    assert _children(spans, "tvae.forward") == {
        "tvae.encoder", "tvae.posterior", "tvae.decoder", "tvae.likelihood"}
    assert _children(spans, "tvae.encoder") == {lift}
    assert not any(user for _, _, user in spans)


@pytest.mark.parametrize("n", [20, 16])
def test_embed_dataset_emits_the_request_tree(n):
    """One tvae.embed a call; tvae.embed.stage and tvae.embed.batch once a
    batch of 8 (the tail its own batch), tvae.embed.out once; the encoder
    inside each batch."""
    tr, _ = _trainer("bfloat16")
    model = tr.model
    spans = _spans(lambda: embed_dataset(model, model.params(), _images(n),
                                         8, "bfloat16"))
    batches = -(-n // 8)
    count = lambda name, parent: sum(s == name and p == parent
                                     for s, p, _ in spans)
    assert count("tvae.embed", None) == 1
    assert count("tvae.embed.stage", "tvae.embed") == batches
    assert count("tvae.embed.batch", "tvae.embed") == batches
    assert count("tvae.embed.out", "tvae.embed") == 1
    assert count("tvae.encoder", "tvae.embed.batch") == batches
    assert _children(spans, "tvae.embed") == {
        "tvae.embed.stage", "tvae.embed.batch", "tvae.embed.out"}
    assert not any(user for _, _, user in spans)


def test_a_span_without_a_profiler_enters_no_user_scope_range(monkeypatch):
    """span() is a FUNCTION-scope range: it goes through neither
    torch.profiler.record_function nor its op."""
    def refuse(*args, **kwargs):
        raise AssertionError("a user-scope record_function was entered")
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("tvae.epoch"):
        with span("tvae.step"):
            x = torch.ones(3) + 1
    assert float(x.sum()) == 6.0


def test_a_profiler_may_start_and_stop_inside_open_spans():
    """A profiler window opened inside a span and closed after it (as a
    window over the later steps of an epoch is), then one closed inside a
    span: nothing fails, and the trace holds the spans opened and closed
    inside the window, not the one opened before it (whether it holds one
    still open as it stops is torch's choice, version by version)."""
    cpu = [torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=cpu)
    with span("tvae.epoch"):
        prof.__enter__()
        with span("tvae.step"):
            x = torch.ones(3) + 1
    prof.__exit__(None, None, None)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "tvae.step" in names and "tvae.epoch" not in names
    prof = torch.profiler.profile(activities=cpu)
    prof.__enter__()
    with span("tvae.embed"):
        with span("tvae.embed.batch"):
            x = x + 1
        prof.__exit__(None, None, None)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "tvae.embed.batch" in names and float(x.sum()) == 9.0


FALLBACK_CASES = [
    ({}, {}),
    ({"kernels_num": 24}, {"encoder": 1}),
    ({"z_dim": 9}, {"encoder": 1, "posterior": 1}),
    ({"hidden_dim": 48}, {"pose_decoder": 1, "decoder": 1})]


@pytest.mark.parametrize("widths,want", FALLBACK_CASES)
def test_fallbacks_are_counted_on_the_bf16_tier(widths, want):
    """A width outside a kernel's range counts one fallback at its site a
    bf16 step (the decoder's twice: the pose decoder falls back to
    generator_apply, whose decoder kernel does not take it either); the
    float32 tier counts none; reset_launch_counts clears them."""
    for dtype in ("bfloat16", None):
        tr, st = _trainer(dtype, **widths)
        kernels.reset_launch_counts()
        tr.train_step(st, _images(8))
        got = {k.split(".", 1)[1]: v
               for k, v in kernels.launch_counts().items()
               if k.startswith("fallback.") and v}
        assert got == (want if dtype else {})
    kernels.reset_launch_counts()
    assert not any(v for v in kernels.launch_counts().values())


def test_fit_logs_an_epoch_s_fallbacks(tmp_path):
    """fit logs '# kernel fallbacks: ...' once for each epoch that had any:
    two epochs of 8 training and 8 test images at B = 8, hidden 48."""
    lg = RunLogger(str(tmp_path), "run")
    fit(TargetVAE(_config(hidden_dim=48), device="cpu"),
        TrainConfig(minibatch_size=8, num_epochs=2,
                    compute_dtype="bfloat16"), lg, _images(8), _images(8, 1))
    lg.close()
    log = open(os.path.join(lg.path_prefix, "train_log.txt")).read()
    lines = [ln for ln in log.splitlines() if ln.startswith("# kernel")]
    # each epoch: one train step and one eval batch, each decoding once
    assert lines == ["# kernel fallbacks: pose_decoder 2, decoder 2"] * 2
