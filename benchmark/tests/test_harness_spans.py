"""benchmark/spans.py's charging rule and the readers of the port's spans,
on hand-built traces: each idle gap to the innermost tvae.* span of the
launch that ends it, to the backward, to the time between two requests or
to the window's edges; the buckets summing to the idle seconds; each
reader None where it has nothing to read."""

import pytest

from benchmark import spans, spec
from benchmark.drive import Window
from benchmark.trace import DeviceOp, Trace

TRAIN_CHAIN = ("aten::mm", "tvae.encoder", "tvae.forward", "tvae.step",
               "tvae.epoch", "bench.epoch", "bench.window")
BACKWARD_CHAIN = ("aten::mm", "autograd::engine::evaluate_function: "
                  "MmBackward0")
STAGE_CHAIN = ("aten::copy_", "tvae.embed.stage", "tvae.embed",
               "bench.request", "bench.window")
BATCH_CHAIN = ("aten::cudnn_convolution", "tvae.lift", "tvae.encoder",
               "tvae.embed.batch", "tvae.embed", "bench.request")
OUT_CHAIN = ("aten::copy_", "aten::_to_copy", "tvae.embed.out",
             "tvae.embed", "bench.request")


def _op(start, end, chain):
    return DeviceOp("kernel", start, end, chain)


def _trace(ops, kind, window=(0.0, 16.0), **run):
    t = Trace(device=ops, window=window)
    t.run = Window(kind, window[1] - window[0], None, **run)
    return t


def _train():
    """Busy 1-2, 2.5-4 (two ops, the second inside the first), 6-7, 9-10
    in a window of 0-16."""
    return _trace([
        _op(1.0, 2.0, TRAIN_CHAIN),
        _op(2.5, 4.0, ("aten::add", "tvae.optimizer", "tvae.step")),
        _op(3.0, 3.5, TRAIN_CHAIN),
        _op(6.0, 7.0, BACKWARD_CHAIN),
        _op(9.0, 10.0, ("aten::randperm", "bench.epoch", "bench.window")),
    ], "train", steps=4, images=400)


def _embed():
    """Two requests: stage, batch, out (two copies); then stage, batch,
    stage, batch, out."""
    return _trace([
        _op(1.0, 2.0, STAGE_CHAIN),
        _op(2.25, 4.0, BATCH_CHAIN),
        _op(4.5, 5.0, OUT_CHAIN),
        _op(5.25, 5.5, OUT_CHAIN),
        _op(8.0, 8.5, STAGE_CHAIN),
        _op(8.5, 10.0, BATCH_CHAIN),
        _op(12.0, 12.5, STAGE_CHAIN),
        _op(12.5, 13.0, BATCH_CHAIN),
        _op(14.0, 14.5, OUT_CHAIN),
    ], "embed", images=200, attempted=2)


def test_each_gap_goes_to_the_launch_that_ends_it():
    assert spans.gaps(_train()) == [
        (1.0, spans.OUTSIDE), (0.5, "tvae.optimizer"),
        (2.0, spans.BACKWARD), (2.0, spans.UNSPANNED),
        (6.0, spans.OUTSIDE)]


def test_a_gap_after_a_request_s_copy_out_lies_between_requests():
    """The gap inside tvae.embed.out (between its two copies) is the out
    stage's own; the one after it, ended by the next request's staging,
    is the request's."""
    assert spans.gaps(_embed()) == [
        (1.0, spans.OUTSIDE), (0.25, "tvae.lift"), (0.5, "tvae.embed.out"),
        (0.25, "tvae.embed.out"), (2.5, spans.REQUEST),
        (2.0, "tvae.embed.stage"), (1.0, "tvae.embed.out"),
        (1.5, spans.OUTSIDE)]


@pytest.mark.parametrize("make", [_train, _embed])
def test_the_buckets_sum_to_the_idle_seconds(make):
    t = make()
    assert sum(spans.charge(t).values()) == t.window_s - t.busy_s


def test_an_empty_window_is_outside():
    t = _trace([], "train", steps=1, images=100)
    assert spans.charge(t) == {spans.OUTSIDE: 16.0}


def test_a_stretch_that_runs_to_the_window_s_edges_has_no_outside():
    t = _trace([_op(0.0, 4.0, TRAIN_CHAIN), _op(5.0, 16.0, TRAIN_CHAIN)],
               "train", steps=1, images=100)
    assert spans.charge(t) == {"tvae.encoder": 1.0}


def _read(name, trace):
    return spec.metric_reader(name).read(trace)


def test_the_readers_read_the_charge():
    t, e = _train(), _embed()
    for name in ("step_gap_ms.train", "step_gap_ms.train.particles"):
        # the optimizer's 0.5 s and the backward's 2 s over 4 steps
        assert _read(name, t) == pytest.approx(2.5e3 / 4)
    for name in ("staging_gap_ms.embed", "staging_gap_ms.embed.particles"):
        assert _read(name, e) == pytest.approx(2.0e3 / 2)
    for name in ("request_gap_ms.embed", "request_gap_ms.embed.particles"):
        assert _read(name, e) == pytest.approx(2.5e3)
    patches = _trace([_op(1.0, 1.5, ("aten::copy_", "tvae.patches",
                                     "tvae.encoder", "tvae.forward",
                                     "tvae.step")),
                      _op(2.0, 4.0, TRAIN_CHAIN)], "train", steps=2,
                     images=200)
    assert _read("patches_ms.train", patches) == pytest.approx(250.0)
    patches.run.kind = "embed"
    assert _read("patches_ms.embed", patches) == pytest.approx(250.0)


READERS = ["step_gap_ms.train", "step_gap_ms.train.particles",
           "staging_gap_ms.embed", "staging_gap_ms.embed.particles",
           "request_gap_ms.embed", "request_gap_ms.embed.particles",
           "patches_ms.train", "patches_ms.embed"]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_returns_none(name):
    """The other run kind, and a program without the spans (the chains
    carry the benchmark's and autograd's names only), read None."""
    for make in (_train, _embed):
        t = make()
        if name.split(".")[1] != t.run.kind:
            assert _read(name, t) is None
        for op in t.device:
            op.chain = tuple(n for n in op.chain
                             if not n.startswith("tvae."))
        assert _read(name, t) is None
