"""The lift_roofline.* readers (benchmark/lift.py) on hand-built traces:
K13's bound over its launches' device time where the launch count is the
window's batches, None where it is not or the run is of the other kind."""

import json
from types import SimpleNamespace

import pytest

from benchmark import drive, lift, spec
from benchmark.drive import Window
from benchmark.tests.conftest import ROOT
from benchmark.trace import DeviceOp, Trace

K13 = ("void (anonymous namespace)::lift::fwd_kernel(CUtensorMap_st, "
       "CUtensorMap_st, float const*, (anonymous namespace)::lift::Shape)")
K1 = "void (anonymous namespace)::chain::fwd_kernel<0>(CUtensorMap_st)"


def _model():
    cfg = json.loads((ROOT / "benchmark/configs/mnist-u-p8.json")
                     .read_text())
    return drive.model_namespace(cfg["model"])


def _trace(kind, launches, ms_a_launch=0.5):
    """Two full batches and a tail of 50, one K13 launch each, and a K1
    launch beside each."""
    ops = []
    for i in range(3):
        t = 2.0 * i
        ops.append(DeviceOp(K13, t, t + ms_a_launch * 1e-3, ()))
        ops.append(DeviceOp(K1, t + 1.0, t + 1.5, ()))
    tr = Trace(device=ops, window=(0.0, 8.0))
    tr.run = Window(kind, 8.0, _model(), batches={100: 2, 50: 1},
                    launches={"lift_conv_fwd": launches})
    return tr


def test_the_bound_of_the_flagship_lift():
    """0.247 ms a batch of 100 (operations: 0.244 TFLOP at 989 TFLOP/s),
    half that at 50."""
    e = _model().encoder
    assert lift.bound_ms(e, 100) == pytest.approx(0.246933, rel=1e-5)
    assert lift.bound_ms(e, 50) == pytest.approx(0.246933 / 2, rel=1e-5)


@pytest.mark.parametrize("kind", ["train", "embed"])
def test_the_readers_read_k13_alone(kind):
    name = f"lift_roofline.{kind}"
    read = spec.metric_reader(name).read
    want = 100 * 2.5 * 0.246933 / 1.5
    assert read(_trace(kind, 3)) == pytest.approx(want, rel=1e-5)
    other = "embed" if kind == "train" else "train"
    assert read(_trace(other, 3)) is None
    # a count that is not the window's batches, or no launch (a program
    # without K13): nothing to read
    assert read(_trace(kind, 4)) is None
    t = _trace(kind, None)
    t.run.launches = {}
    t.device = [op for op in t.device if op.name != K13]
    assert read(t) is None


def test_no_kernel_in_the_window_reads_none():
    t = _trace("train", 3)
    t.device = [op for op in t.device if op.name != K13]
    assert lift.roofline(t, "train") is None
    assert lift.roofline(SimpleNamespace(run=Window("train", 1.0, _model())),
                         "train") is None
