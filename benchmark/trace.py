"""The device trace of a --trace 1 run, from torch.profiler, and the spans
the benchmark records around its calls into the port.

Trace.device lists every operation that ran on the card inside the window
(kernels, copies, memsets) with the chain of host operations that launched
it, innermost first: the CUDA runtime call's enclosing CPU ops (aten ops,
the port's autograd Functions such as _PoseDecoder or
_LiftedEncoderBackward, the benchmark's spans "bench.*"), matched by the
launch's correlation id. Busy time is the union of those operations'
intervals; idle gaps are labelled by the innermost host operation that ran
across them, and the one around it.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@contextmanager
def span(name: str):
    """A span of the benchmark's own (a no-op unless a profiler runs)."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class DeviceOp:
    name: str
    start: float            # seconds, the profiler's clock
    end: float
    chain: tuple            # launching host ops, innermost first

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    device: list
    window: tuple           # (start, end) seconds of the bench.window span
    gaps: list = field(default_factory=list)    # (seconds, label)
    run: object = None      # what the window did (drive.Window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device))

    def seconds(self, select) -> float:
        """Device seconds of the operations for which select(op) holds."""
        return sum(op.seconds for op in self.device if select(op))

    def top_ops(self, top: int = 12) -> list:
        """[(seconds, name, chain)] of the device operations that took most
        time, by name and launching chain."""
        ops: dict = {}
        for op in self.device:
            key = (op.name, op.chain[:4])
            ops[key] = ops.get(key, 0.0) + op.seconds
        return sorted(((v, k[0], k[1]) for k, v in ops.items()),
                      reverse=True)[:top]

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for op in self.device:
            ops[op.name] = ops.get(op.name, 0.0) + op.seconds
        gaps: dict = {}
        for sec, label in self.gaps:
            gaps[label] = gaps.get(label, 0.0) + sec
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def _union(ops) -> list:
    out = []
    for op in sorted(ops, key=lambda o: o.start):
        if out and op.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end)
        else:
            out.append([op.start, op.end])
    return out


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])


def from_profiler(prof) -> Trace:
    """The window's device operations, their launching chains and the idle
    gaps, from a finished torch.profiler.profile."""
    events = prof.profiler.kineto_results.events()
    host, device = {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.setdefault(e.start_thread_id(), []).append(e)
        elif not (e.is_user_annotation() or e.name().startswith("bench.")):
            device.append(e)
    window, main = None, None
    for tid, evs in host.items():
        for e in evs:
            if e.name() == WINDOW:
                window, main = (e.start_ns() * 1e-9, e.end_ns() * 1e-9), tid
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")

    chains = {}
    for evs in host.values():
        stack = []
        for e in sorted(evs, key=lambda e: (e.start_ns(), -e.end_ns())):
            while stack and stack[-1].end_ns() <= e.start_ns():
                stack.pop()
            if _RUNTIME.match(e.name()):
                chains[e.correlation_id()] = tuple(
                    s.name() for s in reversed(stack))
            else:
                stack.append(e)
    ops = []
    for e in device:
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        a, b = max(a, window[0]), min(b, window[1])
        if b > a:
            ops.append(DeviceOp(e.name(), a, b,
                                chains.get(e.correlation_id(), ())))
    trace = Trace(device=ops, window=window)
    trace.gaps = _label_gaps(_union(ops), window, host[main])
    return trace


def _label_gaps(busy: list, window: tuple, main_thread: list) -> list:
    """(seconds, label) of each idle stretch of the window: the innermost
    host op of the window's thread across its middle and the op around it
    ("bench.*" spans included; "no host op" where none)."""
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    ops = sorted(main_thread, key=lambda e: (e.start_ns(), -e.end_ns()))
    out, stack, i = [], [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2 * 1e9
        while i < len(ops) and ops[i].start_ns() <= mid:
            while stack and stack[-1].end_ns() <= ops[i].start_ns():
                stack.pop()
            if not _RUNTIME.match(ops[i].name()) or ops[i].end_ns() > mid:
                stack.append(ops[i])
            i += 1
        while stack and stack[-1].end_ns() < mid:
            stack.pop()
        out.append((b - a, " < ".join(e.name() for e in stack[:-3:-1])
                    or "no host op"))
    return out
