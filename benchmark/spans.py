"""The port's own spans (targetvae_tpu_torch/utils/trace.py, names
"tvae.*") in the device trace of a --trace 1 run: each idle gap of the
window charged to one bucket, and what the readers of metrics/ take from
that.

The charging rule walks the union of Trace.device's intervals. A gap
between two busy stretches goes to what the card was waiting for: the
innermost "tvae.*" span in the launching chain of the device operation
that ends the gap; where that chain has none but runs under an autograd
node (autograd's device thread launches the backward of native ops),
"backward"; otherwise "unspanned". A gap after an operation launched under
tvae.embed.out (an embed request's copy to the host), ended by one that
was not, lies between two requests: "request". The window's leading and
trailing gaps are "outside". The buckets sum to window_s - busy_s.

A program without the spans (one older than them) charges nothing to a
"tvae.*" bucket, and each reader below returns None there.
"""

from __future__ import annotations

PREFIX = "tvae."
OUTSIDE, REQUEST, BACKWARD, UNSPANNED = ("outside", "request", "backward",
                                         "unspanned")
AUTOGRAD = "autograd::engine::evaluate_function"
EMBED_OUT = "tvae.embed.out"
STAGE = "tvae.embed.stage"
STEP = "tvae.step"


def owner(op) -> str:
    """The bucket of a gap that `op`'s launch ends."""
    for name in op.chain:
        if name.startswith(PREFIX):
            return name
    if any(name.startswith(AUTOGRAD) for name in op.chain):
        return BACKWARD
    return UNSPANNED


def _stretches(trace) -> list:
    """[(seconds, the operation before, the one after)] of every idle
    stretch of the window, in order; None at the window's edges."""
    start, end = trace.window
    ops = sorted(trace.device, key=lambda o: o.start)
    if not ops:
        return [(end - start, None, None)]
    out = [(ops[0].start - start, None, ops[0])]
    busy_end, last = ops[0].end, ops[0]
    for op in ops[1:]:
        if op.start <= busy_end:
            if op.end > busy_end:
                busy_end, last = op.end, op
            continue
        out.append((op.start - busy_end, last, op))
        busy_end, last = op.end, op
    out.append((end - busy_end, last, None))
    return [g for g in out if g[0] > 0]


def _bucket(before, after) -> str:
    if before is None or after is None:
        return OUTSIDE
    if EMBED_OUT in before.chain and EMBED_OUT not in after.chain:
        return REQUEST
    return owner(after)


def gaps(trace) -> list:
    """[(seconds, bucket)] of every idle stretch of the window, in order."""
    return [(s, _bucket(a, b)) for s, a, b in _stretches(trace)]


def charge(trace) -> dict:
    """{bucket: idle seconds} of the window."""
    out: dict = {}
    for seconds, bucket in gaps(trace):
        out[bucket] = out.get(bucket, 0.0) + seconds
    return out


def spanned(trace, name: str) -> bool:
    """Whether any device operation was launched under span `name`."""
    return any(name in op.chain for op in trace.device)


def step_gap_ms(trace):
    """Idle ms a step charged to a launch under tvae.step (whatever span
    inside it) or to the backward."""
    run = trace.run
    if run.kind != "train" or not run.steps or not spanned(trace, STEP):
        return None
    idle = sum(s for s, before, after in _stretches(trace)
               if before is not None and after is not None
               and (STEP in after.chain or owner(after) == BACKWARD))
    return idle * 1e3 / run.steps


def staging_gap_ms(trace):
    """Idle ms per 100 images charged to the embed's staging."""
    run = trace.run
    if run.kind != "embed" or not run.images or not spanned(trace, STAGE):
        return None
    return charge(trace).get(STAGE, 0.0) * 1e3 / (run.images / 100.0)


def request_gap_ms(trace):
    """Idle ms a gap between two requests, the mean over the window's."""
    if trace.run.kind != "embed":
        return None
    between = [s for s, bucket in gaps(trace) if bucket == REQUEST]
    return sum(between) * 1e3 / len(between) if between else None


def device_ms_under(trace, name: str, kind: str):
    """Device ms per 100 images of everything launched under span `name`
    in a run of `kind`."""
    run = trace.run
    if run.kind != kind or not run.images:
        return None
    ms = trace.seconds(lambda op: name in op.chain) * 1e3
    return ms / (run.images / 100.0) if ms > 0 else None
