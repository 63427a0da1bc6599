"""The port's spans: named host ranges on torch.profiler's own clock.

span(name) opens a record-function range of the FUNCTION scope
(torch._C._profiler._RecordFunctionFast), as an aten op is one. Under a
profiler it is a CPU op of the calling thread in the kineto timeline, the
clock of the device's events, so every kernel, copy and memset launched
inside it has it in its launching chain; it is not a user annotation, so
the profiler makes no device-side range of it. With no profiler running it
costs under a microsecond. Every name starts with "tvae.":

    tvae.epoch                train/loop.py: train_epoch, train_epoch_stream
      tvae.step               one Adam step (Trainer._step)
        tvae.forward          the objective
          tvae.encoder        encoder_apply / encoder_heads
            tvae.lift         the conv tier's lift (lifted weight + conv)
            tvae.patches      the patch tier's pad and build_patches
          tvae.posterior      the posterior over the cells, the KL
          tvae.decoder        the pose decoder / generator_apply
          tvae.likelihood     the likelihood, the CTF included
        tvae.backward         autograd's backward, the gradients' all-reduce
        tvae.optimizer        Adam, the shards' take and gather
      tvae.collect            the host's read of the step metrics
    tvae.embed                cli/clustering_common.py: one embed_dataset call
      tvae.embed.stage        one batch's staging and its copy's launch
      tvae.embed.batch        model.embed on one batch (the stages above)
      tvae.embed.out          the outputs' cat and copy to the host

The backward of native ops runs on autograd's device thread, outside
these ranges; its launches carry their autograd nodes. A span opened
before a profiler starts is not in its trace.
"""

from __future__ import annotations

from contextlib import nullcontext

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_IDLE = nullcontext()


def span(name: str):
    """A context manager: the range `name` while a profiler runs. Opened
    with no profiler running it is a no-op to its end, so that a profiler
    started inside it (a window opened mid-epoch) finds no range to close:
    a _RecordFunctionFast entered before the profiler starts and exited
    under it fails its guard's assertion and crashes the process."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _IDLE
