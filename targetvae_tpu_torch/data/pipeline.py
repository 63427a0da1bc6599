"""Host-side data feed: background shuffle -> gather -> copy to the card
while the previous step computes (mirror of targetvae_tpu/data/pipeline.py).

For datasets that fit in the card's memory the Trainer keeps both splits
there (train/fit.py). This pipeline covers the streaming case, particle
stacks larger than the card: a worker thread gathers each shuffled batch on
the host with the native multithreaded gather (data/native.py) into one of
prefetch + 1 pinned host buffers, and copies it to the card without
blocking on a side stream; the consumer's stream waits on that copy's
event. A buffer is refilled only once its last copy has ended.

Under dp ranks every rank runs the same pipeline (the same seed, so the same
global permutation over the whole dataset, which every rank holds in host
RAM) and gathers only `rows` of each global batch, its data shard's, with
the matching slice of the weights: the counterpart of the JAX package's
multihost row selection (_local_rows).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..models.targetvae import resolve_device
from . import native as _native


class StreamBatch(NamedTuple):
    """One staged batch. Every batch arrives at the fixed batch size with a
    row-weight vector: uniform 1/B on full batches, and on a ragged epoch
    tail 1/n_real over the real rows with ZERO-weight wrap-around pad rows
    (the reference's drop_last=False, train_mnist.py:586-587), so that a
    whole streamed epoch, tail included, runs through one step shape and
    splits evenly over ranks. Under ranks y, ctf and w hold the rank's rows
    of the global batch; n_real counts the global batch's real rows."""

    y: torch.Tensor                # (B, H, W, C) on the device, wire dtype
    ctf: Optional[torch.Tensor]    # (B, kc, kc) on the device, or None
    w: torch.Tensor                # float32 (B,), sums to 1 over the batch
    n_real: int                    # real rows (B except on the tail)


_WIRE = {None: torch.float32, "float32": torch.float32,
         "bfloat16": torch.bfloat16}


class HostDataPipeline:
    def __init__(self, images: np.ndarray, ctf: Optional[np.ndarray] = None,
                 batch_size: int = 100, seed: int = 0, device=None,
                 prefetch: int = 2, shuffle: bool = True,
                 wire_dtype: Optional[str] = None, rows: Optional[slice] = None,
                 native: bool = True, timing: bool = False):
        """images (N, H, W, C) and ctf (N, kc, kc) stay in host RAM.
        device: where batches land (None: cuda:0; a CPU device gets plain
        tensors, no pinned buffers or streams). wire_dtype 'bfloat16' casts
        y and the CTF kernels on the host (halving the bytes copied); the
        Trainer upcasts them on the device. rows: this rank's rows of each
        global batch (None: all). native=False gathers with numpy. timing
        records each copy's device time (CUDA events on the side stream) for
        stats()."""
        if wire_dtype not in _WIRE:
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        self.images = np.ascontiguousarray(images, dtype=np.float32)
        self.ctf = None if ctf is None else np.ascontiguousarray(
            ctf, dtype=np.float32)
        self.batch = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch = max(1, prefetch)
        self.shuffle = shuffle
        self.wire = _WIRE[wire_dtype]
        self.local = np.arange(batch_size)[rows or slice(None)]
        self.native = native
        self.timing = timing
        self._ring = None
        self._stats = {"wait_s": [], "copy_ms": []}

    def __len__(self) -> int:
        return len(self.images)

    def order(self, epoch_idx: int = 0) -> np.ndarray:
        """The epoch's order of the rows: np.random.RandomState(seed + epoch)
        .permutation(N), the JAX package's, or 0..N-1 without shuffle."""
        n = len(self.images)
        if not self.shuffle:
            return np.arange(n)
        return np.random.RandomState(self.seed + epoch_idx).permutation(n)

    def stats(self) -> dict:
        """The last epoch's consumer waits for a batch (host seconds) and,
        with timing, each batch's copy to the card (device ms)."""
        return {k: list(v) for k, v in self._stats.items()}

    def _gather(self, src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
        return _native.gather_f32(src, idx, out=out, native=self.native)

    def _host_batch(self, idx: np.ndarray, w: np.ndarray, n_real: int):
        """A batch as CPU tensors (the CPU device: no staging)."""
        y = torch.from_numpy(self._gather(self.images, idx)).to(self.wire)
        c = None if self.ctf is None else torch.from_numpy(
            self._gather(self.ctf, idx)).to(self.wire)
        return StreamBatch(y, c, torch.from_numpy(w), n_real), None

    def _device_batch(self, k: int, idx: np.ndarray, w: np.ndarray,
                      n_real: int):
        """Gather into pinned slot k (once its last copy has ended), cast on
        the host for the bf16 wire, and copy to the card on the side stream.
        Returns the batch and the event its copies end on."""
        ring = self._ring
        if ring["done"][k] is not None:
            ring["done"][k].synchronize()
        slot = ring["slots"][k]
        for name, src in (("y", self.images), ("ctf", self.ctf)):
            if src is None:
                continue
            if self.wire == torch.float32:
                self._gather(src, idx, slot[name].numpy())
            else:                         # a torch CPU cast: releases the GIL
                self._gather(src, idx, ring["scratch"][name].numpy())
                slot[name].copy_(ring["scratch"][name])
        slot["w"].numpy()[...] = w
        side = ring["stream"]
        with torch.cuda.stream(side):
            start = None
            if self.timing:
                start = torch.cuda.Event(enable_timing=True)
                start.record(side)
            y = slot["y"].to(self.device, non_blocking=True)
            c = (None if self.ctf is None
                 else slot["ctf"].to(self.device, non_blocking=True))
            wd = slot["w"].to(self.device, non_blocking=True)
            done = torch.cuda.Event(enable_timing=self.timing)
            done.record(side)
        ring["done"][k] = done
        return StreamBatch(y, c, wd, n_real), (done, start)

    def _make_ring(self) -> None:
        nb = len(self.local)
        pinned = lambda shape, dt: torch.empty((nb,) + shape,
                                               dtype=dt).pin_memory()
        shapes = {"y": self.images.shape[1:]}
        if self.ctf is not None:
            shapes["ctf"] = self.ctf.shape[1:]
        self._ring = {
            "slots": [dict({k: pinned(s, self.wire) for k, s in shapes.items()},
                           w=torch.empty(nb).pin_memory())
                      for _ in range(self.prefetch + 1)],
            "scratch": ({k: torch.empty((nb,) + s) for k, s in shapes.items()}
                        if self.wire != torch.float32 else None),
            "done": [None] * (self.prefetch + 1),
            "stream": torch.cuda.Stream(self.device)}

    def epoch(self, epoch_idx: int = 0) -> Iterator[StreamBatch]:
        """Yield StreamBatch(y, ctf, w, n_real) for one epoch. Every batch
        has the fixed batch size; a ragged tail is wrap-around padded with
        ZERO-weight rows (see StreamBatch). A worker's exception is raised
        here as RuntimeError from it; a consumer that stops early stops the
        worker (its puts wait a bounded time) and joins it."""
        cuda = self.device.type == "cuda"
        if cuda and self._ring is None:
            self._make_ring()
        order, n, b = self.order(epoch_idx), len(self.images), self.batch
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        worker_err = []
        self._stats = {"wait_s": [], "copy_ms": []}

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for i, lo in enumerate(range(0, n, b)):
                    if stop.is_set():
                        return
                    idx = order[lo:lo + b]
                    rem = len(idx)
                    w = np.zeros(b, np.float32)
                    w[:rem] = 1.0 / rem
                    if rem < b:
                        idx = np.resize(idx, b)
                    idx, w = idx[self.local], w[self.local]
                    if cuda:
                        put(self._device_batch(i % (self.prefetch + 1), idx,
                                               w, rem))
                    else:
                        put(self._host_batch(idx, w, rem))
            except BaseException as e:   # surfaced to the consumer: a crash
                worker_err.append(e)     # must not look like a short epoch
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True,
                             name="HostDataPipeline")
        t.start()
        timed = []
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if item is None:
                    if worker_err:
                        raise RuntimeError(
                            "HostDataPipeline worker failed mid-epoch"
                        ) from worker_err[0]
                    break
                self._stats["wait_s"].append(time.perf_counter() - t0)
                batch, events = item
                if events is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(events[0])
                    for v in (batch.y, batch.ctf, batch.w):
                        if v is not None:  # the allocator must not reuse it
                            v.record_stream(cur)  # before `cur` is done
                    if events[1] is not None:
                        timed.append(events)
                yield batch
        finally:
            stop.set()
            t.join()
            for done, start in timed:
                done.synchronize()
                self._stats["copy_ms"].append(start.elapsed_time(done))
