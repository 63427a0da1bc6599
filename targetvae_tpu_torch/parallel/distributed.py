"""Process-group set-up and a host-local launcher (mirror of
targetvae_tpu/parallel/distributed.py and of the two-process pattern of
__graft_entry__.dryrun_multichip / tests/_mp_worker.py).

initialize takes the backend ("gloo" or "nccl"), the rendezvous (an
init_method URL such as "tcp://localhost:<port>" or "file://<path>"), the
rank and the world size from its caller; initialize_from_env takes them
from torchrun's environment (env://; `torchrun --standalone` meets on
localhost) and picks the backend: nccl where every rank has a card of its
own, gloo where ranks share one (NCCL refuses two ranks on one device;
gloo takes CUDA tensors in all_reduce and all_to_all_single) or run on
the CPU.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def initialize(backend: str, init_method: str, rank: int, world_size: int,
               timeout: Optional[float] = None) -> None:
    """Join the default process group as `rank` of `world_size`. timeout:
    seconds a collective may wait for a peer before it fails (None: the
    backend's default)."""
    _check_backend(backend)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size, **kw)


TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def launched_by_torchrun() -> bool:
    """Whether torchrun's environment (RANK, WORLD_SIZE, ...) is set."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def local_device(device_index: int) -> str:
    """This process's device under torchrun: cuda:(index + LOCAL_RANK) when
    each local rank has a card of its own, else cuda:index, which the local
    ranks then share (and talk over gloo); -1 is the CPU."""
    if device_index < 0:
        return "cpu"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    if device_index + local_world <= torch.cuda.device_count():
        return f"cuda:{device_index + local}"
    return f"cuda:{device_index}"


def initialize_from_env(device, timeout: Optional[float] = None) -> str:
    """Join the default process group that torchrun describes in the
    environment (env://; `torchrun --standalone` rendezvouses on
    localhost). The backend is nccl when every rank's device is a card of
    its own and gloo when ranks share one (NCCL refuses two ranks on one
    device) or run on the CPU. Returns the backend's name."""
    if not launched_by_torchrun():
        raise RuntimeError(
            "no torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, ...): "
            "launch multi-rank runs with `torchrun --standalone "
            "--nproc_per_node N -m targetvae_tpu_torch.cli.<cli> ...`")
    device = torch.device(device)
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    # local_device's layout: rank i on cuda:(base + i) when the cards suffice
    base = (device.index or 0) - int(os.environ["LOCAL_RANK"])
    own_card = (device.type == "cuda" and local_world == world
                and (world == 1 or (base >= 0 and base + local_world
                                    <= torch.cuda.device_count())))
    backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(backend, "env://", int(os.environ["RANK"]), world, timeout)
    return backend


def _rank_main(fn, rank: int, world_size: int, backend: str, init: str,
               timeout: float, workdir: str, args) -> None:
    out = Path(workdir) / f"rank{rank}"
    try:
        initialize(backend, init, rank, world_size, timeout)
        # No rank leaves before every rank has joined: init_process_group
        # may return on one rank while a peer is still connecting, and a
        # rank that then finishes fn and tears its group down fails that
        # peer's connect ("Connection closed by peer").
        dist.barrier()
        torch.save(fn(rank, world_size, *args), out.with_suffix(".pt"))
    except BaseException:
        # written before the group goes down, which fails the peers
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, world_size: int, backend: str, timeout: float,
              args: Sequence = ()) -> list:
    """Run fn(rank, world_size, *args) in `world_size` fresh processes on
    this host, each a rank of one process group on `backend`, and return
    their results in rank order (each must be picklable; fn must be
    importable by name, as multiprocessing's spawn requires).

    The ranks meet through a file:// store in a temporary directory. The
    call waits at most `timeout` seconds in all: if a rank fails, or the
    time runs out, every rank still alive is killed and it raises, with the
    failed rank's traceback. It never leaves a process behind."""
    _check_backend(backend)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tvae_ranks_") as workdir:
        init = "file://" + os.path.join(workdir, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init, timeout,
                                   workdir, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    # every rank's traceback so far: the rank that failed
                    # first may still be exiting when its peers have
                    errs = [Path(workdir, f"rank{r}.err")
                            for r in range(world_size)]
                    text = "\n".join(f"rank {e.stem[4:]}: {e.read_text()}"
                                     for e in errs if e.exists())
                    raise RuntimeError(f"ranks {failed} of {world_size} failed "
                                       f"(exit codes {codes}):\n{text}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s "
                                       f"(exit codes {codes})")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        return [torch.load(Path(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
