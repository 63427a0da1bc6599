"""parallel/distributed.py::run_local's failure paths on the CPU (gloo): a
rank that raises fails the call with its traceback while its peer waits in
a collective, and a rank that hangs is killed at the timeout. Either way
no process is left behind. The success path runs in
tests/test_torch_port_sp.py."""

import multiprocessing
import time

import pytest
import torch
import torch.distributed as dist

from targetvae_tpu_torch.parallel.distributed import run_local


def _raise_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()                       # waits for rank 1 forever
    return rank


def _hang_on_rank_1(rank, world):
    if rank == 1:
        time.sleep(600)
    return torch.full((2,), float(rank))


def test_run_local_fails_with_the_ranks_traceback():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_local(_raise_on_rank_1, 2, backend="gloo", timeout=120)
    assert time.monotonic() - t < 100    # not by the timeout
    assert not multiprocessing.active_children()


def test_run_local_kills_a_hung_rank_at_the_timeout():
    with pytest.raises(TimeoutError):
        run_local(_hang_on_rank_1, 2, backend="gloo", timeout=15)
    assert not multiprocessing.active_children()


def test_run_local_names_its_backend():
    with pytest.raises(ValueError, match="backend"):
        run_local(_raise_on_rank_1, 2, backend="mpi", timeout=30)
