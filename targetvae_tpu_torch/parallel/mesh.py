"""The (data, model) rank layout (mirror of targetvae_tpu/parallel/mesh.py,
make_mesh) as process groups of the initialised default group.

Only data = 1 is built yet: the model axis is the whole world, and its
group is the default one. Data parallelism (data > 1) and the tensor-
parallel parameter layout of the JAX package's _spec_for_param are not
ported (ROADMAP.md, queue 1, item 23).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    model: int         # ranks along the model axis (the SP cell shards)
    group: object      # the model axis' process group
    rank: int          # this rank's index along the model axis

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """SUM-all-reduce the gradients of replicated parameters over the
        model axis, as one flat buffer: the transpose of shard_map's P()
        parameters. Every rank gets the same bits, so an identical
        optimizer step keeps the parameters identical."""
        params = list(params)
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat, group=self.group)
        i = 0
        for p in params:
            n = p.numel()
            p.grad = flat[i:i + n].view_as(p)
            i += n


def make_mesh(model: Optional[int] = None) -> Mesh:
    """The rank layout over the initialised default process group, with a
    data axis of 1; model=None takes every rank of the world."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "initialize (or torch.distributed."
                           "init_process_group) on every rank first")
    world = dist.get_world_size()
    model = world if model is None else model
    if model != world:
        raise ValueError(f"a 1 x {model} mesh needs {model} ranks, the "
                         f"process group has {world}")
    return Mesh(model=model, group=dist.group.WORLD, rank=dist.get_rank())
