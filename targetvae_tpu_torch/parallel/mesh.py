"""The (data, model) rank layout (mirror of targetvae_tpu/parallel/mesh.py,
make_mesh) as process groups of the initialised default group.

Rank r sits at data index r // model and model index r % model, as the JAX
package reshapes its devices into a (data, model) array. The data axis
shards each batch (dp: every rank runs the step on its B / data rows); the
model axis shards the SP step's posterior cells, its exchange running over
the ranks of one data row (`group`). Gradients are all-reduced over the
whole world. The tensor-parallel parameter layout of the JAX package's
_spec_for_param is not ported (ROADMAP.md, queue 1, item 23).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    data: int          # ranks along the data axis (batch shards)
    model: int         # ranks along the model axis (the SP cell shards)
    data_index: int    # this rank's index along the data axis
    rank: int          # this rank's index along the model axis
    group: object      # the model axis' group: this rank's data row
    data_group: object  # the data axis' group: this rank's model column

    @property
    def size(self) -> int:
        return self.data * self.model

    def batch_rows(self, b: int) -> slice:
        """The rows of a global batch of b that this rank's data shard
        holds (the model axis splits them further in the SP step)."""
        if b % self.data:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{self.data} data shards")
        n = b // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """SUM-all-reduce the gradients of replicated parameters over every
        rank, as one flat buffer: the transpose of shard_map's P()
        parameters. Every rank gets the same bits, so an identical
        optimizer step keeps the parameters identical."""
        params = list(params)
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat)
        i = 0
        for p in params:
            n = p.numel()
            p.grad = flat[i:i + n].view_as(p)
            i += n

    def agree(self, values: Sequence[float], device) -> None:
        """Raise unless every rank holds the same bits in `values` (the
        controllers' inputs and decisions, which must agree). `device`: the
        rank's card, where NCCL gathers; gloo gathers on the host."""
        if dist.get_backend() == "gloo":
            device = "cpu"
        mine = torch.tensor(list(values), dtype=torch.float64, device=device)
        every = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(every, mine)
        bits = [v.view(torch.int64).cpu() for v in every]
        if not all(torch.equal(bits[0], b) for b in bits[1:]):
            raise RuntimeError(
                "ranks disagree on values that must be equal on every rank: "
                + str([v.cpu().tolist() for v in every]))


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) layout over the initialised default process group;
    data=None takes every rank the model axis leaves. Every rank must call
    it, in the same order as its other group constructions (new_group)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "initialize (or torch.distributed."
                           "init_process_group) on every rank first")
    world = dist.get_world_size()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    d, t = divmod(rank, model)
    if data == 1:
        group, data_group = dist.group.WORLD, None
    elif model == 1:
        group, data_group = None, dist.group.WORLD
    else:
        rows = [dist.new_group([i * model + j for j in range(model)])
                for i in range(data)]
        cols = [dist.new_group([i * model + j for i in range(data)])
                for j in range(model)]
        group, data_group = rows[d], cols[t]
    return Mesh(data=data, model=model, data_index=d, rank=t, group=group,
                data_group=data_group)
