"""Tensor-parallel (TP) training state over the ranks of a (data, model)
layout (mirror of targetvae_tpu/parallel/pjit.py::shard_state, with the
gather at the loss boundary of targetvae_tpu/train/loop.py::_loss_fn_dp;
shard_batch's rows are mesh.Mesh.flat_rows).

With tp > 1 and no sp, Adam steps only this rank's model-axis shard of
every leaf that mesh.param_layout shards (the wide channel axes), and
keeps exp_avg and exp_avg_sq of that shard alone; the replicated leaves it
steps whole, as every rank does on one process. Each rank holds the whole
parameters, which the forward reads, and their whole gradients; a shard is
a view of its slice of the whole parameter. A step runs so:

- the model's whole parameters are the gathered shards: an all-gather over
  the data row's ranks rebuilds them after every optimizer step (and
  shard_state starts from whole ones), as the JAX package gathers its
  TP-sharded leaves to P() at the loss boundary;
- the forward and backward run on this rank's rows of the batch (the batch
  splits over all dp * tp ranks, Mesh.flat_rows);
- the whole gradients are SUM-all-reduced over the world (Mesh.
  all_reduce_grads) and each rank keeps its slice of a sharded leaf's;
- Adam steps the shards (in place, in the whole parameter) and the
  replicated leaves. Adam is elementwise, so a shard's step is bitwise the
  replicated step's slice on the same gradient.

The collectives are all-gather and all-reduce, which both gloo (ranks
sharing a card, or the CPU) and NCCL run on CUDA tensors; gloo has no
reduce-scatter for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Mesh, leaf_paths, param_layout


@dataclass
class _Leaf:
    path: str                # the JAX pytree path, "encoder/conv1/w"
    whole: nn.Parameter      # the model's parameter, which the forward reads
    axis: Optional[int]      # the axis sharded over the model axis, or None
    shard: torch.Tensor      # what Adam steps: this rank's slice (a view of
                             # whole), or whole

    def cut(self, t: torch.Tensor, rank: int, ranks: int) -> torch.Tensor:
        """This rank's slice of a tensor of the whole leaf's shape (a view)."""
        if self.axis is None:
            return t
        n = t.shape[self.axis] // ranks
        return t.narrow(self.axis, rank * n, n)


class ParamShards:
    """This rank's shards of a TargetVAE's parameters on `mesh`'s model
    axis (mesh.param_layout); the optimizer takes parameters(). A shard is
    a view of the model's whole parameter, so Adam's step writes it in
    place and a load of the whole parameters reaches the shards."""

    def __init__(self, model, mesh: Mesh):
        if mesh.model <= 1:
            raise ValueError("ParamShards needs a model axis of tp > 1 ranks")
        self.mesh = mesh
        layout = param_layout(model.params(), mesh.model)
        self.leaves: List[_Leaf] = []
        for path, t in leaf_paths(model.params()):
            if not isinstance(t, nn.Parameter):
                continue        # the Fourier buffers: never trained
            leaf = _Leaf(path, t, layout[path], t)
            if leaf.axis is not None:
                leaf.shard = self._cut(leaf, t.detach())
            self.leaves.append(leaf)
        self._sharded = [leaf for leaf in self.leaves if leaf.axis is not None]

    def _cut(self, leaf: _Leaf, t: torch.Tensor) -> torch.Tensor:
        return leaf.cut(t, self.mesh.rank, self.mesh.model)

    def parameters(self) -> List[nn.Parameter]:
        """What the optimizer steps: the shards and the replicated leaves,
        in the model's order."""
        return [leaf.shard for leaf in self.leaves]

    def take_grads(self) -> None:
        """Each shard's gradient: its slice (a view) of the whole leaf's
        gradient, which all_reduce_grads has summed over the world."""
        for leaf in self._sharded:
            leaf.shard.grad = self._cut(leaf, leaf.whole.grad)

    def gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors from this rank's shard-shaped tensors of the
        sharded leaves (in their order), all-gathered over the data row's
        ranks as one flat buffer and reassembled along each leaf's axis.
        Every rank of the row must call it."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        every = [torch.empty_like(flat) for _ in range(self.mesh.model)]
        dist.all_gather(every, flat, group=self.mesh.group)
        out, i = [], 0
        for leaf, t in zip(self._sharded, tensors):
            n = t.numel()
            out.append(torch.cat([e[i:i + n].view(t.shape) for e in every],
                                 dim=leaf.axis))
            i += n
        return out

    @torch.no_grad()
    def gather_params(self) -> None:
        """Rebuild the model's whole parameters from the shards (after an
        optimizer step has written this rank's slices): every rank of the
        row gets the same bits."""
        whole = self.gather([leaf.shard for leaf in self._sharded])
        for leaf, w in zip(self._sharded, whole):
            leaf.whole.copy_(w)

    def whole_moments(self, optimizer: torch.optim.Optimizer,
                      key: str) -> dict:
        """{id(whole parameter): its whole Adam moment `key` ("exp_avg" or
        "exp_avg_sq")} for the sharded leaves, gathered over the row (an
        empty dict before the first step, when Adam holds none). Every
        rank of the row must call it."""
        if not self._sharded or not optimizer.state.get(
                self._sharded[0].shard):
            return {}
        whole = self.gather([optimizer.state[leaf.shard][key]
                             for leaf in self._sharded])
        return {id(leaf.whole): w for leaf, w in zip(self._sharded, whole)}

    def targets(self) -> dict:
        """{id(whole parameter): (the optimizer's parameter, a function
        cutting a whole-shaped tensor to it)} for every leaf."""
        return {id(leaf.whole): (leaf.shard,
                                 lambda t, leaf=leaf: self._cut(leaf, t))
                for leaf in self.leaves}

    def nbytes(self, optimizer: torch.optim.Optimizer) -> dict:
        """This rank's bytes: the whole parameters the forward reads, their
        whole gradients (all-reduced over the world), and Adam's moments of
        the shards and the replicated leaves, the one part that tensor
        parallelism cuts."""
        size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        moments = [v for p in self.parameters()
                   for k, v in optimizer.state.get(p, {}).items()
                   if k in ("exp_avg", "exp_avg_sq")]
        whole = [leaf.whole for leaf in self.leaves]
        return {"params": size(whole),
                "grads": size(leaf.whole.grad for leaf in self.leaves
                              if leaf.whole.grad is not None),
                "adam": size(moments)}


def shard_state(state, mesh: Mesh):
    """A TrainState (train/state.py) whose model holds whole parameters,
    TP-sharded on `mesh`: each rank's Adam steps its shards of the sharded
    leaves (state.shards) and the replicated leaves, afresh;
    Adam's moments and step, where the state had any, are cut to the
    shards. Every rank gives the same state."""
    from ..train.state import make_optimizer
    shards = ParamShards(state.model, mesh)
    old = state.optimizer
    lr = old.param_groups[0]["lr"]
    opt = make_optimizer(shards.parameters(), lr)
    targets = shards.targets()
    for p in old.param_groups[0]["params"]:
        st = old.state.get(p)
        if st and id(p) in targets:
            shard, cut = targets[id(p)]
            opt.state[shard] = {k: (cut(v).clone() if k != "step" else
                                    v.clone()) for k, v in st.items()}
    state.optimizer, state.shards = opt, shards
    return state

