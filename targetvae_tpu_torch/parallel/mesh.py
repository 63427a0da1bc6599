"""The (data, model) rank layout (mirror of targetvae_tpu/parallel/mesh.py,
make_mesh) as process groups of the initialised default group.

Rank r sits at data index r // model and model index r % model, as the JAX
package reshapes its devices into a (data, model) array. The data axis
shards each batch (dp: every rank runs the step on its B / data rows); the
model axis shards the SP step's posterior cells, its exchange running over
the ranks of one data row (`group`). Gradients are all-reduced over the
whole world. tp > 1 without sp shards parameters instead (the JAX
package's tensor-parallel layout, _spec_for_param and param_shardings, here
spec_for_param and param_layout): the wide channel axes of the encoder's
lift, mixing and heads and of the generator's layers split over the ranks
of a data row (parallel/pjit.py), and each batch splits over all dp * tp
ranks, rank d * tp + t taking the rows of flattened shard d * tp + t
(flat_rows), as the JAX package's _loss_fn_dp splits it over both axes.
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

    @property
    def flat_index(self) -> int:
        """This rank's index over both axes, data-major: d * model + t."""
        return self.data_index * self.model + self.rank

    def flat_rows(self, b: int) -> slice:
        """The rows of a global batch of b that this rank takes when the
        batch splits over both axes (dp and tp without sp)."""
        if b % self.size:
            raise ValueError(f"a batch of {b} does not split over the "
                             f"{self.data} x {self.model} ranks")
        n = b // self.size
        return slice(self.flat_index * n, (self.flat_index + 1) * n)

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


def spec_for_param(path: str, ndim: int) -> Optional[int]:
    """The tensor-parallel layout of the JAX package's _spec_for_param: the
    axis of a parameter leaf (its pytree path, "encoder/conv1/w", of ndim
    dimensions) that shards over the model axis, or None (replicated).
    conv1's out axis (the K kernels) of the 5-D group-conv weight; the K
    rows of the 1x1 mixing and heads (conv2, conv_a, conv_r, conv_z); the
    columns of the generator's coord_linear and latent_linear (its hidden
    units); the rows of its hidden and out layers."""
    if ndim == 0:
        return None
    if "encoder/conv1/w" in path and ndim == 5:
        return 0
    if any(f"{h}/w" in path for h in ("conv2", "conv_a", "conv_r", "conv_z")
           ) and ndim == 2:
        return 0
    if ("generator/coord_linear/w" in path
            or "generator/latent_linear/w" in path) and ndim == 2:
        return 1
    if ("generator/hidden" in path or "generator/out/w" in path) and ndim == 2:
        return 0
    return None


def shard_axis(path: str, shape: Sequence[int], model: int) -> Optional[int]:
    """spec_for_param's axis under the JAX package's param_shardings guard:
    a leaf whose axis does not divide by the model axis's size stays
    whole (None)."""
    axis = spec_for_param(path, len(shape))
    if axis is None or shape[axis] % model:
        return None
    return axis


def leaf_paths(tree, prefix: str = ""):
    """(path, leaf) over a params dict of nested dicts and lists, the path
    "/"-joined keys and list indices, as the JAX package's _path_str."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def param_layout(params, model: int) -> dict:
    """{path: shard axis or None} for every leaf of a TargetVAE params dict
    on a model axis of `model` ranks: the JAX package's param_shardings
    (targetvae_tpu/parallel/mesh.py) as axes."""
    return {path: shard_axis(path, tuple(leaf.shape), model)
            for path, leaf in leaf_paths(params)}


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
