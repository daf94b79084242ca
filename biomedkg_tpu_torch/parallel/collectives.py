"""Differentiable collectives with the transposes JAX's take
(``jax.lax.all_gather``, ``all_to_all``, ``psum``), and the gradient
all-reduce of the data-parallel steps.

* ``all_gather``: the group's blocks concatenated along rows (tiled); the
  backward is their reduce-scatter (sum), each rank keeping its own block.
* ``all_to_all``: block q of the (P, ...) send buffer goes to rank q, block
  p of the result came from rank p; the backward is the same exchange of
  the gradients.
* ``psum_replicated``: the sum over the group, the same on every rank;
  the backward is the identity, so each rank backpropagates its own
  part once (a term every rank computes alike enters on one rank only).
* ``psum_shared``: the sum over the group, which every rank then uses
  with its own columns only (a row norm, attention logits); the backward
  is the group's sum of the ranks' gradients.
* ``all_gather_cols_whole``: the ranks' column blocks side by side, for
  work every rank then does alike on the whole rows; the backward keeps
  the rank's own block of the (identical) gradient, so that work enters
  the gradient once.

``TensorParallel`` is the tp axis as the models read it: its group, the
rank and the size, and these collectives over it. Its ``cols`` is the
rank's contiguous block of a hidden layer's columns (parallel/sharding.py
lays them out so).

No group (None: an axis of one rank outside an initialised group) is the
identity; a group, even of one rank, runs its collective. Every
collective runs on the tensors' own device (NCCL on the card, gloo where
the caller chose it): nothing here copies to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

# bytes of one all-reduce bucket of the gradient reduction
BUCKET_BYTES = 25 << 20


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = group_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumShared(_PsumReplicated):
    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGatherWhole(_AllGather):
    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // group_size(ctx.group)
        start = dist.get_rank(ctx.group) * rows
        return g[start:start + rows], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n·rows, ...) blocks of the group's ranks in rank order."""
    return x if group is None else _AllGather.apply(x, group)


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """(N, n·c): the ranks' (N, c) column blocks side by side."""
    if group is None:
        return x
    rows = all_gather(x.t().contiguous(), group)    # (n·c, N)
    return rows.t()


def all_gather_cols_whole(x: torch.Tensor, group) -> torch.Tensor:
    """(N, n·c): the ranks' (N, c) column blocks side by side, for work
    every rank does alike on them; the gradient keeps the rank's block."""
    if group is None:
        return x
    return _AllGatherWhole.apply(x.t().contiguous(), group).t()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): block q to rank q; block p of the result from rank p."""
    return x if group is None else _AllToAll.apply(x, group)


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x; the gradient passes to each rank's own x."""
    return x if group is None else _PsumReplicated.apply(x, group)


def psum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x, which each rank uses with its own columns;
    the gradient is the group's sum of the ranks' gradients."""
    return x if group is None else _PsumShared.apply(x, group)


@torch.no_grad()
def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x, outside autograd."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def all_reduce_grads(grads: List[torch.Tensor], group,
                     divisor: int = 1) -> List[torch.Tensor]:
    """The group's sum of each gradient over ``divisor`` (n: JAX's
    ``pmean``), through flat buckets of at most ``BUCKET_BYTES`` per
    dtype, one all-reduce each. Returns, in ``grads``' order, views of
    the buckets (no group: ``grads`` themselves, or their quotients)."""
    if group is None:
        if divisor != 1:
            return torch._foreach_div(list(grads), float(divisor))
        return list(grads)
    buckets, current, size, dtype = [], [], 0, None
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if current and (g.dtype != dtype or size + nbytes > BUCKET_BYTES):
            buckets.append(current)
            current, size = [], 0
        current.append(g)
        size += nbytes
        dtype = g.dtype
    if current:
        buckets.append(current)
    out = []
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        out.extend(part.view_as(g) for part, g in zip(
            flat.split([g.numel() for g in bucket]), bucket))
    return out


@dataclass(frozen=True)
class TensorParallel:
    """The tp axis of a dp × tp step as the modules' losses read it: each
    rank holds a block of every split leaf's columns (parallel/sharding.py)
    and computes those columns of every layer."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int

    def cols(self, width: int) -> slice:
        """The rank's block of a ``width``-wide hidden layer's columns."""
        c = width // self.size
        return slice(self.rank * c, (self.rank + 1) * c)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over the columns to the whole, for work every rank
        then does alike (``psum_replicated``)."""
        return psum_replicated(x, self.group)

    def sum_shared(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums to the whole, used again with the rank's own
        columns (``psum_shared``)."""
        return psum_shared(x, self.group)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The whole rows of a hidden layer, for the next layer's
        contraction onto the rank's columns."""
        return all_gather_cols(x, self.group)

    def gather_cols_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole rows, for work every rank does alike."""
        return all_gather_cols_whole(x, self.group)
