"""The collectives of the sharding layer, over the mesh axes of a
``LogicalRules`` bound to ranks (``launch.mesh.DistMesh``).

Each rank holds plain tensors: its shard of every leaf, its slice of the
batch.  The model code calls these where the layout needs a collective:

- ``psum``: the reference's ``psum``, an ``all_reduce`` sum; its gradient
  passes through unchanged (Megatron's "g": the partial sums of a
  row-parallel product, the experts' partial outputs).
- ``copy``: the identity whose gradient is ``all_reduce``d (Megatron's
  "f"): a tensor replicated over ``model`` that enters rank-local compute
  (the input of a column-parallel product) gets the sum of every rank's
  gradient, so every replicated leaf and activation holds the whole
  gradient on every rank and no leaf needs a reduction over ``model``.
- ``gather``: a dim split over some axes made whole, an ``all_gather``;
  its gradient is summed over the axes whose ranks computed on different
  data (``reduce``: the batch axes, the ZeRO-3 gather of an "fsdp" leaf)
  and sliced back to the rank's block.
- ``pmax``: the reference's ``pmax``, no gradient.

A gather is ``all_gather_into_tensor`` of the rank's block (the dim moved
to the front and back), the max an ``all_reduce`` with ``MAX``; neither
rounds, so each crosses in the tensor's own dtype.  A sum crosses in
float32 when its floating dtype has fewer than 32 bits and is rounded back
once (a sum of bf16 partials then rounds once, where the reference's bf16
psum may round at each step).  A reduce-scatter is an ``all_reduce`` and
the rank's slice.  Both backends take all three on CUDA tensors (gloo for
ranks that share one card, nccl for a card each).  Axes whose extent is 1
need no collective, so on a mesh of one device the code is the one-device
path.  A multi-axis collective runs one axis at a time, minor axis first.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import LogicalRules, axes_of


def _live(rules: LogicalRules, axes) -> tuple[str, ...]:
    """The axes of ``axes`` in the mesh with an extent above 1, minor first."""
    return tuple(a for a in reversed(axes_of(axes)) if rules.sizes.get(a, 1) > 1)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x``'s addends in the dtype the sum crosses in (a new tensor)."""
    if x.is_floating_point() and x.element_size() < 4:
        return x.float()
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    return x.clone()


def all_reduce(x: torch.Tensor, rules: LogicalRules, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes`` (a new tensor)."""
    live = _live(rules, axes)
    if not live:
        return x
    y = _wire(x)
    for a in live:
        dist.all_reduce(y, group=rules.mesh.group(a))
    return y.to(x.dtype)


# torch renamed all_gather_into_tensor to all_gather_single (2.13)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_axis(x: torch.Tensor, dim: int, rules: LogicalRules, axis: str) -> torch.Tensor:
    """The blocks along ``axis`` in rank order; a group's ranks ascend with
    their coordinate on the axis (``DistMesh`` lays them out row-major)."""
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((rules.sizes[axis] * src.shape[0],) + src.shape[1:])
    _all_gather_single(out, src, group=rules.mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, dim: int, rules: LogicalRules, axes) -> torch.Tensor:
    """Dim ``dim`` of the blocks along ``axes`` (major first) made whole."""
    for a in _live(rules, axes):
        x = _gather_axis(x, dim, rules, a)
    return x


def block(x: torch.Tensor, dim: int, rules: LogicalRules, axes) -> torch.Tensor:
    """This rank's block of dim ``dim`` split over ``axes``."""
    n = rules.size(axes)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, rules.index(axes) * c, c)


def pmax(x: torch.Tensor, rules: LogicalRules, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks along ``axes`` (no grad)."""
    live = _live(rules, axes)
    if not live:
        return x
    y = x.detach().clone()
    for a in live:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=rules.mesh.group(a))
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, axes):
        return all_reduce(x, rules, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules, axes):
        ctx.rules, ctx.axes = rules, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.rules, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, rules, axes, reduce):
        ctx.dim, ctx.rules, ctx.axes, ctx.reduce = dim, rules, axes, reduce
        return all_gather(x, dim, rules, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = all_reduce(g, ctx.rules, ctx.reduce)
        return block(g, ctx.dim, ctx.rules, ctx.axes).contiguous(), None, None, None, None


def psum(x: torch.Tensor, rules: LogicalRules, axes) -> torch.Tensor:
    """``all_reduce`` sum over ``axes``; the gradient passes through."""
    if not _live(rules, axes):
        return x
    return _Psum.apply(x, rules, axes)


def copy(x: torch.Tensor, rules: LogicalRules, axes) -> torch.Tensor:
    """The identity; its gradient is summed over ``axes``."""
    if not _live(rules, axes) or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, rules, axes)


def gather(x: torch.Tensor, dim: int, rules: LogicalRules, axes, reduce=()) -> torch.Tensor:
    """``all_gather`` of dim ``dim`` over ``axes``; the gradient is summed
    over ``reduce`` (a subset of the axes, or none) and sliced back."""
    if not _live(rules, axes):
        return x
    return _Gather.apply(x, dim, rules, tuple(axes_of(axes)), tuple(axes_of(reduce)))


def gather_leaf(x: torch.Tensor, dims, rules: LogicalRules, keep=()) -> torch.Tensor:
    """A leaf's block made whole along every split dim whose axes are not
    in ``keep``.  ``dims``: each dim's mesh axes (``Sharding.dims``).  A
    dim split over batch axes is gathered ZeRO-3 style: its gradient is
    summed over them (the ranks computed on different batch slices); over
    ``model`` the compute that follows is replicated, so the gradient is
    only sliced."""
    for d, axes in enumerate(dims):
        if axes and not set(axes) & set(keep):
            reduce = tuple(a for a in axes if a in rules.batch_axes)
            x = gather(x, d, rules, axes, reduce)
    return x
