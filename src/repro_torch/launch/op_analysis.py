"""Op counting: FLOPs and bytes of a step run on the ``meta`` device (the
counterpart of ``repro/launch/hlo_analysis.py``, whose HLO text has no
input in torch).

``OpCounter`` is a ``TorchDispatchMode``: every aten op dispatched under it
(the forward, ``torch.autograd.grad``'s backward, recomputed checkpoints
and the optimizer alike) is run, here on ``meta`` tensors that hold shapes
and no storage, and counted:

- **FLOPs** from ``torch.utils.flop_counter``'s per-op formulas: the
  matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  the SDPA family), 2·M·N·K a product, as the reference counts dots and
  convolutions.  Elementwise work is not counted, as there.
- **Bytes**: each non-view op's outputs written once and its inputs read
  once, a tensor's bytes being the elements it addresses (a dimension of
  stride 0, a broadcast, counts once).  Views and ops that move no data
  (``empty``, ``detach``, ``_unsafe_view``, ...) count nothing.  Eager
  counting fuses nothing: every intermediate of an elementwise chain is
  written and read back, where the reference counts only the buffers that
  XLA materialises after fusion, so this count is larger for the same step.

The counts are of the whole program the step runs: every layer of a Python
loop is dispatched.  ``launch/dryrun.py`` weights layers by their repeat
count to save host time, and holds that equal to this full count.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

#: Ops that move no data: allocations, aliases and shape-only reshapes.
NO_DATA_OPS = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.lift_fresh, aten.alias,
    aten._unsafe_view, aten._reshape_alias, aten._local_scalar_dense,
})


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a stride-0 dimension (a
    broadcast) counts one element along it."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    seen, out = set(), []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


@dataclasses.dataclass
class OpStats:
    """Counts of one program: FLOPs, bytes and ops dispatched, per op name
    [ops, FLOPs, bytes], and per collective kind ``"{op}/{group size}"``
    [collectives, payload bytes] (``add_collectives``); all integers, so
    counts combine exactly."""

    flops: int = 0
    bytes: int = 0
    ops: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    comm: dict = dataclasses.field(default_factory=dict)

    def add_collectives(self, log) -> None:
        """Count each ``distributed.Collective`` of ``log``."""
        for c in log:
            row = self.comm.setdefault(f"{c.op}/{c.group}", [0, 0])
            row[0] += 1
            row[1] += c.nbytes

    @staticmethod
    def combine(parts: list["OpStats"], weights: list[int], divisor: int = 1) -> "OpStats":
        """sum(w * part) / divisor, every count; the division must be exact."""
        def mix(values):
            total = sum(w * v for w, v in zip(weights, values))
            if total % divisor:
                raise ValueError(f"counts {values} do not combine to integers")
            return total // divisor

        def rows(field, width):
            names = sorted(set().union(*(getattr(p, field) for p in parts)))
            return {name: [mix([getattr(p, field).get(name, [0] * width)[i] for p in parts])
                           for i in range(width)] for name in names}

        return OpStats(
            flops=mix([p.flops for p in parts]), bytes=mix([p.bytes for p in parts]),
            ops=mix([p.ops for p in parts]), by_op=rows("by_op", 3), comm=rows("comm", 2))


#: The counters whose context is open, innermost last.
_ACTIVE: list["OpCounter"] = []


class _Meta(tuple):
    """A memoised output tensor's (shape, stride, dtype)."""


def _memo_key(func, args, kwargs):
    """The key of a functional op's call on ``meta`` tensors (every tensor
    by shape, stride, dtype and device), or None: a view, an op that
    mutates or returns an alias, an unhashable argument."""
    schema = func._schema
    if func.is_view or schema.is_mutable or any(r.alias_info for r in schema.returns):
        return None
    parts = []
    for a in tree_flatten((args, kwargs))[0]:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            parts.append((tuple(a.shape), a.stride(), a.dtype))
        else:
            parts.append(a)
    key = (func, tuple(parts))
    try:
        hash(key)
    except TypeError:
        return None
    return key


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op run under it (see the module
    docstring), and the kernels reported through ``record_kernel``;
    ``stats`` holds the totals.

    ``memo``: a functional op called again on ``meta`` tensors of the same
    shapes, strides and dtypes with the same other arguments (a layer's ops
    at every layer, a chunk loop's at every chunk) is not run again: its
    outputs are made empty from the first call's metadata and its counts
    repeated.  The counts are those of running it (the tests hold them
    equal); only the host time falls, ~3x on zamba2-7b's train step."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.stats = OpStats()
        self.memo = {} if memo else None

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add(self, name: str, flops: int, nbytes: int) -> None:
        s = self.stats
        s.flops += flops
        s.bytes += nbytes
        s.ops += 1
        row = s.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _memo_key(func, args, kwargs) if self.memo is not None else None
        if key is not None and key in self.memo:
            outs, spec, name, flops, nbytes = self.memo[key]
            self.add(name, flops, nbytes)
            return tree_unflatten([torch.empty_strided(o[0], o[1], dtype=o[2], device="meta")
                                   if isinstance(o, _Meta) else o for o in outs], spec)
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
        nbytes = 0
        if not (func.is_view or packet in NO_DATA_OPS):
            nbytes = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
            nbytes += sum(tensor_bytes(t) for t in _tensors(out))
        self.add(str(packet), flops, nbytes)
        if key is not None:
            flat, spec = tree_flatten(out)
            outs = [_Meta((tuple(o.shape), o.stride(), o.dtype))
                    if isinstance(o, torch.Tensor) else o for o in flat]
            self.memo[key] = (outs, spec, str(packet), flops, nbytes)
        return out


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """Count a hand-written kernel's work in the innermost open counter: a
    kernel wrapper's ``meta`` route reports what its kernels would do (no
    aten op of theirs is dispatched).  Nothing when no counter is open."""
    if _ACTIVE:
        _ACTIVE[-1].add(name, int(flops), int(nbytes))


def count(fn, *args, memo: bool = True, **kwargs) -> tuple[object, OpStats]:
    """(``fn(*args, **kwargs)``, the counts of the ops it ran)."""
    with OpCounter(memo) as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
