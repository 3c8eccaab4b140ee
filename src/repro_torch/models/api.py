"""Family-generic model API: init, forward dispatch, parameter counts, and
the bridge that carries the reference's weights across (the counterpart of
``repro/models/api.py``).

Weights are stored as they are used: every matrix, and the leaves that the
reference casts to the activations' dtype at use (``mix``, ``mix_c``,
``conv``, ``d_skip``), in the config's ``compute_dtype`` (the reference
keeps ``param_dtype`` and casts at every use; casting once gives the same
values); the leaves that it reads in fp32 in ``param_dtype``: the norm
scales (``ln*``, read by ``rms_norm``), rwkv6's decay base ``w0`` and bonus
``u``, zamba2's ``a_log`` and ``dt_bias``.  Stored in bf16, those four
would change the decay at full width.  Training keeps master weights:
with ``master=True`` every leaf is stored in ``param_dtype``, as the
reference stores them, and the forward casts at use.

On a mesh (``rules``, ``models/common.py::LogicalRules``) each rank holds
its block of every leaf as ``param_specs`` places it: ``shard_params``
takes a whole tree to the rank's tree, ``gather_params`` takes it back;
``param_shardings`` and ``abstract_params`` are the reference's trees of
shardings and of shape/dtype/sharding stand-ins (``meta`` tensors with a
``sharding`` attribute).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import rwkv6, transformer, zamba2
from .common import LogicalRules, ModelConfig, Sharding, dense_init

FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "audio": transformer,
    "ssm": rwkv6,
    "hybrid": zamba2,
}

#: Leaves that the reference reads in fp32 (beside the norm scales).
FP32_LEAVES = ("w0", "u", "a_log", "dt_bias")
#: Leaves that the reference initialises to a constant, and the constant.
CONST_LEAVES = {"d_skip": 1.0, "mix": 0.5, "mix_c": 0.5, "w0": -1.0,
                "a_log": 0.0, "dt_bias": -1.0}


def module_for(cfg: ModelConfig):
    return FAMILIES[cfg.family]


def _walk_flat(node, prefix=()):
    for name, v in node.items():
        if isinstance(v, dict):
            yield from _walk_flat(v, prefix + (name,))
        else:
            yield prefix + (name,), v


def _storage_dtype(cfg: ModelConfig, leaf: str, master: bool = False) -> torch.dtype:
    if master or leaf.startswith("ln") or leaf in FP32_LEAVES:
        return cfg.param_dtype
    return cfg.compute_dtype


def _set(out: dict, path: tuple, value) -> None:
    node = out
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", master: bool = False) -> dict:
    """Random weights by the reference's rules: norm scales one, the
    constants of ``CONST_LEAVES`` (``d_skip`` 1, ``mix``/``mix_c`` 0.5,
    ``w0`` -1, ``a_log`` 0, ``dt_bias`` -1), every other leaf
    ``dense_init`` with ``in_axis = max(ndim - 2, 0)``, drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device``, one leaf at a
    time in sorted path order (so fp32 never holds more than one leaf).
    ``master``: every leaf in ``param_dtype`` (the train state's weights)."""
    dev = resolve_device(device)
    shapes = module_for(cfg).param_shapes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: dict = {}
    for path, shape in sorted(_walk_flat(shapes)):
        leaf = path[-1]
        dtype = _storage_dtype(cfg, leaf, master)
        if leaf.startswith("ln"):
            value = torch.ones(shape, dtype=dtype, device=dev)
        elif leaf in CONST_LEAVES:
            value = torch.full(shape, CONST_LEAVES[leaf], dtype=dtype, device=dev)
        else:
            value = dense_init(shape, dtype, gen, in_axis=max(len(shape) - 2, 0))
        _set(out, path, value)
    return out


def params_from_reference(cfg: ModelConfig, tree: dict, device="cuda",
                          master: bool = False, rules: LogicalRules | None = None) -> dict:
    """The port's params from the reference's param dict given as numpy
    arrays (same keys and shapes), stored as ``init_params`` stores them
    (with ``master``: every leaf in ``param_dtype``); with ``rules``, each
    leaf's block for this rank (``shard_params``)."""
    dev = resolve_device(device)
    shapes = dict(_walk_flat(module_for(cfg).param_shapes(cfg)))
    given = dict(_walk_flat(tree))
    if set(given) != set(shapes):
        raise ValueError(f"param keys differ: {sorted(set(given) ^ set(shapes))}")
    out: dict = {}
    for path, arr in given.items():
        arr = np.asarray(arr)
        if arr.shape != tuple(shapes[path]):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, expected "
                             f"{shapes[path]}")
        value = torch.tensor(np.asarray(arr, dtype=np.float32))
        _set(out, path, value.to(device=dev, dtype=_storage_dtype(cfg, path[-1], master)))
    return out if rules is None else shard_params(out, cfg, rules)


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def param_shardings(cfg: ModelConfig, rules: LogicalRules) -> dict:
    """Each leaf's ``Sharding`` under ``rules`` (the reference's
    ``param_shardings``): its logical names, replication where a dim does
    not divide."""
    key = ("params", cfg)
    cache = rules.__dict__.setdefault("_trees", {})
    if key not in cache:
        mod = module_for(cfg)
        cache[key] = _map(lambda sh, sp: rules.sharding(*sp, dims=sh),
                          mod.param_shapes(cfg), mod.param_specs(cfg))
    return cache[key]


def abstract_params(cfg: ModelConfig, rules: LogicalRules) -> dict:
    """``meta`` tensors of the whole leaves' shapes in ``param_dtype``, each
    carrying its ``Sharding`` as ``.sharding`` (the reference's
    ``ShapeDtypeStruct(..., sharding=)``)."""
    def leaf(shape, sharding: Sharding):
        t = torch.empty(shape, dtype=cfg.param_dtype, device="meta")
        t.sharding = sharding
        return t

    return _map(leaf, module_for(cfg).param_shapes(cfg), param_shardings(cfg, rules))


def shard_params(params: dict, cfg: ModelConfig, rules: LogicalRules) -> dict:
    """A whole param tree to this rank's blocks (copies)."""
    return _map(lambda t, sh: sh.local(t), params, param_shardings(cfg, rules))


def gather_params(params: dict, cfg: ModelConfig, rules: LogicalRules) -> dict:
    """This rank's blocks made whole again (every rank gets every leaf).
    Autograd-aware
    (``distributed.gather_leaf``): the gradient reaches the blocks."""
    from repro_torch.distributed import gather_leaf

    return _map(lambda t, sh: gather_leaf(t, sh.dims(t.dim()), rules),
                params, param_shardings(cfg, rules))


def forward(params, tokens, cfg: ModelConfig, rules: LogicalRules | None = None, **kw):
    """The family's forward.  With ``rules`` bound to ranks, ``params`` are
    the rank's blocks and ``tokens`` its slice of the batch."""
    return module_for(cfg).forward(params, tokens, cfg, rules=rules, **kw)


def param_count(cfg: ModelConfig) -> int:
    shapes = module_for(cfg).param_shapes(cfg)
    return int(sum(math.prod(s) for _, s in _walk_flat(shapes)))
