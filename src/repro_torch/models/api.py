"""Family-generic model API: init, forward dispatch, parameter counts, and
the bridge that carries the reference's weights across (the counterpart of
``repro/models/api.py``).

Weights are stored as they are used: every matrix in the config's
``compute_dtype`` (the reference keeps ``param_dtype`` and casts at every
use; casting once gives the same values), the norm scales (``ln*``) in
``param_dtype``, since ``rms_norm`` reads them in fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import transformer
from .common import ModelConfig, dense_init

FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "audio": transformer,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            "rwkv6, ssm and zamba2 families come with a later slice of the LM "
            "stack")
    return FAMILIES[cfg.family]


def _walk_flat(node, prefix=()):
    for name, v in node.items():
        if isinstance(v, dict):
            yield from _walk_flat(v, prefix + (name,))
        else:
            yield prefix + (name,), v


def _storage_dtype(cfg: ModelConfig, leaf: str) -> torch.dtype:
    return cfg.param_dtype if leaf.startswith("ln") else cfg.compute_dtype


def _set(out: dict, path: tuple, value) -> None:
    node = out
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights by the reference's rules: norm scales one, every other
    leaf ``dense_init`` with ``in_axis = max(ndim - 2, 0)``, drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device``, one leaf at a
    time in sorted path order (so fp32 never holds more than one leaf)."""
    dev = resolve_device(device)
    shapes = module_for(cfg).param_shapes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: dict = {}
    for path, shape in sorted(_walk_flat(shapes)):
        leaf = path[-1]
        dtype = _storage_dtype(cfg, leaf)
        if leaf.startswith("ln"):
            value = torch.ones(shape, dtype=dtype, device=dev)
        else:
            value = dense_init(shape, dtype, gen, in_axis=max(len(shape) - 2, 0))
        _set(out, path, value)
    return out


def params_from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The port's params from the reference's param dict given as numpy
    arrays (same keys and shapes), stored as ``init_params`` stores them."""
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
        _set(out, path, value.to(device=dev, dtype=_storage_dtype(cfg, path[-1])))
    return out


def forward(params, tokens, cfg: ModelConfig, **kw):
    return module_for(cfg).forward(params, tokens, cfg, **kw)


def param_count(cfg: ModelConfig) -> int:
    shapes = module_for(cfg).param_shapes(cfg)
    return int(sum(math.prod(s) for _, s in _walk_flat(shapes)))
