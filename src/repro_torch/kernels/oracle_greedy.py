"""The oracle's greedy pass on the device: the hand-written CUDA kernel and
its plain version.

``greedy_pass(j_idx, t_idx, k_val, gain, kmin, lengths, capacity, horizon)``
walks the entries of Algorithm 1 in their sorted order (``core/oracle.py``
builds and sorts them on the host) and allocates greedily under the cluster
capacity.  It is the counterpart of the JAX package's ``_greedy_jax``
(``src/repro/core/oracle.py:177``, a jitted ``lax.fori_loop``), with its
types: int32 entry indices, int32 ``alloc``/``used``, float32 ``gain``,
``lengths`` and ``work``.  An entry ``(j, t, k)`` is taken when

- ``work[j] < lengths[j] - 1e-9`` in float32 (job ``j`` not yet done),
- ``alloc[j, t]`` is 0 for the base entry ``k == kmin[j]`` and ``k - 1``
  otherwise (incremental consistency),
- ``used[t] + add <= capacity``, ``add`` being ``kmin[j]`` for the base
  entry and 1 otherwise;

it then sets ``alloc[j, t] = k``, adds ``add`` to ``used[t]`` and 1 (base)
or ``gain`` to ``work[j]``, one float32 add.  Once every job is done every
later entry fails, so both versions stop there.

Returns ``(alloc (n, horizon), used (horizon,), work (n,), walked (1,))``
on the inputs' device, ``walked`` being the number of entries walked (all
of them when some job never finishes).  On CPU tensors it runs
``greedy_pass_plain``; on CUDA tensors it launches the kernel of
``csrc/oracle_greedy.cu`` or raises.  Each launch adds one to
``launches["greedy_pass"]``.  Both versions do the same IEEE float32 adds
in the same order, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import build_library

#: Kernel launches since the last ``reset_launches()``.
launches = {"greedy_pass": 0}

_EPS = 1e-9

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    launches["greedy_pass"] = 0


def greedy_pass_plain(j_idx: torch.Tensor, t_idx: torch.Tensor,
                      k_val: torch.Tensor, gain: torch.Tensor,
                      kmin: torch.Tensor, lengths: torch.Tensor,
                      capacity: int, horizon: int):
    """The pass as a loop over the entries, in float32 numpy scalars."""
    n = kmin.shape[0]
    thr = list(lengths.numpy().astype(np.float32) - np.float32(_EPS))
    km_l = kmin.tolist()
    work = [np.float32(0.0)] * n
    used = [0] * horizon
    alloc = [[0] * horizon for _ in range(n)]
    one = np.float32(1.0)
    unfinished = sum(1 for x in thr if np.float32(0.0) < x)
    jl, tl, kl = j_idx.tolist(), t_idx.tolist(), k_val.tolist()
    gl = gain.numpy().astype(np.float32)
    walked = len(jl) if unfinished else 0
    for i in range(walked):
        j, t, k = jl[i], tl[i], kl[i]
        if not (0 <= j < n and 0 <= t < horizon):
            raise IndexError(f"entry {i} = (j={j}, t={t}) outside "
                             f"{n} jobs x {horizon} slots")
        w = work[j]
        if not w < thr[j]:
            continue                          # job already done
        km = km_l[j]
        base = k == km
        row = alloc[j]
        if row[t] != (0 if base else k - 1):
            continue                          # incremental consistency
        add = km if base else 1
        if used[t] + add > capacity:
            continue                          # capacity exceeded
        row[t] = k
        used[t] += add
        w = w + (one if base else gl[i])
        work[j] = w
        if not w < thr[j]:
            unfinished -= 1
            if unfinished == 0:
                walked = i + 1                # every job done
                break
    return (torch.tensor(alloc, dtype=torch.int32).reshape(n, horizon),
            torch.tensor(used, dtype=torch.int32),
            torch.from_numpy(np.array(work, dtype=np.float32)),
            torch.tensor([walked], dtype=torch.int32))


# --- build ------------------------------------------------------------------


def build() -> str:
    """Compile ``csrc/oracle_greedy.cu`` (once per source version) and load
    it.  Returns the compiler's report when this call compiled."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("oracle_greedy")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.greedy_pass.argtypes = [p] * 6 + [i] * 4 + [p] * 5
    lib.greedy_pass.restype = i
    lib.greedy_pass_max_state.argtypes = []
    lib.greedy_pass_max_state.restype = i
    _lib = lib
    return log


# --- dispatch ---------------------------------------------------------------


def greedy_pass(j_idx: torch.Tensor, t_idx: torch.Tensor, k_val: torch.Tensor,
                gain: torch.Tensor, kmin: torch.Tensor, lengths: torch.Tensor,
                capacity: int, horizon: int):
    """The greedy pass over sorted entries; see the module docstring."""
    args = (j_idx, t_idx, k_val, gain, kmin, lengths)
    if all(x.device.type == "cpu" for x in args):
        return greedy_pass_plain(*args, capacity, horizon)
    dev = j_idx.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("the entries, kmin and lengths must lie on the same "
                         f"CUDA device, got {[str(x.device) for x in args]}")
    for name, x, dt in (("j_idx", j_idx, torch.int32), ("t_idx", t_idx, torch.int32),
                        ("k_val", k_val, torch.int32), ("gain", gain, torch.float32),
                        ("kmin", kmin, torch.int32), ("lengths", lengths, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    n_entries, n = j_idx.shape[0], kmin.shape[0]
    if not (t_idx.shape[0] == k_val.shape[0] == gain.shape[0] == n_entries
            and lengths.shape[0] == n):
        raise ValueError("the four entry arrays must share one length, and "
                         "kmin and lengths another")
    if not (0 < horizon and 0 <= capacity < 2 ** 31 and n_entries < 2 ** 31):
        raise ValueError(f"horizon {horizon}, capacity {capacity} or "
                         f"{n_entries} entries out of range")
    build()
    if horizon + 3 * n > _lib.greedy_pass_max_state():
        raise ValueError(f"{n} jobs x {horizon} slots exceed the kernel's shared "
                         f"memory (horizon + 3 n <= {_lib.greedy_pass_max_state()})")
    alloc = torch.empty((n, horizon), dtype=torch.int32, device=dev)
    used = torch.empty(horizon, dtype=torch.int32, device=dev)
    work = torch.empty(n, dtype=torch.float32, device=dev)
    walked = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.greedy_pass(*(x.data_ptr() for x in args), n_entries, n,
                           int(horizon), int(capacity), alloc.data_ptr(),
                           used.data_ptr(), work.data_ptr(), walked.data_ptr(),
                           stream)
    if err != 0:
        raise RuntimeError(f"greedy_pass failed with cudaError_t {err}")
    launches["greedy_pass"] += 1
    return alloc, used, work, walked
