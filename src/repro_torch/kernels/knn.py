"""KNN knowledge-base lookup: the hand-written CUDA kernels and their plain
PyTorch versions (paper §4.3 / Algorithm 2).

Two entry points, each the counterpart of a Pallas kernel of the JAX
package:

- ``knn_topk``        — one query against the (N, D) case base
  (``src/repro/kernels/knn.py`` ``_dist_kernel``);
- ``knn_topk_batch``  — Q queries at once (``_dist_kernel_batch``).

Both return ``(distances, indices)``, ascending, ties to the lower index.
On a CPU tensor they run the plain version (``knn_topk_plain`` /
``knn_topk_batch_plain``) in the tensor's dtype; on a CUDA tensor they
launch the kernels of ``csrc/knn.cu`` (float32 only) or raise.  Each launch
adds one to ``launches``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import build_library

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {"knn_topk": 0, "knn_topk_batch": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --- plain versions ---------------------------------------------------------


def _topk_ascending(d2: torch.Tensor, k: int):
    """k smallest along the last dim, ascending, ties to the lower index
    (a stable sort), as sqrt distances.  Tiny negatives clamp to zero before
    the selection, as the JAX package's numpy backend clamps them."""
    d2s, idx = torch.sort(torch.clamp(d2, min=0.0), dim=-1, stable=True)
    return torch.sqrt(d2s[..., :k]), idx[..., :k]


def knn_topk_plain(cases: torch.Tensor, query: torch.Tensor, k: int):
    """(N, D), (D,) -> ((k,) distances, (k,) int64 indices): the fused
    ``(x - q)^2`` row sum, then top-k."""
    d2 = torch.sum((cases - query[None, :]) ** 2, dim=1)
    return _topk_ascending(d2, k)


def knn_topk_batch_plain(cases: torch.Tensor, queries: torch.Tensor, k: int):
    """(N, D), (Q, D) -> ((Q, k) distances, (Q, k) indices) through the
    ``||q||^2 + ||x||^2 - 2 q.x`` expansion, as the JAX batch path
    (``_knn_jax_batch``) computes it."""
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    xn = torch.sum(cases * cases, dim=1)[None, :]
    d2 = qn + xn - 2.0 * (queries @ cases.T)
    return _topk_ascending(d2, k)


# --- build ------------------------------------------------------------------


def build() -> str:
    """Compile ``csrc/knn.cu`` (once per source version) and load it.

    Returns the compiler's report (registers, shared memory, spills) when
    this call compiled, else an empty string."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_topk_f32.argtypes = [p, p, i, i, i, p, p, p, p, p]
    lib.knn_topk_f32.restype = i
    lib.knn_topk_batch_f32.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.knn_topk_batch_f32.restype = i
    for name, args in (("knn_topk_blocks", [i]), ("knn_max_k", []),
                       ("knn_max_d", [])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    _lib = lib
    return log


def _check(cases: torch.Tensor, queries: torch.Tensor, k: int) -> ctypes.CDLL:
    if cases.device.type != "cuda" or queries.device != cases.device:
        raise ValueError(f"cases ({cases.device}) and queries ({queries.device}) "
                         "must lie on the same CUDA device")
    build()
    if cases.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {cases.dtype} / "
                        f"{queries.dtype}")
    if cases.dim() != 2 or queries.shape[-1] != cases.shape[1]:
        raise ValueError(f"shapes {tuple(cases.shape)} and {tuple(queries.shape)} "
                         "do not match (N, D) / (..., D)")
    if not (cases.is_contiguous() and queries.is_contiguous()):
        raise ValueError("cases and queries must be contiguous")
    n, d = cases.shape
    if not 1 <= d <= _lib.knn_max_d():
        raise ValueError(f"feature dim {d} outside [1, {_lib.knn_max_d()}]")
    if not 1 <= k <= min(n, _lib.knn_max_k()):
        raise ValueError(f"k={k} outside [1, min(N={n}, {_lib.knn_max_k()})]")
    return _lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


# --- dispatch ---------------------------------------------------------------


def knn_topk(cases: torch.Tensor, query: torch.Tensor, k: int):
    """Top-k nearest cases of one query: ((k,) distances, (k,) indices)."""
    if cases.device.type == "cpu" and query.device.type == "cpu":
        return knn_topk_plain(cases, query, k)
    lib = _check(cases, query, k)
    if query.dim() != 1:
        raise ValueError(f"query must be (D,), got {tuple(query.shape)}")
    n, d = cases.shape
    dev = cases.device
    blocks = lib.knn_topk_blocks(n)
    part_d = part_i = None
    if blocks > 1:
        part_d = torch.empty(blocks * k, dtype=torch.float32, device=dev)
        part_i = torch.empty(blocks * k, dtype=torch.int32, device=dev)
    dist = torch.empty(k, dtype=torch.float32, device=dev)
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.knn_topk_f32(
        cases.data_ptr(), query.data_ptr(), n, d, k,
        part_d.data_ptr() if part_d is not None else None,
        part_i.data_ptr() if part_i is not None else None,
        dist.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_topk_f32")
    launches["knn_topk"] += 1
    return dist, idx


def knn_topk_batch(cases: torch.Tensor, queries: torch.Tensor, k: int):
    """Top-k nearest cases of each of Q queries: ((Q, k) distances,
    (Q, k) indices)."""
    if cases.device.type == "cpu" and queries.device.type == "cpu":
        return knn_topk_batch_plain(cases, queries, k)
    lib = _check(cases, queries, k)
    if queries.dim() != 2 or queries.shape[0] < 1:
        raise ValueError(f"queries must be (Q, D), Q >= 1, got {tuple(queries.shape)}")
    n, d = cases.shape
    nq = queries.shape[0]
    dev = cases.device
    dist = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.knn_topk_batch_f32(cases.data_ptr(), queries.data_ptr(), n, d, nq, k,
                                 dist.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_topk_batch_f32")
    launches["knn_topk_batch"] += 1
    return dist, idx
