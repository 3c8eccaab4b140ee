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

``knn_topk_batch`` takes a ``route``: ``"cluster"`` (the default) launches
``knn_cluster_kernel``, a thread-block cluster per group of queries whose
blocks split the base into slices (``batch_plan``); ``"warp"`` launches the
previous kernel, a warp per query over the whole base (``batch_warp_plan``),
kept as the yardstick of the same call.  Each launch also adds one to its
route's count.  Every kernel adds the same fmaf chain in the same order, so
all of them give ``knn_topk``'s neighbours and distances bit for bit.

``knn_lookup(cases, query, k)`` is the per-slot lookup of the knowledge
base: the query is a host numpy array and the result comes back as numpy
``(float64 distances, int64 indices)``.  On CUDA cases it makes one round
trip: the query goes to ``knn_topk``'s kernel as its launch parameter (no
copy to the card), the kernel writes the k pairs into a pinned host record
that the module keeps, and the call waits for the stream once.  Its
launches count as ``knn_topk``'s.  On CPU cases it runs the plain version.
``knn_topk`` still takes a CUDA query (for comparisons); it is then read
from device memory.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ._build import build_library

# The kernels' limits (csrc/knn.cu): the largest k and feature dim.
KMAX = 8
MAX_D = 256
# The single-query kernel's tiling: threads and rows per block, and the
# shared memory its tile of rows may take.
QTHREADS = 512
QROWS = 2048
QSMEM = 196608

# The batch kernels (csrc/knn.cu).  The cluster kernel: queries (warps) a
# block and blocks (slices) a cluster at most, and its dynamic shared memory
# at most; of that, what the staged rows may take.  The plan launches at
# least BATCH_TARGET blocks where Q allows: one per SM of an H100.
BATCH_GROUP_MAX = 8
BATCH_CLUSTER_MAX = 8
BATCH_SMEM = 106496
BATCH_TILE = 98304
BATCH_TARGET = 132
# The previous batch kernel: threads and queries a block, its shared memory
# at most (a launch without the attribute).
BATCH_THREADS = 256
BATCH_WARPS = BATCH_THREADS // 32
SMEM_BUDGET = 49152
BATCH_ROUTES = ("cluster", "warp")

#: Kernel launches per wrapper since the last ``reset_launches()``, and the
#: batch's by route.
launches = {"knn_topk": 0, "knn_topk_batch": 0, "cluster": 0, "warp": 0}

_lib: ctypes.CDLL | None = None
_record: dict = {}          # the pinned host record of knn_lookup and its device address
_record_lock = threading.Lock()   # one lookup at a time writes and reads the record


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
    lib.knn_lookup_f32.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.knn_lookup_f32.restype = i
    lib.knn_topk_batch_f32.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, p, p, p]
    lib.knn_topk_batch_f32.restype = i
    lib.knn_topk_batch_warp_f32.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p]
    lib.knn_topk_batch_warp_f32.restype = i
    lib.knn_batch_floor.argtypes = [i, i, i, i, p]
    lib.knn_batch_floor.restype = i
    lib.knn_device_pointer.argtypes = [p, ctypes.POINTER(ctypes.c_void_p)]
    lib.knn_device_pointer.restype = i
    lib.knn_topk_blocks.argtypes = [i, i]
    lib.knn_topk_blocks.restype = i
    _lib = lib
    return log


def _check(cases: torch.Tensor, query_dim: int, k: int) -> ctypes.CDLL:
    """Build the kernels and check what every CUDA entry takes: a
    contiguous float32 (N, D) case matrix on the card, queries of D
    features, 1 <= k <= min(N, KMAX)."""
    if cases.device.type != "cuda":
        raise ValueError(f"cases must lie on a CUDA device or the CPU, got {cases.device}")
    build()
    if cases.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {cases.dtype}")
    if cases.dim() != 2 or not cases.is_contiguous():
        raise ValueError(f"cases must be a contiguous (N, D) matrix, got "
                         f"{tuple(cases.shape)}, strides {cases.stride()}")
    n, d = cases.shape
    if query_dim != d or not 1 <= d <= MAX_D:
        raise ValueError(f"queries of {query_dim} features against cases of {d} "
                         f"(at most {MAX_D})")
    if not 1 <= k <= min(n, KMAX):
        raise ValueError(f"k={k} outside [1, min(N={n}, {KMAX})]")
    return _lib


def _check_queries(cases: torch.Tensor, queries: torch.Tensor) -> None:
    if queries.device != cases.device:
        raise ValueError(f"cases ({cases.device}) and queries ({queries.device}) "
                         "must lie on the same CUDA device")
    if queries.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 queries, got {queries.dtype}")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


# --- dispatch ---------------------------------------------------------------


def query_rows(d: int) -> int:
    """Rows a block of the single-query kernel takes at feature dim d: what
    its tile holds, a multiple of 4, at most QROWS."""
    return min(QSMEM // (4 * d), QROWS) // 4 * 4


def query_blocks(n: int, d: int) -> int:
    """Blocks of the single-query kernel for n rows; past one, a merge
    launch follows."""
    return -(-n // query_rows(d))


def _partials(n: int, d: int, k: int, dev: torch.device):
    """Scratch of the merge launch, when the base takes more than one block."""
    blocks = query_blocks(n, d)
    if blocks == 1:
        return None, None
    return (torch.empty(blocks * k, dtype=torch.float32, device=dev),
            torch.empty(blocks * k, dtype=torch.int32, device=dev))


def _ptr(x: torch.Tensor | None):
    return x.data_ptr() if x is not None else None


def knn_topk(cases: torch.Tensor, query: torch.Tensor, k: int):
    """Top-k nearest cases of one query: ((k,) distances, (k,) indices)."""
    if cases.device.type == "cpu" and query.device.type == "cpu":
        return knn_topk_plain(cases, query, k)
    _check_queries(cases, query)
    if query.dim() != 1:
        raise ValueError(f"query must be (D,), got {tuple(query.shape)}")
    lib = _check(cases, query.shape[0], k)
    n, d = cases.shape
    dev = cases.device
    part_d, part_i = _partials(n, d, k, dev)
    dist = torch.empty(k, dtype=torch.float32, device=dev)
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.knn_topk_f32(cases.data_ptr(), query.data_ptr(), n, d, k, _ptr(part_d),
                           _ptr(part_i), dist.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, "knn_topk_f32")
    launches["knn_topk"] += 1
    return dist, idx


def _host_record(lib: ctypes.CDLL):
    """The pinned (KMAX, 2) int64 record the lookup kernel writes into, and
    its device address (allocated once)."""
    if not _record:
        rec = torch.empty((KMAX, 2), dtype=torch.int64, pin_memory=True)
        addr = ctypes.c_void_p()
        _raise_on(lib.knn_device_pointer(rec.data_ptr(), ctypes.byref(addr)),
                  "cudaHostGetDevicePointer")
        _record.update(rec=rec, view=rec.numpy(), addr=addr.value)
    return _record


def knn_lookup(cases: torch.Tensor, query, k: int):
    """Top-k nearest cases of one host query: numpy ((k,) float64 distances,
    (k,) int64 indices).  See the module docstring."""
    if cases.device.type == "cpu":
        dist, idx = knn_topk_plain(cases, torch.as_tensor(query, dtype=cases.dtype), k)
        return dist.double().numpy(), idx.numpy()
    if isinstance(query, torch.Tensor) and query.device.type != "cpu":
        raise ValueError("knn_lookup takes the query in host memory; use knn_topk "
                         f"for a query on {query.device}")
    q = np.ascontiguousarray(query, dtype=np.float32)
    if q.ndim != 1:
        raise ValueError(f"query must be (D,), got {q.shape}")
    lib = _check(cases, q.shape[0], k)
    n, d = cases.shape
    part_d, part_i = _partials(n, d, k, cases.device)
    stream = torch.cuda.current_stream(cases.device).cuda_stream
    with _record_lock:
        rec = _host_record(lib)
        err = lib.knn_lookup_f32(cases.data_ptr(), q.ctypes.data, n, d, k, _ptr(part_d),
                                 _ptr(part_i), rec["addr"], stream)
        _raise_on(err, "knn_lookup_f32")
        launches["knn_topk"] += 1
        pairs = rec["view"][:k]         # copied out: the next lookup reuses the record
        return pairs[:, 0].view(np.float64).copy(), pairs[:, 1].copy()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def batch_plan(n: int, d: int, nq: int, k: int) -> dict:
    """The cluster kernel's launch for nq queries against n rows of d
    features: ``group`` queries a block (one warp each; the largest of 8, 4,
    2, 1 that still gives BATCH_TARGET blocks over clusters of 8, else 1),
    ``slices`` blocks a cluster (the fewest that give BATCH_TARGET blocks, at
    most 8), the base cut into ``chunks`` chunks of ``rows`` rows (a multiple
    of 4, so each chunk's bytes start on a 16-byte boundary; the rows of one
    slice, unless they outgrow BATCH_TILE), chunk c taken by block
    ``c % slices`` of each cluster; ``blocks`` blocks of ``threads``,
    ``smem`` bytes of dynamic shared memory (rows and queries)."""
    if not (n >= 1 and 1 <= d <= MAX_D and nq >= 1 and 1 <= k <= min(n, KMAX)):
        raise ValueError(f"no batch launch for N={n} D={d} Q={nq} k={k}")
    group = next((g for g in (8, 4, 2) if _cdiv(nq, g) * BATCH_CLUSTER_MAX >= BATCH_TARGET), 1)
    groups = _cdiv(nq, group)
    slices = min(BATCH_CLUSTER_MAX, _cdiv(BATCH_TARGET, groups))
    rows = min(_cdiv(_cdiv(n, slices), 4) * 4, BATCH_TILE // (4 * d) // 4 * 4)
    return dict(group=group, slices=slices, rows=rows, chunks=_cdiv(n, rows),
                blocks=groups * slices, threads=32 * group, smem=4 * d * (rows + group))


def batch_warp_plan(n: int, d: int, nq: int) -> dict:
    """The previous batch kernel's launch: BATCH_WARPS queries a block,
    chunks of ``chunk`` rows (a multiple of 32) stored with an odd stride,
    ``smem`` bytes."""
    ds = d | 1
    chunk = min(SMEM_BUDGET // (4 * ds) - BATCH_WARPS, 256)
    chunk -= chunk % 32
    return dict(chunk=chunk, blocks=_cdiv(nq, BATCH_WARPS), threads=BATCH_THREADS,
                smem=(BATCH_WARPS + chunk) * ds * 4)


def knn_topk_batch(cases: torch.Tensor, queries: torch.Tensor, k: int,
                   route: str | None = None):
    """Top-k nearest cases of each of Q queries: ((Q, k) distances,
    (Q, k) indices); on CUDA tensors through ``route`` (``"cluster"`` by
    default, ``"warp"``: the previous kernel)."""
    route = route or "cluster"
    if route not in BATCH_ROUTES:
        raise ValueError(f"unknown batch route {route!r}; use one of {BATCH_ROUTES}")
    if cases.device.type == "cpu" and queries.device.type == "cpu":
        return knn_topk_batch_plain(cases, queries, k)
    _check_queries(cases, queries)
    if queries.dim() != 2 or queries.shape[0] < 1:
        raise ValueError(f"queries must be (Q, D), Q >= 1, got {tuple(queries.shape)}")
    lib = _check(cases, queries.shape[1], k)
    n, d = cases.shape
    nq = queries.shape[0]
    dev = cases.device
    dist = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (cases.data_ptr(), queries.data_ptr(), n, d, nq, k)
    if route == "cluster":
        pl = batch_plan(n, d, nq, k)
        err = lib.knn_topk_batch_f32(*ptrs, pl["group"], pl["slices"], pl["rows"],
                                     pl["chunks"], pl["blocks"], pl["smem"], dist.data_ptr(),
                                     idx.data_ptr(), stream)
    else:
        pl = batch_warp_plan(n, d, nq)
        err = lib.knn_topk_batch_warp_f32(*ptrs, pl["chunk"], pl["blocks"], pl["smem"],
                                          dist.data_ptr(), idx.data_ptr(), stream)
    _raise_on(err, f"knn_topk_batch ({route})")
    launches["knn_topk_batch"] += 1
    launches[route] += 1
    return dist, idx
