"""DAG dependency gating: the hand-written CUDA kernel and its plain
PyTorch versions.

Each slot the device slot loop (``core/scan_engine.py``) needs, for every
cell of its batch, ``dec[c] = #{edges (p, c) : fin[p]}``: how many of row
``c``'s predecessors finished in that slot.  The counterpart of
``src/repro/kernels/gating.py``:

- ``dep_decrement(fin, parents, children, n)`` — the reference's edge-list
  signature (``dep_decrement`` / ``dep_decrement_pallas`` there); on a CUDA
  tensor it builds the predecessor CSR and launches the kernel;
- ``dep_decrement_csr(fin, graph)`` — the per-program entry point the
  engine calls each slot, over a :class:`DepGraph` built once;
- the plain versions ``dep_decrement_plain`` (``index_add_``, the
  reference's scatter form), ``dep_decrement_gather_plain`` (its padded
  gather form) and ``dep_decrement_csr_plain``.

``fin`` is (n,) or (B, n), bool or uint8 (nonzero counts as finished); the
counts come back as int32 of the same shape.  On CPU tensors the wrappers
run the plain version; on CUDA tensors they launch the kernel of
``csrc/gating.cu`` or raise.  Each launch adds one to ``launches``.
Integer counts, so every version agrees exactly.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ._build import build_library

#: Kernel launches since the last ``reset_launches()``.
launches = {"dep_decrement": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class DepGraph:
    """Predecessor CSR by child over ``n`` rows: row ``c``'s predecessors
    are ``pred_idx[pred_ptr[c]:pred_ptr[c + 1]]`` (int32, one device).
    Build it with :func:`dep_graph`, which checks the indices."""

    pred_ptr: torch.Tensor           # (n + 1,)
    pred_idx: torch.Tensor           # (E,)

    @property
    def n(self) -> int:
        return self.pred_ptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.pred_idx.shape[0]


def dep_graph(parents, children, n: int,
              device: str | torch.device = "cuda") -> DepGraph:
    """The :class:`DepGraph` of an edge list ``(parents[e], children[e])``
    (numpy arrays or tensors; duplicate edges count twice), built on the
    host and moved to ``device`` (the card by default; without one it
    raises, so host callers pass ``device="cpu"``).  Predecessors of a row
    keep their edge order."""
    device = resolve_device(device)
    par = torch.as_tensor(np.asarray(parents), dtype=torch.int64)
    chd = torch.as_tensor(np.asarray(children), dtype=torch.int64)
    if par.shape != chd.shape or par.dim() != 1:
        raise ValueError(f"parents {tuple(par.shape)} and children "
                         f"{tuple(chd.shape)} must be matching 1-D edge lists")
    if len(par) and not (0 <= min(par.min(), chd.min())
                         and max(par.max(), chd.max()) < n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    if max(n, len(par)) >= 2 ** 31:
        raise ValueError(f"{n} rows / {len(par)} edges exceed int32 indices")
    order = torch.argsort(chd, stable=True)
    ptr = torch.zeros(n + 1, dtype=torch.int64)
    torch.cumsum(torch.bincount(chd, minlength=n), 0, out=ptr[1:])
    return DepGraph(pred_ptr=ptr.to(device, torch.int32),
                    pred_idx=par[order].to(device, torch.int32))


# --- plain versions ---------------------------------------------------------


def dep_decrement_plain(fin: torch.Tensor, parents: torch.Tensor,
                        children: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's scatter form: gather ``fin`` at the parents, then
    ``index_add_`` into the children."""
    contrib = (fin[..., parents] != 0).to(torch.int32)
    out = torch.zeros(fin.shape[:-1] + (n,), dtype=torch.int32, device=fin.device)
    return out.index_add_(-1, children, contrib)


def dep_decrement_gather_plain(fin: torch.Tensor,
                               pred_rows: torch.Tensor) -> torch.Tensor:
    """The reference's gather form: ``pred_rows`` is each row's padded
    predecessor list (n, max in-degree), padding pointing at a row whose
    ``fin`` is always False."""
    return (fin[..., pred_rows] != 0).sum(-1, dtype=torch.int32)


def dep_decrement_csr_plain(fin: torch.Tensor, graph: DepGraph) -> torch.Tensor:
    """Segment sums of ``fin`` over each row's predecessor segment, as
    differences of one running sum."""
    seg = (fin[..., graph.pred_idx] != 0).to(torch.int64)
    run = torch.nn.functional.pad(torch.cumsum(seg, -1), (1, 0))
    ptr = graph.pred_ptr
    return (run[..., ptr[1:]] - run[..., ptr[:-1]]).to(torch.int32)


# --- build ------------------------------------------------------------------


def build() -> str:
    """Compile ``csrc/gating.cu`` (once per source version) and load it.

    Returns the compiler's report (registers, shared memory, spills) when
    this call compiled, else an empty string."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("gating")
    p = ctypes.c_void_p
    lib.dep_decrement_csr.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                                      p, p]
    lib.dep_decrement_csr.restype = ctypes.c_int
    _lib = lib
    return log


# --- dispatch ---------------------------------------------------------------


def dep_decrement_csr(fin: torch.Tensor, graph: DepGraph) -> torch.Tensor:
    """``dec[..., c]`` = finished predecessors of row ``c``, int32, the
    shape of ``fin`` ((n,) or (B, n))."""
    if fin.device.type == "cpu" and graph.pred_ptr.device.type == "cpu":
        return dep_decrement_csr_plain(fin, graph)
    dev = fin.device
    if dev.type != "cuda" or graph.pred_ptr.device != dev \
            or graph.pred_idx.device != dev:
        raise ValueError(f"fin ({fin.device}) and the graph "
                         f"({graph.pred_ptr.device}, {graph.pred_idx.device}) "
                         "must lie on the same CUDA device")
    if fin.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"fin must be bool or uint8, got {fin.dtype}")
    if graph.pred_ptr.dtype != torch.int32 or graph.pred_idx.dtype != torch.int32:
        raise TypeError(f"the graph's indices must be int32, got "
                        f"{graph.pred_ptr.dtype} / {graph.pred_idx.dtype}")
    n = graph.n
    if fin.dim() not in (1, 2) or fin.shape[-1] != n:
        raise ValueError(f"fin {tuple(fin.shape)} must be (n,) or (B, n) "
                         f"with n = {n}")
    if not (fin.is_contiguous() and graph.pred_ptr.is_contiguous()
            and graph.pred_idx.is_contiguous()):
        raise ValueError("fin and the graph must be contiguous")
    build()
    rows = fin.numel() // n if n else 0
    dec = torch.empty(fin.shape, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.dep_decrement_csr(fin.data_ptr(), graph.pred_ptr.data_ptr(),
                                 graph.pred_idx.data_ptr(), rows, n,
                                 dec.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dep_decrement_csr failed with cudaError_t {err}")
    launches["dep_decrement"] += 1
    return dec


def dep_decrement(fin: torch.Tensor, parents: torch.Tensor,
                  children: torch.Tensor, n: int) -> torch.Tensor:
    """``dec[..., c] = #{edges (p, c) : fin[..., p]}`` from an edge list,
    the reference's signature.  Padded edges may self-loop on a row whose
    ``fin`` is always False, as the reference pads them."""
    if all(x.device.type == "cpu" for x in (fin, parents, children)):
        return dep_decrement_plain(fin, parents, children, n)
    for x in (parents, children):
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"edge indices must be int32 or int64, got {x.dtype}")
    if fin.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"fin must be bool or uint8, got {fin.dtype}")
    graph = dep_graph(parents.cpu().numpy(), children.cpu().numpy(), n,
                      device=fin.device)
    return dep_decrement_csr(fin, graph)
