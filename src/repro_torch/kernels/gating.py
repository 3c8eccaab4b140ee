"""DAG dependency gating: the hand-written CUDA kernel and its plain
PyTorch versions.

Each slot the device slot loop (``core/scan_engine.py``) needs, for every
cell of its batch, ``dec[c] = #{edges (p, c) : fin[p]}``: how many of row
``c``'s predecessors finished in that slot.  The counterpart of
``src/repro/kernels/gating.py``:

- ``dep_decrement(fin, parents, children, n)`` — the reference's edge-list
  signature (``dep_decrement`` / ``dep_decrement_pallas`` there); on a CUDA
  tensor it builds the predecessor CSR and launches the kernel;
- ``dep_decrement_csr(fin, graph)`` — the counts over a
  :class:`DepGraph` built once per program;
- ``dep_release_csr(fin, arrived, pred_left, graph)`` — the entry point
  the engine calls each DAG slot step: the counts and what the step does
  with them, ``pred2 = pred_left - dec`` and ``pending = (dec > 0) &
  (pred2 == 0) & arrived``, in one launch;
- the plain versions ``dep_decrement_plain`` (``index_add_``, the
  reference's scatter form), ``dep_decrement_gather_plain`` (its padded
  gather form), ``dep_decrement_csr_plain`` and ``dep_release_csr_plain``.

``fin`` is (n,) or (B, n), bool or uint8 (nonzero counts as finished); the
counts come back as int32 of the same shape.  On CPU tensors the wrappers
run the plain version; on CUDA tensors they launch the one kernel of
``csrc/gating.cu`` (the decrement alone is that kernel given no in-degrees)
or raise.  Each launch adds one to its entry's count in ``launches``.
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
launches = {"dep_decrement": 0, "dep_release": 0}

_lib: ctypes.CDLL | None = None
_stream = None                  # device index -> the current stream's handle
_FLAGS = (torch.bool, torch.uint8)


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

    def __post_init__(self):
        # Checked once here, so the wrappers need only compare devices.
        ptr, idx = self.pred_ptr, self.pred_idx
        if ptr.dtype != torch.int32 or idx.dtype != torch.int32:
            raise TypeError(f"the graph's indices must be int32, got "
                            f"{ptr.dtype} / {idx.dtype}")
        if ptr.dim() != 1 or idx.dim() != 1 or ptr.shape[0] < 1 \
                or not (ptr.is_contiguous() and idx.is_contiguous()):
            raise ValueError("pred_ptr (n + 1,) and pred_idx (E,) must be "
                             "contiguous 1-D tensors")
        if ptr.device != idx.device:
            raise ValueError(f"pred_ptr ({ptr.device}) and pred_idx ({idx.device}) "
                             "must lie on one device")

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


def dep_release_csr_plain(fin: torch.Tensor, arrived: torch.Tensor,
                          pred_left: torch.Tensor, graph: DepGraph):
    """The release in plain ops: the counts, then ``pred2 = pred_left -
    dec`` and ``pending = (dec > 0) & (pred2 == 0) & arrived``."""
    dec = dep_decrement_csr_plain(fin, graph)
    pred2 = pred_left - dec
    return pred2, (dec > 0) & (pred2 == 0) & arrived


# --- build ------------------------------------------------------------------


def build() -> str:
    """Compile ``csrc/gating.cu`` (once per source version) and load it.

    Returns the compiler's report (registers, shared memory, spills) when
    this call compiled, else an empty string."""
    global _lib, _stream
    if _lib is not None:
        return ""
    lib, log = build_library("gating")
    p = ctypes.c_void_p
    lib.dep_release_csr.argtypes = [p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                              p, p, p]
    lib.dep_release_csr.restype = ctypes.c_int
    # The raw handle where torch exposes it (a call per step costs less
    # than building a Stream object).
    _stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda dev: torch.cuda.current_stream(dev).cuda_stream)
    _lib = lib
    return log


# --- dispatch ---------------------------------------------------------------


def _launch(fin: torch.Tensor, arrived, pred_left, graph: DepGraph, what: str):
    """One launch of the kernel on CUDA tensors: the release given
    ``arrived`` and ``pred_left``, else (both None) the decrement alone.
    The slot loop calls it every step, so the checks read device indices
    and attributes, not device objects."""
    ptr = graph.pred_ptr
    dev = fin.get_device()                        # -1 on the CPU
    n = ptr.shape[0] - 1
    shape = fin.shape
    release = pred_left is not None
    if dev < 0 or ptr.get_device() != dev or (release and (
            arrived.get_device() != dev or pred_left.get_device() != dev)):
        raise ValueError(f"{what}: fin, arrived, pred_left and the graph must lie on "
                         "the same CUDA device")
    if fin.dtype not in _FLAGS or (release and arrived.dtype not in _FLAGS):
        raise TypeError(f"{what}: fin and arrived must be bool or uint8")
    if release and pred_left.dtype != torch.int32:
        raise TypeError(f"{what}: pred_left must be int32, got {pred_left.dtype}")
    if fin.dim() not in (1, 2) or shape[-1] != n or (release and (
            arrived.shape != shape or pred_left.shape != shape)):
        raise ValueError(f"{what}: fin {tuple(shape)} (and arrived and pred_left beside "
                         f"it) must all be (n,) or (B, n) with n = {n}")
    if not fin.is_contiguous() or (release and not (
            arrived.is_contiguous() and pred_left.is_contiguous())):
        raise ValueError(f"{what}: fin, arrived and pred_left must be contiguous")
    build()
    if release:
        out = torch.empty_like(pred_left)
        pending = torch.empty_like(arrived, dtype=torch.bool)
        extra = (arrived.data_ptr(), pred_left.data_ptr(), pending.data_ptr())
    else:
        out = torch.empty(shape, dtype=torch.int32, device=fin.device)
        pending, extra = None, (None, None, None)
    err = _lib.dep_release_csr(fin.data_ptr(), extra[0], extra[1], ptr.data_ptr(),
                               graph.pred_idx.data_ptr(), fin.numel() // n if n else 0,
                               n, out.data_ptr(), extra[2], _stream(dev))
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")
    return out, pending


def dep_decrement_csr(fin: torch.Tensor, graph: DepGraph) -> torch.Tensor:
    """``dec[..., c]`` = finished predecessors of row ``c``, int32, the
    shape of ``fin`` ((n,) or (B, n)): on CUDA tensors one launch of the
    release kernel with no in-degrees given."""
    if fin.get_device() < 0 and graph.pred_ptr.get_device() < 0:
        return dep_decrement_csr_plain(fin, graph)
    dec, _ = _launch(fin, None, None, graph, "dep_decrement_csr")
    launches["dep_decrement"] += 1
    return dec


def dep_release_csr(fin: torch.Tensor, arrived: torch.Tensor,
                    pred_left: torch.Tensor, graph: DepGraph):
    """One DAG slot step's release: ``(pred2, pending)``, ``pred2 =
    pred_left - dec`` (int32) and ``pending = (dec > 0) & (pred2 == 0) &
    arrived`` (bool), ``dec`` the finished predecessors of each row, for
    ``fin`` and ``arrived`` (bool or uint8) and ``pred_left`` (int32), all
    (n,) or (B, n).  On CUDA tensors one launch; ``dec`` is not kept."""
    if fin.get_device() < 0 and graph.pred_ptr.get_device() < 0:
        return dep_release_csr_plain(fin, arrived, pred_left, graph)
    out = _launch(fin, arrived, pred_left, graph, "dep_release_csr")
    launches["dep_release"] += 1
    return out


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
