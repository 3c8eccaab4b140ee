"""The oracle's masked score matrix (Algorithm 1, lines 2–5): the
hand-written CUDA kernel and its plain PyTorch version, the counterpart of
``src/repro/kernels/score.py`` ``score_matrix``.

``score_matrix(marginals, ci, t_start, t_end)`` takes (J,) marginal
throughputs ``p_j(k)`` of (job, scale) entries, a (T,) carbon intensity and
(J,) window bounds, and returns the (J, T) matrix
``marginals[j] / max(ci[t], 1e-9)`` inside ``t_start[j] <= t < t_end[j]``
and 0 outside.  On CPU tensors it runs ``score_matrix_plain`` in the
tensors' dtype; on CUDA tensors it launches the kernel of
``csrc/score.cu`` (float32 values, int32 bounds) or raises.  Each launch
adds one to ``launches["score_matrix"]``.  One IEEE division per element in
both, so the kernel equals the plain version exactly.

As in the JAX package, the oracle does not call it: ``oracle.solve``
scores its ragged entry list in float64 on the host, since a float32 score
would reorder the float64 lexsort of the entries.  The kernel is reached
through the port's kernel API, ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import build_library

#: Kernel launches since the last ``reset_launches()``.
launches = {"score_matrix": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    launches["score_matrix"] = 0


def score_matrix_plain(marginals: torch.Tensor, ci: torch.Tensor,
                       t_start: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``score_matrix_ref``: window mask, quotient, where."""
    t = torch.arange(ci.shape[0], device=ci.device)
    mask = (t[None, :] >= t_start[:, None]) & (t[None, :] < t_end[:, None])
    return torch.where(mask, marginals[:, None] / torch.clamp_min(ci, 1e-9)[None, :],
                       0.0)


def build() -> str:
    """Compile ``csrc/score.cu`` (once per source version) and load it.
    Returns the compiler's report when this call compiled."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_matrix.argtypes = [p, p, p, p, i, i, p, p]
    lib.score_matrix.restype = i
    _lib = lib
    return log


def score_matrix(marginals: torch.Tensor, ci: torch.Tensor,
                 t_start: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """(J,), (T,), (J,), (J,) -> (J, T) masked scores."""
    args = (marginals, ci, t_start, t_end)
    if all(x.device.type == "cpu" for x in args):
        return score_matrix_plain(*args)
    dev = marginals.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("marginals, ci, t_start and t_end must lie on the same "
                         f"CUDA device, got {[str(x.device) for x in args]}")
    for name, x, dt in (("marginals", marginals, torch.float32),
                        ("ci", ci, torch.float32), ("t_start", t_start, torch.int32),
                        ("t_end", t_end, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    j, t = marginals.shape[0], ci.shape[0]
    if t_start.shape[0] != j or t_end.shape[0] != j:
        raise ValueError(f"t_start {tuple(t_start.shape)} and t_end "
                         f"{tuple(t_end.shape)} must match marginals ({j},)")
    if max(j, t) >= 2 ** 31:
        raise ValueError(f"J={j} or T={t} exceeds int32")
    out = torch.empty((j, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.score_matrix(*(x.data_ptr() for x in args), j, t, out.data_ptr(),
                            stream)
    if err != 0:
        raise RuntimeError(f"score_matrix failed with cudaError_t {err}")
    launches["score_matrix"] += 1
    return out
