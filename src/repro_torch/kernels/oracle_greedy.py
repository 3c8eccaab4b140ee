"""The oracle's greedy pass on the device: the hand-written CUDA kernels and
their plain version.

``greedy_pass(entries, kmin, lengths, capacity, horizon, k_max)`` walks the
entries of Algorithm 1 in their sorted order (``core/oracle.py`` builds and
sorts them on the host) and allocates greedily under the cluster capacity.
It is the counterpart of the JAX package's ``_greedy_jax``
(``src/repro/core/oracle.py:177``, a jitted ``lax.fori_loop``), with its
types: int32 entry indices, int32 ``alloc``/``used``, float32 ``gain``,
``lengths`` and ``work``.  ``entries`` is one (E, 4) int32 array, a row
``(j, t, k, gain)`` per entry with the float32 gain's bits in the last
column (``pack_entries``).  An entry is taken when

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
``greedy_pass_plain``; on CUDA tensors it launches a kernel of
``csrc/oracle_greedy.cu`` or raises.  ``plan`` picks the kernel by shape:
``"smem"`` keeps ``alloc`` in shared memory as uint8, laid out by job
window, where it fits beside the staged entries (scales up to 255),
``"l2"`` keeps it in device memory.
Each launch adds one to ``launches["greedy_pass"]`` and to its route's
count.  Every version does the same IEEE float32 adds in the same order, so
they agree bit for bit.

``windows``, an (n, 2) int32 tensor of each job's admissible window
``[t0, t1)`` (clamped to ``0 <= t0 <= t1 <= horizon``; ``None``: the whole
horizon for every job), says where a job's entries may lie.  The smem
route lays ``alloc`` out by window (``ragged_layout``): ``sum(t1 - t0)``
bytes instead of ``n * horizon``, which lets the oracle's 552-slot spans
fit a block.  An entry outside its job's window is bad on every route, as
one out of range; ``alloc`` comes back dense, 0 outside the windows.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ._build import build_library

ROUTES = ("smem", "l2")

#: Kernel launches since the last ``reset_launches()``: in all and by route.
launches = {"greedy_pass": 0, "smem": 0, "l2": 0}

# The kernels' constants (csrc/oracle_greedy.cu).
STAGE = 2048                   # entries per staged batch
SMEM_MAX = 232448 - 64         # a block's shared memory, less the statics
SCALE_MAX = 255                # the largest scale the smem route's uint8 alloc holds
_EPS = 1e-9

_lib: ctypes.CDLL | None = None
_staging: dict = {}             # per device: the pinned upload buffer, its last copy's event
_staging_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(route: str, n: int, horizon: int, cells: int | None = None) -> int:
    """Dynamic shared memory of ``route`` for n jobs x horizon slots:
    ``"smem"`` two stages of 16-byte records, (threshold, work) float2,
    kmin, a base and a packed window per job, used int32, and the uint8
    alloc laid out by window in ``cells`` bytes (at least one; ``None``:
    whole-horizon windows, ``n * horizon``); ``"l2"`` two stages of four
    int32 arrays, used, kmin, thresholds and work."""
    if route == "smem":
        cells = n * horizon if cells is None else cells
        return 2 * STAGE * 16 + 20 * n + 4 * horizon + _round16(max(cells, 1))
    if route == "l2":
        return 2 * STAGE * 16 + 4 * (horizon + 3 * n)
    raise ValueError(f"unknown greedy route {route!r}; use one of {ROUTES}")


def plan(n: int, horizon: int, k_max: int, cells: int | None = None) -> dict:
    """The route for n jobs x horizon slots with scales up to ``k_max``
    (``cells``: alloc laid out by window in that many bytes, see
    ``ragged_layout``; ``None``: whole-horizon windows): ``"smem"`` where
    its state fits a block and every scale fits a byte, else ``"l2"``;
    raises when neither fits.  Returns the route and its dynamic shared
    memory in bytes."""
    if n < 0 or horizon < 1:
        raise ValueError(f"{n} jobs x {horizon} slots")
    for route in ROUTES:
        nbytes = smem_bytes(route, n, horizon, cells)
        if nbytes <= SMEM_MAX and (route == "l2" or k_max <= SCALE_MAX):
            return dict(route=route, smem_bytes=nbytes)
    raise ValueError(f"{n} jobs x {horizon} slots exceed the kernel's shared memory "
                     f"({smem_bytes('l2', n, horizon)} > {SMEM_MAX} bytes)")


def ragged_layout(windows, horizon: int):
    """alloc laid out by job window, as the smem kernel lays it out: each
    window clamped to ``0 <= t0 <= t1 <= horizon``, job j's cells at
    ``base[j] + t`` for t in its window, ``base[j] = off[j] - t0[j]`` with
    ``off`` the exclusive prefix sum of the widths.  Returns (t0, t1, base)
    as int64 arrays and the cells in all."""
    w = np.asarray(windows, np.int64).reshape(-1, 2)
    t0 = np.clip(w[:, 0], 0, horizon)
    t1 = np.minimum(np.maximum(w[:, 1], t0), horizon)
    width = t1 - t0
    off = np.cumsum(width) - width
    return t0, t1, off - t0, int(width.sum())


def pack_entries(j_idx, t_idx, k_val, gain, out: np.ndarray | None = None) -> np.ndarray:
    """The (E, 4) int32 layout both versions take: j, t, k and the bits of
    the float32 gain."""
    e = np.empty((len(j_idx), 4), np.int32) if out is None else out
    e[:, 0] = j_idx
    e[:, 1] = t_idx
    e[:, 2] = k_val
    e[:, 3] = np.asarray(gain, np.float32).view(np.int32)
    return e


def upload(j_idx, t_idx, k_val, gain, kmin, lengths, device, windows=None):
    """The packed entries, kmin (int32) and lengths (float32) on ``device``,
    and the (n, 2) int32 windows when they are given.

    To a CUDA device in one copy: all of them are written into one pinned
    host buffer, reused from call to call, and copied at once; the results
    are views of that one device tensor."""
    device = torch.device(device)
    e, n = len(j_idx), len(kmin)
    nw = 0 if windows is None else 2 * n
    size = 4 * e + 2 * n + nw

    def fill(host):
        pack_entries(j_idx, t_idx, k_val, gain, out=host[:4 * e].reshape(e, 4))
        host[4 * e:4 * e + n] = kmin
        host[4 * e + n:4 * e + 2 * n] = np.asarray(lengths, np.float32).view(np.int32)
        if nw:
            host[4 * e + 2 * n:] = np.asarray(windows).reshape(-1)

    if device.type == "cpu":
        host = np.empty(size, np.int32)
        fill(host)
        flat = torch.from_numpy(host)
    else:
        with _staging_lock:
            buf, done = _staging.get(device, (None, None))
            if buf is None or buf.numel() < size:
                buf = torch.empty(max(size, 1 << 20), dtype=torch.int32, pin_memory=True)
            elif done is not None:
                done.synchronize()      # the last copy out of the buffer ended
            fill(buf[:size].numpy())
            flat = buf[:size].to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            _staging[device] = (buf, done)
    out = (flat[:4 * e].view(e, 4), flat[4 * e:4 * e + n],
           flat[4 * e + n:4 * e + 2 * n].view(torch.float32))
    return out if windows is None else out + (flat[4 * e + 2 * n:].view(n, 2),)


def greedy_pass_plain(entries: torch.Tensor, kmin: torch.Tensor,
                      lengths: torch.Tensor, capacity: int, horizon: int,
                      windows: torch.Tensor | None = None):
    """The pass as a loop over the packed entries, in float32 numpy scalars.
    ``windows`` changes no result, only what counts as a bad entry."""
    n = kmin.shape[0]
    lo = hi = None
    if windows is not None:
        t0, t1, _, _ = ragged_layout(windows.numpy(), horizon)
        lo, hi = t0.tolist(), t1.tolist()
    thr = list(lengths.numpy().astype(np.float32) - np.float32(_EPS))
    km_l = kmin.tolist()
    work = [np.float32(0.0)] * n
    used = [0] * horizon
    alloc = [[0] * horizon for _ in range(n)]
    one = np.float32(1.0)
    unfinished = sum(1 for x in thr if np.float32(0.0) < x)
    e = entries.numpy()
    jl, tl, kl = e[:, 0].tolist(), e[:, 1].tolist(), e[:, 2].tolist()
    gl = np.ascontiguousarray(e[:, 3]).view(np.float32)
    walked = len(jl) if unfinished else 0
    for i in range(walked):
        j, t, k = jl[i], tl[i], kl[i]
        if not (0 <= j < n and 0 <= t < horizon):
            raise IndexError(f"entry {i} = (j={j}, t={t}) outside "
                             f"{n} jobs x {horizon} slots")
        if lo is not None and not lo[j] <= t < hi[j]:
            raise IndexError(f"entry {i} = (j={j}, t={t}) outside job {j}'s "
                             f"window [{lo[j]}, {hi[j]})")
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
    lib.greedy_pass.argtypes = [i] + [p] * 4 + [i] * 4 + [ctypes.c_longlong] + [p] * 5
    lib.greedy_pass.restype = i
    lib.greedy_smem_bytes.argtypes = [i, i, i, ctypes.c_longlong]
    lib.greedy_smem_bytes.restype = i
    for name in ("greedy_stage", "greedy_smem_max"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    _lib = lib
    return log


# --- dispatch ---------------------------------------------------------------


def greedy_pass(entries: torch.Tensor, kmin: torch.Tensor, lengths: torch.Tensor,
                capacity: int, horizon: int, k_max: int, route: str | None = None,
                windows: torch.Tensor | None = None, cells: int | None = None):
    """The greedy pass over sorted, packed entries; see the module
    docstring.  ``k_max`` bounds the entries' scales (it picks the route);
    ``route`` names a kernel instead of ``plan``'s choice.  ``windows``
    (n, 2) int32: each job's window, alloc laid out by them on the smem
    route, given with ``cells``, their clamped widths' sum
    (``ragged_layout``), which sizes the launch."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown greedy route {route!r}; use one of {ROUTES}")
    if (windows is None) != (cells is None):
        raise ValueError("windows and their cells come together")
    args = (entries, kmin, lengths) + (() if windows is None else (windows,))
    if all(x.device.type == "cpu" for x in args):
        return greedy_pass_plain(entries, kmin, lengths, capacity, horizon, windows)
    dev = entries.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("the entries, kmin, lengths and windows must lie on the "
                         f"same CUDA device, got {[str(x.device) for x in args]}")
    for name, x, dt, dim in (("entries", entries, torch.int32, 2),
                             ("kmin", kmin, torch.int32, 1),
                             ("lengths", lengths, torch.float32, 1),
                             ("windows", windows, torch.int32, 2)):
        if x is None:
            continue
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != dim or not x.is_contiguous():
            raise ValueError(f"{name} must be {dim}-D and contiguous, got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    n_entries, n = entries.shape[0], kmin.shape[0]
    if entries.shape[1] != 4 or lengths.shape[0] != n:
        raise ValueError(f"entries must be (E, 4) and kmin and lengths share one "
                         f"length, got {tuple(entries.shape)}, {n}, {lengths.shape[0]}")
    if windows is not None and tuple(windows.shape) != (n, 2):
        raise ValueError(f"windows must be ({n}, 2), got {tuple(windows.shape)}")
    if entries.data_ptr() % 16:
        raise ValueError("entries must start on a 16-byte boundary")
    if not (0 < horizon and 0 <= capacity < 2 ** 31 and n_entries < 2 ** 31):
        raise ValueError(f"horizon {horizon}, capacity {capacity} or "
                         f"{n_entries} entries out of range")
    cells = n * horizon if cells is None else int(cells)
    route = route or plan(n, horizon, k_max, cells)["route"]
    build()
    if _lib.greedy_smem_bytes(ROUTES.index(route), n, int(horizon), cells) < 0:
        raise ValueError(f"{n} jobs x {horizon} slots exceed the {route} route's "
                         f"shared memory ({smem_bytes(route, n, horizon, cells)} > "
                         f"{SMEM_MAX})")
    alloc = torch.empty((n, horizon), dtype=torch.int32, device=dev)
    used = torch.empty(horizon, dtype=torch.int32, device=dev)
    work = torch.empty(n, dtype=torch.float32, device=dev)
    walked = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.greedy_pass(ROUTES.index(route), entries.data_ptr(), kmin.data_ptr(),
                           lengths.data_ptr(),
                           None if windows is None else windows.data_ptr(), n_entries,
                           n, int(horizon), int(capacity), cells,
                           alloc.data_ptr(), used.data_ptr(), work.data_ptr(),
                           walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"greedy_pass ({route}) failed with cudaError_t {err}")
    launches["greedy_pass"] += 1
    launches[route] += 1
    return alloc, used, work, walked
