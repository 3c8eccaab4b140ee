"""Chunked linear-recurrence engine shared by RWKV6 (Finch) and Mamba2 (SSD),
the counterpart of ``repro/models/ssm.py``.

Both models are linear-attention recurrences over a per-head state
``S in R^{dk x dv}``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (RWKV6: w_t per-channel;
                                                  Mamba2/SSD: w_t scalar)
    y_t = q_t S_*  (+ current-token term)

The chunked parallel form processes the sequence in chunks of ``chunk``
tokens: within a chunk everything is dense products (mask + cumulative
log-decay), and one state per chunk is carried.  The reference scans the
chunks with ``lax.scan``; here a Python loop walks them.  Decay products
are kept in log space and everything inside runs in fp32, as in the
reference: ``k * exp(-cum)`` grows with a chunk's cumulative decay, and
the expression is the reference's, unguarded, so a chunk whose decay sum
passes fp32's exp limit (88.7) gives what the reference gives.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def chunked_linear_attention(
    q: torch.Tensor,            # (B, S, H, dk)
    k: torch.Tensor,            # (B, S, H, dk)
    v: torch.Tensor,            # (B, S, H, dv)
    log_w: torch.Tensor,        # (B, S, H, dk) per-channel or (B, S, H, 1) scalar log-decay, <= 0
    u: torch.Tensor | None = None,   # (H, dk) RWKV6 current-token bonus; None -> SSD style
    chunk: int = 128,
    initial_state: torch.Tensor | None = None,   # (B, H, dk, dv)
    return_state: bool = False,
):
    """Returns y (B, S, H, dv) in v's dtype [and the fp32 final state].

    Current-token term: with ``u`` (RWKV6), y_t += (q_t * u * k_t) v_t and
    the state update applies decay *before* adding k_t v_t; without ``u``
    (Mamba2/SSD), the j = t term enters through the decay chain with weight
    exp(0) = 1.  S is padded with zeros to a whole number of chunks.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    nchunk = math.ceil(s / chunk)
    pad = nchunk * chunk - s
    if pad:
        q, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v, log_w))

    def to_chunks(x):
        return x.reshape(b, nchunk, chunk, h, x.shape[-1])

    qc, kc, vc, wc = map(to_chunks, (q, k, v, log_w))
    dev = q.device
    if u is None:
        mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    else:
        mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev),
                          diagonal=-1)
        u32 = u.float()[None, None]
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev))
    ys = []
    for c in range(nchunk):
        qb, kb, vb, wb = (t[:, c].float() for t in (qc, kc, vc, wc))
        # cumulative log decay within the chunk: cum[t] = sum_{j<=t} logw_j
        cum = torch.cumsum(wb, dim=1)                     # (B, c, H, dk)
        if u is None:
            # SSD: q_t attends j<=t with decay exp(cum_t - cum_j)
            q_eff = qb * torch.exp(cum)
        else:
            # RWKV6: j<t via the decay chain with cum_prev = sum_{j<t}
            q_eff = qb * torch.exp(cum - wb)
        k_eff = kb * torch.exp(-cum)
        att = torch.einsum("bthd,bjhd->bhtj", q_eff, k_eff)
        att = torch.where(mask, att, 0.0)
        y = torch.einsum("bhtj,bjhd->bthd", att, vb)
        y = y + torch.einsum("bthd,bhdv->bthv", q_eff, state)
        if u is not None:
            # j = t via the u bonus
            y = y + torch.einsum("bthd,bthv->bthv", qb * u32 * kb, vb)
        # state to end of chunk
        total = cum[:, -1]                                # (B, H, dk)
        carry_k = kb * torch.exp(total[:, None] - cum)    # decay from j to end
        state = state * torch.exp(total)[..., None] + torch.einsum(
            "bthd,bthv->bhdv", carry_k, vb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s].to(v.dtype)
    if return_state:
        return y, state
    return y


def recurrence_step(
    q: torch.Tensor,            # (B, H, dk)
    k: torch.Tensor,
    v: torch.Tensor,            # (B, H, dv)
    log_w: torch.Tensor,        # (B, H, dk) or (B, H, 1)
    state: torch.Tensor,        # (B, H, dk, dv) fp32
    u: torch.Tensor | None = None,
):
    """Single decode step (O(1) memory).  Returns (y in v's dtype, new fp32
    state)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())[..., None]                 # (B, H, dk, 1)
    kv = k32[..., None] * v32[..., None, :]                 # (B, H, dk, dv)
    if u is None:
        new_state = state * w + kv
        y = torch.einsum("bhd,bhdv->bhv", q32, new_state)
    else:
        y = torch.einsum("bhd,bhdv->bhv", q32,
                         state + u.float()[None, ..., None] * kv)
        new_state = state * w + kv
    return y.to(v.dtype), new_state


def reference_scan(q, k, v, log_w, u=None, initial_state=None):
    """Sequential oracle for tests: the plain per-step recurrence.  Returns
    (y (B, S, H, dv) in v's dtype, final fp32 state)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device))
    ys = []
    for t in range(s):
        y, state = recurrence_step(q[:, t], k[:, t], v[:, t], log_w[:, t], state, u=u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
