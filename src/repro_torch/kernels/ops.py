"""The port's kernel API: one entry point per kernel, with the names and
argument order of the JAX package's ``repro.kernels.ops`` (without its
``interpret`` flag, which has no counterpart here).

Each routes to the port's wrapper, which launches the hand-written CUDA
kernel on CUDA tensors and runs the plain PyTorch version on CPU tensors.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import knn as _knn
from . import score as _score


def knn_topk(cases: torch.Tensor, query: torch.Tensor, k: int):
    return _knn.knn_topk(cases, query, k)


def knn_topk_batch(cases: torch.Tensor, queries: torch.Tensor, k: int):
    return _knn.knn_topk_batch(cases, queries, k)


def score_matrix(marginals: torch.Tensor, ci: torch.Tensor,
                 t_start: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    return _score.score_matrix(marginals, ci, t_start, t_end)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal_offset: int = 0) -> torch.Tensor:
    return _fa.gqa_flash(q, k, v, causal_offset=causal_offset)
