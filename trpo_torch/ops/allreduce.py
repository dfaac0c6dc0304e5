"""Batch reductions over a process group: the seam of data parallelism.

The reference is one SPMD program: its batch is sharded over a mesh axis
and XLA inserts a ``psum`` wherever the program reduces over the batch.
The port runs one process per rank instead, and every reduction over the
batch goes through this module with the batch axis's process group
(``parallel.mesh.Mesh.group``). With ``group=None`` each function is the
plain single-process expression, op for op, so a run without a mesh is
bitwise what it was before the seam existed.

Every weighted mean is a weighted SUM and a weight sum reduced together
(the reference's ``psum(num)/psum(w)`` contract), so zero-weight padding
rows change nothing and uneven shards carry no bias.

A gloo group holding CUDA tensors (two ranks on one card, where NCCL
refuses a second rank on the device) stages each collective through host
memory; NCCL and CPU tensors reduce in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_max", "all_sum", "weight_total", "wmean",
           "wshare"]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if _staged(t, group):
        h = t.detach().cpu().contiguous()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (``t`` itself when
    ``group`` is None). The result is detached: gradients are taken of the
    local terms and summed afterwards."""
    if group is None:
        return t
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of ``group``."""
    if group is None:
        return t
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) joined along ``dim`` in rank
    order."""
    if group is None:
        return t
    src = t.detach().contiguous()
    if src.dtype == torch.bool:   # not every backend gathers bool
        src = src.to(torch.uint8)
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def weight_total(w: torch.Tensor, group=None) -> torch.Tensor:
    """``max(Σ w, 1)`` over every rank's rows: the normaliser of a
    weighted mean."""
    return torch.clamp(all_sum(torch.sum(w), group), min=1.0)


def wshare(x: torch.Tensor, w: torch.Tensor,
           total: torch.Tensor) -> torch.Tensor:
    """``Σ_local x·w / total``: this rank's share of the weighted mean whose
    normaliser is ``total = weight_total(w, group)``, differentiable in
    ``x``. A gradient or a Hessian-vector product is taken of the share and
    summed over the ranks afterwards; with no group the share is the mean
    itself, op for op."""
    return torch.sum(x * w) / total


def wmean(x: torch.Tensor, w: torch.Tensor,
          group: Optional[object] = None) -> torch.Tensor:
    """``Σ x·w / max(Σ w, 1)`` over every rank's rows; one collective of
    the pair ``[Σ x·w, Σ w]``."""
    if group is None:
        return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)
    pair = all_sum(torch.stack([torch.sum(x * w),
                                torch.sum(w).to(x.dtype)]).float(), group)
    return pair[0] / torch.clamp(pair[1], min=1.0)
