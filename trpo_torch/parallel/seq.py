"""Sequence (time-axis) parallelism for long trajectories (counterpart:
``trpo_tpu/parallel/seq.py``).

A ``(T, N)`` trajectory is split over the ranks of a ``"seq"`` axis in
time order: rank i holds steps ``[i·T/D, (i+1)·T/D)``. The returns and
GAE recurrences ``y_t = x_t + c_t·y_{t+1}`` then run block-parallel, each
rank on the K2 kernel (``ops/reverse_scan.py``; its plain loop on a CPU
tensor):

1. one K2 launch over the block with a zero carry from the right, run on
   two problems side by side: the block itself (``y_local``) and
   ``x = [0, …, 0, c_last]``, whose first row is the block's coefficient
   product ``Πc``;
2. one ``all_gather`` of the ``(2, N)`` summaries ``(Πc, y_local[0])``
   over the ``seq`` group;
3. the carry entering the block from the right folded from the summaries
   of the blocks after it, folded into the block's last row
   (``x'_last = x_last + c_last·carry``), and K2 again over the block.

A 2-D ``("data", "seq")`` mesh splits N over ``data`` and T over ``seq``;
the gather stays inside each ``seq`` group. Results equal one scan over
the whole trajectory to float tolerance.
"""

from __future__ import annotations

from typing import Optional

import torch

from trpo_torch.ops.allreduce import all_gather_cat
from trpo_torch.ops.reverse_scan import reverse_affine_scan

__all__ = [
    "make_seq_gae",
    "seq_sharded_gae",
    "seq_sharded_returns",
    "sharded_reverse_affine_scan",
]


def sharded_reverse_affine_scan(coeffs: torch.Tensor, x: torch.Tensor,
                                group) -> torch.Tensor:
    """``y_t = x_t + c_t·y_{t+1}`` over a time axis split across the ranks
    of ``group``: ``coeffs`` and ``x`` are this rank's ``(T/D, N)`` f32
    block. Two K2 launches and one all-gather."""
    coeffs = coeffs.float().contiguous()
    x = x.float().contiguous()
    n = x.shape[1]
    tail = torch.zeros_like(x)
    tail[-1] = coeffs[-1]
    both = reverse_affine_scan(torch.cat([coeffs, coeffs], dim=1),
                               torch.cat([x, tail], dim=1))
    summary = torch.stack([both[0, n:], both[0, :n]])     # (Πc, y_local[0])
    summaries = all_gather_cat(summary[None], group)       # (D, 2, N)
    idx = torch.distributed.get_rank(group)
    carry = torch.zeros_like(x[0])
    for j in range(summaries.shape[0] - 1, idx, -1):
        carry = summaries[j, 1] + summaries[j, 0] * carry
    folded = x.clone()
    folded[-1] = x[-1] + coeffs[-1] * carry
    return reverse_affine_scan(coeffs, folded)


def _block(mesh, t: torch.Tensor, seq_axis: str, batch_axis: Optional[str]):
    """This rank's ``(T/D_seq, N/D_batch)`` block of a global tensor."""
    n_seq, i = mesh.shape[seq_axis], mesh.coordinate(seq_axis)
    if t.shape[0] % n_seq:
        raise ValueError(
            f"T={t.shape[0]} must divide evenly over the {seq_axis}={n_seq} "
            "mesh axis")
    k = t.shape[0] // n_seq
    t = t[i * k:(i + 1) * k]
    if batch_axis is not None:
        n_b, j = mesh.shape[batch_axis], mesh.coordinate(batch_axis)
        m = t.shape[1] // n_b
        t = t[:, j * m:(j + 1) * m]
    return t.contiguous()


def _gather(mesh, t: torch.Tensor, seq_axis: str, batch_axis: Optional[str]):
    t = all_gather_cat(t, mesh.group(seq_axis), 0)
    if batch_axis is not None:
        t = all_gather_cat(t, mesh.group(batch_axis), 1)
    return t


def seq_sharded_returns(mesh, rewards, dones, gamma: float,
                        seq_axis: str = "seq",
                        batch_axis: Optional[str] = None) -> torch.Tensor:
    """Segmented discounted returns of the global ``(T, N)`` tensors with
    the time axis split over ``seq_axis`` (and N over ``batch_axis``):
    the semantics of ``ops.returns.discounted_returns_segmented``. Every
    rank passes the global tensors and gets the global result back."""
    rew = _block(mesh, torch.as_tensor(rewards).float(), seq_axis,
                 batch_axis)
    dn = _block(mesh, torch.as_tensor(dones).float(), seq_axis, batch_axis)
    y = sharded_reverse_affine_scan(gamma * (1.0 - dn), rew,
                                    mesh.group(seq_axis))
    return _gather(mesh, y, seq_axis, batch_axis)


def make_seq_gae(mesh, gamma: float, lam: float, seq_axis: str = "seq",
                 batch_axis: Optional[str] = None):
    """``gae(rewards, values, next_values, terminated, done) ->
    (advantages, value_targets)`` over this rank's LOCAL ``(T/D, N)``
    blocks, time split over ``seq_axis``: what the agent calls inside its
    iteration on a ``("data", "seq")`` mesh. ``next_values`` carries the
    true successor values, so the TD deltas need no halo at block
    boundaries."""
    group = mesh.group(seq_axis)

    def gae(rew, v, nv, term, dn):
        delta = rew + gamma * (1.0 - term.to(rew.dtype)) * nv - v
        coeffs = gamma * lam * (1.0 - dn.to(rew.dtype))
        adv = sharded_reverse_affine_scan(coeffs, delta, group)
        return adv, adv + v

    return gae


def seq_sharded_gae(mesh, rewards, values, next_values, terminated, dones,
                    gamma: float, lam: float, seq_axis: str = "seq",
                    batch_axis: Optional[str] = None):
    """GAE(λ) advantages and value targets of the global ``(T, N)``
    tensors, time split over ``seq_axis``: the semantics of
    ``ops.returns.gae_from_next_values``. Every rank passes the global
    tensors and gets the global ``(advantages, value_targets)`` back."""
    blocks = [_block(mesh, torch.as_tensor(a).float(), seq_axis, batch_axis)
              for a in (rewards, values, next_values, terminated, dones)]
    adv, vtarg = make_seq_gae(mesh, gamma, lam, seq_axis, batch_axis)(*blocks)
    return (_gather(mesh, adv, seq_axis, batch_axis),
            _gather(mesh, vtarg, seq_axis, batch_axis))
