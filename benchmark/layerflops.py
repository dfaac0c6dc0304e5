"""Operations of a chain of dense or convolutional layers, from the
multiply-adds each layer does for one row (``macs[0]`` is the layer that
reads the input). Counted as 2 operations a multiply-add, matrix products
only: biases, activations and reductions are left out.

* forward: ``2 Σ macs`` a row;
* gradient (forward, then weight and input gradients back to the first
  layer, which needs no input gradient): ``2 Σ macs + 2 Σ macs + 2 Σ
  macs[1:]``;
* Fisher-vector product ``Jᵀ M J v``: the tangent forward (``V_k h_k``
  at every layer and ``W_k δh_k`` past the first), then the backward
  sweep (weight gradients everywhere, input gradients past the first):
  ``2 (2 macs[0] + 4 Σ macs[1:])``.
"""

from __future__ import annotations

from typing import Sequence


def forward(macs: Sequence[int], rows: int) -> int:
    return 2 * rows * sum(macs)


def gradient(macs: Sequence[int], rows: int) -> int:
    return 2 * rows * (2 * sum(macs) + sum(macs[1:]))


def fvp(macs: Sequence[int], rows: int) -> int:
    return 2 * rows * (2 * macs[0] + 4 * sum(macs[1:]))
