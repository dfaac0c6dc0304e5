"""Flat-parameter utilities (counterpart: ``trpo_tpu/ops/flat.py``).

The reference flattens its parameter pytree with ``ravel_pytree``. This
module reproduces that order exactly — dict keys sorted, lists in order,
each leaf raveled row-major — so a policy ``{"net": {"layers": [{"w",
"b"}, ...]}, "log_std"}`` flattens to ``log_std, layers[0].b,
layers[0].w, layers[1].b, ...`` in both packages, and flat CG iterates
compare one-for-one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch
import torch.func

__all__ = ["flat_grad", "flatten_params", "numel", "tree_leaves",
           "tree_map", "var_shapes"]


def _rebuild(seq, items):
    """A list, tuple or NamedTuple like ``seq`` holding ``items``."""
    items = list(items)
    return type(seq)(*items) if hasattr(seq, "_fields") else type(seq)(items)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``ravel_pytree`` order: sorted dict keys, sequences (and
    NamedTuple fields) in order. ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (tree_map(fn, t, *(r[i] for r in rest))
                               for i, t in enumerate(tree)))
    return fn(tree, *rest)


def _unravel_fn(tree: Any) -> Callable[[torch.Tensor], Any]:
    """``flat -> tree`` with leaves as VIEWS of ``flat`` (so autograd and
    ``torch.func`` transforms see through the unflatten)."""
    shapes = []

    def number(t):
        # the tree with each leaf replaced by its index in ravel order
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: number(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, (number(x) for x in t))
        shapes.append(tuple(t.shape))
        return len(shapes) - 1

    index_tree = number(tree)
    offsets = [0]
    for s in shapes:
        offsets.append(offsets[-1] + math.prod(s))

    def unravel(flat: torch.Tensor) -> Any:
        return tree_map(
            lambda i: flat[offsets[i]:offsets[i + 1]].view(shapes[i]),
            index_tree,
        )

    unravel.offsets = offsets
    unravel.shapes = shapes
    return unravel


def flatten_params(params: Any) -> Tuple[torch.Tensor, Callable]:
    """Return ``(flat, unravel)`` like ``jax.flatten_util.ravel_pytree``:
    ``flat`` concatenates every leaf in sorted-key order; ``unravel(flat)``
    rebuilds the tree as views of ``flat``."""
    leaves = tree_leaves(params)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return flat, _unravel_fn(params)



def flat_grad(fn: Callable[[Any], torch.Tensor], params: Any) -> torch.Tensor:
    """The flat gradient of a scalar function of a params tree, in ravel
    order (the reference's ``flatgrad``)."""
    return flatten_params(torch.func.grad(fn)(params))[0]


def var_shapes(params: Any) -> List[Tuple[int, ...]]:
    """The shape of every leaf, in ravel order."""
    return [tuple(leaf.shape) for leaf in tree_leaves(params)]


def numel(params: Any) -> int:
    """The element count of the whole tree."""
    return sum(leaf.numel() for leaf in tree_leaves(params))
