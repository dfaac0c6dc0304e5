"""Tensor and expert parallelism: parameter shardings for a ``"model"`` or
``"expert"`` mesh axis (counterpart: ``trpo_tpu/parallel/tp.py``).

The layout is the reference's Megatron split:

- even MLP layers (any ``{"layers": [...]}`` stack) are column-parallel:
  ``w`` split on its output dimension, ``b`` split with it;
- odd MLP layers are row-parallel: ``w`` split on its input dimension,
  ``b`` replicated (added after the reduction);
- the ``gru``/``lstm`` gate projections ``wx``/``wh`` are row-parallel on
  their input dimension, so the hidden state stays replicated;
- mixture-of-experts leaves (under ``"experts"``) split on their leading
  expert axis: each rank holds K/D whole experts;
- everything else is replicated, and so is any leaf whose dimension does
  not divide the axis.

The reference writes none of the collectives: GSPMD inserts them from the
arrays' shardings. The port runs one process per rank, so the sharded
forward spells them (``models/mlp.py``, ``models/moe.py``,
``models/recurrent.py``) with Megatron's four conjugate operators below,
each a ``torch.autograd.Function`` with a backward and a forward-mode
``jvp``, so ``torch.autograd``, ``torch.func.grad``/``vjp``/``jvp`` and
``jvp`` over ``grad`` all see through them:

- :func:`copy_to_model`: identity forward, all-reduce backward (the input
  of a column-parallel layer);
- :func:`reduce_from_model`: all-reduce forward, identity backward (the
  partial sums of a row-parallel layer, the expert blend);
- :func:`scatter_to_model`: this rank's block of the last dimension
  forward, all-gather backward (a row-parallel layer after a replicated
  one);
- :func:`gather_from_model`: all-gather of the blocks forward, this
  rank's block backward (a replicated layer after a column-parallel one,
  or a sharded output).

A policy built with a :class:`ModelAxis` (``make_policy(..., tp=...)`` and
the recurrent and MoE families) runs this forward on this rank's blocks
(:func:`shard_policy_params`); :func:`gather_policy_params` is the
inverse, for checkpoints, stats and tests. The solve over the blocks is
``trpo.make_tree_trpo_update``, whose dot product all-reduces the sharded
part over the axis and counts the replicated part once
(:func:`make_flat_space`).

A gloo group holding CUDA tensors (two ranks sharing one card) stages
each collective through host memory, as ``ops/allreduce.py`` does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from trpo_torch.ops.allreduce import _all_reduce, all_gather_cat, all_sum
from trpo_torch.ops.flat import tree_leaves, tree_map

__all__ = [
    "FlatSpace",
    "ModelAxis",
    "copy_to_model",
    "gather_from_model",
    "gather_policy_params",
    "local_entries",
    "make_flat_space",
    "model_axis",
    "policy_param_shardings",
    "reduce_from_model",
    "scatter_to_model",
    "shard_policy_params",
    "shards_anything",
]


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


def _layer_spec(layer_idx: int, name: str, shape, axis_size: int):
    col = layer_idx % 2 == 0
    if name == "w" and len(shape) == 2:
        if col and shape[1] % axis_size == 0:
            return 1
        if not col and shape[0] % axis_size == 0:
            return 0
    elif name == "b" and len(shape) == 1:
        # bias of a column-parallel layer lives on the sharded activation
        if col and shape[0] % axis_size == 0:
            return 0
    return None


def _leaf_spec(path, shape, axis_size: int):
    for j, k in enumerate(path):
        if k == "experts":
            if len(shape) >= 2 and shape[0] % axis_size == 0:
                return 0
            return None
        if (k == "layers" and j + 2 < len(path)
                and isinstance(path[j + 1], int)
                and isinstance(path[j + 2], str)):
            return _layer_spec(path[j + 1], path[j + 2], shape, axis_size)
        if (k in ("gru", "lstm") and j + 1 < len(path)
                and isinstance(path[j + 1], str)):
            if (path[j + 1] in ("wx", "wh") and len(shape) == 2
                    and shape[0] % axis_size == 0):
                return 0
            return None
    return None


def _map_with_path(fn: Callable, tree: Any, path=()) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def policy_param_shardings(params: Any, mesh, model_axis: str = "model"):
    """A tree with ``params``'s structure holding, for every leaf, the
    dimension split over ``model_axis`` (an int), or None where the leaf
    is replicated. ``mesh`` is a ``parallel.Mesh`` (or anything whose
    ``shape`` maps the axis to its size)."""
    size = mesh.shape[model_axis]
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), size), params)


def shards_anything(specs: Any) -> bool:
    """True when some leaf of ``specs`` is split."""
    return any(s is not None for s in tree_leaves(specs))


def _block(x: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    k = x.shape[dim] // size
    return x.narrow(dim, rank * k, k).clone(
        memory_format=torch.contiguous_format)


def shard_policy_params(params: Any, mesh, model_axis: str = "model",
                        specs: Any = None) -> Any:
    """This rank's blocks of full ``params`` under
    :func:`policy_param_shardings` (or ``specs``); replicated leaves are
    kept whole."""
    if specs is None:
        specs = policy_param_shardings(params, mesh, model_axis)
    size, rank = mesh.shape[model_axis], mesh.coordinate(model_axis)
    return tree_map(
        lambda x, d: x if d is None else _block(x, d, size, rank),
        params, specs)


def gather_policy_params(params: Any, mesh, specs: Any,
                         model_axis: str = "model") -> Any:
    """The inverse of :func:`shard_policy_params`: every split leaf's
    blocks joined in rank order (one all-gather per split leaf, a
    collective over the axis)."""
    group = mesh.group(model_axis)
    return tree_map(
        lambda x, d: x if d is None else all_gather_cat(x, group, d),
        params, specs)


class ModelAxis(NamedTuple):
    """What a sharded forward needs: the parameter axis's process group,
    its size, this rank's coordinate on it, and the split dimensions
    (:func:`policy_param_shardings`) of the params the forward reads."""
    group: Any
    size: int
    rank: int
    specs: Any

    def sub(self, key) -> "ModelAxis":
        """The axis over one subtree of the params."""
        return self._replace(specs=self.specs[key])


def model_axis(mesh, axis: str, specs: Any) -> ModelAxis:
    """The :class:`ModelAxis` of this rank on ``mesh``'s ``axis``."""
    return ModelAxis(mesh.group(axis), mesh.shape[axis],
                     mesh.coordinate(axis), specs)


# ---------------------------------------------------------------------------
# the four conjugate operators
# ---------------------------------------------------------------------------


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    return all_gather_cat(x, group, dim=x.ndim - 1)


def _block_last(x: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    k = x.shape[-1] // size
    return x.narrow(x.ndim - 1, rank * k, k).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, tp):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.tp), None

    @staticmethod
    def jvp(ctx, t, _):
        return t.view_as(t)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(x, tp):
        return _all_reduce(x, tp.group, dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.tp), None

    @staticmethod
    def jvp(ctx, t, _):
        return _all_reduce(t, ctx.tp.group, dist.ReduceOp.SUM)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(x, tp):
        return _block_last(x, tp.size, tp.rank)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.tp), None

    @staticmethod
    def jvp(ctx, t, _):
        return _block_last(t, ctx.tp.size, ctx.tp.rank)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, tp):
        return _gather_last(x, tp.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.tp), None

    @staticmethod
    def jvp(ctx, t, _):
        return _gather_last(t, ctx.tp.group)


def copy_to_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """Identity forward; the gradient summed over the axis."""
    return _Copy.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """``x`` summed over the axis; the gradient passed through."""
    return _Reduce.apply(x, tp)


def scatter_to_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """This rank's block of the last dimension; the gradient's blocks
    gathered."""
    return _Scatter.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """Every rank's block of the last dimension, joined in rank order; the
    gradient cut back to this rank's block."""
    return _Gather.apply(x, tp)


# ---------------------------------------------------------------------------
# the solve's inner product over this rank's blocks
# ---------------------------------------------------------------------------


class FlatSpace(NamedTuple):
    """The inner product of the solve's flat vectors, which hold this
    rank's blocks of every leaf in ravel order: ``dot`` all-reduces the
    split entries' part over the axis and adds the replicated entries'
    part once; ``index`` is each local entry's position in the one-rank
    flat vector of ``n_global`` entries (seeded probes and the skew test
    lever are drawn over that vector and cut to the local entries)."""
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    norm: Callable[[torch.Tensor], torch.Tensor]
    index: torch.Tensor
    n_global: int


def _paired(tree: Any, specs: Any) -> list:
    """``(leaf, split dim)`` pairs in ravel order (``ops/flat.py``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paired(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs) for p in _paired(t, s)]
    return [(tree, specs)]


def make_flat_space(params: Any, tp: ModelAxis) -> FlatSpace:
    """The :class:`FlatSpace` of the local blocks ``params`` (a tree with
    ``tp.specs``'s structure)."""
    pairs = _paired(params, tp.specs)
    split, index = [], []
    offset = 0
    for x, d in pairs:
        local = tuple(x.shape)
        full = list(local)
        if d is not None:
            full[d] *= tp.size
        pos = np.arange(int(np.prod(full)), dtype=np.int64).reshape(full)
        if d is not None:
            k = local[d]
            pos = np.take(pos, np.arange(tp.rank * k, (tp.rank + 1) * k),
                          axis=d)
        index.append(offset + pos.reshape(-1))
        split.append(np.full(int(np.prod(local)), d is not None))
        offset += int(np.prod(full))
    dev = pairs[0][0].device
    split = np.concatenate(split)
    sh = torch.as_tensor(np.nonzero(split)[0], device=dev)
    rep = torch.as_tensor(np.nonzero(~split)[0], device=dev)
    group = tp.group

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        part = all_sum(torch.dot(a[sh], b[sh]), group)
        return part + torch.dot(a[rep], b[rep])

    def norm(a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(dot(a, a))

    return FlatSpace(dot=dot, norm=norm,
                     index=torch.as_tensor(np.concatenate(index), device=dev),
                     n_global=offset)


def local_entries(space: Optional[FlatSpace], v: torch.Tensor) -> torch.Tensor:
    """``v`` (a one-rank flat vector) cut to this rank's entries; ``v``
    itself without a space."""
    return v if space is None else v[space.index.to(v.device)]
