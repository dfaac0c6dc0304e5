"""Checkpoint / resume of the whole ``TrainState`` (counterpart:
``trpo_tpu/utils/checkpoint.py``), on torch-native storage.

A step is one directory, ``step_<n>/``: ``tensors.pt``, a flat
``{path: tensor}`` dict written by ``torch.save``, and ``state.json``, the
state's structure with its Python values (``iteration``,
``total_timesteps``, the critic's Adam count, the ladder's host mirrors).
The rollout generator is saved as its ``get_state()`` bytes, so a resumed
run draws the same rollout noise as an uninterrupted one. Loading uses
``torch.load(weights_only=True)``, which unpickles no object: the
structure comes from the JSON and from the template, never from the file.

The save-integrity gate is the reference's. A step is written under a
temporary name, moved into place with ``os.replace``, and only then gets
its ``step_<n>.complete`` marker. A step newer than the newest marker and
without one of its own is a torn save: never selected by
:meth:`Checkpointer.latest_step`, and deleted by
:meth:`Checkpointer.prune_incomplete`. A fresh directory is stamped
``.markers_enabled`` before any save, so a tear during its first save
cannot pass for a directory written before markers existed.

A host env's simulator state (``envs/*.env_state_snapshot``: numpy arrays
in nested dicts and lists, per-env uint64 RNG streams among them) is not in
``TrainState``; :meth:`Checkpointer.save` writes it beside the state as
``step_<n>/host_env.npz``, a pickle-free sidecar: the arrays as npz
entries, the nesting as JSON, read back with ``allow_pickle=False``. It is
written before the step's marker, so every marked step of a host-env run
has its sidecar, and it is pruned with its step. A step without a sidecar
(a device-env run) restores none; a sidecar that is there but unreadable
raises.

On a mesh (``Checkpointer(..., mesh=m)``, or ``TRPOAgent.learn`` handing
its mesh to the checkpointer) every rank calls :meth:`Checkpointer.save`:
the env carry is all-gathered over the batch axis and, on a parameter
axis, the policy's blocks over that axis (``param_layout=``, the agent's
``param_layout``, which a mesh with a ``"model"`` or ``"expert"`` axis
requires; ``learn`` hands it over with the mesh); rank 0 writes the global state in the same ``step_<n>/``
format, and every rank waits at a barrier until the marker is on disk.
:meth:`Checkpointer.restore` reads the global state on every rank and
keeps the rank's slice of the carry and its blocks of the params. A step
written by a mesh therefore restores on one rank, and a one-rank step on
a mesh of any width that divides its envs and layers, as the reference's
restore keeps the template's sharding. A host env's sidecar arrives
gathered (``TRPOAgent.snapshot_host_env``) and is cut to each data
rank's envs on restore.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Checkpointer"]

# TrainState fields whose presence follows the config (adaptive damping,
# the amortized head-block preconditioner, the solver ladder): a restore
# across a flip keeps the template's fresh value, or drops the saved one.
# host_rng follows host_inference. A field the saved state predates
# restores as absent (None), or, where the template has it, with the
# template's fresh value: a step written before the solver counters
# (metrics) existed restores them at zero.
FLIPPABLE = ("cg_damping", "precond", "ladder", "host_rng", "metrics")
SIDECAR = "host_env.npz"


def _join(path: str, key) -> str:
    return f"{path}.{key}" if path else str(key)


def _encode(node: Any, path: str, tensors: dict) -> Any:
    """The JSON structure of ``node``; its tensors go into ``tensors``
    under their dotted paths."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, torch.Generator):
        tensors[path] = node.get_state()
        return {"generator": path}
    if isinstance(node, torch.Tensor):
        tensors[path] = node.detach().cpu()
        return {"tensor": path}
    if hasattr(node, "_fields"):
        return {"namedtuple": type(node).__name__,
                "fields": {f: _encode(getattr(node, f), _join(path, f),
                                      tensors) for f in node._fields}}
    if isinstance(node, dict):
        return {"dict": {str(k): _encode(v, _join(path, k), tensors)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_encode(v, _join(path, i), tensors)
                                      for i, v in enumerate(node)]}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at {path!r}")


def _mismatch(path: str, what: str) -> ValueError:
    return ValueError(
        f"checkpoint does not match the template at {path or '<root>'}: "
        f"{what}"
    )


def _decode(tmpl: Any, saved: Any, path: str, tensors: dict) -> Any:
    """``saved`` rebuilt in the structure, types and devices of
    ``tmpl``; any other difference of structure, shape or dtype raises."""
    if tmpl is None or saved is None:
        if tmpl is not None or saved is not None:
            raise _mismatch(path, "present in one, None in the other")
        return None
    if isinstance(tmpl, torch.Generator):
        if not (isinstance(saved, dict) and "generator" in saved):
            raise _mismatch(path, "expected a generator")
        gen = torch.Generator(device=tmpl.device)
        gen.set_state(tensors[saved["generator"]].cpu())
        return gen
    if isinstance(tmpl, torch.Tensor):
        if not (isinstance(saved, dict) and "tensor" in saved):
            raise _mismatch(path, "expected a tensor")
        t = tensors[saved["tensor"]]
        if t.shape != tmpl.shape or t.dtype != tmpl.dtype:
            raise _mismatch(path, f"saved {tuple(t.shape)} {t.dtype}, "
                            f"template {tuple(tmpl.shape)} {tmpl.dtype}")
        return t.to(tmpl.device)
    if hasattr(tmpl, "_fields"):
        fields = saved.get("fields") if isinstance(saved, dict) else None
        if fields is None or list(fields) != list(tmpl._fields):
            raise _mismatch(path, f"expected {type(tmpl).__name__} fields "
                            f"{list(tmpl._fields)}")
        return type(tmpl)(*(_decode(getattr(tmpl, f), fields[f],
                                    _join(path, f), tensors)
                            for f in tmpl._fields))
    if isinstance(tmpl, dict):
        items = saved.get("dict") if isinstance(saved, dict) else None
        if items is None or set(items) != {str(k) for k in tmpl}:
            raise _mismatch(path, f"expected dict keys {sorted(tmpl)}")
        return {k: _decode(v, items[str(k)], _join(path, k), tensors)
                for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        items = (saved.get(type(tmpl).__name__)
                 if isinstance(saved, dict) else None)
        if items is None or len(items) != len(tmpl):
            raise _mismatch(path, f"expected a {type(tmpl).__name__} of "
                            f"{len(tmpl)}")
        return type(tmpl)(_decode(t, s, _join(path, i), tensors)
                          for i, (t, s) in enumerate(zip(tmpl, items)))
    if type(saved) is not type(tmpl):
        raise _mismatch(path, f"saved {saved!r}, template {tmpl!r}")
    return saved


def _first_device(tree: Any) -> torch.device:
    """The device of the first tensor in ``tree`` (CPU when none)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            dev = _first_device(node)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def _write_synced(path: str, write) -> None:
    """``write(f)`` into ``path``, flushed and synced to disk."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, bus=None,
                 mesh=None, param_layout=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.bus = bus   # obs.events.EventBus: health findings
        self.mesh = mesh  # parallel.Mesh: collective save/restore
        # (axis, split dims): the policy's blocks on a parameter axis
        self.param_layout = param_layout
        os.makedirs(self.directory, exist_ok=True)
        if not self.all_steps() and (mesh is None or mesh.is_writer):
            _write_synced(self._sentinel_path(), lambda f: None)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def _marker_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.complete")

    def _sentinel_path(self) -> str:
        return os.path.join(self.directory, ".markers_enabled")

    def _steps_named(self, pattern: str, want_dir: bool) -> set:
        out = set()
        for name in os.listdir(self.directory):
            m = re.fullmatch(pattern, name)
            if m and os.path.isdir(os.path.join(self.directory, name)) \
                    == want_dir:
                out.add(int(m.group(1)))
        return out

    def all_steps(self) -> list:
        """Every step directory, complete or not, in order."""
        return sorted(self._steps_named(r"step_(\d+)", True))

    def _marked_steps(self) -> set:
        return self._steps_named(r"step_(\d+)\.complete", False)

    def _complete_steps(self) -> list:
        """Steps safe to restore: with no marker at all, every step of a
        directory without the sentinel and none of one with it; else every
        step except unmarked ones newer than the newest marker."""
        steps = self.all_steps()
        marked = self._marked_steps()
        if not marked:
            if steps and os.path.exists(self._sentinel_path()):
                return []
            return steps
        newest = max(marked)
        return [s for s in steps if s in marked or s < newest]

    def _delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        if os.path.exists(self._marker_path(step)):
            os.remove(self._marker_path(step))

    def save(self, step: int, state: Any, host_env: Any = None) -> None:
        """Write ``state`` as ``step`` (replacing an existing one), with
        ``host_env`` (a host adapter's snapshot, or None) as its sidecar,
        its marker last, then keep the newest ``max_to_keep`` steps. On a
        mesh: a collective, rank 0 writing the gathered state."""
        if self.mesh is not None:
            from trpo_torch.parallel.sharded import gather_state

            state = gather_state(self.mesh, state, self._layout())
            if self.mesh.is_writer:
                self._save(step, state, host_env)
            self.mesh.barrier()
            return
        self._save(step, state, host_env)

    def _layout(self):
        """``param_layout``; a mesh with a parameter axis and no layout
        raises (its params are blocks this checkpointer cannot place)."""
        param_axes = [ax for ax in ("model", "expert")
                      if ax in self.mesh.axis_names]
        if param_axes and self.param_layout is None:
            raise ValueError(
                f'this mesh has a "{param_axes[0]}" axis, over which the '
                "policy's params are blocks: pass "
                "Checkpointer(..., param_layout=agent.param_layout)")
        return self.param_layout

    def _save(self, step: int, state: Any, host_env: Any) -> None:
        tensors: dict = {}
        structure = _encode(state, "", tensors)
        tmp = os.path.join(self.directory, f".step_{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_synced(os.path.join(tmp, "tensors.pt"),
                      lambda f: torch.save(tensors, f))
        _write_synced(os.path.join(tmp, "state.json"), lambda f: f.write(
            json.dumps({"step": step, "state": structure}).encode()))
        if host_env is not None:
            nesting, arrays = _flatten_snapshot(host_env)
            arrays["__structure__"] = np.asarray(nesting)
            _write_synced(os.path.join(tmp, SIDECAR),
                          lambda f: np.savez(f, **arrays))
        self._delete(step)
        os.replace(tmp, self._step_dir(step))
        _write_synced(self._marker_path(step), lambda f: None)
        for old in self.all_steps()[:-self.max_to_keep]:
            self._delete(old)
        for orphan in self._marked_steps() - set(self.all_steps()):
            os.remove(self._marker_path(orphan))

    def restore_host_env(self, step: Optional[int] = None) -> Any:
        """The host-env snapshot saved with ``step`` (default: the newest
        complete one); None when the step has no sidecar. An unreadable
        sidecar raises ``ValueError`` naming its path, after a
        ``host_env_sidecar_corrupt`` health event when a bus is
        attached."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self._step_dir(step), SIDECAR)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                return _unflatten_snapshot(str(z["__structure__"]), z)
        except Exception as e:
            message = (f"host-env sidecar {path} exists but is unreadable "
                       f"({type(e).__name__}: {e})")
            if self.bus is not None:
                self.bus.emit("health", check="host_env_sidecar_corrupt",
                              level="error", message=message,
                              data={"step": step,
                                    "error": type(e).__name__})
            raise ValueError(message) from e

    def latest_step(self) -> Optional[int]:
        """The newest complete step, or None."""
        steps = self._complete_steps()
        return max(steps) if steps else None

    def prune_incomplete(self) -> list:
        """Delete torn saves; returns their step numbers."""
        torn = sorted(set(self.all_steps()) - set(self._complete_steps()))
        for s in torn:
            self._delete(s)
            print(f"checkpoint: step {s} was interrupted mid-save (no "
                  "completion marker); pruned, restore uses the previous "
                  "complete step", file=sys.stderr)
        return torn

    def restore(self, template: Any, step: Optional[int] = None,
                prune: bool = True) -> Any:
        """The saved state in the structure of ``template`` (the agent's
        ``init_state()``), on its devices. Torn saves are pruned first
        unless ``prune=False`` (a reader of a directory a live trainer
        writes: to it, a save in flight looks torn). ``cg_damping``,
        ``precond`` and ``ladder`` may differ in presence between the save
        and the template: a field the template gains keeps the template's
        fresh value, one it lost is dropped (``host_rng`` likewise, with
        ``host_inference``). A step saved without the solver counters
        (``metrics``) restores them at zero. On a mesh every rank reads
        the global state and keeps its slice of the env carry."""
        if self.mesh is not None:
            from trpo_torch.parallel.sharded import gather_state, local_state

            if prune and self.mesh.is_writer:
                self.prune_incomplete()
            self.mesh.barrier()
            layout = self._layout()
            return local_state(self.mesh, self._restore(
                gather_state(self.mesh, template, layout), step), layout)
        if prune:
            self.prune_incomplete()
        return self._restore(template, step)

    def _restore(self, template: Any, step: Optional[int]) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "state.json")) as f:
            saved = json.load(f)["state"]
        tensors = torch.load(os.path.join(d, "tensors.pt"),
                             weights_only=True,
                             map_location=_first_device(template))
        fields = saved.get("fields", {}) if isinstance(saved, dict) else {}
        if hasattr(template, "_fields") and set(fields) < set(
                template._fields):
            fields = {f: fields.get(f) for f in template._fields}
            saved = {**saved, "fields": fields}
        if hasattr(template, "_fields") and all(
                f in fields and f in template._fields for f in FLIPPABLE):
            kept = {}
            for f in FLIPPABLE:
                if (getattr(template, f) is None) != (fields[f] is None):
                    kept[f] = getattr(template, f)
                    fields = {**fields, f: None}
            tmpl = template._replace(**{f: None for f in kept})
            restored = _decode(tmpl, {**saved, "fields": fields}, "",
                               tensors)
            return restored._replace(**kept)
        return _decode(template, saved, "", tensors)


def _flatten_snapshot(obj: Any) -> tuple:
    """``(JSON nesting, {key: array})`` of a host-env snapshot: nested
    dicts, lists, tuples, None, scalars and numeric arrays (Python ints of
    any size, like a bit generator's state words, stay exact in JSON). An
    object array or another type raises here, at save time."""
    arrays: dict = {}

    def flatten(x):
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, np.bool_):
            return bool(x)
        if isinstance(x, np.integer):
            return int(x)
        if isinstance(x, np.floating):
            return float(x)
        if isinstance(x, np.ndarray):
            if x.dtype == object:
                raise TypeError("host-env snapshot holds an object-dtype "
                                "array; snapshots must be numeric")
            key = f"a{len(arrays)}"
            arrays[key] = x
            return {"__npz__": key}
        if isinstance(x, dict):
            return {"__dict__": {str(k): flatten(v) for k, v in x.items()}}
        if isinstance(x, tuple):
            return {"__tuple__": [flatten(v) for v in x]}
        if isinstance(x, list):
            return {"__list__": [flatten(v) for v in x]}
        raise TypeError(f"host-env snapshot holds a {type(x).__name__}")

    return json.dumps(flatten(obj)), arrays


def _unflatten_snapshot(nesting: str, npz) -> Any:
    def unflatten(x):
        if isinstance(x, dict):
            if "__npz__" in x:
                return np.asarray(npz[x["__npz__"]])
            if "__dict__" in x:
                return {k: unflatten(v) for k, v in x["__dict__"].items()}
            if "__list__" in x:
                return [unflatten(v) for v in x["__list__"]]
            if "__tuple__" in x:
                return tuple(unflatten(v) for v in x["__tuple__"])
        return x

    return unflatten(json.loads(nesting))
