"""Policy-inference engine: eval-mode ``act`` at a fixed ladder of batch
shapes (counterpart: ``trpo_tpu/serve/engine.py``).

Training may pay a warm-up on the first call of each shape; serving must
not, so the engine builds its programs when a params snapshot is loaded,
one per rung of a small ladder of batch shapes (default 1/8/64), and
every request pads up to the nearest rung. On a CUDA device a rung's
program is **one CUDA graph**: the mode of the policy at the rung's
shape, captured once, replayed per request. On the CPU, which only the
tests ask for, the program runs eagerly at the padded shape.

A CUDA graph holds the addresses of the tensors it read at capture, and
the reference swaps params by reference on a hot reload. So a snapshot
here is the whole tuple ``(params, obs_norm, step, graphs)``: ``load``
copies the params and statistics onto the device (the engine owns them:
a caller that goes on updating its state in place cannot reach a served
snapshot), captures a fresh graph per rung on the loading thread, off
the request path, and swaps the tuple in as one reference. An in-flight
``infer`` holds its own tuple, so it finishes on the old params and the
next call sees the new ones, never a mix. ``rollback`` swaps the
previous tuple back. Captures run on a side stream after a warm-up
there, in ``thread_local`` capture mode, so a batcher thread may replay
the old graphs while the watcher captures the new ones; they go through
``CUDAGraph.capture_begin``/``capture_end`` rather than the
``torch.cuda.graph`` context, whose entry synchronizes the device and
empties the allocator's cache under the request path's feet.

A replay is not re-entrant (its input and output buffers are shared), so
each rung of a snapshot has a lock held from copy-in to copy-out. The
observations go in through a pinned staging buffer, the actions come
back through another, and one event wait ends the call. A failed capture
or replay raises: the engine never falls back to eager on a card.
``captures_total`` counts captures, so a test can pin that ``infer``
never adds one.

Determinism contract (the reference's eval-mode argmax): same
observation → same action, no generator consumed. Whether the action of
row i is independent of the rung it padded to is a property of the
device's matmul kernels (cuBLAS may pick another kernel per width), and
is measured rather than assumed (``tests/test_torch_serve.py``,
``chip_smoke.py`` ``[serve]``).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from trpo_torch.obs import recompile
from trpo_torch.ops.flat import tree_map
from trpo_torch.utils.normalize import normalize

__all__ = ["InferenceEngine", "SimulatedCostEngine"]

# warm-up runs of a rung's program on the capture stream before its
# capture: the first run allocates cuBLAS's workspace and picks kernels
_WARMUP = 2


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def check_batch_shapes(batch_shapes) -> Tuple[int, ...]:
    if not batch_shapes or any(
            not isinstance(b, int) or b < 1 for b in batch_shapes):
        raise ValueError(
            f"batch_shapes must be positive ints, got {batch_shapes!r}")
    return tuple(sorted(set(int(b) for b in batch_shapes)))


class _GraphRung:
    """One rung's program on one snapshot as a CUDA graph: static device
    inputs, the graph, its outputs, pinned host staging for both, and the
    lock a replay holds from copy-in to copy-out."""

    def __init__(self, fn: Callable, inputs: List[torch.Tensor],
                 stream: torch.cuda.Stream):
        self.inputs = inputs
        self.pinned_in = [torch.zeros(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in inputs]
        with torch.cuda.stream(stream), torch.no_grad():
            for _ in range(_WARMUP):
                fn(*inputs)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = fn(*inputs)
            finally:
                self.graph.capture_end()
        self.outputs = list(outputs)
        self.pinned_out = [torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                           for t in self.outputs]
        self.done = torch.cuda.Event()
        self.lock = threading.Lock()

    def run(self, values: Sequence, width: int,
            on_device: Sequence[bool]) -> list:
        """Replay on ``values`` (numpy arrays or device tensors of
        ``width`` rows; the rows past ``width`` are zeroed); the outputs'
        first ``width`` rows, as numpy arrays or, where ``on_device`` says
        so, as fresh device tensors."""
        with self.lock:
            for buf, pinned, x in zip(self.inputs, self.pinned_in, values):
                if isinstance(x, torch.Tensor):
                    buf[:width].copy_(x)
                    buf[width:].zero_()
                else:
                    host = pinned.numpy()
                    host[:width] = x
                    host[width:] = 0
                    buf.copy_(pinned, non_blocking=True)
            self.graph.replay()
            out = []
            for buf, pinned, dev in zip(self.outputs, self.pinned_out,
                                        on_device):
                if dev:
                    out.append(buf[:width].clone())
                else:
                    pinned[:width].copy_(buf[:width], non_blocking=True)
                    out.append(pinned)
            self.done.record()
            self.done.synchronize()
            return [o if dev else o[:width].numpy().copy()
                    for o, dev in zip(out, on_device)]


class _Snapshot(NamedTuple):
    params: Any
    obs_norm: Any
    step: Optional[int]
    graphs: dict  # rung -> _GraphRung on a card; empty on the CPU


class LadderEngine:
    """What both serving engines share: the snapshot lifecycle (load,
    one-shot rollback, the obs-norm presence checks), the rung ladder,
    and running one rung's program (a graph replay on a card, eager on
    the CPU). Subclasses define :meth:`_program` and :meth:`_input_specs`.
    """

    def __init__(self, batch_shapes, with_obs_norm: bool, obs_dtype,
                 device):
        self.batch_shapes = check_batch_shapes(batch_shapes)
        self.max_batch = self.batch_shapes[-1]
        self.with_obs_norm = bool(with_obs_norm)
        self.obs_dtype = np.dtype(obs_dtype)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the serving engine runs on CUDA and none is "
                    "available; pass device='cpu' to run it eagerly on "
                    "the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self._snapshot: Optional[_Snapshot] = None  # swapped by reference
        self._prev_snapshot: Optional[_Snapshot] = None  # for rollback()
        self._lock = threading.Lock()  # counters only
        self._capture_stream = None
        self.shape_counts: Counter = Counter()  # rung -> dispatches
        self.captures_total = 0
        self.last_load_ms: Optional[float] = None

    def _program(self, params, obs_norm) -> Callable:
        raise NotImplementedError

    def _input_specs(self, rung: int) -> list:
        """``[(shape, torch dtype), ...]`` of a rung's inputs."""
        raise NotImplementedError

    # -- snapshot lifecycle ------------------------------------------------

    @property
    def loaded_step(self) -> Optional[int]:
        snap = self._snapshot
        return snap.step if snap is not None else None

    @property
    def ready(self) -> bool:
        return self._snapshot is not None

    def load(self, params, obs_norm=None, step: Optional[int] = None) -> None:
        """Install a params snapshot (and its obs-norm statistics when the
        engine normalizes): copy them onto the device, build the rung
        programs (a graph capture per rung on a card) and swap the whole
        snapshot in. Each load captures anew; ``last_load_ms`` is its
        wall time."""
        if self.with_obs_norm and obs_norm is None:
            raise ValueError(
                "engine was built with with_obs_norm=True but load() got "
                "obs_norm=None — serving would skip the normalization the "
                "policy was trained behind (silently wrong actions)"
            )
        if not self.with_obs_norm and obs_norm is not None:
            # a non-None stats object here would be silently ignored,
            # which is the same wrong-numbers trap inverted
            raise ValueError(
                "engine was built with with_obs_norm=False but load() "
                "got obs-norm statistics — rebuild the engine with "
                "with_obs_norm=True to serve a normalized policy"
            )
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            snap = self._capture(params, obs_norm, step)
        else:
            copy = lambda t: t.detach().to(self.device, copy=True)  # noqa
            snap = _Snapshot(tree_map(copy, params),
                             tree_map(copy, obs_norm), step, {})
        self.last_load_ms = (time.perf_counter() - t0) * 1e3
        self._prev_snapshot = self._snapshot
        self._snapshot = snap

    def _capture(self, params, obs_norm, step) -> _Snapshot:
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            copy = lambda t: t.detach().to(self.device, copy=True)  # noqa
            params = tree_map(copy, params)
            obs_norm = tree_map(copy, obs_norm)
        fn = self._program(params, obs_norm)
        graphs = {}
        for rung in self.batch_shapes:
            with torch.cuda.stream(stream):
                inputs = [torch.zeros(shape, dtype=dtype, device=self.device)
                          for shape, dtype in self._input_specs(rung)]
            t0 = time.perf_counter()
            graphs[rung] = _GraphRung(fn, inputs, stream)
            recompile.notify(f"capture:{type(self).__name__}:rung_{rung}",
                             time.perf_counter() - t0)
            with self._lock:
                self.captures_total += 1
        stream.synchronize()
        return _Snapshot(params, obs_norm, step, graphs)

    def rollback(self) -> Optional[int]:
        """Swap the PREVIOUS snapshot back in (one-deep, ONE-SHOT): the
        canary gate's instant, disk-free rejection path. The history is
        consumed, so a duplicated rollback answers "nothing to roll back
        to" instead of reinstating the rejected snapshot. Returns the
        step now serving; raises when there is no previous snapshot."""
        prev = self._prev_snapshot
        if prev is None:
            raise RuntimeError(
                "no previous snapshot to roll back to — the engine has "
                "loaded at most one checkpoint (or already rolled back)"
            )
        self._prev_snapshot = None
        self._snapshot = prev
        return prev.step

    def _current(self) -> _Snapshot:
        snap = self._snapshot
        if snap is None:
            raise RuntimeError(
                "no params snapshot loaded — call load() (or point the "
                "server at a checkpoint directory) before serving"
            )
        return snap

    # -- running a rung ----------------------------------------------------

    def padded_shape(self, n: int) -> int:
        """The rung a batch of ``n`` dispatches at: the smallest ladder
        shape ≥ n, or the top rung (over-sized batches chunk)."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        for rung in self.batch_shapes:
            if n <= rung:
                return rung
        return self.max_batch

    def _run(self, snap: _Snapshot, values: Sequence, width: int,
             on_device: Sequence[bool]) -> list:
        """One dispatch of ``width`` rows at their rung."""
        rung = self.padded_shape(width)
        if snap.graphs:
            out = snap.graphs[rung].run(values, width, on_device)
        else:
            padded = []
            for (shape, dtype), x in zip(self._input_specs(rung), values):
                buf = torch.zeros(shape, dtype=dtype)
                buf[:width] = torch.as_tensor(x)
                padded.append(buf)
            with torch.no_grad():
                res = self._program(snap.params, snap.obs_norm)(*padded)
            out = [r[:width] if dev else r[:width].numpy()
                   for r, dev in zip(res, on_device)]
        with self._lock:
            self.shape_counts[rung] += 1
        return out


class InferenceEngine(LadderEngine):
    """Eval-mode ``act`` over a swappable params snapshot, one program per
    rung.

    Feedforward policies only: serving is stateless per request, and a
    recurrent policy's carry makes it a session protocol
    (``serve/session.py``). ``with_obs_norm`` folds ``normalize(stats,
    obs)`` in front of the policy (the stats ride the snapshot, so a hot
    reload updates them with the params); clients always send RAW
    observations. Categorical actions come back int32, Gaussian ones f32,
    as the reference's.
    """

    def __init__(
        self,
        policy,
        obs_shape: Tuple[int, ...],
        batch_shapes: Tuple[int, ...] = (1, 8, 64),
        with_obs_norm: bool = False,
        obs_dtype=np.float32,
        device="cuda",
    ):
        super().__init__(batch_shapes, with_obs_norm, obs_dtype, device)
        self.policy = policy
        self.obs_shape = tuple(obs_shape)
        self.infer_calls = 0

    def _input_specs(self, rung: int) -> list:
        return [((rung,) + self.obs_shape, torch_dtype(self.obs_dtype))]

    def _program(self, params, obs_norm) -> Callable:
        policy, with_norm = self.policy, self.with_obs_norm

        def act(obs):
            if with_norm:
                obs = normalize(obs_norm, obs)
            action = policy.dist.mode(policy.apply(params, obs))
            if action.dtype == torch.int64:
                action = action.to(torch.int32)
            return (action,)

        return act

    def infer(self, obs, return_step: bool = False):
        """Greedy actions for a batch of raw observations ``(n,
        *obs_shape)``: padded up to the nearest rung (over-sized batches
        chunk at the top one), the padding sliced back off. Reads the
        snapshot ONCE: a concurrent hot reload affects the next call,
        never this one.

        ``return_step=True`` returns ``(actions, step)``, ``step`` being
        the checkpoint step of the snapshot THIS call used — the
        provenance the serving tier reports per request (reading
        ``loaded_step`` afterwards could race a hot swap)."""
        snap = self._current()
        obs = np.asarray(obs, self.obs_dtype)
        if obs.ndim != 1 + len(self.obs_shape) or (
                obs.shape[1:] != self.obs_shape):
            raise ValueError(
                f"obs must be (n, {', '.join(map(str, self.obs_shape))}), "
                f"got shape {obs.shape}"
            )
        n = obs.shape[0]
        outs = []
        for i in range(0, n, self.max_batch):
            chunk = obs[i:i + self.max_batch]
            outs.append(self._run(snap, [chunk], chunk.shape[0],
                                  [False])[0])
        with self._lock:
            self.infer_calls += 1
        actions = outs[0] if len(outs) == 1 else np.concatenate(outs)
        return (actions, snap.step) if return_step else actions


class SimulatedCostEngine:
    """An engine wrapper adding a fixed per-``infer`` cost (a GIL-free
    sleep): for control-plane experiments that need a per-dispatch cost
    that behaves like device time (off-thread, concurrent across
    replicas) rather than like host compute. Production paths never use
    it."""

    def __init__(self, engine, cost_ms: float):
        if cost_ms < 0:
            raise ValueError(f"cost_ms must be >= 0, got {cost_ms}")
        self._engine = engine
        self.cost_ms = float(cost_ms)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def infer(self, obs, return_step: bool = False):
        time.sleep(self.cost_ms / 1e3)
        return self._engine.infer(obs, return_step=return_step)
