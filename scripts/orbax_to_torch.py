"""Convert one step of a ``trpo_tpu`` run's Orbax checkpoint into the
port's checkpoint format, so a run started with ``trpo_tpu`` resumes in
``trpo_torch``.

    python scripts/orbax_to_torch.py --src REF_CKPT_DIR --dst TORCH_CKPT_DIR \\
        [--step N] --preset cartpole [train flags ...] [--device cpu]

It reads the step that the reference's ``Checkpointer`` wrote (an Orbax
``CheckpointManager`` directory: ``<n>/`` and its ``step_<n>.complete``
marker) as a raw tree, Orbax restoring without a template, and writes it
as ``step_<n>/`` with its marker through
``trpo_torch.utils.checkpoint.Checkpointer``. The default step is the
newest complete one under the reference's save-integrity gate: a step
newer than the newest marker and without a marker of its own is a torn
save, never picked; asking for one with ``--step`` exits 2 naming it.

The template is the port's ``TRPOAgent`` built from the same ``--preset``
and config flags as ``python -m trpo_torch.train`` (its ``init_state(0)``),
filled through ``trpo_torch/convert.py``: the policy, the critic with its
Adam count and moments, the observation statistics, the damping, the
solver ladder and the head-block factors; ``iteration``,
``total_timesteps``, ``total_episodes`` and the five solver counters carry
over unchanged.

What cannot carry over is the random stream: JAX draws with threefry, the
port with Philox. The port's generators are seeded deterministically from
the reference's key data, and the script says so: a converted run goes on
from the same weights, optimizer, normalizer and counters, but draws a
different noise stream from there. A device env's carry is carried over
where its fields match the port's env state, and otherwise re-initialized,
naming the fields. A host env's ``host_env_<n>.npz`` sidecar is carried
over only if the port's adapter accepts it (``env_state_restore``);
otherwise the script exits 2 naming the file. Nothing is dropped without a
line saying so.

It needs ``orbax`` (and the JAX it runs on), so it runs where the
reference is installed, not on a machine with only the port. It imports
``orbax``, ``numpy`` and ``trpo_torch``, never ``trpo_tpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


class ConvertError(Exception):
    """A refusal: the script exits 2 with this message."""


def complete_steps(src: str) -> tuple:
    """``(complete, torn)`` step numbers of a reference checkpoint
    directory, by the reference's marker gate."""
    names = os.listdir(src)
    steps = sorted(int(n) for n in names
                   if n.isdigit() and os.path.isdir(os.path.join(src, n)))
    marked = {int(m.group(1)) for m in
              (re.fullmatch(r"step_(\d+)\.complete", n) for n in names) if m}
    if not marked:
        if steps and os.path.exists(os.path.join(src, ".markers_enabled")):
            return [], steps
        return steps, []
    newest = max(marked)
    ok = [s for s in steps if s in marked or s < newest]
    return ok, [s for s in steps if s not in ok]


def choose_step(src: str, step=None) -> int:
    ok, torn = complete_steps(src)
    if step is None:
        if not ok:
            raise ConvertError(f"no complete step in {src} (torn: {torn})")
        return max(ok)
    if step in torn:
        raise ConvertError(
            f"step {step} in {src} is a torn save (newer than the newest "
            "completion marker and without one of its own); pick a "
            f"complete step: {ok}")
    if step not in ok:
        raise ConvertError(f"no step {step} in {src}; complete steps: {ok}")
    return step


def read_step(src: str, step: int) -> dict:
    """The step's raw tree (dicts, lists, numpy arrays), restored by Orbax
    without a template."""
    import orbax.checkpoint as ocp

    raw = ocp.CheckpointManager(os.path.abspath(src)).restore(step)
    to_np = lambda x: x if x is None else (  # noqa: E731
        {k: to_np(v) for k, v in x.items()} if isinstance(x, dict)
        else [to_np(v) for v in x] if isinstance(x, (list, tuple))
        else np.asarray(x))
    return to_np(raw)


def _seed_from_key(key_data, salt: int = 0) -> int:
    """A torch seed from the reference's raw key words."""
    words = np.asarray(key_data, np.uint64).reshape(-1)
    seed = salt
    for w in words:
        seed = (seed * 0x100000001B3 + int(w)) % (2 ** 63)
    return seed


def _carry(template, raw, log) -> object:
    """The reference's device-env carry in the port's structure where the
    fields and shapes match; the template's fresh carry otherwise."""
    import torch

    if template is None:
        if raw is not None:
            log("env carry: the reference saved one, this agent has none; "
                "dropped")
        return None
    if raw is None or len(raw) != len(template):
        log("env carry: no matching carry in the step; re-initialized "
            "(every field)")
        return template
    out, fresh = [], []
    for i, (t, r) in enumerate(zip(template, raw)):
        if hasattr(t, "_fields"):
            if not isinstance(r, dict) or set(r) != set(t._fields) or any(
                    np.shape(r[f]) != tuple(getattr(t, f).shape)
                    for f in t._fields):
                fresh.append(f"{i} ({type(t).__name__}: "
                             f"{', '.join(t._fields)})")
                out.append(t)
                continue
            out.append(type(t)(*(torch.as_tensor(
                np.array(r[f]), device=getattr(t, f).device).to(
                    getattr(t, f).dtype) for f in t._fields)))
        elif isinstance(t, torch.Tensor) and np.shape(r) == tuple(t.shape):
            out.append(torch.as_tensor(np.array(r), device=t.device).to(
                t.dtype))
        else:
            fresh.append(str(i))
            out.append(t)
    if fresh:
        log(f"env carry: re-initialized field(s) {', '.join(fresh)} (their "
            "layout differs from the port's env state)")
    return tuple(out)


def convert(raw: dict, agent, log):
    """The port's ``TrainState`` from the reference's raw tree."""
    import torch

    from trpo_torch import convert as cv
    from trpo_torch.obs.device_metrics import DeviceMetrics
    from trpo_torch.ops.precond import PrecondState

    tmpl = agent.init_state(0)
    dev = agent.device
    vf = raw["vf_state"]
    adam = vf["opt_state"][0]
    repl = dict(
        policy_params=cv.policy_params_from_numpy(raw["policy_params"], dev),
        vf_state=cv.vf_state_from_numpy(
            vf["params"], adam["mu"], adam["nu"], int(adam["count"]),
            bool(vf["initialized"]), dev),
        iteration=int(raw["iteration"]),
        total_timesteps=int(raw["total_timesteps"]),
        total_episodes=torch.as_tensor(int(raw["total_episodes"]),
                                       dtype=torch.int64, device=dev),
        env_carry=_carry(tmpl.env_carry, raw.get("env_carry"), log),
    )
    for field, saved, build in (
            ("obs_norm", raw.get("obs_norm"),
             lambda s: cv.obs_norm_from_numpy(s, dev)),
            ("cg_damping", raw.get("cg_damping"),
             lambda s: cv.damping_from_numpy(s, dev)),
            ("ladder", raw.get("ladder"),
             lambda s: cv.ladder_from_numpy(s, dev)),
            ("precond", raw.get("precond"),
             lambda s: PrecondState(
                 u=torch.as_tensor(s["u"], device=dev).float(),
                 s_eig=torch.as_tensor(s["s_eig"], device=dev).float(),
                 age=int(s["age"]))),
            ("metrics", raw.get("metrics"),
             lambda s: DeviceMetrics(*(torch.as_tensor(
                 int(s[k]), dtype=torch.int64, device=dev)
                 for k in DeviceMetrics._fields)))):
        have = getattr(tmpl, field) is not None
        if have and saved is not None:
            repl[field] = build(saved)
        elif saved is not None:
            log(f"{field}: saved by the reference, off in this config; "
                "dropped")
        elif have:
            log(f"{field}: not in the step; the port's fresh value")
    key = raw.get("rng")
    if key is not None:
        repl["rng"] = torch.Generator(device=dev).manual_seed(
            _seed_from_key(key))
        if tmpl.host_rng is not None:
            repl["host_rng"] = torch.Generator().manual_seed(
                _seed_from_key(key, salt=1))
        log("rng: JAX's threefry stream cannot be carried into torch's "
            "Philox; the port's generators are seeded deterministically "
            f"from the reference's key data {np.asarray(key).tolist()} — "
            "the run continues from the same weights, optimizer, "
            "normalizer and counters with a different noise stream")
    return tmpl._replace(**repl)


def _host_sidecar(src: str, step: int, agent, log):
    """The reference's host-env sidecar of ``step`` if the port's adapter
    accepts it; None when there is none."""
    from trpo_torch.utils.checkpoint import _unflatten_snapshot

    path = os.path.join(src, f"host_env_{step}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            snapshot = _unflatten_snapshot(str(z["__structure__"]), z)
        agent.restore_host_env(snapshot)
    except Exception as e:
        raise ConvertError(
            f"host-env sidecar {path} is not accepted by the port's "
            f"adapter ({type(e).__name__}: {e})") from e
    log(f"host env: sidecar {os.path.basename(path)} accepted by the "
        "port's adapter; written beside the step")
    return snapshot


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True,
                   help="the reference's checkpoint directory")
    p.add_argument("--dst", required=True,
                   help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, help="default: newest complete")
    args, rest = p.parse_known_args(argv)
    from trpo_torch import train
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.utils.checkpoint import Checkpointer

    targs = train.parse_args(rest)
    cfg = train.build_config(targs)
    log = lambda msg: print(f"orbax_to_torch: {msg}", flush=True)  # noqa
    try:
        step = choose_step(args.src, args.step)
        agent = TRPOAgent(cfg.env, cfg, device=targs.device)
        raw = read_step(args.src, step)
        state = convert(raw, agent, log)
        host = _host_sidecar(args.src, step, agent, log)
    except ConvertError as e:
        print(f"orbax_to_torch: {e}", file=sys.stderr)
        return 2
    Checkpointer(args.dst).save(step, state, host_env=host)
    log(f"step {step} of {args.src} written to {args.dst} (iteration "
        f"{state.iteration}, {state.total_timesteps} timesteps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
