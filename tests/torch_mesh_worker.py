"""One rank of a gloo process group for the port's mesh tests.

    python tests/torch_mesh_worker.py JOBS_JSON RANK WORLD

``JOBS_JSON`` names the work directory's job list: ``[{"name", "fn",
"args"}, ...]``. Every rank joins the group through a file store in the
work directory (no TCP port), runs every job in order — job ``name``
reads ``<name>.in.npz`` when there is one — and writes ``<name>.r<RANK>.npz``
(or ``<name>.r<RANK>.err`` with the traceback). Each collective has a
60 s timeout, so a rank that diverges fails the job instead of hanging
the file. The process group is destroyed in a ``finally``.

The test files start a group with :class:`Group` (one group per file,
from a module-scoped fixture) and read each job's outputs with
:func:`outputs`.
"""

import datetime
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Group:
    """``world`` ranks of this script started on a job list: the inputs
    (``{name: {key: array}}``) and the jobs are written into ``work``, the
    ranks start at once, and :meth:`wait` waits for their end (so the
    caller computes its reference results meanwhile)."""

    def __init__(self, work, jobs, world: int, inputs=None):
        work = str(work)
        for name, arrays in (inputs or {}).items():
            np.savez(os.path.join(work, name + ".in.npz"), **arrays)
        path = os.path.join(work, "jobs.json")
        with open(path, "w") as f:
            json.dump(jobs, f)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, path, str(r), str(world)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]

    def wait(self, timeout: float = 300) -> str:
        """The ranks' combined output once all have exited; a rank still
        running at ``timeout`` is killed, and so are the others."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return "\n".join(logs)


def outputs(work, name: str, world: int) -> list:
    """Every rank's outputs of job ``name``; raises with a rank's
    traceback when it failed."""
    out = []
    for r in range(world):
        base = os.path.join(str(work), f"{name}.r{r}")
        if os.path.exists(base + ".err"):
            with open(base + ".err") as f:
                raise AssertionError(f"rank {r} of {name}:\n{f.read()}")
        with np.load(base + ".npz") as z:
            out.append(dict(z))
    return out


def _policy(spec, tp=None):
    from trpo_torch.models.moe import make_moe_policy
    from trpo_torch.models.policy import BoxSpec, DiscreteSpec, make_policy

    kind, n = spec["act"]
    act = DiscreteSpec(n) if kind == "discrete" else BoxSpec(n)
    if spec.get("experts"):
        return make_moe_policy((spec["obs_dim"],), act,
                               hidden=tuple(spec["hidden"]),
                               n_experts=spec["experts"], tp=tp)
    return make_policy((spec["obs_dim"],), act, hidden=tuple(spec["hidden"]),
                       tp=tp)


def _tp_policy(spec, mesh, axis):
    """The spec's policy with its forward over this rank's blocks of
    ``axis``, and the layout: ``(policy, specs)``."""
    from trpo_torch.parallel.tp import model_axis, policy_param_shardings

    full = _policy(spec).init(torch.Generator().manual_seed(0))
    specs = policy_param_shardings(full, mesh, axis)
    return _policy(spec, model_axis(mesh, axis, specs)), specs


def _params(policy, flat):
    from trpo_torch.ops.flat import flatten_params

    _, unravel = flatten_params(policy.init(torch.Generator().manual_seed(0)))
    return unravel(torch.from_numpy(np.asarray(flat, np.float32)).clone())


def _batch(inp):
    from trpo_torch.trpo import TRPOBatch

    T = lambda k: torch.from_numpy(np.asarray(inp[k]))  # noqa: E731
    dist_keys = [k[2:] for k in inp if k.startswith("d_")]
    return TRPOBatch(T("obs"), T("actions"), T("adv"),
                     {k: T("d_" + k) for k in dist_keys}, T("weight"))


def _flat(params):
    from trpo_torch.ops.flat import flatten_params

    return flatten_params(params)[0].detach().numpy()


def _mesh(args):
    from trpo_torch.parallel import make_mesh

    return make_mesh(tuple(args.get("shape", (dist.get_world_size(),))),
                     tuple(args.get("axes", ("data",))), device="cpu")


# ---------------------------------------------------------------------------
# jobs: each returns a dict of arrays
# ---------------------------------------------------------------------------


def job_sharded_fvp(args, inp):
    from trpo_torch.config import TRPOConfig
    from trpo_torch.parallel import (
        make_sharded_fused_fvp,
        make_sharded_fvp,
        make_sharded_ggn_fvp,
        shard_batch,
    )

    mesh = _mesh(args)
    policy = _policy(args["policy"])
    cfg = TRPOConfig(cg_damping=args["damping"])
    make = {"jvp": make_sharded_fvp, "ggn": make_sharded_ggn_fvp,
            "fused": make_sharded_fused_fvp}[args["kind"]]
    local = shard_batch(mesh, _batch(inp))
    hv = make(policy, cfg, mesh)(_params(policy, inp["flat"]), local,
                                 torch.from_numpy(inp["v"]))
    return {"hv": hv.numpy()}


def job_sharded_solve(args, inp):
    from trpo_torch.config import TRPOConfig
    from trpo_torch.ops.cg import conjugate_gradient
    from trpo_torch.parallel import make_sharded_fvp, shard_batch

    mesh = _mesh(args)
    policy = _policy(args["policy"])
    op = make_sharded_fvp(policy, TRPOConfig(cg_damping=0.1), mesh).operator(
        _params(policy, inp["flat"]), shard_batch(mesh, _batch(inp)))
    return {"x": conjugate_gradient(op, torch.from_numpy(inp["b"])).x.numpy()}


def job_sharded_update(args, inp):
    from trpo_torch.config import TRPOConfig
    from trpo_torch.parallel import make_sharded_update, shard_batch

    mesh = _mesh(args)
    policy = _policy(args["policy"])
    cfg = TRPOConfig(**args.get("cfg", {}))
    update = make_sharded_update(policy, cfg, mesh)
    try:
        new, stats = update(_params(policy, inp["flat"]),
                            shard_batch(mesh, _batch(inp)))
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    out = {"flat": _flat(new), "kl": stats.kl.numpy(),
           "kl_hex": np.asarray(float(stats.kl).hex()),
           "success": stats.linesearch_success.numpy()}
    if cfg.fvp_subsample is not None:
        from trpo_torch.trpo import _keep

        local = shard_batch(mesh, _batch(inp))
        n = local.weight.shape[0]
        keep = _keep(local, n, cfg.fvp_subsample, mesh.group("data"))
        out["keep"] = (keep + mesh.coordinate("data") * n).numpy()
    return out


def job_counted_update(args, inp):
    """The data-parallel update under a profiler: the new params, the
    line search's trials and its evaluations (the trial spans opened)."""
    from torch.profiler import profile

    from trpo_torch.config import TRPOConfig
    from trpo_torch.ops import _build
    from trpo_torch.parallel import make_sharded_update, shard_batch

    mesh = _mesh(args)
    policy = _policy(args["policy"])
    update = make_sharded_update(policy, TRPOConfig(**args.get("cfg", {})),
                                 mesh)
    _build.reset_launches()
    with profile():
        new, stats = update(_params(policy, inp["flat"]),
                            shard_batch(mesh, _batch(inp)))
    return {"flat": _flat(new), "trials": stats.linesearch_trials.numpy(),
            "evals": np.asarray(
                _build.SPAN_COUNTS["trpo/linesearch/trial"]),
            "fraction": stats.step_fraction.numpy()}


def job_tp_update(args, inp):
    """The tree update of a policy sharded over ``args["axis"]`` on a
    data×axis mesh: the gathered new params and the stats."""
    from trpo_torch.config import TRPOConfig
    from trpo_torch.ops.flat import tree_leaves
    from trpo_torch.parallel import shard_batch
    from trpo_torch.parallel.tp import (
        gather_policy_params, shard_policy_params)
    from trpo_torch.trpo import make_tree_trpo_update

    mesh, axis = _mesh(args), args["axis"]
    policy, specs = _tp_policy(args["policy"], mesh, axis)
    full = _params(_policy(args["policy"]), inp["flat"])
    local = shard_policy_params(full, mesh, axis, specs)
    update = make_tree_trpo_update(policy, TRPOConfig(**args.get("cfg", {})),
                                   group=mesh.group("data"))
    new, stats = update(local, shard_batch(mesh, _batch(inp)))
    first = [t for t in tree_leaves(local) if t.ndim >= 2][0]
    return {"flat": _flat(gather_policy_params(new, mesh, specs, axis)),
            "kl": stats.kl.numpy(), "grad_norm": stats.grad_norm.numpy(),
            "step_norm": stats.step_norm.numpy(),
            "success": stats.linesearch_success.numpy(),
            "step_fraction": stats.step_fraction.numpy(),
            "local_flat": _flat(new),
            "first_shape": np.asarray(first.shape)}


def job_tp_cg(args, inp):
    """CG over this rank's entries of a vector laid out as the tree
    ``{"a": (8, 4) split on dim 1, "b": (6,) replicated}``, with the
    axis's inner product; the matvec gathers the whole vector."""
    from trpo_torch.ops.allreduce import all_gather_cat
    from trpo_torch.ops.cg import conjugate_gradient
    from trpo_torch.parallel.tp import make_flat_space, model_axis

    mesh = _mesh(args)
    tp = model_axis(mesh, "model", {"a": 1, "b": None})
    A = torch.from_numpy(inp["A"])
    b = torch.from_numpy(inp["b"])
    space = make_flat_space({"a": torch.zeros(8, 4 // tp.size),
                             "b": torch.zeros(6)}, tp)
    n_a = 8 * (4 // tp.size)

    def whole(v):
        a = all_gather_cat(v[:n_a].reshape(8, -1), tp.group, dim=1)
        return torch.cat([a.reshape(-1), v[n_a:]])

    x = conjugate_gradient(lambda v: (A @ whole(v))[space.index], b[space.index],
                           cg_iters=args["iters"], dot=space.dot).x
    return {"x": whole(x).numpy(),
            "dot": space.dot(b[space.index], b[space.index]).numpy()}


def job_mesh_validate(args, inp):
    from trpo_torch.parallel import make_mesh

    out = {}
    for key, shape in (("oversubscribed", (4,)), ("smaller", (1,))):
        try:
            make_mesh(shape, ("data",), device="cpu")
            out[key] = np.asarray("no error")
        except ValueError as e:
            out[key] = np.asarray(str(e))
    mesh = make_mesh((1, 2), ("data", "seq"), device="cpu")
    out["shape"] = np.asarray([mesh.shape["data"], mesh.shape["seq"]])
    out["coord"] = np.asarray([mesh.coordinate("data"),
                               mesh.coordinate("seq")])
    return out


def job_seq_scan(args, inp):
    from trpo_torch.parallel import seq_sharded_gae, seq_sharded_returns

    from trpo_torch.ops import _build

    mesh = _mesh(args)
    batch_axis = args.get("batch_axis")
    before = _build.LAUNCHES["reverse_scan_plain"]
    if args["what"] == "returns":
        y = seq_sharded_returns(mesh, torch.from_numpy(inp["rewards"]),
                                torch.from_numpy(inp["dones"]),
                                args["gamma"], batch_axis=batch_axis)
        out = {"y": y.numpy()}
    else:
        adv, vt = seq_sharded_gae(
            mesh, *(torch.from_numpy(inp[k]) for k in
                    ("rewards", "values", "next_values", "terminated",
                     "dones")),
            args["gamma"], args["lam"], batch_axis=batch_axis)
        out = {"adv": adv.numpy(), "vtarg": vt.numpy()}
    out["scans"] = np.asarray(_build.LAUNCHES["reverse_scan_plain"] - before)
    return out


def job_diverge(args, inp):
    """Rank 0 enters a collective that rank 1 never joins, on a group
    with a short timeout: it must raise, not hang."""
    import time

    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=2))
    out = {"error": np.asarray(""), "seconds": np.asarray(0.0)}
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        try:
            dist.all_reduce(torch.ones(3), group=group)
        except RuntimeError as e:
            out["error"] = np.asarray(str(e)[:200] or type(e).__name__)
        out["seconds"] = np.asarray(time.perf_counter() - t0)
    return out


def _agent(args):
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig

    cfg = TRPOConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in args["cfg"].items()})
    return TRPOAgent(cfg.env, cfg, device="cpu")


def job_agent_iterations(args, inp):
    """``n`` iterations of a mesh agent; with ``ckpt``: save, restore
    through the mesh checkpointer and run ``more`` from both states."""
    from trpo_torch.utils.checkpoint import Checkpointer

    agent = _agent(args)
    if args.get("restore"):
        # a checkpoint written elsewhere (one rank, or another layout)
        ck = Checkpointer(args["restore"], mesh=agent.mesh,
                          param_layout=agent.param_layout)
        state = ck.restore(agent.init_state(args.get("seed", 0)))
        return {"flat": _flat(agent.gather_params(state.policy_params)),
                "local_flat": _flat(state.policy_params)}
    try:
        state = agent.init_state(args.get("seed", 0))
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    local_flat = _flat(state.policy_params)
    state, stats = agent.run_iterations(state, args["n"])
    out = {"flat": _flat(agent.gather_params(state.policy_params)),
           "init_local_flat": local_flat,
           "kl": stats["kl_old_new"].numpy(),
           "entropy": stats["entropy"].numpy(),
           "episodes": stats["episodes_in_batch"].numpy(),
           "total_timesteps": np.asarray(state.total_timesteps)}
    if state.env_carry is not None:
        out["carry_obs"] = state.env_carry[1].numpy()
    if state.obs_norm is not None:
        out["obs_norm_count"] = state.obs_norm.count.numpy()
    if state.cg_damping is not None:
        out["cg_damping"] = state.cg_damping.numpy()
    if args.get("ckpt"):
        if agent.param_layout is not None:
            # blocks this checkpointer could not place: refused
            try:
                Checkpointer(args["ckpt"] + "_no_layout",
                             mesh=agent.mesh).save(args["n"], state)
                out["no_layout_error"] = np.asarray("")
            except ValueError as e:
                out["no_layout_error"] = np.asarray(str(e))
        ck = Checkpointer(args["ckpt"], mesh=agent.mesh,
                          param_layout=agent.param_layout)
        ck.save(args["n"], state, host_env=agent.snapshot_host_env())
        restored = ck.restore(agent.init_state(args.get("seed", 0)))
        out["restored_flat"] = _flat(agent.gather_params(
            restored.policy_params))
        out["restored_local_equal"] = np.asarray(np.array_equal(
            _flat(restored.policy_params), _flat(state.policy_params)))
        out["restored_damping"] = (np.asarray(float("nan"))
                                   if restored.cg_damping is None
                                   else restored.cg_damping.numpy())
        if not args.get("more"):
            return out
        s1, st1 = agent.run_iterations(state, args["more"])
        s2, st2 = agent.run_iterations(restored, args["more"])
        out.update(entropy_cont=st1["entropy"].numpy(),
                   entropy_resumed=st2["entropy"].numpy(),
                   iteration_resumed=np.asarray(s2.iteration),
                   damping_resumed=(np.asarray(float("nan"))
                                    if s2.cg_damping is None
                                    else s2.cg_damping.numpy()))
    return out


def job_peer_desync(args, inp):
    """A host env on a data×model mesh whose model peers' envs part (one
    rank's env state moved, as a worker restart there alone would):
    ``n`` iterations, the move on ``part_ranks``, one more."""
    agent = _agent(args)
    state, _ = agent.run_iterations(agent.init_state(0), args["n"])
    if dist.get_rank() in args["part_ranks"]:
        agent.env._state[0] += 0.5
    try:
        agent.run_iterations(state, 1)
    except RuntimeError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def job_host_learn(args, inp):
    """``learn`` over ``n`` iterations on a host-env mesh; then, when
    ``more`` is given, one of rank ``fault_rank``'s env workers killed (a
    fault of that rank alone, revived by its supervisor) and ``more``
    iterations on. The gathered params and the observation statistics
    after each part, and the worker restarts."""
    import io

    from trpo_torch.utils.metrics import StatsLogger

    agent = _agent(args)
    quiet = lambda: StatsLogger(stream=io.StringIO())  # noqa: E731
    out = {}
    try:
        state = agent.learn(n_iterations=args["n"], logger=quiet())
        parts = [("", state)]
        if args.get("more"):
            if dist.get_rank() == args["fault_rank"]:
                agent.env.env._procs[0].kill()
            state = agent.learn(n_iterations=args["more"], state=state,
                                logger=quiet())
            parts.append(("fault_", state))
            out["restarts"] = np.asarray(sum(agent.env.restarts.values()))
        for tag, s in parts:
            out[tag + "flat"] = _flat(agent.gather_params(s.policy_params))
            out[tag + "iteration"] = np.asarray(s.iteration)
            for field in ("count", "mean", "m2"):
                out[f"{tag}obs_norm_{field}"] = getattr(
                    s.obs_norm, field).numpy()
    finally:
        agent.env.close()
    return out


def job_population(args, inp):
    from trpo_torch.population import Population

    agent = _agent(args)
    mesh = _mesh(args)
    try:
        pop = Population(agent, args["seeds"], mesh=mesh)
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    stats = pop.run_iteration()
    out = {"reward": stats["mean_episode_reward"].numpy(),
           "best": np.asarray(pop.best_member(stats))}
    for i in pop._members:
        out[f"member{i}"] = _flat(pop.member_state(i).policy_params)
    return out


JOBS = {k[4:]: v for k, v in globals().items() if k.startswith("job_")}


def main(jobs_path: str, rank: int, world: int) -> int:
    torch.set_num_threads(1)
    work = os.path.dirname(os.path.abspath(jobs_path))
    with open(jobs_path) as f:
        jobs = json.load(f)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        for job in jobs:
            base = os.path.join(work, job["name"])
            try:
                inp = {}
                if os.path.exists(base + ".in.npz"):
                    with np.load(base + ".in.npz") as z:
                        inp = dict(z)
                out = JOBS[job["fn"]](job.get("args", {}), inp)
                np.savez(f"{base}.r{rank}.npz", **out)
            except Exception:
                with open(f"{base}.r{rank}.err", "w") as f:
                    f.write(traceback.format_exc())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
