"""Fleet specification: which members to train, under what budgets
(counterpart: ``trpo_tpu/fleet/spec.py``; pure Python, its errors and
rendered argv are the reference's).

A fleet is N *members* — variations of one ``trpo_torch.train`` run
(seeds, damping sweeps, KL radii, …) — scheduled over a bounded pool of
local worker slots by :mod:`trpo_torch.fleet.scheduler`. The spec layer is
pure data + parsing, no processes:

* :class:`MemberSpec` — one member: a stable id plus the train-CLI
  overrides that distinguish it from the base run.
* :class:`FleetSpec` — the whole fleet: members, shared base args,
  worker-slot bound, requeue/restart budgets, gate and selection knobs.
* :func:`expand_grid` — the ``--grid seed=0..3,cg_damping=0.1|0.3``
  syntax: ``..`` is an inclusive int range, ``|`` separates explicit
  values, ``,`` separates fields; members are the cartesian product,
  with ids derived from the varying fields (``seed0-cg_damping0.1``).
* :func:`load_spec_file` — the JSON spec-file form of the same thing,
  for fleets too irregular for a grid (per-member fault injection, the
  chaos smoke's asymmetric members).

Overrides are TRAIN CLI destinations (``seed``, ``cg_damping``,
``batch_timesteps`` — underscores, exactly the config-field spellings
``trpo_torch.train`` accepts), rendered to ``--flag value`` pairs at
launch time; a boolean ``True`` renders as a bare flag. Member argv
order is ``base_args`` then overrides, so an override always wins
(argparse last-wins).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "MemberSpec",
    "FleetSpec",
    "expand_grid",
    "load_spec_file",
    "member_cli_args",
    "member_total_iterations",
]

_ID_RE = re.compile(r"^[A-Za-z0-9._=-]+$")


@dataclasses.dataclass(frozen=True)
class MemberSpec:
    """One fleet member: a stable id + its train-CLI overrides."""

    member_id: str
    overrides: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.member_id or not _ID_RE.match(self.member_id):
            raise ValueError(
                "member_id must be non-empty [A-Za-z0-9._=-], got "
                f"{self.member_id!r}"
            )
        # normalize dict-style construction to the hashable tuple form
        if isinstance(self.overrides, Mapping):
            object.__setattr__(
                self, "overrides", tuple(self.overrides.items())
            )

    @property
    def overrides_dict(self) -> Dict[str, Any]:
        return dict(self.overrides)


@dataclasses.dataclass
class FleetSpec:
    """The whole fleet: members + scheduling/gate/selection budgets.

    ``max_restarts`` is the per-member budget for *crash* exits (nonzero,
    non-``requeue_exit_code``) before the member is marked failed;
    preemptions (exit == ``requeue_exit_code``) requeue against the
    separate ``max_requeues`` safety bound and never consume the crash
    budget — a preempted member did nothing wrong.
    """

    members: Tuple[MemberSpec, ...]
    base_args: Tuple[str, ...] = ()
    max_workers: int = 2
    max_restarts: int = 2
    max_requeues: int = 8
    requeue_exit_code: int = 75
    requeue_backoff: float = 1.0    # base seconds; ×2^(n-1), capped
    backoff_cap: float = 30.0
    gate_reference: Optional[str] = None  # member id; default: first
    gate_threshold_pct: float = 200.0
    gate_min_ms: float = 5.0
    cull_bottom_k: int = 0
    poll_interval: float = 0.2
    scrape_interval: float = 2.0
    # PBT exploit/explore: after a round's cull, respawn the
    # culled members from the winner's checkpoint with perturbed
    # hyperparameters and drive another round — up to pbt_rounds times.
    # pbt_iterations is the per-respawn iteration budget (default: the
    # member's remaining budget past the winner's resume step, min 1);
    # pbt_perturb is the multiplicative explore factor (×(1±p)).
    pbt_rounds: int = 0
    pbt_iterations: Optional[int] = None
    pbt_perturb: float = 0.2

    def __post_init__(self):
        self.members = tuple(
            m if isinstance(m, MemberSpec) else MemberSpec(**m)
            for m in self.members
        )
        if not self.members:
            raise ValueError("FleetSpec needs at least one member")
        ids = [m.member_id for m in self.members]
        dupes = {i for i in ids if ids.count(i) > 1}
        if dupes:
            raise ValueError(f"duplicate member ids: {sorted(dupes)}")
        if self.max_workers < 1:
            raise ValueError(
                f"max_workers must be >= 1, got {self.max_workers}"
            )
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if self.max_requeues < 0:
            raise ValueError(
                f"max_requeues must be >= 0, got {self.max_requeues}"
            )
        if not 0 < self.requeue_exit_code < 256:
            raise ValueError(
                "requeue_exit_code must be in (0, 255], got "
                f"{self.requeue_exit_code}"
            )
        if self.requeue_backoff < 0 or self.backoff_cap < 0:
            raise ValueError("backoff values must be >= 0")
        if self.cull_bottom_k < 0:
            raise ValueError(
                f"cull_bottom_k must be >= 0, got {self.cull_bottom_k}"
            )
        if self.cull_bottom_k >= len(self.members):
            raise ValueError(
                f"cull_bottom_k={self.cull_bottom_k} would cull the whole "
                f"fleet of {len(self.members)}"
            )
        if self.gate_reference is not None and self.gate_reference not in ids:
            raise ValueError(
                f"gate_reference {self.gate_reference!r} is not a member "
                f"(have {ids})"
            )
        if self.poll_interval <= 0 or self.scrape_interval <= 0:
            raise ValueError("poll/scrape intervals must be > 0")
        if self.pbt_rounds < 0:
            raise ValueError(
                f"pbt_rounds must be >= 0, got {self.pbt_rounds}"
            )
        if self.pbt_iterations is not None and self.pbt_iterations < 1:
            raise ValueError(
                f"pbt_iterations must be >= 1, got {self.pbt_iterations}"
            )
        if not 0 < self.pbt_perturb < 1:
            raise ValueError(
                f"pbt_perturb must be in (0, 1), got {self.pbt_perturb}"
            )
        self.base_args = tuple(str(a) for a in self.base_args)

    @property
    def reference_id(self) -> str:
        return self.gate_reference or self.members[0].member_id


# ---------------------------------------------------------------------------
# grid expansion
# ---------------------------------------------------------------------------


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    if tok.lower() in ("true", "false"):
        return tok.lower() == "true"
    return tok


def _parse_values(raw: str) -> List[Any]:
    raw = raw.strip()
    m = re.fullmatch(r"(-?\d+)\.\.(-?\d+)", raw)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ValueError(f"empty range {raw!r} (hi < lo)")
        return list(range(lo, hi + 1))
    vals = [_parse_scalar(v) for v in raw.split("|") if v.strip()]
    if not vals:
        raise ValueError(f"no values in {raw!r}")
    return vals


def expand_grid(grid: str) -> List[MemberSpec]:
    """``"seed=0..2,cg_damping=0.1|0.3"`` → the 6-member cartesian
    product, ids from the varying fields (a single-valued field pins a
    constant and stays out of the id)."""
    fields: List[Tuple[str, List[Any]]] = []
    for part in grid.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"grid field {part!r} must look like name=values"
            )
        name, _, raw = part.partition("=")
        name = name.strip()
        if not name:
            raise ValueError(f"grid field {part!r} has no name")
        fields.append((name, _parse_values(raw)))
    if not fields:
        raise ValueError(f"empty grid spec {grid!r}")
    varying = [name for name, vals in fields if len(vals) > 1]
    combos: List[Dict[str, Any]] = [{}]
    for name, vals in fields:
        combos = [{**c, name: v} for c in combos for v in vals]
    members = []
    seen: Dict[str, int] = {}
    for i, combo in enumerate(combos):
        if varying:
            mid = "-".join(f"{k}{combo[k]}" for k in varying)
            # ids are [A-Za-z0-9._=-]: values like gymproc:CartPole-v1
            # are legitimate grid members, so out-of-alphabet chars
            # sanitize to '-' instead of failing the whole spec …
            mid = re.sub(r"[^A-Za-z0-9._=-]", "-", mid)
        else:
            mid = f"m{i}"
        # … and two values that collide after sanitization get a
        # positional suffix rather than tripping the duplicate check
        if mid in seen:
            seen[mid] += 1
            mid = f"{mid}-{seen[mid]}"
        else:
            seen[mid] = 0
        members.append(MemberSpec(mid, tuple(combo.items())))
    return members


# ---------------------------------------------------------------------------
# spec files
# ---------------------------------------------------------------------------

_SPEC_KEYS = {f.name for f in dataclasses.fields(FleetSpec)}


def load_spec_file(path: str) -> FleetSpec:
    """JSON spec file → :class:`FleetSpec`. Shape::

        {"base_args": ["--preset", "cartpole", "--iterations", "6"],
         "max_workers": 2,
         "members": [
           {"id": "ref", "overrides": {"seed": 0}},
           {"id": "chaos", "overrides": {"seed": 1,
            "inject_faults": "sigterm@iter=2"}}]}

    Unknown top-level keys fail loudly — a typoed budget silently using
    its default is how a chaos fleet runs without its chaos.
    """
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: spec must be a JSON object")
    members_raw = raw.pop("members", None)
    if not isinstance(members_raw, list) or not members_raw:
        raise ValueError(f"{path}: spec needs a non-empty 'members' list")
    members = []
    for i, m in enumerate(members_raw):
        if not isinstance(m, dict):
            raise ValueError(f"{path}: members[{i}] must be an object")
        mid = m.get("id") or m.get("member_id") or f"m{i}"
        overrides = m.get("overrides") or {}
        if not isinstance(overrides, dict):
            raise ValueError(
                f"{path}: members[{i}].overrides must be an object"
            )
        members.append(MemberSpec(str(mid), tuple(overrides.items())))
    unknown = set(raw) - _SPEC_KEYS
    if unknown:
        raise ValueError(
            f"{path}: unknown spec keys {sorted(unknown)} "
            f"(have {sorted(_SPEC_KEYS - {'members'})})"
        )
    return FleetSpec(members=tuple(members), **raw)


# ---------------------------------------------------------------------------
# argv rendering
# ---------------------------------------------------------------------------


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def member_cli_args(member: MemberSpec) -> List[str]:
    """Render a member's overrides as train-CLI args (``True`` → bare
    flag, ``False``/``None`` → omitted — a store_true flag cannot be
    negated through an override; leave it out of ``base_args`` instead)."""
    args: List[str] = []
    for name, val in member.overrides:
        if val is None or val is False:
            continue
        if val is True:
            args.append(_flag(name))
        else:
            args.extend([_flag(name), str(val)])
    return args


def _scan_iterations(args: Tuple[str, ...]) -> Optional[int]:
    it = None
    args = list(args)
    for i, a in enumerate(args):
        if a == "--iterations" and i + 1 < len(args):
            try:
                it = int(args[i + 1])
            except ValueError:
                pass
        elif a.startswith("--iterations="):
            try:
                it = int(a.split("=", 1)[1])
            except ValueError:
                pass
    return it


def member_total_iterations(
    spec: FleetSpec, member: MemberSpec
) -> Optional[int]:
    """The member's TOTAL iteration budget (override wins over base
    args), or None when neither states one. The scheduler needs this to
    relaunch a preempted member with ``--iterations`` = *remaining*
    (total − resumed checkpoint step) — the zero-lost-iterations
    contract: a resumed ``learn()`` runs its budget *in addition to* the
    restored counter."""
    ov = member.overrides_dict.get("iterations")
    if ov is not None:
        return int(ov)
    return _scan_iterations(spec.base_args)
