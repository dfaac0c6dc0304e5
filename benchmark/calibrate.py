"""Readings the output check's limits are set from (``limits/``), on the
card at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload humanoid-sim.update \\
        --seeds 101,102,103 [--control] [--faults] [--out FILE]

For each seed it draws the cell's weights and batches, runs the program's
check updates as a run's set-up does, frees the program's state, runs
the f32 reference, and prints the four compared numbers of

* ``program``: the program against the reference (sound runs: the lower
  readings);
* ``control`` (``--control``): the reference with TF32 on, in the
  program's place (the upper readings);
* ``half_batch`` (``--faults``): the reference on the first half of each
  batch's rows, in the program's place (a planted fault).

A state left unchanged reads 1 on ``change`` by construction and needs no
run. One JSON line a seed goes to standard output (and to ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def readings(cell_name: str, seed: int, device: str, control: bool,
             faults: bool) -> dict:
    import torch

    from benchmark import check
    from benchmark.spec import Cell

    cell = Cell(cell_name)
    wl = cell.unit.Workload(cell, seed, torch.device(device))
    wl.build_program()
    t = time.monotonic()
    prog = wl.check_program()
    program_s = time.monotonic() - t
    wl.drop_program()
    t = time.monotonic()
    ref = check.reference_readings(cell, wl)
    out = {"seed": seed, "program_s": program_s,
           "reference_s": time.monotonic() - t,
           "program": check.numbers(prog, ref, wl.params0, detail=True),
           "surrogate_after": ref["surrogate_after"], "kl": ref["kl"]}
    if control:
        ctrl = check.reference_readings(cell, wl, precision="tf32")
        out["control"] = check.numbers(ctrl, ref, wl.params0)
    if faults:
        half = check.reference_readings(cell, wl, half_batch=True)
        out["half_batch"] = check.numbers(half, ref, wl.params0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    from trpo_torch.ops import _build

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    _build.build()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(dict(readings(args.workload, seed, "cuda",
                                        args.control, args.faults),
                               workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
