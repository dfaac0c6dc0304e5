"""Small shapes of each cell for the CPU tests: the widths the card runs
would take minutes on a CPU. Only sizes change; every other key of the
configuration is the cell's own."""

from benchmark.spec import Cell

SMALL = {
    "humanoid-sim": {"obs_shape": [11], "hidden": [32, 32], "n_envs": 8,
                     "steps_per_env": 64},
    "pong-sim": {"obs_shape": [36, 36, 4], "hidden": [16], "n_envs": 4,
                 "steps_per_env": 8},
}

CELLS = ("humanoid-sim.update", "pong-sim.update",
         "humanoid-sim.update-pinned")


def small_config(cell_name: str) -> dict:
    cell = Cell(cell_name)
    return dict(cell.config, **SMALL[cell.config["name"]])
