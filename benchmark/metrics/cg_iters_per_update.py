"""CG iterations an update over the window: ``TRPOStats.cg_iterations``,
plus ``cg_iterations_cheap`` on an audited update (whose used solve is
the full one)."""


def read(ctx):
    if not ctx.records:
        return None
    total = sum(r["cg_iterations"]
                + (r["cg_iterations_cheap"] if r["audited"]
                   and r["cg_iterations_cheap"] >= 0 else 0)
                for r in ctx.records)
    return total / len(ctx.records)
