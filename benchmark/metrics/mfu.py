"""The whole update's share of the card's dense TF32 peak over the
window: the model operations of every update the window completed, over
the window's time times the peak. An update's operations, from the
shapes (``flops/<family>``) and its own counts: the ``old_dist`` forward
and the gradient on the batch; for each solve that ran, the forward its
products read and (CG iterations + 1) Fisher-vector products on its
rows; the preconditioner's refresh where it ran; a forward on the batch
for each line-search trial. Never from time."""


def update_flops(ctx, r) -> int:
    f, c, rows = ctx.flops, ctx.config, ctx.rows
    total = 2 * f.forward(c, rows) + f.gradient(c, rows)
    total += (r["linesearch_trials"] - 1) * f.forward(c, rows)
    for solve_rows, iters in r["solves"]:
        total += f.operator_build(c, solve_rows)
        total += (iters + 1) * f.fvp(c, solve_rows)
    if r["refreshed"]:
        total += f.precond_refresh(c, ctx.subsample_rows)
    return total


def read(ctx):
    if ctx.peak is None or not ctx.records:
        return None
    flops = sum(update_flops(ctx, r) for r in ctx.records)
    return 100.0 * flops / (ctx.window_s * ctx.peak["tf32_flops"])
