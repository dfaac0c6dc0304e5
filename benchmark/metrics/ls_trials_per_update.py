"""Line-search trials an update over the window
(``TRPOStats.linesearch_trials``: the trials up to the first accepted)."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["linesearch_trials"] for r in ctx.records) / len(ctx.records)
