"""Policy updates completed in the window over the window's whole time
(host clock; the window ends in a ``torch.cuda.synchronize()``)."""


def read(ctx):
    return ctx.n_updates / ctx.window_s
