"""``torch.cuda.max_memory_allocated()`` over the run (reset at its
start, read when the window closes), in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30
