"""Process start to the first timed update: imports, CUDA start, the
kernel library's build or load, the inputs, the warm-up updates."""


def read(ctx):
    return ctx.setup_s
