"""K1's share of its roofline: the least time one Fisher-vector product
at its shape could take on the card, over the device time K1's kernels
took a product in the traced stretch (their summed profiler time over
``LAUNCHES["fused_fvp"]``). The least time is the larger of the
product's operations, counted once (``flops/<family>.fvp``), at the
dense TF32 peak, and its input and output bytes, each once
(``flops/<family>.fvp_bytes``), at the memory bandwidth. The count does
not depend on how the product is computed (K1 runs 3xTF32: three
products for each counted one)."""

KERNELS = ("fvp_sweep_kernel", "fvp_wgrad_kernel", "fvp_reduce_kernel",
           "fvp_unpack_kernel")


def read(ctx):
    launches = ctx.trace_launches.get("fused_fvp", 0)
    if ctx.trace is None or ctx.peak is None or launches == 0:
        return None
    per_call = ctx.trace.kernel_seconds(KERNELS) / launches
    if per_call <= 0:
        return None
    bound = max(ctx.flops.fvp(ctx.config, ctx.fvp_rows)
                / ctx.peak["tf32_flops"],
                ctx.flops.fvp_bytes(ctx.config, ctx.fvp_rows)
                / ctx.peak["hbm_bytes_per_s"])
    return 100.0 * bound / per_call
