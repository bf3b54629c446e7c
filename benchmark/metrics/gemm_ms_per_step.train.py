"""Device milliseconds a training step in cuBLAS's kernels (the frozen
categories of ``yardstick/categories.py``), over the traced window's
steps."""

from benchmark.yardstick.categories import category


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds = ctx.trace.seconds(lambda name: category(name) == "GEMM")
    return 1e3 * seconds / ctx.trace.units if seconds > 0 else None
