"""Model FLOPs of the window's work over its time × the bf16 peak, %."""
from benchmark.metrics.common import mfu


def read(ctx):
    return mfu(ctx, "train", "mfu.moe")
