"""The window attention kernels' bound over their device time, %."""
from benchmark.metrics.common import ATTENTION, roofline


def read(ctx):
    return roofline(ctx, "serve", ATTENTION, "attn_s", "attn_roofline.serve")
