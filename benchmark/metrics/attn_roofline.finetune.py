"""The window attention kernels' bound over their device time, %."""
from benchmark.metrics.common import ATTENTION, roofline


def read(ctx):
    return roofline(ctx, "train", ATTENTION, "attn_s",
                    "attn_roofline.finetune")
