"""The fused MLP + LayerNorm kernels' bound over their device time, %."""
from benchmark.metrics.common import MLP, roofline


def read(ctx):
    return roofline(ctx, "train", MLP, "mlp_s", "mlp_roofline.finetune")
