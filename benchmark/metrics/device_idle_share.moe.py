"""1 − the union of device spans over the traced window's wall time, %."""
from benchmark.metrics.common import idle


def read(ctx):
    return idle(ctx, "train", "device_idle_share.moe")
