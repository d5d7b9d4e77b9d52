"""The host's time in the train step's forward and loss (span
``step.forward``), ms per traced step."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "step.forward", "forward_ms.train")
