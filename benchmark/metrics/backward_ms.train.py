"""The host's time in the train step's backward (span ``step.backward``),
ms per traced step."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "step.backward", "backward_ms.train")
