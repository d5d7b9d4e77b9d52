"""The batch's copy to the card (``to_device``, span ``step.input``), ms
per traced step."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "step.input", "step_input_ms.train")
