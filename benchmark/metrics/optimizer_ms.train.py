"""The host's time in the clip's norm and the optimizer's update (span
``step.optimizer``), ms per traced step. Its note sums the eager step's
phases against the traced steps' own host time."""
from benchmark.metrics.spans import ms_per_unit, sum_against

PHASES = ("feed.wait", "step.input", "step.forward", "step.backward",
          "step.optimizer")


def read(ctx):
    v = ms_per_unit(ctx, "train", "step.optimizer", "optimizer_ms.train")
    if v is not None:
        sum_against(ctx, "train", PHASES, "optimizer_ms.train")
    return v
