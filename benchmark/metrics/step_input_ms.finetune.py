"""The superbatch's copy into the graph's static buffers
(``MultiTrainStep.load``, span ``step.input``), ms per traced optimizer
step. Its note sums the wait and the copy against the traced call's host
time (the rest is the replay's launch)."""
from benchmark.metrics.spans import ms_per_unit, sum_against


def read(ctx):
    v = ms_per_unit(ctx, "train", "step.input", "step_input_ms.finetune")
    if v is not None:
        sum_against(ctx, "train", ("feed.wait", "step.input"),
                    "step_input_ms.finetune")
    return v
