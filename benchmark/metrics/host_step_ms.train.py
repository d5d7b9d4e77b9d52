"""The host's time in each call into the step (it returns without waiting
for the device), per optimizer step, mean over the window, ms."""
import statistics


def read(ctx):
    raw = ctx["raw"]
    if raw["kind"] != "train" or not raw["host_step_s"]:
        return None
    return 1e3 * statistics.fmean(raw["host_step_s"])
