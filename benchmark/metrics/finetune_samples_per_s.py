"""Samples of the optimizer steps completed in the window over the window's
time, up to the synchronised end of its last call."""


def read(ctx):
    raw = ctx["raw"]
    if raw["kind"] != "train":
        return None
    return raw["samples"] / raw["window_s"]
