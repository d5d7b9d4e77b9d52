"""Process start to the first timed step: imports, kernel build or load,
model, weights, inputs, warm-up and the checked steps."""


def read(ctx):
    return ctx["setup_s"]
