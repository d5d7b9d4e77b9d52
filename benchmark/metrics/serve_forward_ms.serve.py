"""The host's time in each chunk's forward and softmax (span
``serve.forward``), ms per traced request."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "serve", "serve.forward", "serve_forward_ms.serve")
