"""Slicing, tail padding and the copies to the card of each chunk
(span ``serve.input``), ms per traced request."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "serve", "serve.input", "serve_input_ms.serve")
