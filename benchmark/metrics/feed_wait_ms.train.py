"""The train step's wait for its batch in the ``Prefetcher`` (span
``feed.wait``), ms per traced step."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "feed.wait", "feed_wait_ms.train")
