"""The ``Prefetcher`` thread's time to pull and page-lock one batch
(span ``feed.make``), ms per batch made while traced."""
from benchmark.metrics.spans import ms_per_item


def read(ctx):
    return ms_per_item(ctx, "feed.make", "feed_make_ms.train")
