"""The ``Prefetcher`` thread's time to stack and page-lock one superbatch
(span ``feed.make``), ms per superbatch made while traced, over its K
optimizer steps."""
from benchmark.metrics.spans import ms_per_item


def read(ctx):
    return ms_per_item(ctx, "feed.make", "feed_make_ms.finetune")
