"""The multi-step call's wait for its superbatch in the ``Prefetcher``
(span ``feed.wait``), ms per traced optimizer step."""
from benchmark.metrics.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, "train", "feed.wait", "feed_wait_ms.finetune")
