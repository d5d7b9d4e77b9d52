"""The traffic generator: the same seed gives the same arrays, another
seed other arrays; serving sizes are one multiset in another order."""

import numpy as np
import pytest
import torch

from benchmark.lib import traffic
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _e2e(seed):
    c = tiny.cell("e2e_train_b16")
    return traffic.batches(c["traffic"], c["model"]["data"], 2, 4, seed, CPU)


@pytest.mark.parametrize("key", ["func_ids", "node_ids", "image", "pos",
                                 "adj", "node_mask", "label"])
def test_rows_repeat_by_seed(key):
    a, b, c = _e2e(2 ** 31 + 5), _e2e(2 ** 31 + 5), _e2e(7)
    assert all(np.array_equal(x[key], y[key]) for x, y in zip(a, b))
    if key != "label":
        assert not all(np.array_equal(x[key], y[key]) for x, y in zip(a, c))


def test_rows_are_framed_and_valid():
    b = _e2e(11)[0]
    assert (b["func_ids"][:, :3] == [0, 5, 2]).all()
    assert (b["node_mask"].sum(1) >= 2).all()
    valid = b["node_mask"] > 0
    assert (b["node_ids"][~valid] == traffic.PAD).all()
    idx = np.arange(b["adj"].shape[1])
    assert (b["adj"][:, idx, idx][valid] == 15).all()


def test_images_repeat_and_differ():
    a = traffic.image_batches(2, 3, 16, 123, CPU)
    b = traffic.image_batches(2, 3, 16, 123, CPU)
    c = traffic.image_batches(2, 3, 16, 124, CPU)
    assert np.array_equal(a[1]["image"], b[1]["image"])
    assert not np.array_equal(a[1]["image"], c[1]["image"])


def test_request_sizes_same_multiset_other_order():
    p = tiny.cell("e2e_serve_ci")["traffic"]
    full = traffic.request_sizes(p, 1, 5 * p["block"])
    other = traffic.request_sizes(p, 2, 5 * p["block"])
    assert sorted(full) == sorted(other) and full != other
    assert traffic.requests(p, 24, 3, 50) == traffic.requests(p, 24, 3, 50)
    assert all(lo + n <= 24 for lo, n in traffic.requests(p, 24, 3, 50))
