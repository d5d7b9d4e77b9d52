"""The counters against hand counts."""

from benchmark.counts import common


def test_one_swin_block_by_hand():
    # one stage of one block: 448-pixel image, patch 4 → 112² tokens of
    # width 128, window 28 (784 tokens), 4 heads
    s = {"img": 448, "patch": 4, "chans": 3, "embed": 128, "depths": [1],
         "heads": [4], "window": 28}
    L, C, N = 112 * 112, 128, 784
    patch = 2 * L * 48 * C
    qkv, proj, mlp = 2 * L * C * 3 * C, 2 * L * C * C, 2 * 2 * L * C * 4 * C
    attn = 2 * 2 * (L // N) * N * N * C          # q·kᵀ and p·v per window
    cpb = 2 * 55 * 55 * 2 * 512 + 2 * 55 * 55 * 512 * 4
    assert common.swin_flops(s, 1) == patch + qkv + proj + mlp + attn + cpb


def test_one_roberta_layer_by_hand():
    t = {"hidden": 768, "layers": 1, "intermediate": 3072}
    T, H, I = 512, 768, 3072
    qkv, out = 3 * 2 * T * H * H, 2 * T * H * H
    scores, ctx = 2 * T * T * H, 2 * T * T * H
    mlp = 2 * T * H * I * 2
    assert common.roberta_flops(t, [T]) == qkv + out + scores + ctx + mlp


def test_bounds_take_the_larger_term():
    # a big GEMM is bound by operations, a thin one by bytes
    assert common.mlp_bound(1 << 20, 512, False) > 0
    big = common.mlp_bound(1 << 20, 512, False)
    assert abs(big - 4.0 * (1 << 20) * 512 * 2048 / 989e12) < 1e-12
    thin = common.mlp_bound(1, 512, False)
    assert abs(thin - (2 * 512 * 2 + 2 * 512 * 2048 * 4) / 3.35e12) < 1e-15
