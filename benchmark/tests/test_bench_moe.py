"""The Swin-MoE cell on the CPU at tiny widths: the entry
``train_multi_moe`` drives the system's plain layers in fp32, the
reference ``follow_moe`` agrees with it, the control (the reference in fp8
in the system's place) and a frozen step read not correct, and the
window's counters reach ``moe_slot_fill.moe``."""

import copy
import time

import torch

from benchmark import run
from benchmark.lib import checks, common
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
SWIN = {"img": 64, "patch": 4, "chans": 3, "embed": 16, "depths": [2, 2],
        "heads": [2, 4], "window": 4, "mlp_ratio": 4.0,
        "drop_path_rate": 0.2}
MOE = {"blocks": [[1], [0, 1]], "experts": 4, "top_k": 1,
       "capacity_factor": 1.0, "gate_noise": 1.0, "aux_weight": 0.01,
       "drop": 0.1, "bpr": True, "gshard_loss": False, "fc2_bias": False}


def _cell():
    c = copy.deepcopy(common.cell("swin_moe_ft_b128_k8"))
    m = c["model"]
    opts = list(m["opts"])
    widths = {"MODEL.SWIN_MOE.EMBED_DIM": 16, "MODEL.SWIN_MOE.DEPTHS": [2, 2],
              "MODEL.SWIN_MOE.NUM_HEADS": [2, 4],
              "MODEL.SWIN_MOE.WINDOW_SIZE": 4, "DATA.IMG_SIZE": 64,
              "MODEL.SWIN_MOE.MOE_BLOCKS": MOE["blocks"],
              "MODEL.SWIN_MOE.NUM_LOCAL_EXPERTS": 4,
              "MODEL.SWIN_MOE.CAPACITY_FACTOR": 1.0,
              "PARALLEL.DTYPE": "float32", "TRAIN.FUSED_STEPS": 2,
              "TRAIN.WEIGHT_DECAY": 0.005}
    for i in range(0, len(opts), 2):
        if opts[i] in widths:
            opts[i + 1] = widths[opts[i]]
    m.update(swin=SWIN, moe=MOE, data={"img_size": 64}, opts=opts,
             optimizer=tiny.OPT)
    c["traffic"].update(batch=4, fused_steps=2, pool_batches=6, lr=1e-4)
    c["limits"] = dict(tiny.LIMITS)
    return c


def _measure(traced=False):
    return run.measure(_cell(), common.manifest(), SEED, 0.3, traced, CPU,
                       time.perf_counter())


def test_reference_agrees_with_the_plain_path():
    result, numbers, notes = _measure()
    assert result["correct"], numbers
    assert set(result["metrics"]) == {"finetune_samples_per_s",
                                      "train_peak_mem_gib", "setup_s"}


def test_slot_fill_reads_the_counters():
    c = _cell()
    entry, setup_s, raw, peak = run.run_program(c, SEED, 0.3, False, CPU,
                                                time.perf_counter())
    moe = raw["moe"]
    assert 0 < moe["kept"] <= min(moe["routed"], moe["slots"])
    steps = raw["steps"]
    # per step: 16² tokens in stage 1's block, 8² in each of stage 2's two
    assert moe["routed"] == steps * 4 * (16 * 16 + 2 * 8 * 8)
    reader = common.load_module(f"{common.BENCH_DIR}/metrics/"
                                "moe_slot_fill.moe.py")
    ctx = {"raw": raw, "notes": []}
    assert reader.read(ctx) == 100.0 * moe["kept"] / moe["slots"]
    assert "dropped" in ctx["notes"][0]
    assert reader.read({"raw": {"kind": "train"}, "notes": []}) is None


def test_control_in_fp8_is_not_correct():
    c = _cell()
    entry, *_ = run.run_program(c, SEED, 0.3, False, CPU, time.perf_counter())
    ref = entry.reference("fp32")
    numbers = run.numbers_of(entry, ref, entry.reference("fp8"))
    assert not checks.judge(numbers, c["limits"]), numbers


def test_frozen_step_is_not_correct(monkeypatch):
    from mvuld_tpu_torch.core import optim
    monkeypatch.setattr(optim.Optimizer, "update", lambda self, grads: None)
    result, numbers, _ = _measure()
    assert not result["correct"], numbers
