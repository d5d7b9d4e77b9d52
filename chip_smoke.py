#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mvuld_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels of
     ``mvuld_tpu_torch/csrc`` with nvcc (all sources at once) and print the
     build seconds and ptxas's resource lines;
  2. hold each kernel against its plain PyTorch version on the card and
     time the kernel, the plain version and, where one exists, the one
     PyTorch call that computes the same function (the library yardstick),
     beside the bound computed from the shapes: the forward kernels K1,
     K3, K4 (K1 with its row sums, K4 with and without its keep-mask) at
     the shapes one bucket-16 forward gives them, the backward kernels K2,
     K3b, K4b at the shapes one batch-16 training step gives them; K1, K2,
     K5 (also against K2), K3 and K3b at the shapes one batch-64 SwinV2
     fine-tune step gives them (the plain attention versions over chunks
     of windows there), with a profile of one K1, one K2 and one K5
     launch by pass; K1, K2 and K5 on fp32 inputs, with bf16 product operands
     (``mxu_bf16``) and on a row whose row sum underflows, and K2's time
     with ``mxu_bf16``; K6/K6b at blockbench's stage-3 shapes; K3/K3b,
     K4/K4b and K6/K6b also on fp32 x (one shape each), with a profile of
     one K4b launch at the ``lines`` shape by pass; and the
     head-layout K8/K8b (mask operand) and map-layout K7/K7b (mask
     synthesised, fp32 outputs) at the bucket-16 geometry of every stage,
     plus one fp32 case and K7/K7b with bf16 product operands;
  3. serve 37 seeded requests at full width (SwinV2-Base-448 window 28,
     UniXcoder-base, the multi_defect_new_gcn head) through the kernels,
     counting each kernel's launches, then again through the plain layers,
     and compare P(vul); profile one forward of each path;
  4. train: one epoch of three batch-16 AdamW steps through the trainer
     CLI (``train_e2e.main``, kernels on, Swin stage 2 checkpointed) from a
     seeded synthetic cache, counting every kernel's launches; then, with
     one seeded generator per path, the first step's loss and gradients
     through the kernels against the plain layers, both held against the
     plain layers in fp32 (the bf16 plain path's own error sets the bound
     of the tensors whose exact gradient cancels), timed steps of both
     paths (ms/step, functions/s, peak memory) and a profile of one
     kernel-path step;
  5. the SwinV2 fine-tune (``train_swin``) alone at the published 448
     config, batch 64 (an out-of-memory error fails the run):
     ``--throughput`` through the kernels; a warm-up and
     three AdamW steps with mixup soft targets through the kernels under
     the v2 backward (K2) and then the v1 backward (K5), counting every
     kernel's launches (K1 once per block: never rerun in the checkpointed
     stage); the first step's gradients of both generations and of the
     plain layers against the plain layers in fp32 at batch 16, and v1
     against v2;
     a profile of one step of each generation;
  6. TRAIN.FUSED_STEPS as a CUDA graph (``make_multi_train_step``) on the
     same fine-tune, K 8 at batch 64: 8 replayed steps against 8 eager
     steps from one saved state (losses, the update, the DropPath masks),
     the capture's seconds, ms/step eager and by replay, images/s, peak
     memory, a profile of one replay beside one eager step;
     ``train_swin.main --opts TRAIN.FUSED_STEPS 4`` in a world-1 NCCL
     group (the Prefetcher, BEST_FETCH async, a remainder of single steps)
     against the unfused run; a capture with dropout in the checkpointed
     stage at reduced depth; the kernels counted as captured launches ×
     replays;
  7. the block microbenchmark (``tools/blockbench.py``): its five variants
     of the stage-3 MLP half, fwd_bwd at batch 64, one JSON line each, the
     K6/K6b launches counted in v3's run;
  8. the op entry points: ``window_attention_map`` and ``window_attention``
     forward and backward through autograd at stage-1 (shifted) and stage-3
     full width, K7/K7b/K8/K8b launches counted, the map and head layouts
     held against each other on the same numbers re-laid and both against
     ``flat_attention`` (K1/K2); a profile of one K7, one K8b and one K7b
     launch;
  9. the staged path at full width from seeded arrays: a warm-up and three
     AdamW steps of the text classifier (``build_text_training``,
     UniXcoder-base, batch 16 × 512 tokens), the trained encoder and
     SwinV2-Base-448 as frozen featurizers filling the fusion cache columns
     (``encode_cache_columns``), and ``train_fusion.main`` on those caches
     with the splits resident on the card;
  10. the fusion zoo on those caches at production width: each of the 23
     keys of ``FUSION_MODELS`` at batch 32, one train-mode step (dropout
     0) on the card against the same weights on the CPU in fp32 (logits,
     loss, gradients, BatchNorm statistics), the time of a train step
     (dropout on, AdamW) and of an eval forward; ``train_fusion.main
     --arch`` for four keys; each bilinear operator's forward and backward
     on the card against the CPU;
  11. the OCR subsystem: EAST one train-mode step at batch 8 × 256² on the
     card against the CPU (fp64 and fp32), ``train_east.main`` for three
     epochs on a seeded canvas cache (timed step, images/s, peak memory),
     oracle score/geo maps decoded through the native NMS (every box back
     within 1 px), the eval forward at the four ``pad_to`` 256 input
     shapes, the host decode and one ``detect_array`` call timed;
  12. the baseline detectors: GloVe and SGNS at V 20000, dim 100 from
     seeded arrays (ms per epoch, card vs CPU in fp64 and fp32); Devign,
     ReVeal (GGNNSum, SMOTE, metric learner) and IVDetect at the JAX
     modules' widths, 100 nodes, batch 16, on features the port's
     ``build_*_features`` make from seeded synthetic functions: one step
     card vs CPU in fp64, the three trainers' epochs, timed and profiled
     steps, the TreeLSTM's share; the trained checkpoints served through
     ``eval_patches``;
  13. the Swin family through ``build_model``: SwinV1-B, Swin-MLP-B (224²),
     Swin-MoE-S (192², 8 experts on the card) and SwinV2-B 448 (through
     K1, K2, K3, K3b, counted) at the published widths, a warm-up and five
     AdamW steps at batch 64 each (ms/step, images/s, peak memory, the
     MoE's dropped share, a profiled step); each type card against CPU on
     one train-mode step at depths 2-2-2-2, fp64 and fp32 (the MoE's
     routings compared first);
  14. the causal text model (``UniXcoderLM`` at UniXcoder-base width,
     bf16): logits of 8 × 512 seeded tokens through K4 (counted) against
     the plain layers by the bf16 bound, card vs CPU in fp64 at 2 layers,
     ``beam_search_generate`` at beam 5 to 64 tokens over four seeded
     prefixes (fp32: kernel and plain ids identical; bf16: agreement
     printed), ms per generated token;
  15. the parallel layer: a world-1 NCCL group through ``train_e2e.main``'s
     data-parallel path (one batch-16 step, kernels counted); the pipelined
     ``train_text`` classifier (PARALLEL.PP 2 × 4 microbatches, both stages
     on the card, K4/K4b counted) against the sequential one; then two
     ranks on the one card over gloo (spawned, timed out as a whole): the
     dp e2e step at batch 16 (8 per rank; loss, gradients, BatchNorm
     statistics), the sequence-parallel flat attention at the fine-tune's
     shapes (dqkv, dbias, dscale; times beside the unsharded) and a
     SwinV2-B 448 batch-64 step through it (K1/K2 counted per rank), a
     tensor-parallel SwinV2-B step at mp 2, Swin-MoE-S's 8 experts over
     the two ranks (routing compared first) — each against one rank;
  16. the tools: ``convert_checkpoint swinv2`` 384/24 → 448/28 loaded as
     ``pipeline --swin-ckpt`` loads it (logits equal to the bit to
     ``load_pretrained_swinv2``'s on the card), ``traceparse`` over step
     4's exported trace against ``key_averages()``, ``joern_json`` on a
     node/edge pair, ``results_table`` over the staged and baselines runs;
  17. print the kernels JSON line, the card line, and the result line last.

Needs no network and no package beyond torch and numpy: no JAX, PIL,
yaml, pandas or tokenizers (``serve`` takes the featurised arrays; the
trainer starts from a prebuilt cache and tokenizer.json).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

# Published H100 SXM peaks (dense): device memory 3.35 TB/s, bf16 tensor
# cores 989 TFLOP/s, and the special-function units' exp rate: 16 per SM
# per clock × 132 SMs × 1.98 GHz boost.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
SFU_EXP_S = 16 * 132 * 1.98e9

BATCH = 16          # serving bucket
N_REQUESTS = 37     # → buckets 16, 16 and 8
NODE_CAPACITY = 512
VOCAB = 4096        # train_e2e's tokenizer size
P_TOL = 1e-2        # |Δp| between the kernel and the plain serving paths
REPEATS = 3         # timed serves of the 37 requests, per path

# (stage, Bn, N, C, H, shift, nWh, launches per forward) at bucket 16
K1_SHAPES = [(1, 256, 784, 128, 4, 0, 4, 1), (1, 256, 784, 128, 4, 14, 4, 1),
             (2, 64, 784, 256, 8, 0, 2, 1), (2, 64, 784, 256, 8, 14, 2, 1),
             (3, 16, 784, 512, 16, 0, 1, 18), (4, 16, 196, 1024, 32, 0, 1, 2)]
# (label, M, C, launches per forward)
K3_SHAPES = [("stage1", 200704, 128, 2), ("stage2", 50176, 256, 2),
             ("stage3", 12544, 512, 18)]
K4_SHAPES = [("function", BATCH * 512, 768, 12),
             ("lines", NODE_CAPACITY * 64, 768, 12)]
# A batch-16 training step runs the same shapes, and each backward kernel
# once per forward launch: K2 as K1, K3b as K3, K4b as K4.
SWIN_BATCH = 64     # the SwinV2 fine-tune's batch
# its step runs K1, K2 or K5 and K3 (K3b) at 4× the bucket-16 windows or
# rows, the same number of times per step
SWIN_K1_SHAPES = [(s, Bn * SWIN_BATCH // BATCH, *rest)
                  for s, Bn, *rest in K1_SHAPES]
SWIN_K3_SHAPES = [(label, M * SWIN_BATCH // BATCH, C, n)
                  for label, M, C, n in K3_SHAPES]
# the fused_steps phase: TRAIN.FUSED_STEPS K steps as one CUDA graph
FUSED_K = 8              # bench.py's steps per dispatch
FUSED_REPLAYS = 3        # timed replays (their median)
FUSED_LOSS_TOL = 1e-6    # the K losses, replay against eager, fp32 relative
FUSED_UPDATE_TOL = 1e-5  # the update p_K − p_0, replay against eager, rel L2
FUSED_CLI_K = 4          # train_swin --opts TRAIN.FUSED_STEPS 4
FUSED_CLI_BATCH = 16
FUSED_CLI_SPLITS = (6 * FUSED_CLI_BATCH, 32, 32)   # 6 batches: 4 + 2 single
FUSED_DROP_K = 4         # the dropout capture (reduced depth)
FUSED_DROP_DEPTHS = [2, 2, 2, 2]
SCORE_BYTES = 2 ** 32    # a plain attention version's fp32 scores per chunk
KEEP = 0.9              # RoBERTa dropout 0.1: K4/K4b's keep probability
TRAIN_STEPS = 3          # timed steps per path, after one warm-up step
LOSS_TOL = 2e-2          # |Δ loss| of the first step, kernels vs plain
GRAD_TOL = 0.1           # per-tensor relative L2 of the first step's grads
GRAD_NOISE = 3.0         # … against fp32, or this × the plain bf16 path's

# K6 / K6b at blockbench's default shape (batch 64 at stage 3: M = 64·784,
# C = 512, Hd = 2048): (label, M, K, N, act, ln)
DENSE_SHAPES = [("fc1_gelu", 64 * 784, 512, 2048, "gelu", False),
                ("fc2_ln", 64 * 784, 2048, 512, "none", True)]
# … and at a row count that no tile divides (path "ragged")
DENSE_RAGGED = [("fc2_ln_ragged", 50000, 2048, 512, "none", True)]
VEC_TOL = 1e-3           # K6b's fp32 column sums, relative L2

# the staged path: functions cached and trained on (train / val / test),
# encoder batch, fusion batch and epochs
STAGED_SPLITS = (128, 16, 16)
ENCODE_BATCH = 32
FUSION_BATCH = 32
FUSION_EPOCHS = 3
# the op entry points' pass: these K1_SHAPES rows, once each
OPS_SHAPES = ((1, 14), (3, 0))         # (stage, shift)
# the fusion zoo on the staged caches: every key at batch 32, one
# train-mode step (dropout 0) on the card against the CPU, in fp64 and in
# fp32 (TF32 off): relative L2 of the logits, the loss and the BatchNorm
# statistics within ZOO_TOL, of each gradient tensor within ZOO_GRAD_TOL;
# in fp32, where that fails, the card's error from the CPU's fp64 result
# within ZOO_NOISE × the CPU fp32 result's own (gradients that cancel in
# exact arithmetic behind a train-mode BN over features nearly constant
# across the batch, the GRU keys' final state; var = E[x²] − E[x]² of a
# BN whose inputs share a large mean); ZOO_TIMED timed train steps
# (dropout on, AdamW) and eval forwards; the
# CLI for the paper's two ablation runs, the key that reads ntype and the
# GRU key with final dropout; every bilinear operator at 512 × 512 → 512,
# batch 256 (RelationalNetwork over sets of 16 × 512)
ZOO_BATCH = 32
ZOO_TOL = 1e-4
ZOO_GRAD_TOL = 1e-3
ZOO_NOISE = 3.0
ZOO_TIMED = 5
ZOO_CLI_KEYS = ("multi_defect_nofunc", "multi_defect_nograph",
                "multi_defect_allnode", "multi_defect_grudot")
ZOO_PROFILED = "multi_defect_grudot"   # the slowest step: a profile of one
BILINEAR_BATCH = 256
BILINEAR_DIMS = (512, 512, 512)        # input_dims, output_dim
BILINEAR_SET = (16, 512)               # RelationalNetwork's N, D
# the OCR phase: EAST (half-channel VGG16-BN, ~4 M parameters, nothing cut)
# at the trainer's defaults, batch 8 × 256²; one train-mode step card vs
# CPU in fp64 and fp32 (TF32 off) with the zoo's bounds; train_east on 32
# seeded canvases for 3 epochs; detection at the input shapes that pad_to
# 256 gives the renderer's graphs (widths 472-569, heights 318-660 on 30
# synthetic functions)
OCR_BATCH = 8
OCR_SIZE = 256
OCR_TOL = 1e-4
OCR_GRAD_TOL = 1e-3
# fp32: where a tensor misses OCR_TOL / OCR_GRAD_TOL, the card's error from
# the CPU's fp64 result within OCR_NOISE × the CPU fp32 result's own. At
# initialisation the deep extractor layers' gradients cancel through the
# train-mode BatchNorms, so every fp32 result of them is far from fp64
# (the CPU's worst is printed); cuDNN's fp32 convolution algorithms land up
# to 3.94× further than the CPU's on an H100. The same step with cuDNN off
# (PyTorch's own CUDA convolution) and with TF32 convolutions, which the
# bound must catch, is printed beside.
OCR_NOISE = 10.0
OCR_CORPUS = 32
OCR_EPOCHS = 3
OCR_TIMED = 5
OCR_SHAPES = ((512, 512), (512, 768), (768, 512), (768, 768))   # (H, W)

# the baselines phase, at the JAX modules' default (the reference's) widths:
# Devign 132 → 200 (6 steps), GGNNSum 200 (8 steps), metric learner 256,
# IVDetect hidden 64 over 100-d GloVe tokens (SEQ_LEN 12); 100 nodes (the
# corpus funnel's line cap) and the CLI's batch of 16. The embedding
# trainers at the vocabulary cap (20000) and dim 100 from seeded arrays:
# GloVe over EMB_PAIRS Zipf-distributed nonzeros (the gathered [P, 100]
# fp32 operands are 1.6 GB each) for 40 epochs, as the IVDetect path runs
# it; SGNS on 8192-pair batches with 5 negatives for 60 epochs.
BASE_BATCH = 16
BASE_NODES = 100
BASE_CORPUS = (128, 16, 16)        # seeded synthetic functions per split
BASE_EPOCHS = 3                    # timed trainer epochs after one warm-up
BASE_TIMED = 5
EMB_VOCAB = 20000
EMB_DIM = 100
EMB_PAIRS = 4_000_000
EMB_CHECK_PAIRS = 200_000          # card vs CPU, 5 epochs each
# the checks' learning rates: GloVe's default; SGNS at 50, since at its
# default 0.05 five steps move its vectors by under 3e-6, so no check at
# 1e-4 could tell a right update from a missing one
EMB_CHECK_LR = {"glove": 0.05, "sgns": 50.0}
GLOVE_EPOCHS = 40
SGNS_EPOCHS = 60
# card vs CPU in fp64: the rel L2 of the vectors' difference to the
# update (the vectors minus their shared start), the rel loss, the rel L2
# of each gradient tensor (all measured ≤ 1e-14)
BASE_TOL64 = 1e-9
BASE_TOL32 = 1e-4      # fp32 vectors: max |card − CPU|, as the CPU tests

# the Swin family phase: build_model's four types at the published widths
# of the Swin Transformer repository (microsoft/Swin-Transformer), batch
# 64, bf16, one warm-up and FAMILY_TIMED AdamW steps each; card vs CPU on
# one train-mode step (dropout, DropPath and gate noise off) at the same
# widths with depths 2-2-2-2 and FAMILY_CHECK images, fp64 within
# FAMILY_TOL64 and fp32 by the zoo's rule (ZOO_TOL / ZOO_GRAD_TOL, else
# within ZOO_NOISE × the CPU fp32's own error from fp64)
FAMILY_BATCH = 64
FAMILY_TIMED = 5
FAMILY_CHECK = 2
FAMILY_TOL64 = 1e-9
# SwinV1-B: configs/swin/swin_base_patch4_window7_224.yaml (88 M
# parameters, 15.4 GFLOPs per 224² image forward, Swin paper Table 1)
SWIN_B = ["MODEL.TYPE", "swin", "DATA.IMG_SIZE", 224,
          "MODEL.SWIN.EMBED_DIM", 128, "MODEL.SWIN.DEPTHS", [2, 2, 18, 2],
          "MODEL.SWIN.NUM_HEADS", [4, 8, 16, 32], "MODEL.SWIN.WINDOW_SIZE", 7]
# Swin-MLP-B: configs/swinmlp/swin_mlp_base_patch4_window7_224.yaml
SWIN_MLP_B = ["MODEL.TYPE", "swin_mlp", "DATA.IMG_SIZE", 224,
              "MODEL.SWIN_MLP.EMBED_DIM", 128,
              "MODEL.SWIN_MLP.DEPTHS", [2, 2, 18, 2],
              "MODEL.SWIN_MLP.NUM_HEADS", [4, 8, 16, 32],
              "MODEL.SWIN_MLP.WINDOW_SIZE", 7]
# Swin-MoE-S: configs/swinmoe/swin_moe_small_patch4_window12_192_8expert_
# 32gpu_22k.yaml (MoE in the odd blocks of stage 3 and block 1 of stage 4,
# top-1, capacity factor 1.25). One deviation: the file spreads 8 experts
# over 32 GPUs (a negative NUM_LOCAL_EXPERTS, which build_model reads
# as one expert); here all 8 experts sit on the one card
SWIN_MOE_S = ["MODEL.TYPE", "swin_moe", "DATA.IMG_SIZE", 192,
              "MODEL.SWIN_MOE.EMBED_DIM", 96,
              "MODEL.SWIN_MOE.DEPTHS", [2, 2, 18, 2],
              "MODEL.SWIN_MOE.NUM_HEADS", [3, 6, 12, 24],
              "MODEL.SWIN_MOE.WINDOW_SIZE", 12,
              "MODEL.SWIN_MOE.MOE_BLOCKS",
              [[-1], [-1], [1, 3, 5, 7, 9, 11, 13, 15, 17], [1]],
              "MODEL.SWIN_MOE.NUM_LOCAL_EXPERTS", 8,
              "MODEL.SWIN_MOE.TOP_VALUE", 1,
              "MODEL.SWIN_MOE.CAPACITY_FACTOR", 1.25]
# the causal phase: UniXcoderLM at UniXcoder-base width (MODEL.UNIXCODER:
# 12 layers, H 768, 12 heads, FFN 3072, vocab 51416, 1026 positions),
# seed-0 weights, bf16: logits of CAUSAL_BATCH × CAUSAL_TOKENS tokens (tails
# padded); the kernel path's rel L2 from the plain fp32 layers within
# CAUSAL_NOISE × the plain bf16 layers' own; card vs CPU in fp64 at
# CAUSAL_DEPTH64 layers within CAUSAL_TOL64; beam search at beam BEAM to
# BEAM_MAX tokens over BEAM_PREFIXES seeded prefixes of BEAM_PREFIX tokens
CAUSAL_BATCH = 8
CAUSAL_TOKENS = 512
CAUSAL_NOISE = 3.0
CAUSAL_DEPTH64 = 2
CAUSAL_TOL64 = 1e-9
BEAM = 5
BEAM_MAX = 64
BEAM_PREFIXES = 4
BEAM_PREFIX = 16
# the parallel phase: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device), each check against one rank on the same work. The
# relative L2 of all gradients joined (and of all BatchNorm statistics) is
# held, the worst tensor printed: within PAR_TOL in fp32 (the dp e2e step
# at batch PAR_BATCH through the kernels, a tensor-parallel SwinV2-B 448
# step at batch TP_BATCH: only the order of reduced sums differs), within
# PAR_TOL16 in bf16 (SwinV2-B 448 at SWIN_BATCH with the sequence-parallel
# attention; the pipelined text classifier at PP_MICRO microbatches, whose
# smaller row counts pick other GEMM tilings), the losses within PAR_TOL
# relative (fp32) or LOSS_TOL (bf16); the sharded attention's out and
# dqkv within two bf16 ulps of the max (the same kernel on the same
# windows), dbias and dscale (sums over the ranks) within SP_TOL;
# Swin-MoE-S's 8 experts over the two ranks at PAR_MOE_BATCH images in
# fp32, logits by ZOO_TOL
PAR_BATCH = 16
PAR_TOL = 1e-4
PAR_TOL16 = 1e-2
SP_TOL = 1e-5
TP_BATCH = 8
PAR_MOE_BATCH = 16
PP_MICRO = 4
PAR_TIMEOUT = 600
# the tools phase: one Joern node/edge JSON pair (the shape of
# tests/test_joern_json.py's fixture)
JOERN_NODES = [
    {"id": 1, "_label": "METHOD", "name": "f", "code": "int f(int a)",
     "lineNumber": 1},
    {"id": 3, "_label": "CALL", "name": "<operator>.assignment",
     "code": "x = a + 1", "lineNumber": 3},
    {"id": 4, "_label": "CALL", "name": "<operator>.addition",
     "code": "a + 1", "lineNumber": 3},
    {"id": 5, "_label": "CALL", "name": "memcpy", "code": "memcpy(b, a, 4)",
     "lineNumber": 4},
    {"id": 6, "_label": "RETURN", "name": "", "code": "return x;",
     "lineNumber": 5},
    {"id": 7, "_label": "COMMENT", "name": "", "code": "// hi",
     "lineNumber": 2}]
JOERN_EDGES = [[3, 1, "AST", ""], [5, 1, "AST", ""], [6, 1, "AST", ""],
               [5, 3, "CFG", ""], [6, 5, "CFG", ""],
               [6, 3, "REACHING_DEF", "x"], [3, 1, "CONTAINS", ""]]
TRACE_TOL = 0.01        # traceparse's device total against key_averages'
PROFILES = {}           # profile_run's results by label, with a trace path

# the published 448 image config
# (configs/swinv2_base_patch4_window24to28_384to448_1ktoMYDATA_ft.yaml)
# plus UniXcoder-base and the multi_defect_new_gcn head, as opts: the card
# has no yaml
MODEL_OPTS = ["MODEL.SWINV2.EMBED_DIM", 128, "MODEL.SWINV2.DEPTHS", [2, 2, 18, 2],
              "MODEL.SWINV2.NUM_HEADS", [4, 8, 16, 32],
              "MODEL.SWINV2.WINDOW_SIZE", 28,
              "MODEL.SWINV2.PRETRAINED_WINDOW_SIZES", [12, 12, 12, 6],
              "MODEL.DROP_PATH_RATE", 0.2, "MODEL.NUM_CLASSES", 2,
              "DATA.IMG_SIZE", 448,
              "MODEL.UNIXCODER.HIDDEN", 768, "MODEL.UNIXCODER.LAYERS", 12,
              "MODEL.UNIXCODER.HEADS", 12, "MODEL.UNIXCODER.INTERMEDIATE", 3072,
              "DATA.FUNC_TOKENS", 512, "DATA.NODE_TOKENS", 64,
              "DATA.MAX_NODES", 100, "MODEL.MULTI.HIDDEN", 512,
              "MODEL.MULTI.NUM_RS_GCN", 8, "PARALLEL.DTYPE", "bfloat16",
              "TRAIN.FUSED_MLP", True]
# the JAX e2e training defaults (bench.py): batch 16, remat on Swin stage 2
# only, no text remat; one epoch of three steps, best snapshot params-only
# the SwinV2 fine-tune alone (train_swin): the same published config with
# its training settings, batch 64 as bench.py trains SwinV2 alone, bf16,
# the fused MLP on and the 18-block stage checkpointed; mixup/cutmix on
SWIN_OPTS = MODEL_OPTS[:16] + [
    "MODEL.LABEL_SMOOTHING", 0.1, "PARALLEL.DTYPE", "bfloat16",
    "TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True,
    "TRAIN.REMAT_STAGES", [2], "TRAIN.WARMUP_EPOCHS", 5,
    "TRAIN.WEIGHT_DECAY", 1e-8, "TRAIN.BASE_LR", 2e-5,
    "TRAIN.WARMUP_LR", 2e-8, "TRAIN.MIN_LR", 2e-7, "SEED", 0]
SWIN_BLOCKS = 24                # K1 launches per forward
TRAIN_OPTS = ["DATA.BATCH_SIZE", BATCH, "TRAIN.USE_CHECKPOINT", True,
              "TRAIN.REMAT_STAGES", [2], "TRAIN.TEXT_REMAT", "off",
              "TRAIN.EPOCHS", 1, "TRAIN.BEST_SAVE", "params", "SAVE_FREQ", 0,
              "PRINT_FREQ", 1, "SEED", 0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls, on
    CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_tol(ref) -> float:
    """Two bf16 ulps at the largest output: kernel and plain version both
    compute in fp32 and round once to bf16, so they may differ by a
    rounding step."""
    return 2.0 ** -6 * float(ref.abs().max())


def rel_err(got, want) -> float:
    """max |got − want| / max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def by_windows(fn, Bn, nW, H, N, n_summed=0, budget=None):
    """``fn(w)`` over slices ``w`` of whole images' windows (the shift mask
    repeats per image), each slice's fp32 [windows, H, N, N] scores within
    ``budget`` (SCORE_BYTES by default): the plain attention versions hold
    several such tensors at once, more than the card holds at the
    fine-tune's stage 1. The outputs are joined along windows; the last
    ``n_summed`` (dbias and dscale, sums over windows) are added."""
    import torch

    budget = budget or SCORE_BYTES
    step = max(nW, budget // (H * N * N * 4) // nW * nW)
    parts = [fn(slice(i, i + step)) for i in range(0, Bn, step)]
    k = len(parts[0]) - n_summed
    return (tuple(torch.cat([p[j] for p in parts]) for j in range(k))
            + tuple(sum(p[j] for p in parts) for j in range(k, len(parts[0]))))


def check_attention(dev, gen, rows, shapes, path):
    """K1 (output and row sums) and K2 at every stage's ``shapes``; on the
    fine-tune's path (``path`` "swin") also K5, against its plain version
    and against K2 on the same inputs. The plain versions run over chunks
    of windows (``by_windows``); the kernels over all of them at once."""
    import torch
    import torch.nn.functional as F

    from mvuld_tpu_torch.ops.window_attention import (
        shift_and_scale, window_attention_flat, window_attention_flat_bwd,
        window_attention_flat_bwd_plain, window_attention_flat_bwd_v1,
        window_attention_flat_bwd_v1_plain, window_attention_flat_plain,
        window_region_mask)

    for stage, Bn, N, C, H, shift, nW1, per_fwd in shapes:
        hd, nW = C // H, nW1 * nW1
        qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen
                          ).to(torch.bfloat16)
        bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                              generator=gen))
        ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=gen)
        args = (qkv, bias, ls, shift, nW1, nW1)
        chunks = lambda fn, n_summed=0: by_windows(  # noqa: E731
            fn, Bn, nW, H, N, n_summed)
        got = window_attention_flat(*args)
        out, r = chunks(lambda w: window_attention_flat_plain(
            qkv[w], *args[1:], return_rowsum=True))
        torch.cuda.synchronize()
        err = float((got.float() - out.float()).abs().max())
        tol = bf16_tol(out.float())

        # library yardstick: SDPA on pre-normalised q·scale, k, v with a
        # float mask of bias (+ the shift mask); timed only
        x = qkv.reshape(Bn, N, 3, H, hd).permute(2, 0, 3, 1, 4).float()
        scale, _ = shift_and_scale(ls, bias)
        q = x[0] * torch.rsqrt((x[0] ** 2).sum(-1, keepdim=True) + 1e-12)
        k = x[1] * torch.rsqrt((x[1] ** 2).sum(-1, keepdim=True) + 1e-12)
        q = (q * scale[:, None, None]).to(torch.bfloat16)
        k, v = k.to(torch.bfloat16), x[2].to(torch.bfloat16)
        del x
        mask = bias[None, None]
        if shift:
            mask = mask + torch.as_tensor(window_region_mask(
                int(math.isqrt(N)), shift, nW1, nW1), device=dev)[None, :, None]
        mask = mask.to(torch.bfloat16)
        shp = (Bn // nW, nW, H, N, hd)
        qs, ks, vs = (t.reshape(shp) for t in (q, k, v))
        ms = time_ms(lambda: window_attention_flat(*args), 5)
        plain_ms = time_ms(lambda: chunks(lambda w: (
            window_attention_flat_plain(qkv[w], *args[1:]),)), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=1.0), 5)
        nbytes = Bn * N * 3 * C * 2 + H * N * N * 4 + Bn * N * C * 2
        t_bytes = nbytes / HBM_BYTES_S
        # K1 runs its products on the tensor cores (as every attention
        # kernel): the least time the card needs for the work whatever
        # implements it, 4·Bn·H·N²·hd flops at the bf16 tensor-core rate or
        # one exp per logit at the special-function rate ("operations")
        t_ops = max(4 * Bn * H * N * N * hd / BF16_TC_FLOP_S,
                    Bn * H * N * N / SFU_EXP_S)
        shape = f"stage{stage} Bn={Bn} N={N} C={C} H={H} shift={shift}"
        rows.append(dict(kernel="window_attention_flat", shape=shape,
                         path=path, per_fwd=per_fwd, err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=t_bytes * 1e3, t_ops=t_ops * 1e3))

        # K1's row sums: fp32 sums of the same terms in another order
        r_err = rel_err(window_attention_flat(*args, return_rowsum=True)[1],
                        r)
        if path == "e2e" and stage == 1 and shift:
            # where a K1 launch spends its time: prep, the one pass
            profile_run(f"K1 {shape}", lambda: window_attention_flat(
                *args, return_rowsum=True))
        print(f"K1 row sums {shape}: max rel err {r_err:.3e} (tol 1e-4)",
              flush=True)
        if not r_err <= 1e-4:
            raise AssertionError(f"K1 row sums disagree: {r_err}")

        # K2 from the forward's output and row sums. Tolerances: dqkv two
        # bf16 ulps at its largest value (both round one fp32 result);
        # dbias and dscale fp32 sums over every window in another order,
        # 1e-4 and 1e-3 of their largest value
        g = torch.randn(out.shape, device=dev, generator=gen
                        ).to(torch.bfloat16)
        bargs = (qkv, bias, ls, out, r, g, shift, nW1, nW1)
        k2_plain = lambda: chunks(  # noqa: E731
            lambda w: window_attention_flat_bwd_plain(
                qkv[w], bias, ls, out[w], r[w], g[w], shift, nW1, nW1), 2)
        got = window_attention_flat_bwd(*bargs)
        want = k2_plain()
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tols = [bf16_tol(want[0].float()),
                1e-4 * float(want[1].abs().max()),
                1e-3 * float(want[2].abs().max())]
        ms = time_ms(lambda: window_attention_flat_bwd(*bargs), 3)
        plain_ms = time_ms(k2_plain, 2)
        del want
        # library yardstick: SDPA's backward with the float mask as a
        # tensor that requires grad (dbias), when a backend runs it
        leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        mask_g = mask.detach().requires_grad_()
        gs = g.reshape(Bn, N, H, hd).permute(0, 2, 1, 3).reshape(shp)
        try:
            lo = F.scaled_dot_product_attention(*leaves, attn_mask=mask_g,
                                                scale=1.0)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lo, leaves + [mask_g], gs, retain_graph=True), 3)
            del lo
        except RuntimeError as e:
            print(f"K2 {shape}: SDPA backward with a mask gradient does not "
                  f"run here ({str(e)[:120]})", flush=True)
            lib_ms = None
        del leaves, mask_g, gs, qs, ks, vs, q, k, v
        nbytes = (2 * Bn * N * 3 * C * 2 + 2 * Bn * N * C * 2
                  + Bn * H * N * 4 + 2 * H * N * N * 4)
        # K2/K5 run their products on the tensor cores (as K8b/K7b): the
        # least time the card needs for the work whatever implements it,
        # 10·Bn·H·N²·hd flops at the bf16 tensor-core rate or one exp per
        # logit at the special-function rate ("operations")
        t_ops = max(10 * Bn * H * N * N * hd / BF16_TC_FLOP_S,
                    Bn * H * N * N / SFU_EXP_S)
        rows.append(dict(kernel="window_attention_flat_bwd", shape=shape,
                         path=path, per_fwd=per_fwd, err=max(errs),
                         tol=tols[errs.index(max(errs))],
                         ok=all(e <= t for e, t in zip(errs, tols)),
                         detail=f"dqkv {errs[0]:.2e}/{tols[0]:.2e} dbias "
                                f"{errs[1]:.2e}/{tols[1]:.2e} dscale "
                                f"{errs[2]:.2e}/{tols[2]:.2e}",
                         ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=t_ops * 1e3))
        if path != "swin":
            if stage == 1 and shift:      # where a K2 launch spends its time
                profile_run(f"K2 {shape}",
                            lambda: window_attention_flat_bwd(*bargs))
            del got, out, r
            continue

        # K5, the v1 backward, from the forward's inputs alone: against
        # its plain version with K2's tolerances, and against K2 on the
        # same inputs (the same function; K2's row term comes from the
        # bf16 output, so relative L2 within 1e-2). Its library yardstick
        # is K2's (the same SDPA backward); its bound K2's operations, and
        # bytes without o and r
        k2 = got
        vargs = (qkv, bias, ls, g, shift, nW1, nW1)
        k5_plain = lambda: chunks(  # noqa: E731
            lambda w: window_attention_flat_bwd_v1_plain(
                qkv[w], bias, ls, g[w], shift, nW1, nW1), 2)
        got = window_attention_flat_bwd_v1(*vargs)
        want = k5_plain()
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tols = [bf16_tol(want[0].float()),
                1e-4 * float(want[1].abs().max()),
                1e-3 * float(want[2].abs().max())]
        vs_k2 = [rel_l2(a, b) for a, b in zip(got, k2)]
        del want, k2
        ms = time_ms(lambda: window_attention_flat_bwd_v1(*vargs), 3)
        plain_ms = time_ms(k5_plain, 2)
        nbytes = (Bn * N * 3 * C * 2 + Bn * N * C * 2 + Bn * N * 3 * C * 2
                  + 2 * H * N * N * 4)
        rows.append(dict(kernel="window_attention_flat_bwd_v1", shape=shape,
                         path=path, per_fwd=per_fwd, err=max(errs),
                         tol=tols[errs.index(max(errs))],
                         ok=(all(e <= t for e, t in zip(errs, tols))
                             and max(vs_k2) <= 1e-2),
                         detail=f"dqkv {errs[0]:.2e}/{tols[0]:.2e} dbias "
                                f"{errs[1]:.2e}/{tols[1]:.2e} dscale "
                                f"{errs[2]:.2e}/{tols[2]:.2e}; against K2 "
                                f"rel L2 {vs_k2[0]:.2e} {vs_k2[1]:.2e} "
                                f"{vs_k2[2]:.2e} (tol 1e-2)",
                         ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=t_ops * 1e3))
        if stage == 1 and shift:          # where a K5 launch spends its time
            profile_run(f"K5 {shape}",
                        lambda: window_attention_flat_bwd_v1(*vargs))
        del got, out, r


def check_attention_variants(dev, gen):
    """K1, K2 and K5 beyond the main path's bf16 inputs, against their plain
    versions: (a) fp32 qkv at stage 2 shift 14 (outputs and dq, dk, dv
    within 1e-4 of their largest value, dbias 1e-4, dscale 1e-3); (b)
    ``mxu_bf16`` at stage 3 (the kernels and the plain versions round the
    same operands to bf16 and a value on a rounding boundary may go either
    way: two bf16 ulps of the largest value, dbias 1e-3, dscale 1e-2, as
    K7b's); (c) a query row whose logits all sit 90-110 below the fixed
    shift m_h at stage 3 (scale 10, bias in [0, 1) but −90 on row 3: its
    row sum under the 1e-30 clamp, its exps subnormal, which the kernels
    flush), K2 and K5 within the usual tolerances and finite; (d) K2's time
    with split operands against ``mxu_bf16`` at stage 1 shift 14."""
    import torch

    from mvuld_tpu_torch.ops import window_attention as wa

    big = lambda t: float(t.float().abs().max())  # noqa: E731

    def inputs(row, dtype):
        stage, Bn, N, C, H, shift, nW1, _ = row
        qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen).to(dtype)
        bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                              generator=gen))
        ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=gen)
        g = torch.randn(Bn, N, C, device=dev, generator=gen).to(dtype)
        return qkv, bias, ls, g, (shift, nW1, nW1)

    def grads(kind, qkv, bias, ls, g, geom, plain=False, **kw):
        if kind == "K5":
            fn = (wa.window_attention_flat_bwd_v1_plain if plain
                  else wa.window_attention_flat_bwd_v1)
            out = fn(qkv, bias, ls, g, *geom, **kw)
        else:
            o, r = wa.window_attention_flat_plain(qkv, bias, ls, *geom,
                                                  return_rowsum=True, **kw)
            fn = (wa.window_attention_flat_bwd_plain if plain
                  else wa.window_attention_flat_bwd)
            out = fn(qkv, bias, ls, o, r, g, *geom, **kw)
        C = g.shape[-1]
        return [out[0][..., i * C:(i + 1) * C] for i in range(3)] + [
            out[1], out[2]]

    def report(label, got, want, rels):
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        tols = [r * big(w) for r, w in zip(rels, want)]
        print(f"{label}: " + " ".join(f"{e:.2e}/{t:.2e}"
                                      for e, t in zip(errs, tols)),
              flush=True)
        if not (all(e <= t for e, t in zip(errs, tols))
                and all(bool(torch.isfinite(a).all()) for a in got)):
            raise AssertionError(f"{label} disagrees with its plain version")

    qkv, bias, ls, g, geom = inputs(K1_SHAPES[3], torch.float32)
    report("K1 fp32 stage2 shift=14",
           [wa.window_attention_flat(qkv, bias, ls, *geom)],
           [wa.window_attention_flat_plain(qkv, bias, ls, *geom)], [1e-4])
    for kind in ("K2", "K5"):
        report(f"{kind} fp32 stage2 shift=14 (dq dk dv dbias dscale)",
               grads(kind, qkv, bias, ls, g, geom),
               grads(kind, qkv, bias, ls, g, geom, plain=True),
               [1e-4] * 4 + [1e-3])
    del qkv, g

    qkv, bias, ls, g, geom = inputs(K1_SHAPES[4], torch.bfloat16)
    ulps = 2.0 ** -6
    report("K1 mxu_bf16 stage3",
           [wa.window_attention_flat(qkv, bias, ls, *geom, mxu_bf16=True)],
           [wa.window_attention_flat_plain(qkv, bias, ls, *geom,
                                           mxu_bf16=True)], [ulps])
    for kind in ("K2", "K5"):
        report(f"{kind} mxu_bf16 stage3 (dq dk dv dbias dscale)",
               grads(kind, qkv, bias, ls, g, geom, mxu_bf16=True),
               grads(kind, qkv, bias, ls, g, geom, plain=True, mxu_bf16=True),
               [ulps] * 3 + [1e-3, 1e-2])
    bias = torch.rand(bias.shape, device=dev, generator=gen)
    bias[:, 3, :] = -90.0
    ls = torch.full_like(ls, 10.0)
    _, r = wa.window_attention_flat_plain(qkv, bias, ls, *geom,
                                          return_rowsum=True)
    if not bool((r[:, :, 3] == 1e30).all()):
        raise AssertionError("the underflowing row's sum is not clamped")
    for kind in ("K2", "K5"):
        want = grads(kind, qkv, bias, ls, g, geom, plain=True)
        report(f"{kind} underflowing row stage3 (dq dk dv dbias dscale)",
               grads(kind, qkv, bias, ls, g, geom), want,
               [ulps] * 3 + [1e-4, 1e-3])
    del qkv, g, want

    # what the split operands cost against one bf16 product per term
    qkv, bias, ls, g, geom = inputs(K1_SHAPES[1], torch.bfloat16)
    o, r = wa.window_attention_flat(qkv, bias, ls, *geom, return_rowsum=True)
    ms = [time_ms(lambda m=m: wa.window_attention_flat_bwd(
        qkv, bias, ls, o, r, g, *geom, mxu_bf16=m), 5) for m in (False, True)]
    print(f"K2 stage1 shift=14: split operands {ms[0]:.3f} ms, mxu_bf16 "
          f"{ms[1]:.3f} ms [{card_line()}]", flush=True)


def _layout_inputs(dev, gen, Bn, N, C, H, nW1, dtype):
    """Seeded map-layout inputs of one stage: qkv [B, Hp, Wp, 3, H, hd],
    bias, per-head scale, and the output gradient as an fp32 map whose
    values are bf16 numbers (so both layouts read the same g)."""
    import torch

    ws, hd, nW = math.isqrt(N), C // H, nW1 * nW1
    B, Hp = Bn // nW, nW1 * ws
    qkv = torch.randn(B, Hp, Hp, 3, H, hd, device=dev, generator=gen
                      ).to(dtype)
    bias = 16 * torch.sigmoid(torch.randn(H, N, N, device=dev,
                                          generator=gen))
    ls = math.log(10.0) + 0.1 * torch.randn(H, device=dev, generator=gen)
    g = torch.randn(B, Hp, Hp, H, hd, device=dev, generator=gen
                    ).to(torch.bfloat16).float()
    return qkv, bias, ls, g, ws, hd, nW


def _abs_errs(got, want):
    return [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)]


def check_layouts(dev, gen, rows):
    """K8/K8b (head layout, the shift mask as a [nW, N, N] operand) and
    K7/K7b (map layout read in place, mask synthesised, fp32 outputs) at
    every stage's bucket-16 shape, bf16 inputs, against their plain versions
    over chunks of windows. Every kernel's bound is taken at the
    tensor-core and special-function rates (they run on the tensor cores).
    Tolerances as K1/K2's: bf16 outputs two bf16
    ulps at the largest value, fp32 outputs 1e-4 of the largest; dbias 1e-4
    and dscale 1e-3 of their largest. Library yardstick: SDPA with a float
    mask (and its backward with the mask's gradient), once per shape. The
    rows of OPS_SHAPES are the ones the op entry points' pass runs."""
    import torch
    import torch.nn.functional as F

    from mvuld_tpu_torch.ops import window_attention as wa

    big = lambda t: float(t.float().abs().max())  # noqa: E731
    for stage, Bn, N, C, H, shift, nW1, _ in K1_SHAPES:
        qkv, bias, ls, g, ws, hd, nW = _layout_inputs(
            dev, gen, Bn, N, C, H, nW1, torch.bfloat16)
        per_fwd = int((stage, shift) in OPS_SHAPES)
        shape = f"stage{stage} Bn={Bn} N={N} C={C} H={H} shift={shift}"
        q, k, v = (t.to(torch.bfloat16).contiguous()
                   for t in wa._map_to_windows(qkv, ws))
        gh = wa._heads_map_to_windows(g, ws).to(torch.bfloat16)
        mask = (torch.as_tensor(wa.window_region_mask(ws, shift, nW1, nW1),
                                device=dev) if shift else None)
        chunks = lambda fn, n_summed=0: by_windows(  # noqa: E731
            fn, Bn, nW, H, N, n_summed)
        imgs = lambda w: slice(w.start // nW, w.stop // nW)  # noqa: E731

        # library yardstick (timed only), as for K1/K2
        qn = q.float() * torch.rsqrt((q.float() ** 2).sum(-1, keepdim=True)
                                     + 1e-12)
        kn = k.float() * torch.rsqrt((k.float() ** 2).sum(-1, keepdim=True)
                                     + 1e-12)
        shp = (Bn // nW, nW, H, N, hd)
        qs = (qn * ls[:, None, None]).to(torch.bfloat16).reshape(shp)
        ks, vs = kn.to(torch.bfloat16).reshape(shp), v.reshape(shp)
        del qn, kn
        fmask = bias[None, None]
        if shift:
            fmask = fmask + mask[None, :, None]
        fmask = fmask.to(torch.bfloat16)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=fmask, scale=1.0), 5)
        leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        mask_g = fmask.detach().requires_grad_()
        try:
            lo = F.scaled_dot_product_attention(*leaves, attn_mask=mask_g,
                                                scale=1.0)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lo, leaves + [mask_g], gh.reshape(shp), retain_graph=True), 3)
            del lo
        except RuntimeError as e:
            print(f"{shape}: SDPA backward with a mask gradient does not run "
                  f"here ({str(e)[:120]})", flush=True)
            lib_bwd = None
        del leaves, mask_g, qs, ks, vs, fmask

        elems = Bn * H * N * hd
        sq = H * N * N * 4
        # every kernel runs its products on the tensor cores, so its bound
        # is the least time the card needs for the work whatever implements
        # it: 4·Bn·H·N²·hd flops forward, 10·Bn·H·N²·hd backward at the bf16
        # tensor-core rate, or one exp per logit at the special-function
        # rate (both "operations")
        ops_f = max(4 * elems * N / BF16_TC_FLOP_S, Bn * H * N * N / SFU_EXP_S)
        ops_b = max(10 * elems * N / BF16_TC_FLOP_S, Bn * H * N * N / SFU_EXP_S)
        mask_bytes = 0 if mask is None else mask.numel() * 4

        def row(kernel, err, tol, ok, detail, ms, plain_ms, lib, nbytes, ops):
            rows.append(dict(kernel=kernel, shape=shape, path="ops",
                             per_fwd=per_fwd, err=err, tol=tol, ok=ok,
                             detail=detail, ms=ms, plain_ms=plain_ms,
                             lib_ms=lib, t_bytes=nbytes / HBM_BYTES_S * 1e3,
                             t_ops=ops * 1e3))

        # K8: q, k, v and the mask as operands
        got = wa.window_attention_fwd(q, k, v, bias, ls, mask)
        (want,) = chunks(lambda w: (wa.window_attention_plain(
            q[w], k[w], v[w], bias, ls, mask),))
        torch.cuda.synchronize()
        err, tol = _abs_errs([got], [want])[0], bf16_tol(want.float())
        row("window_attention_fwd", err, tol, err <= tol,
            f"max_abs_err={err:.3e} (tol {tol:.3e})",
            time_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ls, mask),
                    5),
            time_ms(lambda: chunks(lambda w: (wa.window_attention_plain(
                q[w], k[w], v[w], bias, ls, mask),)), 3),
            lib_fwd, 4 * elems * 2 + sq + mask_bytes, ops_f)
        del got, want

        # K8b
        k8b_plain = lambda: chunks(  # noqa: E731
            lambda w: wa.window_attention_bwd_plain(
                q[w], k[w], v[w], bias, ls, gh[w], mask), 2)
        got = wa.window_attention_bwd(q, k, v, bias, ls, gh, mask)
        want = k8b_plain()
        torch.cuda.synchronize()
        errs = _abs_errs(got, want)
        tols = [bf16_tol(t.float()) for t in want[:3]] + [
            1e-4 * big(want[3]), 1e-3 * big(want[4])]
        worst = max(range(5), key=lambda i: errs[i] / tols[i])
        row("window_attention_bwd", errs[worst], tols[worst],
            all(e <= t for e, t in zip(errs, tols)),
            " ".join(f"{n} {e:.2e}/{t:.2e}" for n, e, t in zip(
                ("dq", "dk", "dv", "dbias", "dscale"), errs, tols)),
            time_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ls, gh,
                                                    mask), 3),
            time_ms(k8b_plain, 2), lib_bwd,
            7 * elems * 2 + 2 * sq + mask_bytes + H * 4, ops_b)
        del got, want

        # K7: the map read in place, fp32 out
        k7_plain = lambda: chunks(  # noqa: E731
            lambda w: (wa.window_attention_map_plain(
                qkv[imgs(w)], bias, ls, shift),))
        got = wa.window_attention_map_fwd(qkv, bias, ls, shift)
        (want,) = k7_plain()
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"K7 output dtype {got.dtype}")
        err, tol = _abs_errs([got], [want])[0], 1e-4 * big(want)
        row("window_attention_map_fwd", err, tol, err <= tol,
            f"max_abs_err={err:.3e} (tol {tol:.3e})",
            time_ms(lambda: wa.window_attention_map_fwd(qkv, bias, ls, shift),
                    5),
            time_ms(k7_plain, 3), lib_fwd,
            3 * elems * 2 + elems * 4 + sq, ops_f)
        del got, want

        # K7b: fp32 dqkv in qkv's layout
        k7b_plain = lambda: chunks(  # noqa: E731
            lambda w: wa.window_attention_map_bwd_plain(
                qkv[imgs(w)], bias, ls, g[imgs(w)], shift), 2)
        got = wa.window_attention_map_bwd(qkv, bias, ls, g, shift)
        want = k7b_plain()
        torch.cuda.synchronize()
        if got[0].dtype != torch.float32:
            raise AssertionError(f"K7b dqkv dtype {got[0].dtype}")
        errs = _abs_errs(got, want)
        tols = [1e-4 * big(want[0]), 1e-4 * big(want[1]), 1e-3 * big(want[2])]
        worst = max(range(3), key=lambda i: errs[i] / tols[i])
        row("window_attention_map_bwd", errs[worst], tols[worst],
            all(e <= t for e, t in zip(errs, tols)),
            " ".join(f"{n} {e:.2e}/{t:.2e}" for n, e, t in zip(
                ("dqkv", "dbias", "dscale"), errs, tols)),
            time_ms(lambda: wa.window_attention_map_bwd(qkv, bias, ls, g,
                                                        shift), 3),
            time_ms(k7b_plain, 2), lib_bwd,
            3 * elems * 2 + elems * 4 + 3 * elems * 4 + 2 * sq + H * 4, ops_b)
        del got, want, qkv, q, k, v, g, gh


def check_layouts_variants(dev, gen):
    """The four kernels on fp32 inputs (stage 2, shift 14; everything within
    1e-4 of the largest value, dscale 1e-3), and K7/K7b with bf16 product
    operands (``mxu_bf16``, stage 3): kernel and plain version round the
    same operands to bf16, and a value on a rounding boundary may go either
    way, so outputs within two bf16 ulps of the largest value."""
    import torch

    from mvuld_tpu_torch.ops import window_attention as wa

    big = lambda t: float(t.float().abs().max())  # noqa: E731

    def report(label, got, want, rels):
        errs = _abs_errs(got, want)
        tols = [r * big(w) for r, w in zip(rels, want)]
        print(f"{label}: " + " ".join(f"{e:.2e}/{t:.2e}"
                                      for e, t in zip(errs, tols)),
              flush=True)
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"{label} disagrees with its plain version")

    stage, Bn, N, C, H, shift, nW1, _ = K1_SHAPES[3]
    qkv, bias, ls, g, ws, hd, nW = _layout_inputs(dev, gen, Bn, N, C, H, nW1,
                                                  torch.float32)
    q, k, v = (t.contiguous() for t in wa._map_to_windows(qkv, ws))
    gh = wa._heads_map_to_windows(g, ws)
    mask = wa.window_region_mask(ws, shift, nW1, nW1)
    report("K8 fp32 stage2 shift=14",
           [wa.window_attention_fwd(q, k, v, bias, ls, mask)],
           [wa.window_attention_plain(q, k, v, bias, ls, mask)], [1e-4])
    report("K8b fp32 stage2 shift=14 (dq dk dv dbias dscale)",
           wa.window_attention_bwd(q, k, v, bias, ls, gh, mask),
           wa.window_attention_bwd_plain(q, k, v, bias, ls, gh, mask),
           [1e-4] * 4 + [1e-3])
    report("K7 fp32 stage2 shift=14",
           [wa.window_attention_map_fwd(qkv, bias, ls, shift)],
           [wa.window_attention_map_plain(qkv, bias, ls, shift)], [1e-4])
    report("K7b fp32 stage2 shift=14 (dqkv dbias dscale)",
           wa.window_attention_map_bwd(qkv, bias, ls, g, shift),
           wa.window_attention_map_bwd_plain(qkv, bias, ls, g, shift),
           [1e-4, 1e-4, 1e-3])
    del qkv, q, k, v, g, gh

    stage, Bn, N, C, H, shift, nW1, _ = K1_SHAPES[4]
    qkv, bias, ls, g, ws, hd, nW = _layout_inputs(dev, gen, Bn, N, C, H, nW1,
                                                  torch.bfloat16)
    ulps = 2.0 ** -6
    report("K7 mxu_bf16 stage3",
           [wa.window_attention_map_fwd(qkv, bias, ls, 0, True)],
           [wa.window_attention_map_plain(qkv, bias, ls, 0, True)], [ulps])
    report("K7b mxu_bf16 stage3 (dqkv dbias dscale)",
           wa.window_attention_map_bwd(qkv, bias, ls, g, 0, True),
           wa.window_attention_map_bwd_plain(qkv, bias, ls, g, 0, True),
           [ulps, 1e-3, 1e-2])
    # what the split operands cost against one bf16 product per term
    ms = [time_ms(lambda m=m: wa.window_attention_map_bwd(qkv, bias, ls, g, 0,
                                                          m), 5)
          for m in (False, True)]
    print(f"K7b stage3: split operands {ms[0]:.3f} ms, mxu_bf16 {ms[1]:.3f} ms "
          f"[{card_line()}]", flush=True)


def check_mlp(dev, gen, rows, name, shapes, path="e2e", fp32=False):
    """K3 / K4 (K4 also with a keep-mask at 0.9) against the plain version:
    bf16 y within two ulps of its largest value; with ``fp32`` x (the
    kernels' two-term products) within 1e-4 of it."""
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd

    wrapper = getattr(fd, name)
    residual = name == "mlp_ln_res"
    eps = 1e-5 if residual else 1e-6
    dtype = torch.float32 if fp32 else torch.bfloat16
    tol_of = ((lambda ref: 1e-4 * float(ref.abs().max())) if fp32  # noqa: E731
              else bf16_tol)
    for label, M, C, per_fwd in shapes:
        Hd = 4 * C
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x = r(M, C).to(dtype)
        w1, b1 = r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02)
        w2, b2 = r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02)
        gamma, beta = 1 + r(C, sc=0.1), r(C, sc=0.1)
        args = (x, w1, b1, w2, b2, gamma, beta)
        got = wrapper(*args)
        want = fd.mlp_ln_plain(*args, residual=residual, eps=eps)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ms = time_ms(lambda: wrapper(*args), 10)
        plain_ms = time_ms(lambda: fd.mlp_ln_plain(
            *args, residual=residual, eps=eps), 5)
        size = x.element_size()
        nbytes = 2 * M * C * size + 2 * C * Hd * size + (Hd + 3 * C) * 4
        rows.append(dict(kernel=name, shape=f"{label} M={M} C={C}"
                         + (" fp32" if fp32 else ""),
                         path=path, per_fwd=per_fwd, err=err,
                         tol=tol_of(want.float()),
                         ms=ms, plain_ms=plain_ms, lib_ms=None,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=4 * M * C * Hd * (3 if fp32 else 1)
                         / BF16_TC_FLOP_S * 1e3))
        if residual:   # the training form: the dropout keep-mask
            mask = (torch.rand(M, C, device=dev, generator=gen) < KEEP
                    ).to(dtype)
            got = wrapper(*args, mask, KEEP)
            want = fd.mlp_ln_plain(*args, residual=True, eps=eps, mask=mask,
                                   keep_prob=KEEP)
            err_m = float((got.float() - want.float()).abs().max())
            tol_m = tol_of(want.float())
            print(f"{name} {label} M={M} C={C} keep {KEEP}: max_abs_err="
                  f"{err_m:.3e} (tol {tol_m:.3e})", flush=True)
            if not err_m <= tol_m:
                raise AssertionError(f"{name} with its mask disagrees: "
                                     f"{err_m}")
            rows[-1]["err"] = max(err, err_m)


def check_mlp_bwd(dev, gen, rows, name, shapes, path="e2e", fp32=False):
    """K3b / K4b (K4b with a keep-mask at 0.9) against the plain version:
    each of the 7 gradients within relative L2 1e-2 — both round dz and dh
    to bf16 before the products, so a value near a rounding boundary may
    round either way, and the weight gradients sum those over M rows; with
    ``fp32`` x within 1e-4 (two-term products). One K4b launch at the
    ``lines`` shape is profiled by pass."""
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.tools import traceparse

    wrapper = getattr(fd, name)
    residual = name == "mlp_ln_res_bwd"
    eps = 1e-5 if residual else 1e-6
    dtype = torch.float32 if fp32 else torch.bfloat16
    lim = 1e-4 if fp32 else 1e-2
    for label, M, C, per_step in shapes:
        Hd = 4 * C
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x = r(M, C).to(dtype)
        params = (r(C, Hd, sc=C ** -0.5), r(Hd, sc=0.02),
                  r(Hd, C, sc=Hd ** -0.5), r(C, sc=0.02), 1 + r(C, sc=0.1))
        dy = r(M, C).to(dtype)
        extra = ()
        if residual:
            extra = ((torch.rand(M, C, device=dev, generator=gen) < KEEP
                      ).to(dtype), KEEP)
        got = wrapper(x, dy, *params, *extra)
        want = fd.mlp_ln_bwd_plain(x, dy, *params, residual=residual,
                                   eps=eps, mask=extra[0] if extra else None,
                                   keep_prob=KEEP if extra else 1.0)
        torch.cuda.synchronize()
        l2 = [rel_l2(a, b) for a, b in zip(got, want)]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ms = time_ms(lambda: wrapper(x, dy, *params, *extra), 5)
        plain_ms = time_ms(lambda: fd.mlp_ln_bwd_plain(
            x, dy, *params, residual=residual, eps=eps,
            mask=extra[0] if extra else None,
            keep_prob=KEEP if extra else 1.0), 3)
        size = x.element_size()
        nbytes = ((3 + residual) * M * C * size + 2 * C * Hd * size
                  + 2 * C * Hd * 4 + (Hd + 3 * C) * 4)
        rows.append(dict(kernel=name, shape=f"{label} M={M} C={C}"
                         + (" fp32" if fp32 else ""),
                         path=path, per_fwd=per_step, err=err, tol=None,
                         ok=max(l2) <= lim,
                         detail="rel L2 " + " ".join(
                             f"{n} {e:.1e}" for n, e in zip(
                                 ("dx", "dW1", "db1", "dW2", "db2", "dγ",
                                  "dβ"), l2)) + f" (tol {lim:g})",
                         ms=ms, plain_ms=plain_ms, lib_ms=None,
                         t_bytes=nbytes / HBM_BYTES_S * 1e3,
                         t_ops=12 * M * C * Hd * (3 if fp32 else 1)
                         / BF16_TC_FLOP_S * 1e3))
        if residual and label == "lines" and not fp32:
            profile_run(f"K4b {label} launch", lambda: wrapper(
                x, dy, *params, *extra), category=traceparse.mlp_pass)


def check_dense(dev, gen, rows, fp32=False):
    """K6 and K6b against their plain versions at blockbench's stage-3
    shapes and the ragged one: the bf16 outputs (y, dz) within two bf16
    ulps of their largest value (with ``fp32`` x: 1e-4 of it), K6b's fp32
    column sums (db, dγ, dβ) within relative L2 VEC_TOL (sums over 50176
    rows in another order). Yardstick: ``torch.addmm`` on the product alone
    (the epilogue not included). One launch of each at blockbench's shapes
    is profiled by pass (bf16)."""
    import torch

    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.tools import traceparse

    dtype = torch.float32 if fp32 else torch.bfloat16
    tol_of = ((lambda ref: 1e-4 * float(ref.abs().max())) if fp32  # noqa: E731
              else bf16_tol)
    base = "fp32" if fp32 else "blockbench"
    for label, M, K, N, act, ln, path in (
            [(*d, base) for d in DENSE_SHAPES]
            + [(*d, ("fp32 " if fp32 else "") + "ragged")
               for d in DENSE_RAGGED]):
        r = lambda *s, sc=1.0: sc * torch.randn(*s, device=dev,  # noqa: E731
                                                generator=gen)
        x, w, b = r(M, K).to(dtype), r(K, N, sc=K ** -0.5), r(N, sc=0.02)
        gamma, beta = 1 + r(N, sc=0.1), r(N, sc=0.1)
        dy = r(M, N).to(dtype)
        fargs = (x, w, b, gamma, beta, act, ln)
        bargs = (x, w, b, gamma, dy, act, ln)
        got, want = fd.dense_fwd(*fargs), fd.dense_fwd_plain(*fargs)
        dz, vecs = fd.dense_bwd(*bargs)
        dz_p, vecs_p = fd.dense_bwd_plain(*bargs)
        torch.cuda.synchronize()
        wb, bb = w.to(dtype), b.to(dtype)
        lib_ms = time_ms(lambda: torch.addmm(bb, x, wb), 10)
        shape = f"{label} M={M} K={K} N={N}" + (" fp32" if fp32 else "")
        size = x.element_size()
        t_ops = 2 * M * K * N * (3 if fp32 else 1) / BF16_TC_FLOP_S * 1e3
        err = float((got.float() - want.float()).abs().max())
        rows.append(dict(kernel="dense_fwd", shape=shape, path=path,
                         per_fwd=1, err=err,
                         tol=tol_of(want.float()),
                         ms=time_ms(lambda: fd.dense_fwd(*fargs), 10),
                         plain_ms=time_ms(lambda: fd.dense_fwd_plain(*fargs),
                                          5),
                         lib_ms=lib_ms,
                         t_bytes=(M * K + K * N + M * N) * size
                         / HBM_BYTES_S * 1e3,
                         t_ops=t_ops))
        err = float((dz.float() - dz_p.float()).abs().max())
        tol = tol_of(dz_p.float())
        v_err = [rel_l2(a, b) for a, b in zip(vecs, vecs_p)]
        names = ("db", "dγ", "dβ")
        rows.append(dict(kernel="dense_bwd", shape=shape, path=path,
                         per_fwd=1, err=err,
                         tol=tol, ok=err <= tol and max(v_err) <= VEC_TOL,
                         detail=f"dz {err:.2e}/{tol:.2e}; rel L2 " + " ".join(
                             f"{n} {e:.1e}" for n, e in zip(names, v_err))
                         + f" (tol {VEC_TOL})",
                         ms=time_ms(lambda: fd.dense_bwd(*bargs), 10),
                         plain_ms=time_ms(lambda: fd.dense_bwd_plain(*bargs),
                                          5),
                         lib_ms=lib_ms,
                         t_bytes=((M * K + K * N + 2 * M * N) * size
                                  + len(vecs) * N * 4) / HBM_BYTES_S * 1e3,
                         t_ops=t_ops))
        if path == "blockbench":
            profile_run(f"K6 {label} launch", lambda: fd.dense_fwd(*fargs),
                        category=traceparse.dense_pass)
            profile_run(f"K6b {label} launch", lambda: fd.dense_bwd(*bargs),
                        category=traceparse.dense_pass)
        del x, dy, got, want, dz, dz_p


def requests(cfg, n: int, seed: int = 0):
    """``n`` featurised request rows in ``build_request``'s layout, from a
    numpy seed: UniXcoder framing ([<s>, <encoder-only>, </s>] … </s>, pad
    1), 3-30 valid lines per function, edges among valid lines with
    self-loops, normalised boxes, a normal image."""
    import numpy as np

    rng = np.random.RandomState(seed)
    M, T, Tn, S = (cfg.DATA.MAX_NODES, cfg.DATA.FUNC_TOKENS,
                   cfg.DATA.NODE_TOKENS, cfg.DATA.IMG_SIZE)

    def framed(length, width):
        ids = np.full(width, 1, np.int32)
        body = rng.randint(9, VOCAB, length)
        ids[: length + 4] = np.concatenate([[0, 5, 2], body, [2]])
        return ids

    arrs = {"func_ids": np.stack([framed(rng.randint(40, T - 4), T)
                                  for _ in range(n)]),
            "node_ids": np.full((n, M, Tn), 1, np.int32),
            "image": rng.randn(n, S, S, 3).astype(np.float32),
            "pos": np.zeros((n, M, 4), np.float32),
            "adj": np.zeros((n, M, M), np.uint8),
            "node_mask": np.zeros((n, M), np.float32)}
    for i in range(n):
        nv = rng.randint(3, 31)
        arrs["node_mask"][i, :nv] = 1.0
        for j in range(nv):
            arrs["node_ids"][i, j] = framed(rng.randint(2, Tn - 4), Tn)
        x0 = rng.rand(nv, 2) * 0.5
        arrs["pos"][i, :nv] = np.concatenate([x0, x0 + 0.05], 1)
        edges = (rng.rand(nv, nv) < 0.1) * (1 << rng.randint(0, 4, (nv, nv)))
        arrs["adj"][i, :nv, :nv] = edges.astype(np.uint8)
        arrs["adj"][i, np.arange(nv), np.arange(nv)] |= np.uint8(15)
    return arrs


def serve_phase(dev):
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa
    from mvuld_tpu_torch.train.predict import serve
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    cfg = get_config(SimpleNamespace(cfg=None, opts=MODEL_OPTS,
                                     output="unused"))
    arrs = requests(cfg, N_REQUESTS)

    def model(kernels: bool):
        m, _, _ = build_e2e_model(cfg, VOCAB, node_capacity=NODE_CAPACITY,
                                  use_pallas=kernels,
                                  roberta_pallas_mlp=kernels,
                                  use_pallas_mlp=kernels)
        return m

    t0 = time.time()
    fast = model(True)
    init_jax_like(fast, torch.Generator().manual_seed(0))
    fast.to(dev).eval()
    n_params = sum(p.numel() for p in fast.parameters())
    print(f"serve: model built ({n_params / 1e6:.1f}M params) in "
          f"{time.time() - t0:.1f}s", flush=True)

    def timed(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = serve(m, arrs, BATCH, dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, p

    plain = model(False)
    plain.load_state_dict(fast.state_dict())
    plain.to(dev).eval()
    serve(fast, arrs, BATCH, dev)                 # warm-ups
    serve(plain, arrs, BATCH, dev)

    counters = [wa.window_attention_flat, fd.mlp_ln, fd.mlp_ln_res]
    for c in counters:
        c.launches = 0
    t, p_fast = timed(fast)                       # the main path, counted
    launches = {c.__name__: c.launches for c in counters}
    # then in turns: plain, kernels, plain, kernels, plain
    t_fast, t_plain = [t], []
    for r in range(REPEATS):
        t, p_plain = timed(plain)
        t_plain.append(t)
        if r < REPEATS - 1:
            t_fast.append(timed(fast)[0])
    if any(c.launches != REPEATS * launches[c.__name__] for c in counters):
        raise AssertionError("the plain serving path launched a kernel")

    one = {k: v[:BATCH] for k, v in arrs.items()}
    for label, m in (("kernels", fast), ("plain", plain)):
        profile_run(f"{label} forward (bucket {BATCH})",
                    lambda: serve(m, one, BATCH, dev))

    forwards = math.ceil(N_REQUESTS / BATCH)
    per_fwd = {"window_attention_flat": 24, "mlp_ln": 22, "mlp_ln_res": 24}
    for name, n in launches.items():
        print(f"serve: {name} launched {n} times "
              f"(want {per_fwd[name]} × {forwards} forwards)", flush=True)
        if n != per_fwd[name] * forwards:
            raise AssertionError(f"{name}: {n} launches, want "
                                 f"{per_fwd[name] * forwards}")
    if p_fast.shape != (N_REQUESTS,) or not np.isfinite(p_fast).all() \
            or p_fast.min() < 0 or p_fast.max() > 1:
        raise AssertionError(f"p_vul out of range: {p_fast}")
    dp = float(np.abs(p_fast - p_plain).max())
    print(f"serve: p_vul range [{p_fast.min():.4f}, {p_fast.max():.4f}], "
          f"max |Δp| kernels vs plain {dp:.3e} (tol {P_TOL})", flush=True)
    if not dp <= P_TOL:
        raise AssertionError(f"kernel and plain serving disagree: {dp}")
    for label, ts in (("kernels", t_fast), ("plain", t_plain)):
        med = statistics.median(ts)
        print(f"serve {label}: {N_REQUESTS} functions, median of {REPEATS} "
              f"runs {med:.4f}s = {N_REQUESTS / med:.2f} functions/s "
              f"(runs {', '.join(f'{t:.4f}' for t in ts)} s) "
              f"[{card_line()}]", flush=True)
    return launches


def write_cache(out_dir: str, cfg, n_train: int, n_val: int) -> None:
    """A seeded synthetic corpus as the trainer's prebuilt inputs:
    ``cache/e2e.npz`` in ``build_e2e_cache``'s layout (``requests`` rows,
    balanced labels, train/val parts) and a ``tokenizer.json`` of the
    4096-token vocabulary."""
    import numpy as np

    n = n_train + n_val
    arrs = requests(cfg, n, seed=1)
    arrs["label"] = (np.arange(n) % 2).astype(np.int32)
    arrs["part"] = np.asarray(["train"] * n_train + ["val"] * n_val)
    arrs["node_context"] = np.asarray("none")
    os.makedirs(os.path.join(out_dir, "cache"), exist_ok=True)
    np.savez(os.path.join(out_dir, "cache", "e2e.npz"), **arrs)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump({"model": {"vocab": {f"t{i}": i for i in range(VOCAB)}},
                   "added_tokens": []}, f)


def train_phase(dev, counters, trace_dir=None):
    """(a) The main path: one epoch through ``train_e2e.main`` with the
    kernels, launches counted. (b) Kernels against plain layers: first-step
    loss and per-tensor gradients, then timed steps and peak memory; the
    kernel path's profiled step's Chrome trace goes to ``trace_dir``."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import (cross_entropy,
                                                  model_inputs, train_step)
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model
    from mvuld_tpu_torch.train.train_e2e import main as train_main

    work = tempfile.mkdtemp(prefix="mvuld_train_")
    try:
        args = ["--output", work, "--device", dev.type, "--node-capacity",
                str(NODE_CAPACITY), "--opts",
                *_opts_args(MODEL_OPTS + TRAIN_OPTS)]
        cfg = get_config(SimpleNamespace(cfg=None, opts=MODEL_OPTS + TRAIN_OPTS,
                                         output=work))
        write_cache(cfg.OUTPUT, cfg, 3 * BATCH, BATCH)
        for c in counters:
            c.launches = 0
        t0 = time.time()
        res = train_main(args)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        with open(os.path.join(cfg.OUTPUT, "log_rank0.txt")) as f:
            losses = [float(line.split(": loss ")[1].split()[0])
                      for line in f if ": loss " in line]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"train main: 1 epoch of {len(losses)} steps + eval in "
          f"{time.time() - t0:.1f}s, losses {losses}, val "
          f"{ {k: round(v, 4) for k, v in res['history'][0].items() if k in ('acc', 'f1', 'roc_auc')} }",
          flush=True)
    for name, n in launches.items():
        print(f"train main: {name} launched {n} times", flush=True)
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"train main losses: {losses}")
    idle = [n for n, k in launches.items() if k == 0]
    if idle:
        raise AssertionError(f"the training run never launched {idle}")

    # (b) kernels against plain layers, one seeded generator per path, and
    # both against the plain layers in fp32
    cfg32 = get_config(SimpleNamespace(
        cfg=None, opts=MODEL_OPTS + TRAIN_OPTS + ["PARALLEL.DTYPE", "float32"],
        output=work))

    def build(kernels, c=cfg):
        m, _, _ = build_e2e_model(c, VOCAB, node_capacity=NODE_CAPACITY,
                                  use_pallas=kernels, use_pallas_mlp=kernels,
                                  roberta_pallas_mlp=kernels)
        return m

    fast = build(True)
    init_jax_like(fast, torch.Generator().manual_seed(0))
    plain, ref = build(False), build(False, cfg32)
    for m in (plain, ref):
        m.load_state_dict(fast.state_dict())
        m.to(dev)
    fast.to(dev)
    arrs = requests(cfg, BATCH, seed=2)
    arrs["label"] = (np.arange(BATCH) % 2).astype(np.int32)

    def batch_of(n):
        return to_device({k: v[:n] for k, v in arrs.items()}, dev)

    def first_step(model, n):
        gen = torch.Generator(device=dev).manual_seed(1)
        b = batch_of(n)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        logits = model(**model_inputs(b), train=True, gen=gen)
        loss = cross_entropy(logits, b["label"], cfg.MODEL.LABEL_SMOOTHING)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        model.load_state_dict(stats, strict=False)   # undo the BN update
        return loss.item(), grads

    def largest_fit(label, model, n):
        """(batch, first_step) at the largest batch from ``n`` down that
        fits."""
        while True:
            try:
                return n, first_step(model, n)
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                if n == 1:
                    raise
                print(f"train {label}: batch {n} does not fit", flush=True)
                n //= 2

    B_plain, (lp, gp) = largest_fit("plain", plain, BATCH)
    B_cmp, (lr, gr) = largest_fit("plain fp32", ref, B_plain)
    if B_cmp < B_plain:
        lp, gp = first_step(plain, B_cmp)
    lk, gk = first_step(fast, B_cmp)
    del ref
    names = [n for n, _ in fast.named_parameters()]
    # each bf16 path's relative L2 error per tensor against the fp32 run.
    # A gradient that vanishes or cancels in exact arithmetic (the Swin
    # final norm and any bias ahead of a batch-statistics BatchNorm, the
    # logits' bias) is rounding noise on both bf16 paths, so each tensor's
    # bound is the larger of GRAD_TOL and GRAD_NOISE × the plain path's
    # own error on it
    rows = []
    for a, b, r, n in zip(gk, gp, gr, names):
        ek, ep, ekp = rel_l2(a, r), rel_l2(b, r), rel_l2(a, b)
        rows.append((ek / max(GRAD_TOL, GRAD_NOISE * ep), ek, ep, ekp, n))
    rows.sort(reverse=True)
    del gk, gp, gr
    torch.cuda.empty_cache()
    med = lambda i: statistics.median(r[i] for r in rows)  # noqa: E731
    print(f"train compare (batch {B_cmp}): first-step loss kernels "
          f"{lk:.5f} plain {lp:.5f} |Δ| {abs(lk - lp):.2e} (tol {LOSS_TOL}), "
          f"fp32 {lr:.5f}; gradient rel L2 over {len(rows)} tensors against "
          f"fp32: kernels median {med(1):.3e}, plain median {med(2):.3e}; "
          f"kernels vs plain median {med(3):.3e}; bound per tensor "
          f"max({GRAD_TOL}, {GRAD_NOISE} × plain's), "
          f"{sum(GRAD_NOISE * r[2] > GRAD_TOL for r in rows)} tensors above "
          f"{GRAD_TOL}; largest share of its bound {rows[0][0]:.3f} "
          f"({rows[0][4]})", flush=True)
    for share, ek, ep, ekp, n in rows[:6]:
        print(f"train compare:   {n}: kernels {ek:.3e} plain {ep:.3e} "
              f"against fp32, kernels vs plain {ekp:.3e}", flush=True)
    if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_TOL):
        raise AssertionError(f"first-step losses disagree: {lk} vs {lp}")
    if not rows[0][0] <= 1.0:
        raise AssertionError(f"first-step gradients disagree: {rows[:3]}")

    def timed_steps(label, model, n):
        opt = build_optimizer(cfg, build_schedule(cfg, 3, n), model)
        gen = torch.Generator(device=dev).manual_seed(1)
        b = batch_of(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times = [], []
        for i in range(1 + TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(train_step(model, opt, b, gen,
                                      cfg.MODEL.LABEL_SMOOTHING))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: non-finite loss/grad_norm {vals}")
        ms = statistics.median(times[1:]) * 1e3
        print(f"train {label}: batch {n}, {TRAIN_STEPS} steps after a "
              f"warm-up, median {ms:.1f} ms/step = {n / ms * 1e3:.2f} "
              f"functions/s (steps {', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; "
              f"warm-up {times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
              f"loss/grad_norm {[(round(a, 4), round(g, 3)) for a, g in vals]} "
              f"[{card_line()}]", flush=True)
        return opt, b, gen

    opt, b, gen = timed_steps("kernels", fast, BATCH)
    profile_run(f"kernels train step (batch {BATCH})",
                lambda: train_step(fast, opt, b, gen,
                                   cfg.MODEL.LABEL_SMOOTHING),
                trace_path=(os.path.join(trace_dir, "e2e_train_step.json")
                            if trace_dir else None))
    del opt, b, fast
    torch.cuda.empty_cache()
    timed_steps("plain", plain, B_plain)
    return launches


def _opts_args(opts):
    """Config opts as a shell passes them."""
    return [json.dumps(o) if isinstance(o, list) else str(o) for o in opts]


def _counts(counters):
    return {c.__name__: c.launches for c in counters}


def _reset(counters):
    for c in counters:
        c.launches = 0


def swin_phase(dev, counters):
    """The SwinV2 fine-tune alone (``train_swin``), at full width:
    (a) ``--throughput`` through the CLI; (b) per backward generation a
    warm-up and TRAIN_STEPS timed AdamW steps with mixup soft targets at
    SWIN_BATCH, launches counted; (c) the first step's gradients of v2, v1
    and the plain layers (bf16) against the plain layers in fp32 at BATCH,
    where the plain layers fit; (d) a profile of one step of each
    generation. Returns the launches of the counted runs."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.train_state import cross_entropy, image_inputs
    from mvuld_tpu_torch.ops import window_attention as wa
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_swin import build_swin_training
    from mvuld_tpu_torch.train.train_swin import main as swin_main

    def config(batch, extra=()):
        return get_config(SimpleNamespace(
            cfg=None, opts=SWIN_OPTS + ["DATA.BATCH_SIZE", batch, *extra],
            output=tempfile.gettempdir()))

    def host_batch(n, seed):
        rng = np.random.RandomState(seed)
        S = config(n).DATA.IMG_SIZE
        return {"image": rng.randn(n, S, S, 3).astype(np.float32),
                "label": (np.arange(n) % 2).astype(np.int32)}

    total = dict.fromkeys(_counts(counters), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) the throughput mode through the CLI
    B = SWIN_BATCH
    work = tempfile.mkdtemp(prefix="mvuld_swin_")
    try:
        _reset(counters)
        res = swin_main(["--throughput", "--output", work, "--device",
                         dev.type, "--opts",
                         *_opts_args(SWIN_OPTS + ["DATA.BATCH_SIZE", B])])
        torch.cuda.synchronize()
        counts = _counts(counters)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    add(counts)
    print(f"swin throughput: {res['throughput']:.2f} images/s (batch {B}, 50 "
          f"warm-up + 30 timed forwards; launches "
          f"{ {k: v for k, v in counts.items() if v} }) [{card_line()}]",
          flush=True)
    if counts["window_attention_flat"] != 80 * SWIN_BLOCKS:
        raise AssertionError(f"throughput launches: {counts}")
    torch.cuda.empty_cache()

    # (b) timed fine-tune steps, v2 then v1
    def steps(gen_name, n=SWIN_BATCH):
        os.environ["MVULD_ATTN_BWD"] = gen_name
        run = build_swin_training(config(n), dev, steps_per_epoch=3)
        raw = host_batch(n, 3)
        batches = [to_device(run.batch_hook(raw, 0, i), dev)
                   for i in range(1 + TRAIN_STEPS)]
        gen = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        metrics, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            metrics.append(run.step(b, gen))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = _counts(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        return run, batches, gen, counts, times, peak, vals

    n = SWIN_BATCH
    for gen_name, bwd in (("v2", "window_attention_flat_bwd"),
                          ("v1", "window_attention_flat_bwd_v1")):
        run, batches, gen, counts, times, peak, vals = steps(gen_name)
        add(counts)
        ms = statistics.median(times[1:]) * 1e3
        print(f"swin train {gen_name} (MVULD_ATTN_BWD={gen_name}): batch {n}, "
              f"{TRAIN_STEPS} steps after a warm-up, median {ms:.1f} ms/step "
              f"= {n / ms * 1e3:.2f} images/s (steps "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; warm-up "
              f"{times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
              f"loss/grad_norm {[(round(a, 4), round(g, 3)) for a, g in vals]}"
              f", launches { {k: v for k, v in counts.items() if v} } "
              f"[{card_line()}]", flush=True)
        if not np.isfinite(vals).all():
            raise AssertionError(f"swin {gen_name}: non-finite {vals}")
        other = ("window_attention_flat_bwd_v1" if gen_name == "v2"
                 else "window_attention_flat_bwd")
        n_steps = 1 + TRAIN_STEPS
        if (counts["window_attention_flat"] != SWIN_BLOCKS * n_steps
                or counts[bwd] != SWIN_BLOCKS * n_steps or counts[other]
                or not counts["mlp_ln"] or not counts["mlp_ln_bwd"]):
            raise AssertionError(f"swin {gen_name} launches: {counts} (want "
                                 f"K1 and {bwd} {SWIN_BLOCKS} per step: K1 "
                                 f"never rerun in the checkpointed stage)")
        profile_run(f"swin {gen_name} train step (batch {n})",
                    lambda: run.step(batches[-1], gen))
        del run, batches
        torch.cuda.empty_cache()
    os.environ["MVULD_ATTN_BWD"] = "v2"

    # (c) first-step gradients against the plain layers in fp32
    def first_step(model, n, smoothing, hook):
        gen = torch.Generator(device=dev).manual_seed(1)
        b = to_device(hook(host_batch(n, 4), 0, 0), dev)
        logits = model(**image_inputs(b), train=True, gen=gen)
        loss = cross_entropy(logits, b["label"], smoothing, b["soft_label"])
        return loss.item(), torch.autograd.grad(loss, list(model.parameters()))

    def grads_at(kind, n):
        extra = ["PARALLEL.DTYPE", "float32"] if kind == "fp32" else []
        c = config(n, extra)
        run = build_swin_training(c, dev, kernels=kind.startswith("kernels"))
        if kind.startswith("kernels"):
            os.environ["MVULD_ATTN_BWD"] = kind[-2:]
        try:
            return first_step(run.model, n, run.label_smoothing,
                              run.batch_hook), run.model
        finally:
            os.environ["MVULD_ATTN_BWD"] = "v2"

    n = BATCH
    (lr_, gr), ref = grads_at("fp32", n)
    (lp, gp), plain = grads_at("plain", n)
    del ref, plain
    torch.cuda.empty_cache()
    (l2, g2), _ = grads_at("kernels_v2", n)
    (l1, g1), fast = grads_at("kernels_v1", n)
    names = [k for k, _ in fast.named_parameters()]
    del fast
    report = {}
    for label, gk, lk in (("v2", g2, l2), ("v1", g1, l1)):
        rows = sorted(((rel_l2(a, r) / max(GRAD_TOL, GRAD_NOISE * rel_l2(b, r)),
                        rel_l2(a, r), rel_l2(b, r), name)
                       for a, b, r, name in zip(gk, gp, gr, names)),
                      reverse=True)
        report[label] = rows
        med = lambda i: statistics.median(x[i] for x in rows)  # noqa: E731
        print(f"swin compare {label} (batch {n}): first-step loss kernels "
              f"{lk:.5f} plain {lp:.5f} fp32 {lr_:.5f}; gradient rel L2 over "
              f"{len(rows)} tensors against fp32: kernels median "
              f"{med(1):.3e}, plain median {med(2):.3e}; bound per tensor "
              f"max({GRAD_TOL}, {GRAD_NOISE} × plain's); largest share of "
              f"its bound {rows[0][0]:.3f} ({rows[0][3]})", flush=True)
        for share, ek, ep, name in rows[:4]:
            print(f"swin compare {label}:   {name}: kernels {ek:.3e} plain "
                  f"{ep:.3e} against fp32", flush=True)
        scales = [x for x in rows if x[3].endswith("logit_scale")]
        print(f"swin compare {label}: logit scales against fp32: kernels "
              f"median {statistics.median(x[1] for x in scales):.3e}, plain "
              f"median {statistics.median(x[2] for x in scales):.3e}",
              flush=True)
        if not (math.isfinite(lk) and abs(lk - lp) <= LOSS_TOL):
            raise AssertionError(f"swin {label}: first-step losses {lk} {lp}")
        if not rows[0][0] <= 1.0:
            raise AssertionError(f"swin {label}: gradients {rows[:3]}")
    v12 = sorted((rel_l2(a, b), name) for a, b, name in zip(g1, g2, names))
    print(f"swin compare v1 against v2: rel L2 median "
          f"{statistics.median(x[0] for x in v12):.3e}, max {v12[-1][0]:.3e} "
          f"({v12[-1][1]})", flush=True)
    if not all(math.isfinite(x[0]) for x in v12):
        raise AssertionError("swin v1 against v2: non-finite gradients")
    del g1, g2, gp, gr
    torch.cuda.empty_cache()
    return total


def _graph_state(run, gen):
    """The training state a replay reads: parameters, the optimizer's
    moments and counters, the step generator."""
    opt = run.opt
    return ([p.detach().clone() for p in opt.params],
            [t.clone() for t in opt.mu + opt.nu + opt.acc],
            (opt.count_t.clone(), opt.mini_step_t.clone()), gen.get_state())


def _graph_restore(run, gen, state):
    import torch
    params, moments, (count, mini), rng = state
    opt = run.opt
    with torch.no_grad():
        for t, v in zip(opt.params + opt.mu + opt.nu + opt.acc,
                        params + moments):
            t.copy_(v)
    opt.count_t.copy_(count)
    opt.mini_step_t.copy_(mini)
    gen.set_state(rng)


def _graph_vs_eager(label, run, sb, gen, k):
    """The first call of ``run.multi_step(k)`` on the host superbatch ``sb``
    (K eager warm-up steps, then the capture); from the state it leaves, K
    eager steps (``run.multi_step(k, capture=False)``, the plain version)
    on the same superbatch against one replay: the K losses within
    FUSED_LOSS_TOL, the update p_K − p_0 within FUSED_UPDATE_TOL (relative
    L2 of the difference over the eager update), the DropPath masks to the
    bit. Returns (the multi-step, the plain version, eager s/step, first
    call's s)."""
    import torch

    from mvuld_tpu_torch.models import swin_v2

    drawn = []
    inner = swin_v2.keep_mask

    def keep(*a):
        drawn.append(inner(*a))
        return drawn[-1]

    multi = run.multi_step(k)
    plain = run.multi_step(k, capture=False)
    swin_v2.keep_mask = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(sb, gen)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        start = _graph_state(run, gen)
        n = len(drawn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = plain(sb, gen)
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - t0) / k
        eager_masks = drawn[n:]
        p_eager = [p.detach().clone() for p in run.opt.params]
        _graph_restore(run, gen, start)
        got = multi(sb, gen)
        torch.cuda.synchronize()
    finally:
        swin_v2.keep_mask = inner
    le = eager["loss"].double()
    lg = got["loss"].double()
    loss_rel = float(((lg - le).abs() / le.abs()).max())
    num = sum(float((p.detach().double() - e.double()).norm() ** 2)
              for p, e in zip(run.opt.params, p_eager)) ** 0.5
    den = sum(float((e.double() - s.double()).norm() ** 2)
              for e, s in zip(p_eager, start[0])) ** 0.5
    captured = drawn[n // 2:n]
    masks = (len(captured) == len(eager_masks) > 0
             and all(torch.equal(a, b) for a, b in zip(captured,
                                                       eager_masks)))
    print(f"fused_steps {label}: {k} replayed steps against {k} eager from "
          f"one state: losses {[round(float(x), 5) for x in lg]}, max rel "
          f"{loss_rel:.3e} (tol {FUSED_LOSS_TOL}); update rel L2 "
          f"{num / max(den, 1e-30):.3e} (tol {FUSED_UPDATE_TOL}, |update| "
          f"{den:.4e}); DropPath masks {len(eager_masks)} equal to the bit: "
          f"{masks}; capture {multi.capture_s:.2f} s [{card_line()}]",
          flush=True)
    if not (math.isfinite(loss_rel) and loss_rel <= FUSED_LOSS_TOL
            and den > 0 and num <= FUSED_UPDATE_TOL * den and masks):
        raise AssertionError(f"fused_steps {label}: replay differs from the "
                             f"eager steps")
    return multi, plain, eager_s, first_s


def fused_steps_phase(dev, counters):
    """TRAIN.FUSED_STEPS as a CUDA graph (``make_multi_train_step``) on the
    SwinV2 fine-tune at full width (SWIN_OPTS: bf16, the fused MLP, stage 2
    checkpointed, DropPath 0.2), batch SWIN_BATCH: (a) FUSED_K replayed
    steps against FUSED_K eager ``train_step``s from one saved state; (b)
    the capture's seconds, ms/step eager and by replay (median of
    FUSED_REPLAYS calls each), images/s, peak memory: both take the host
    superbatch as ``fit`` hands it over (page-locked by the Prefetcher's
    ``pin_batch``) and copy it to the card inside the timed call, and one
    replay takes it from pageable numpy; (c) a profile of one replay call
    (the copy included) beside one eager step; (d)
    ``train_swin.main --opts TRAIN.FUSED_STEPS FUSED_CLI_K`` (Prefetcher,
    BEST_FETCH async) in a world-1 NCCL group (the gradients' all-reduce
    captured) on a seeded image corpus whose 6 batches leave a remainder,
    its history.json against the unfused run's; (e) a capture
    at MODEL.DROP_RATE 0.1 and depths FUSED_DROP_DEPTHS (inside the capture
    the checkpointed stage's recomputation takes the masks its first run
    kept: their bytes are printed). Returns the launches: the counted
    ones, each capture's launches counted × its replays."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.train_state import MultiTrainStep
    from mvuld_tpu_torch.models import dropout
    from mvuld_tpu_torch.parallel.distributed import backend_for, free_port
    from mvuld_tpu_torch.data.loader import ArrayDataset, pin_batch
    from mvuld_tpu_torch.train import train_swin
    from mvuld_tpu_torch.train.train_swin import build_swin_training

    def config(batch, extra=()):
        return get_config(SimpleNamespace(
            cfg=None, opts=SWIN_OPTS + ["DATA.BATCH_SIZE", batch, *extra],
            output=tempfile.gettempdir()))

    captures, extra = [], dict.fromkeys(_counts(counters), 0)
    record = MultiTrainStep.record

    def counted_record(self, gen, data):
        before = _counts(counters)
        graph = record(self, gen, data)
        after = _counts(counters)
        captures.append((self, {k: after[k] - before[k] for k in after}))
        return graph

    def settle():
        """Count the finished graphs' launches (a capture launched nothing,
        each replay all) and drop them, with their private memory pools."""
        for m, cap in captures:
            for name, n in cap.items():
                extra[name] += n * (m.replays - 1)
        captures.clear()
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.time()
    _reset(counters)
    MultiTrainStep.record = counted_record
    work = tempfile.mkdtemp(prefix="mvuld_fused_")
    try:
        K, B = FUSED_K, SWIN_BATCH
        run = build_swin_training(config(B), dev, steps_per_epoch=4 * K)
        S = run.model.config.img_size
        rng = np.random.RandomState(11)
        hosts = [run.batch_hook({"image": rng.randn(B, S, S, 3).astype(
            np.float32), "label": (np.arange(B) % 2).astype(np.int32)}, 0, i)
            for i in range(K)]
        sb = {key: np.stack([h[key] for h in hosts]) for key in hosts[0]}
        del hosts
        sb_pin = pin_batch(sb)       # what fit's Prefetcher hands over
        gen = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # (a)
        multi, plain, first_eager_s, first_s = _graph_vs_eager(
            f"SwinV2-B 448 batch {B}", run, sb_pin, gen, K)

        # (b) eager and replayed calls on the page-locked host superbatch,
        # its copy to the card inside each call; one replay from numpy
        def timed(step, host, n):
            out = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(host, gen)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            return out

        e_times = timed(plain, sb_pin, FUSED_REPLAYS)
        times = timed(multi, sb_pin, FUSED_REPLAYS)
        numpy_ms = timed(multi, sb, 1)[0] / K * 1e3
        eager_s = statistics.median(e_times) / K
        replay_ms = statistics.median(times) / K * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"fused_steps times: batch {B}, {K} steps per call, the host "
              f"superbatch page-locked as fit's Prefetcher leaves it and "
              f"copied inside each call: first call {first_s:.2f} s ({K} "
              f"eager warm-up steps and the capture, capture "
              f"{multi.capture_s:.2f} s); eager {eager_s * 1e3:.1f} ms/step "
              f"= {B / eager_s:.2f} images/s (calls "
              f"{', '.join(f'{t * 1e3:.1f}' for t in e_times)} ms; the "
              f"comparison's {first_eager_s * 1e3:.1f} ms/step); replay "
              f"{replay_ms:.1f} ms/step = {B / replay_ms * 1e3:.2f} images/s "
              f"(calls {', '.join(f'{t * 1e3:.1f}' for t in times)} ms); one "
              f"replay from pageable numpy {numpy_ms:.1f} ms/step; peak "
              f"memory {peak:.2f} GiB (eager and graph pools) "
              f"[{card_line()}]", flush=True)
        # (c)
        batch0 = {key: v[0].to(dev) for key, v in sb_pin.items()}
        prof_graph = profile_run(f"fused_steps replay call ({K} steps, "
                                 f"batch {B}, its copy included)",
                                 lambda: multi(sb_pin, gen))
        prof_eager = profile_run(f"fused_steps eager step (batch {B})",
                                 lambda: run.step(batch0, gen))
        g_idle = 1 - prof_graph["busy_ms"] / prof_graph["wall_ms"]
        e_idle = 1 - prof_eager["busy_ms"] / prof_eager["wall_ms"]
        print(f"fused_steps profile: replay wall {prof_graph['wall_ms']:.1f} "
              f"ms per {K} steps, busy {prof_graph['busy_ms']:.1f}, idle "
              f"share {max(g_idle, 0.0):.3f}; eager step wall "
              f"{prof_eager['wall_ms']:.1f} ms, busy "
              f"{prof_eager['busy_ms']:.1f}, idle share "
              f"{max(e_idle, 0.0):.3f} [{card_line()}]", flush=True)
        del multi, plain, batch0, sb_pin, run
        settle()

        # (e) dropout in the checkpointed stage, reduced depth
        k = FUSED_DROP_K
        drun = build_swin_training(config(B, ["MODEL.SWINV2.DEPTHS",
                                              FUSED_DROP_DEPTHS,
                                              "MODEL.DROP_RATE", 0.1]),
                                   dev, steps_per_epoch=4 * k)
        dsb = {key: v[:k] for key, v in sb.items()}
        rngs = []
        stage_rng = dropout.StageRng.__init__

        def kept(self, *a):
            stage_rng(self, *a)
            rngs.append(self)

        dropout.StageRng.__init__ = kept
        try:
            _graph_vs_eager(f"MODEL.DROP_RATE 0.1 depths {FUSED_DROP_DEPTHS}",
                            drun, dsb,
                            torch.Generator(device=dev).manual_seed(2), k)
        finally:
            dropout.StageRng.__init__ = stage_rng
        tapes = [r.tape for r in rngs if r.tape is not None]
        held = sum(t.numel() * t.element_size() for tape in tapes
                   for t in tape)
        print(f"fused_steps MODEL.DROP_RATE 0.1: {len(rngs) - len(tapes)} "
              f"checkpointed stage runs rewound their generator (eager), "
              f"{len(tapes)} inside the capture kept their masks for the "
              f"recomputation: {sum(map(len, tapes))} masks, "
              f"{held / 2 ** 20:.1f} MiB in the graph's pool "
              f"({held / max(len(tapes), 1) / 2 ** 20:.1f} MiB per step)",
              flush=True)
        if not tapes or len(tapes) == len(rngs):
            raise AssertionError("fused_steps: the checkpointed stage's "
                                 "eager rewind or captured tape never ran")
        del drun, dsb, sb, rngs, tapes
        settle()

        # (d) the trainer CLI, fused and unfused, on seeded images
        def split(n, seed):
            rs = np.random.RandomState(seed)
            return ArrayDataset({
                "image": rs.randn(n, S, S, 3).astype(np.float32),
                "label": (np.arange(n) % 2).astype(np.int32)})

        data = dict(zip(("train", "val", "test"),
                        (split(n, 20 + i)
                         for i, n in enumerate(FUSED_CLI_SPLITS))))
        corpus = train_swin.corpus_datasets
        train_swin.corpus_datasets = lambda *a: data
        hist = {}
        backend = backend_for(dev)
        try:
            for k in (FUSED_CLI_K, 1):
                out = os.path.join(work, f"fused{k}")
                t0 = time.time()
                if k > 1:   # the fused run's step all-reduces in the graph
                    dist.init_process_group(
                        backend, init_method=f"tcp://127.0.0.1:"
                        f"{free_port()}", world_size=1, rank=0,
                        device_id=dev if backend == "nccl" else None)
                try:
                    res = train_swin.main([
                        "--output", out, "--device", dev.type, "--opts",
                        *_opts_args(SWIN_OPTS + [
                            "DATA.BATCH_SIZE", FUSED_CLI_BATCH,
                            "TRAIN.FUSED_STEPS", k, "TRAIN.EPOCHS", 2,
                            "TRAIN.BEST_FETCH", "async",
                            "TRAIN.BEST_SAVE", "params", "PRINT_FREQ", 1,
                            "SAVE_FREQ", 0])])
                    torch.cuda.synchronize()
                finally:
                    if dist.is_initialized():
                        dist.destroy_process_group()
                path = [os.path.join(d, "history.json")
                        for d, _, files in os.walk(out)
                        if "history.json" in files]
                with open(path[0]) as f:
                    hist[k] = json.load(f)
                best = [d for d, _, files in os.walk(out)
                        if d.endswith("checkpoint-best-f1") and files]
                print(f"fused_steps cli TRAIN.FUSED_STEPS {k}"
                      f"{f' (a world-1 {backend} group)' if k > 1 else ''}: "
                      f"{FUSED_CLI_SPLITS} images, batch {FUSED_CLI_BATCH}, "
                      f"2 epochs in {time.time() - t0:.1f} s, best f1 "
                      f"{res['best_f1']:.4f} @ {res['best_epoch']}, "
                      f"best checkpoints {len(best)}", flush=True)
                del res
                torch.cuda.empty_cache()
        finally:
            train_swin.corpus_datasets = corpus
        shape = lambda h: ([sorted(e) for e in h["history"]],  # noqa: E731
                           sorted(h), sorted(h["test_metrics"] or {}))
        replays = [m.replays for m, _ in captures]
        got = hist[FUSED_CLI_K]
        print(f"fused_steps cli: history.json keys {shape(got)[1]}, "
              f"{len(got['history'])} epochs, equal in shape to the unfused "
              f"run's: {shape(got) == shape(hist[1])}; the fused run's "
              f"graph replays {replays}", flush=True)
        if (shape(hist[FUSED_CLI_K]) != shape(hist[1])
                or not replays or replays[0] < 1):
            raise AssertionError("fused_steps cli: the fused run's history "
                                 "differs in shape or no graph replayed")
        settle()
    finally:
        MultiTrainStep.record = record
        shutil.rmtree(work, ignore_errors=True)
    counts = _counts(counters)
    for name, n in extra.items():
        counts[name] += n
    print(f"fused_steps launches (replays × captured, plus the eager "
          f"steps): { {k: v for k, v in counts.items() if v} }; phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    need = ("window_attention_flat", "window_attention_flat_bwd", "mlp_ln",
            "mlp_ln_bwd")
    if not all(counts[name] for name in need):
        raise AssertionError(f"fused_steps: a kernel of the path never ran: "
                             f"{counts}")
    return counts


def blockbench_phase(dev, counters):
    """The five blockbench variants, fwd_bwd at the default shape (batch
    64, C 512); K6/K6b (and K3/K3b in v4) counted in their variant's run."""
    import torch

    from mvuld_tpu_torch.tools.blockbench import VARIANTS, run_variant

    total = dict.fromkeys(_counts(counters), 0)
    want = {"v3": ("dense_fwd", "dense_bwd"), "v4": ("mlp_ln", "mlp_ln_bwd")}
    for v in VARIANTS:
        _reset(counters)
        row = run_variant(v, 64 * 784, 24, "fwd_bwd", device=dev)
        torch.cuda.synchronize()
        counts = _counts(counters)
        for k, n in counts.items():
            total[k] += n
        launched = {k for k, n in counts.items() if n}
        if launched != set(want.get(v, ())):
            raise AssertionError(f"blockbench {v} launched {counts}")
        print(json.dumps({"blockbench": row, "card": card_line()}),
              flush=True)
    return total


def ops_phase(dev, counters):
    """The op entry points, the main path of K7/K7b/K8/K8b: with seeded
    qkv, bias, scale and output weights at the OPS_SHAPES rows of K1_SHAPES
    (stage 1 shifted, stage 3), ``window_attention_map`` and
    ``window_attention`` run forward and backward through autograd on a
    scalar loss, launches counted. The map and head layouts run the same
    numbers re-laid and must agree: outputs within two bf16 ulps of the
    largest value (the head layout's output is bf16 and its p is rounded to
    bf16), gradients within two bf16 ulps, dbias 1e-4 and dscale 1e-3 of
    their largest. Both are then held against ``flat_attention`` (K1/K2,
    the fixed-shift softmax with a clamped row sum; its K2 takes the row
    term from the bf16 output): outputs within two bf16 ulps, gradients
    within relative L2 2e-2."""
    import torch

    from mvuld_tpu_torch.ops import window_attention as wa

    big = lambda t: float(t.float().abs().max())  # noqa: E731
    total = dict.fromkeys(_counts(counters), 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    for stage, Bn, N, C, H, shift, nW1, _ in K1_SHAPES:
        if (stage, shift) not in OPS_SHAPES:
            continue
        qkv, bias, ls, w, ws, hd, nW = _layout_inputs(
            dev, gen, Bn, N, C, H, nW1, torch.bfloat16)
        B, Hp = qkv.shape[0], qkv.shape[1]
        q, k, v = (t.to(torch.bfloat16).contiguous()
                   for t in wa._map_to_windows(qkv, ws))
        wh = wa._heads_map_to_windows(w, ws)
        mask = wa.window_region_mask(ws, shift, nW1, nW1) if shift else None
        leaves = [t.requires_grad_() for t in (qkv, bias, ls)]
        hleaves = [t.requires_grad_() for t in (q, k, v)]

        _reset(counters)
        t0 = time.perf_counter()
        out_m = wa.window_attention_map(*leaves, shift)
        gm = torch.autograd.grad((out_m * w).sum(), leaves)
        out_h = wa.window_attention(*hleaves, bias, ls, mask)
        gh = torch.autograd.grad((out_h.float() * wh).sum(),
                                 hleaves + [bias, ls])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts(counters)
        for name, n in counts.items():
            total[name] += n
        if any(n != 1 for n in counts.values()):
            raise AssertionError(f"op entry points launched {counts}, want "
                                 f"each kernel once")
        if out_m.dtype != torch.float32 or gm[0].dtype != torch.bfloat16 \
                or out_h.dtype != torch.bfloat16:
            raise AssertionError("entry point dtypes: map out "
                                 f"{out_m.dtype}, dqkv {gm[0].dtype}, head "
                                 f"out {out_h.dtype}")

        # the map layout against the head layout (the hard check)
        out_hm = wa._windows_to_map(out_h.detach().float(), B, Hp, Hp, ws)
        dqkv_h = wa._windows_to_map(torch.stack([t.float() for t in gh[:3]]),
                                    B, Hp, Hp, ws)
        pairs = [("out", out_hm, out_m.detach(), bf16_tol(out_m.detach())),
                 ("dqkv", dqkv_h, gm[0].float(), bf16_tol(gm[0].float())),
                 ("dbias", gh[3], gm[1], 1e-4 * big(gm[1])),
                 ("dscale", gh[4], gm[2], 1e-3 * big(gm[2]))]
        errs = [(n, float((a - b).abs().max()), t) for n, a, b, t in pairs]
        label = f"ops stage{stage} Bn={Bn} N={N} H={H} shift={shift}"
        print(f"{label}: forward + backward of both entry points "
              f"{ms:.1f} ms, launches {counts}; head vs map layout "
              + " ".join(f"{n} {e:.2e}/{t:.2e}" for n, e, t in errs),
              flush=True)
        if not all(e <= t for _, e, t in errs):
            raise AssertionError(f"{label}: the head and map layouts "
                                 f"disagree: {errs}")

        # both against the flat layout's K1/K2 (their launches are a
        # comparison, not this phase's path)
        flat = qkv.detach().reshape(B, nW1, ws, nW1, ws, 3 * C).permute(
            0, 1, 3, 2, 4, 5).reshape(Bn, N, 3 * C).requires_grad_()
        out_f, _ = wa.flat_attention(flat, bias, ls, shift, nW1, nW1,
                                     bwd_v2=True)
        wf = w.reshape(B, nW1, ws, nW1, ws, C).permute(0, 1, 3, 2, 4, 5
                                                       ).reshape(Bn, N, C)
        gf = torch.autograd.grad((out_f.float() * wf).sum(), [flat, bias, ls])
        out_fm = out_f.detach().float().reshape(B, nW1, nW1, ws, ws, H, hd
                                                ).permute(0, 1, 3, 2, 4, 5, 6
                                                          ).reshape(out_m.shape)
        dq_fm = gf[0].float().reshape(B, nW1, nW1, ws, ws, 3, H, hd).permute(
            0, 1, 3, 2, 4, 5, 6, 7).reshape(qkv.shape)
        torch.cuda.synchronize()
        o_err, o_tol = float((out_fm - out_m.detach()).abs().max()), \
            bf16_tol(out_m.detach())
        l2 = [rel_l2(dq_fm, gm[0]), rel_l2(gf[1], gm[1]), rel_l2(gf[2], gm[2])]
        print(f"{label}: flat layout (K1/K2, fixed-shift softmax) vs map "
              f"layout: out {o_err:.2e}/{o_tol:.2e}, gradient rel L2 dqkv "
              f"{l2[0]:.2e} dbias {l2[1]:.2e} dscale {l2[2]:.2e} (tol 2e-2)",
              flush=True)
        if not (o_err <= o_tol and max(l2) <= 2e-2):
            raise AssertionError(f"{label}: the flat and map layouts "
                                 f"disagree")
        # where a launch spends its time, by kernel (K7: prep, row pass,
        # output pass)
        with torch.no_grad():
            profile_run(f"{label} K7", lambda: wa.window_attention_map_fwd(
                qkv, bias, ls, shift))
            profile_run(f"{label} K8b", lambda: wa.window_attention_bwd(
                q, k, v, bias, ls, wh.to(torch.bfloat16), mask))
            profile_run(f"{label} K7b", lambda: wa.window_attention_map_bwd(
                qkv, bias, ls, w, shift))
        del qkv, q, k, v, w, wh, out_m, out_h, gm, gh, flat, out_f, gf
        torch.cuda.empty_cache()
    return total


def fusion_cli(dev, cache_dir: str, out: str, fopts, arch: str):
    """``train_fusion.main --arch arch`` on the caches under ``cache_dir``
    at FUSION_BATCH: its result, the logged losses and rates, its seconds
    and its config. Fails on a loss count other than FUSION_EPOCHS epochs
    of steps, a non-finite loss or a non-finite F1."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.train.train_fusion import main as fusion_main

    t0 = time.time()
    res = fusion_main(["--cache-dir", cache_dir, "--batch-size",
                       str(FUSION_BATCH), "--output", out, "--arch", arch,
                       "--device", dev.type, "--opts", *_opts_args(fopts)])
    torch.cuda.synchronize()
    secs = time.time() - t0
    fcfg = get_config(SimpleNamespace(
        cfg=None, opts=fopts + ["DATA.BATCH_SIZE", FUSION_BATCH],
        output=out))
    with open(os.path.join(fcfg.OUTPUT, "log_rank0.txt")) as f:
        lines = [line for line in f if ": loss " in line]
    losses = [float(x.split(": loss ")[1].split()[0]) for x in lines]
    rates = [float(x.split("(")[-1].split()[0]) for x in lines]
    steps = FUSION_EPOCHS * (STAGED_SPLITS[0] // FUSION_BATCH)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"fusion {arch} losses: {losses}")
    if not all(np.isfinite(h["f1"]) for h in res["history"]):
        raise AssertionError(f"fusion {arch} metrics: {res['history']}")
    return res, losses, rates, secs, fcfg


def staged_phase(dev, work: str):
    """The staged path at full width from seeded arrays, in ``work``. (a)
    The text stage: ``build_text_training`` with UniXcoder-base takes a
    warm-up and TRAIN_STEPS AdamW steps at batch 16 × 512 tokens. (b) The
    trained encoder and SwinV2-Base-448 (plain layers, as the pipeline
    builds them) as frozen featurizers fill the cache columns of
    sum(STAGED_SPLITS) seeded functions through ``encode_cache_columns``
    (node types seeded on the valid lines), written to ``work``/cache. (c)
    ``train_fusion.main`` trains ``multi_defect_new_gcn`` from those caches
    with TRAIN.DEVICE_DATA and TRAIN.DEVICE_EVAL on; then one fusion step is
    profiled. A non-finite loss or an out-of-memory error fails the run.
    Returns the fusion stage's config opts."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import train_step
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import build_fusion_model
    from mvuld_tpu_torch.models.swin_v2 import SwinTransformerV2, SwinV2Config
    from mvuld_tpu_torch.train import precompute
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_fusion import (edge_bits, fusion_inputs,
                                                    load_cached_datasets)
    from mvuld_tpu_torch.train.train_text import build_text_training

    opts = MODEL_OPTS + ["DATA.BATCH_SIZE", BATCH, "SEED", 0]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output=work))
    n = sum(STAGED_SPLITS)
    arrs = requests(cfg, n, seed=5)
    labels = (np.arange(n) % 2).astype(np.int32)

    # (a) the text stage
    ds = {"train": ArrayDataset({"input_ids": arrs["func_ids"],
                                 "label": labels})}
    run = build_text_training(cfg, ds, VOCAB, dev)
    batch = to_device({"input_ids": arrs["func_ids"][:BATCH],
                       "label": labels[:BATCH]}, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(run.step(batch, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    ms = statistics.median(times[1:]) * 1e3
    n_params = sum(p.numel() for p in run.model.parameters())
    print(f"staged text: UniXcoder classifier ({n_params / 1e6:.1f}M params), "
          f"batch {BATCH} × {cfg.DATA.FUNC_TOKENS} tokens, {TRAIN_STEPS} "
          f"steps after a warm-up, median {ms:.1f} ms/step = "
          f"{BATCH / ms * 1e3:.2f} functions/s (steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; warm-up "
          f"{times[0] * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
          f"loss/grad_norm {[(round(a, 4), round(g, 3)) for a, g in vals]} "
          f"[{card_line()}]", flush=True)
    if not np.isfinite(vals).all():
        raise AssertionError(f"staged text: non-finite loss/grad_norm {vals}")
    profile_run(f"staged text train step (batch {BATCH})",
                lambda: run.step(batch, gen))
    embedder = run.model
    del run, batch
    torch.cuda.empty_cache()

    # (b) the caches, through the frozen featurizers
    swin = SwinTransformerV2(SwinV2Config.from_cfg(cfg))
    init_jax_like(swin, torch.Generator().manual_seed(0))
    cols = precompute.empty_cache_columns(n, cfg)
    for key in ("pos", "adj", "node_mask"):
        cols[key][...] = arrs[key]
    cols["ntype"][...] = (np.random.RandomState(6).randint(
        0, 32, cols["ntype"].shape) * (arrs["node_mask"] > 0))
    rows_, nodes = np.nonzero(arrs["node_mask"] > 0)
    line_ids = arrs["node_ids"][rows_, nodes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precompute.encode_cache_columns(
        cols, func_ids=arrs["func_ids"], line_ids=line_ids,
        line_index=np.stack([rows_, nodes], 1), images=arrs["image"],
        text_encoder=precompute.frozen_text_encoder(embedder, dev),
        swin_encoder=precompute.frozen_swin_encoder(swin, dev),
        encode_batch=ENCODE_BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"staged cache: {n} functions, {len(line_ids)} line texts of "
          f"{cfg.DATA.NODE_TOKENS} tokens and {n} images of "
          f"{cfg.DATA.IMG_SIZE}² encoded in batches of {ENCODE_BATCH} in "
          f"{secs:.2f}s = {n / secs:.2f} functions/s; text_emb "
          f"{cols['text_emb'].shape}, node_emb {cols['node_emb'].shape}, "
          f"img_emb {cols['img_emb'].shape} [{card_line()}]", flush=True)
    for key in ("text_emb", "node_emb", "img_emb"):
        if not (np.isfinite(cols[key]).all() and cols[key].any()):
            raise AssertionError(f"staged cache: {key} is empty or not finite")
    if cols["node_emb"][arrs["node_mask"] == 0].any() \
            or not (cols["token_ids"][rows_, nodes] == line_ids).all():
        raise AssertionError("staged cache: line columns misplaced")
    del embedder, swin
    torch.cuda.empty_cache()
    cols["label"] = labels
    cols["ids"] = np.arange(n, dtype=np.int64)
    cache_dir = os.path.join(work, "cache")
    os.makedirs(cache_dir)
    lo = 0
    for part, k in zip(("train", "val", "test"), STAGED_SPLITS):
        np.savez(os.path.join(cache_dir, f"{part}.npz"),
                 **{key: v[lo:lo + k] for key, v in cols.items()})
        lo += k

    # (c) the fusion stage through its CLI, the splits on the card
    fopts = opts + ["TRAIN.DEVICE_DATA", True, "TRAIN.DEVICE_EVAL", True,
                    "TRAIN.EPOCHS", FUSION_EPOCHS, "PRINT_FREQ", 1,
                    "SAVE_FREQ", 0, "TRAIN.BEST_SAVE", "params"]
    res, losses, rates, secs, fcfg = fusion_cli(
        dev, cache_dir, os.path.join(work, "fusion"), fopts,
        "multi_defect_new_gcn")
    train = load_cached_datasets(
        {"train": os.path.join(cache_dir, "train.npz")})["train"]
    steps = FUSION_EPOCHS * (STAGED_SPLITS[0] // FUSION_BATCH)
    rate = statistics.median(rates[1:])
    print(f"staged fusion: train_fusion.main, {FUSION_EPOCHS} epochs of "
          f"{steps // FUSION_EPOCHS} steps at batch {FUSION_BATCH} + eval in "
          f"{secs:.1f}s, device-resident splits; logged median "
          f"{rate:.1f} functions/s = {FUSION_BATCH / rate * 1e3:.2f} ms/step; "
          f"losses {losses}; val "
          f"{[{k: round(v, 4) for k, v in h.items() if k in ('acc', 'f1', 'roc_auc')} for h in res['history']]}"
          f"; test { {k: round(v, 4) for k, v in res['test_metrics'].items() if k in ('acc', 'f1')} } "
          f"[{card_line()}]", flush=True)

    # one fusion step under the profiler
    model = build_fusion_model(fcfg)
    init_jax_like(model, torch.Generator().manual_seed(0))
    model.to(dev)
    opt = build_optimizer(fcfg, build_schedule(fcfg, 4, FUSION_BATCH), model)
    fb = to_device({k: np.asarray(v)[:FUSION_BATCH]
                    for k, v in train.columns.items()}, dev)
    inputs = fusion_inputs(edge_bits(fcfg.DATA.GTYPE))
    step = lambda: train_step(model, opt, fb, gen,  # noqa: E731
                              fcfg.MODEL.LABEL_SMOOTHING, inputs)
    step()
    profile_run(f"staged fusion train step (batch {FUSION_BATCH})", step)
    return fopts


def _grads_and_stats(model, batch, inputs, label_smoothing):
    """One train-mode step's logits, loss, parameter gradients and the
    BatchNorm statistics it leaves, all on the host."""
    import torch

    from mvuld_tpu_torch.core.train_state import cross_entropy

    logits = model(**inputs(batch), train=True)
    loss = cross_entropy(logits, batch["label"], label_smoothing)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (logits.detach().cpu(), loss.detach().cpu(),
            {n: g.cpu() for n, g in zip(names, grads)}, stats)


def _rel_l2(got, want) -> float:
    """rel_l2 taken in fp64 (fp64 results keep their digits), or the
    absolute L2 error where ``want`` is all zeros (the Rs-GCN blocks'
    gradients behind their zero-initialised BN scale)."""
    diff = float((got.double() - want.double()).norm())
    norm = float(want.double().norm())
    return diff / norm if norm > 0 else diff


def _held(got, want, exact, tol, noise=ZOO_NOISE):
    """(relative L2 of the card's ``got`` against the CPU's ``want``, the
    ratio of their errors from the CPU's fp64 ``exact`` where that exceeds
    ``tol`` else None, whether it passes: within ``tol``, or the ratio
    within ``noise``)."""
    e = _rel_l2(got, want)
    if e <= tol:
        return e, None, True
    own = float((want.double() - exact).norm())
    ratio = float((got.double() - exact).norm()) / max(own, 1e-300)
    return e, ratio, ratio <= noise


def _held_all(got, want, exact, tol, noise=ZOO_NOISE):
    """``_held`` over dicts of tensors: the worst relative error and its
    name, the worst ratio, whether all pass."""
    rows = {k: _held(got[k], want[k], exact[k], tol, noise) for k in want}
    worst = max(rows, key=lambda k: rows[k][0], default=None)
    ratios = [r for _, r, _ in rows.values() if r is not None]
    return (rows[worst][0] if rows else 0.0, worst,
            max(ratios, default=None), all(ok for *_, ok in rows.values()))


def _ratio(r) -> str:
    return "" if r is None else f" (×{r:.2f} the CPU fp32's error)"


def zoo_phase(dev, work: str, fopts):
    """The fusion zoo at production width on the staged caches in
    ``work``/cache. (a) Each key of ``FUSION_MODELS``, built from the
    staged config with ``init_jax_like`` weights on the card and on the
    CPU: one train-mode step with dropout 0 (logits, loss, gradients,
    BatchNorm statistics) at ZOO_BATCH, card against CPU, in fp64 and in
    fp32; then ZOO_TIMED train steps with the key's dropout (forward,
    backward, AdamW) and eval forwards, timed, and ZOO_PROFILED's step
    profiled. (b) ``train_fusion.main --arch`` for ZOO_CLI_KEYS with
    device-resident splits: finite losses and F1. (c) Each bilinear
    operator's forward and backward on the card against the CPU. Any
    error beyond its tolerance fails the run."""
    import copy

    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import eval_step, train_step
    from mvuld_tpu_torch.models.bilinear_fusion import (
        BILINEAR_FUSIONS, build_bilinear_fusion)
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.fusion_zoo import (FUSION_MODELS,
                                                   build_fusion_model)
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_fusion import (edge_bits, fusion_inputs,
                                                    load_cached_datasets)

    cfg = get_config(SimpleNamespace(
        cfg=None, opts=fopts + ["DATA.BATCH_SIZE", ZOO_BATCH], output=work))
    cache_dir = os.path.join(work, "cache")
    train = load_cached_datasets(
        {"train": os.path.join(cache_dir, "train.npz")})["train"]
    cols = {k: np.asarray(v)[:ZOO_BATCH] for k, v in train.columns.items()}
    host = to_device(cols, torch.device("cpu"))
    card = to_device(cols, dev)
    inputs = fusion_inputs(edge_bits(cfg.DATA.GTYPE))
    ls = cfg.MODEL.LABEL_SMOOTHING
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []

    # (a) every key, card against CPU, then timed
    for key in FUSION_MODELS.keys():
        ref = build_fusion_model(cfg, key, dropout=0.0, final_dropout=0.0)
        init_jax_like(ref, torch.Generator().manual_seed(0))
        runs = [copy.deepcopy(ref).double(), copy.deepcopy(ref).double().to(dev),
                ref, copy.deepcopy(ref).to(dev)]
        t0 = time.perf_counter()
        exact, got64, want, got = (
            _grads_and_stats(m, host if i % 2 == 0 else card, inputs, ls)
            for i, m in enumerate(runs))
        cpu_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in ref.parameters())
        del ref, runs
        # fp64: the same function on both devices
        fwd64 = max(_rel_l2(got64[0], exact[0]), _rel_l2(got64[1], exact[1]),
                    *(_rel_l2(got64[3][k], exact[3][k]) for k in exact[3]))
        grad64 = max(_rel_l2(got64[2][k], exact[2][k]) for k in exact[2])
        # fp32, with the CPU fp32 result's own error as the fallback bound
        held = [_held(got[i], want[i], exact[i], ZOO_TOL) for i in (0, 1)]
        e_stats, _, r_stats, ok_stats = _held_all(got[3], want[3], exact[3],
                                                  ZOO_TOL)
        e_grad, worst, r_grad, ok_grad = _held_all(got[2], want[2], exact[2],
                                                   ZOO_GRAD_TOL)
        ok = (fwd64 <= ZOO_TOL and grad64 <= ZOO_GRAD_TOL and held[0][2]
              and held[1][2] and ok_stats and ok_grad)

        model = build_fusion_model(cfg, key)
        init_jax_like(model, torch.Generator().manual_seed(0))
        model.to(dev)
        opt = build_optimizer(cfg, build_schedule(cfg, 4, ZOO_BATCH), model)
        step_ms = time_ms(lambda: train_step(model, opt, card, gen, ls,
                                             inputs), ZOO_TIMED)
        eval_ms = time_ms(lambda: eval_step(model, card, inputs), ZOO_TIMED)
        if key == ZOO_PROFILED:
            profile_run(f"zoo {key} train step (batch {ZOO_BATCH})",
                        lambda: train_step(model, opt, card, gen, ls, inputs))
        print(f"zoo {key}: {n_params / 1e6:.2f}M params; one train-mode "
              f"step at batch {ZOO_BATCH} (dropout 0), card vs CPU (the four "
              f"steps {cpu_s:.2f}s), rel L2 in fp64: forward {fwd64:.2e}, "
              f"gradients {grad64:.2e}; in fp32: logits {held[0][0]:.2e}"
              f"{_ratio(held[0][1])}, loss {held[1][0]:.2e}"
              f"{_ratio(held[1][1])}, BN stats {e_stats:.2e}"
              f"{_ratio(r_stats)}, gradients {e_grad:.2e} ({worst})"
              f"{_ratio(r_grad)} (tol {ZOO_TOL:.0e} / {ZOO_GRAD_TOL:.0e}, "
              f"else ≤ ×{ZOO_NOISE:g}){'' if ok else ' FAILED'}; train step "
              f"(dropout on, AdamW) {step_ms:.2f} ms, eval forward "
              f"{eval_ms:.2f} ms [{card_line()}]", flush=True)
        if not ok:
            bad.append(key)
        del model, opt
    if bad:
        raise AssertionError(f"zoo keys disagree card vs CPU: {bad}")

    # (b) the CLI for four keys, the splits on the card
    for key in ZOO_CLI_KEYS:
        res, losses, rates, secs, _ = fusion_cli(
            dev, cache_dir, os.path.join(work, f"zoo_{key}"), fopts, key)
        rate = statistics.median(rates[1:])
        print(f"zoo cli --arch {key}: {FUSION_EPOCHS} epochs of "
              f"{len(losses) // FUSION_EPOCHS} steps at batch {FUSION_BATCH} "
              f"+ eval in {secs:.1f}s, device-resident splits; logged median "
              f"{FUSION_BATCH / rate * 1e3:.2f} ms/step; losses "
              f"{[round(x, 4) for x in losses]}; val f1 "
              f"{[round(h['f1'], 4) for h in res['history']]}; test "
              f"{ {k: round(v, 4) for k, v in res['test_metrics'].items() if k in ('acc', 'f1')} } "
              f"[{card_line()}]", flush=True)

    # (c) every bilinear operator, card against CPU
    rng = np.random.RandomState(7)
    d0, d1, out_dim = BILINEAR_DIMS
    for name in BILINEAR_FUSIONS.keys():
        if name == "relational_network":
            n, d = BILINEAR_SET
            ref = build_bilinear_fusion(name, input_dim=d, output_dim=out_dim)
            xs = [rng.randn(BILINEAR_BATCH, n, d)]
            shape = f"[{BILINEAR_BATCH}, {n}, {d}]"
        else:
            ref = build_bilinear_fusion(name, input_dims=(d0, d1),
                                        output_dim=out_dim)
            xs = [rng.randn(BILINEAR_BATCH, d0), rng.randn(BILINEAR_BATCH, d1)]
            shape = f"[{BILINEAR_BATCH}, {d0}] × [{BILINEAR_BATCH}, {d1}]"
        init_jax_like(ref, torch.Generator().manual_seed(0))
        model = copy.deepcopy(ref).to(dev)
        x_host = [torch.as_tensor(x).float() for x in xs]
        x_card = [x.to(dev) for x in x_host]
        cot = torch.as_tensor(rng.randn(BILINEAR_BATCH, out_dim)).float()
        cot_card = cot.to(dev)

        def fwd_bwd(op, x_in, cot):
            leaves = [x.detach().requires_grad_() for x in x_in]
            y = op(leaves[0] if len(leaves) == 1 else leaves)
            return y, torch.autograd.grad((y * cot).sum(),
                                          [*leaves, *op.parameters()])

        y_ref, g_ref = fwd_bwd(ref, x_host, cot)
        y, g = fwd_bwd(model, x_card, cot_card)
        e_out = _rel_l2(y.detach().cpu(), y_ref.detach())
        e_grad32 = max(_rel_l2(a.cpu(), b) for a, b in zip(g, g_ref))
        # the signed square root's gradient 1/(2√|z|) magnifies rounding
        # where |z| is small: the gradients are held in fp64 on both sides,
        # and fp32's own spread (CPU fp32 against CPU fp64) is printed
        _, g64_ref = fwd_bwd(copy.deepcopy(ref).double(),
                             [x.double() for x in x_host], cot.double())
        _, g64 = fwd_bwd(copy.deepcopy(model).double(),
                         [x.double() for x in x_card], cot_card.double())
        e_grad = max(_rel_l2(a.cpu(), b) for a, b in zip(g64, g64_ref))
        spread = max(_rel_l2(a.double(), b) for a, b in zip(g_ref, g64_ref))
        ms = time_ms(lambda: fwd_bwd(model, x_card, cot_card),
                     ZOO_TIMED)
        ok = e_out <= ZOO_TOL and e_grad <= ZOO_GRAD_TOL
        print(f"zoo bilinear {name} {shape} → {out_dim}: card vs CPU, rel "
              f"L2 of the fp32 output {e_out:.2e} (tol {ZOO_TOL:.0e}), of "
              f"the gradients of inputs and parameters in fp64 max "
              f"{e_grad:.2e} (tol {ZOO_GRAD_TOL:.0e}){'' if ok else ' FAILED'}"
              f", in fp32 {e_grad32:.2e} (CPU fp32 against fp64 "
              f"{spread:.2e}); fp32 forward + backward {ms:.3f} ms "
              f"[{card_line()}]", flush=True)
        if not ok:
            bad.append(name)
        del ref, model
    if bad:
        raise AssertionError(f"bilinear operators disagree card vs CPU: "
                             f"{bad}")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- OCR

def _east_step(model, batch, dev):
    """One train-mode EAST step on ``batch`` (make_batch's arrays): the
    score and geo maps, the loss, the parameter gradients and the
    BatchNorm statistics it leaves, all on the host."""
    import torch

    from mvuld_tpu_torch.ocr.east import east_loss, to_nchw

    dtype = next(model.parameters()).dtype
    b = {k: to_nchw(v).to(dev, dtype) for k, v in batch.items()}
    score, geo = model(b["image"], train=True)
    loss = east_loss(b["score"], score, b["geo"], geo, b["ignored"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return ({"score": score.detach().cpu(), "geo": geo.detach().cpu(),
             "loss": loss.detach().cpu()},
            {n: g.cpu() for n, g in zip(names, grads)}, stats)


def _cancelling(grads, name) -> bool:
    """A convolution bias that feeds a train-mode BatchNorm: its gradient
    is exactly 0 (the batch mean takes the bias out), so any result is
    rounding noise of a sum over the batch's pixels; it passes below 1e-9
    (fp64) or 1e-3 (fp32) of the layer's weight gradient."""
    import torch
    w = float(grads[name[:-4] + "weight"].abs().max())
    rel = 1e-9 if grads[name].dtype == torch.float64 else 1e-3
    return float(grads[name].abs().max()) <= rel * w


def _oracle_quads(H: int, W: int):
    """Text-label-like axis-aligned boxes on an H × W canvas, apart from
    one another (the decoder would merge overlapping ones)."""
    import numpy as np
    quads = []
    for r, y in enumerate(range(40, H - 60, 96)):
        for c, x in enumerate(range(24 + 40 * (r % 2), W - 200, 248)):
            w, h = 120 + 16 * ((r + c) % 4), 18 + 2 * (c % 3)
            quads.append(np.array([[x, y], [x + w, y], [x + w, y + h],
                                   [x, y + h]], np.float32))
    return quads


def ocr_phase(dev, work: str) -> None:
    """The OCR subsystem (``mvuld_tpu_torch/ocr``, ``train_east``) on the
    card, numpy, torch and the compiled lanms only (no PIL, no cv2).
    (a) EAST (half-channel VGG16-BN + merge decoder, seed-0 ``init_jax_like``
    weights), one train-mode step at OCR_BATCH × OCR_SIZE² on numpy-
    rasterized gt of seeded canvases, card against CPU in fp64 and fp32:
    score, geo, loss, BatchNorm statistics within OCR_TOL, each gradient
    within OCR_GRAD_TOL (fp32: or within OCR_NOISE × the CPU fp32 result's
    own error from fp64, and once more with cuDNN off and with TF32 on,
    printed; the
    20 convolution biases before a train-mode BN
    have gradient 0 and pass as noise below 1e-9 (fp64) or 1e-3 (fp32) of
    their weight's).
    (b) ``train_east.main --no-crop`` on a seeded OCR_CORPUS-canvas cache for
    OCR_EPOCHS epochs: finite losses, the last below the first; a step
    timed (CUDA events), images/s, peak memory, one step profiled.
    (c) Oracle maps of known boxes decoded through ``get_boxes`` and the
    native NMS (each box back within 1 px; native against numpy NMS);
    the eval forward at batch 1 at each OCR_SHAPES input, the host decode,
    and one ``detect_array`` call timed."""
    import copy

    import numpy as np
    import torch

    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.ocr import detect
    from mvuld_tpu_torch.ocr.east import EAST
    from mvuld_tpu_torch.ocr.gt import rasterize_gt
    from mvuld_tpu_torch.train import train_east

    card = card_line()
    print(f"ocr: {card}", flush=True)

    # (a) one train-mode step, card against CPU
    imgs, quads, nq = train_east.synthetic_canvases(OCR_BATCH, OCR_SIZE, 0)
    t0 = time.perf_counter()
    batch = train_east.make_batch(imgs, quads, nq, np.arange(OCR_BATCH),
                                  OCR_SIZE, np.random.RandomState(0),
                                  crop=False)
    host_ms = (time.perf_counter() - t0) * 1e3
    ref = EAST()
    init_jax_like(ref, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in ref.parameters())
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    exact = _east_step(copy.deepcopy(ref).double(), batch, cpu)
    want = _east_step(copy.deepcopy(ref), batch, cpu)
    cpu_s = time.perf_counter() - t0
    got64 = _east_step(copy.deepcopy(ref).double().to(dev), batch, dev)
    got = _east_step(copy.deepcopy(ref).to(dev), batch, dev)
    ok = True
    fwd64 = max(max(_rel_l2(got64[0][k], exact[0][k]) for k in exact[0]),
                max(_rel_l2(got64[2][k], exact[2][k]) for k in exact[2]))
    real = [k for k in exact[1] if not k.endswith(".bias")
            or ".conv_" not in k]
    grad64 = max(_rel_l2(got64[1][k], exact[1][k]) for k in real)
    noise = [k for k in exact[1] if k not in real]
    ok &= all(_cancelling(g[1], k) for g in (exact, got64, want, got)
              for k in noise)
    max_noise = max(float(g[1][k].abs().max())
                    / float(g[1][k[:-4] + "weight"].abs().max())
                    for g in (want, got) for k in noise)
    ok &= fwd64 <= OCR_TOL and grad64 <= OCR_GRAD_TOL
    e_out, w_out, r_out, ok_out = _held_all(got[0], want[0], exact[0],
                                            OCR_TOL, OCR_NOISE)
    e_bn, _, r_bn, ok_bn = _held_all(got[2], want[2], exact[2], OCR_TOL,
                                     OCR_NOISE)

    def grads_held(run):
        return _held_all({k: run[1][k] for k in real},
                         {k: want[1][k] for k in real},
                         {k: exact[1][k] for k in real}, OCR_GRAD_TOL,
                         OCR_NOISE)
    e_g, w_g, r_g, ok_g = grads_held(got)
    ok &= ok_out and ok_bn and ok_g
    cpu_own = max(_rel_l2(want[1][k], exact[1][k]) for k in real)
    torch.backends.cudnn.allow_tf32 = True
    tf32 = grads_held(_east_step(copy.deepcopy(ref).to(dev), batch, dev))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    no_cudnn = grads_held(_east_step(copy.deepcopy(ref).to(dev), batch, dev))
    torch.backends.cudnn.enabled = True
    print(f"ocr east: {n_params / 1e6:.2f}M params; one train-mode step at "
          f"batch {OCR_BATCH} × {OCR_SIZE}² (gt rasterized in numpy, "
          f"{host_ms:.1f} ms on the host), card vs CPU (the CPU's two steps "
          f"{cpu_s:.2f}s), rel L2 in fp64: outputs/loss/BN {fwd64:.2e}, "
          f"gradients {grad64:.2e}; in fp32: outputs {e_out:.2e} ({w_out})"
          f"{_ratio(r_out)}, BN stats {e_bn:.2e}{_ratio(r_bn)}, gradients "
          f"{e_g:.2e} ({w_g}){_ratio(r_g)}; {len(noise)} cancelling conv "
          f"biases at most {max_noise:.1e} of their weights' gradients in "
          f"fp32 (tol {OCR_TOL:.0e} / {OCR_GRAD_TOL:.0e}, else ≤ "
          f"×{OCR_NOISE:g}){'' if ok else ' FAILED'}; the CPU fp32's worst "
          f"gradient {cpu_own:.2e} from fp64; with cuDNN off: gradients "
          f"{no_cudnn[0]:.2e} ({no_cudnn[1]}){_ratio(no_cudnn[2])}; with TF32 "
          f"convolutions: gradients {tf32[0]:.2e} ({tf32[1]}){_ratio(tf32[2])}"
          f" [{card}]", flush=True)
    if not ok:
        raise AssertionError("EAST disagrees card vs CPU")
    del exact, want, got64, got

    # (b) the trainer CLI on the card from a seeded cache, then a timed step
    out = os.path.join(work, "east")
    path = train_east.corpus_path(os.path.join(out, "corpus"), OCR_CORPUS,
                                  OCR_SIZE, 0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **dict(zip(("images", "quads", "nquads"),
                              train_east.synthetic_canvases(
                                  OCR_CORPUS, OCR_SIZE, 1))))
    t0 = time.perf_counter()
    res = train_east.main([
        "--synthetic", str(OCR_CORPUS), "--img-size", str(OCR_SIZE),
        "--batch-size", str(OCR_BATCH), "--epochs", str(OCR_EPOCHS),
        "--no-crop", "--out-dir", out, "--device", dev.type])
    secs = time.perf_counter() - t0
    losses = res["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_east losses {losses}")
    model = copy.deepcopy(ref).to(dev)
    opt = train_east.build_optimizer(model, 1e-3, 100)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: train_east.train_step(model, opt, batch, dev),
                      OCR_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"ocr train_east: {OCR_EPOCHS} epochs of "
          f"{OCR_CORPUS // OCR_BATCH} steps at batch {OCR_BATCH} × "
          f"{OCR_SIZE}² (--no-crop, seeded canvases) in {secs:.1f}s; losses "
          f"{[round(x, 4) for x in losses]}; train step {step_ms:.2f} ms "
          f"({OCR_BATCH / step_ms * 1e3:.1f} images/s; batch upload "
          f"included, host rasterization {host_ms:.1f} ms not), peak "
          f"{peak:.2f} GiB [{card}]", flush=True)
    profile_run(f"ocr east train step (batch {OCR_BATCH} × {OCR_SIZE}²)",
                lambda: train_east.train_step(model, opt, batch, dev))
    del model, opt

    # (c) detection: oracle maps through the native NMS, timed forwards
    if detect.nms_backend() != "native":
        raise AssertionError("the native NMS (native/lanms.cpp) did not "
                             "build")
    rng = np.random.RandomState(3)
    boxes = []
    for _ in range(12):
        x0, y0 = rng.rand(2) * 100
        w, h = rng.rand(2) * 30 + 5
        boxes.append([x0, y0, x0 + w, y0, x0 + w, y0 + h, x0, y0 + h,
                      rng.rand()])
    boxes = np.asarray(boxes, np.float32)
    native = detect.nms_locality(boxes.copy(), 0.2)
    plain = detect.nms_locality_numpy(boxes.copy(), 0.2)
    if not (native.shape[1] == 9 and 1 <= len(native) <= len(boxes)
            and native[:, 8].max() >= boxes[:, 8].max() - 1e-5
            and len(plain) == len(native)
            and np.abs(np.sort(plain[:, 8]) - np.sort(native[:, 8])).max()
            <= 1e-4):
        raise AssertionError(f"native NMS {native} vs numpy {plain}")
    model = copy.deepcopy(ref).to(dev).eval()
    apply_fn = detect.east_apply_fn(dev)
    worst = 0.0
    for H, W in OCR_SHAPES:
        qs = _oracle_quads(H, W)
        score, geo, _ = rasterize_gt(qs, H, W)
        t0 = time.perf_counter()
        found = detect.get_boxes(score[..., 0], geo)
        decode_ms = (time.perf_counter() - t0) * 1e3
        n_pos = int((score > 0).sum())
        if found is None or len(found) != len(qs):
            raise AssertionError(f"oracle {H}×{W}: {len(qs)} boxes, decoded "
                                 f"{None if found is None else len(found)}")
        for q in qs:
            d = np.abs(found[:, :8] - q.reshape(-1)).max(axis=1).min()
            worst = max(worst, float(d))
        x = torch.ones((1, 3, H, W), device=dev)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: model(x), OCR_TIMED)
        # a render resized to /32 (one 32-px step under the shape), padded
        # back up to it
        x = np.full((H - 32, W - 32, 3), 0.95, np.float32)
        t0 = time.perf_counter()
        detect.detect_array(apply_fn, model, x, (W - 20, H - 20), pad_to=256)
        array_ms = (time.perf_counter() - t0) * 1e3
        print(f"ocr detect {H}×{W}: eval forward (batch 1) {fwd_ms:.2f} ms; "
              f"host decode of the oracle maps (get_boxes + native NMS, "
              f"{n_pos} positive pixels → {len(found)} boxes) "
              f"{decode_ms:.2f} ms; one detect_array call "
              f"{array_ms:.2f} ms [{card}]", flush=True)
    if worst > 1.0:
        raise AssertionError(f"oracle boxes decoded {worst:.3f} px off")
    print(f"ocr detect: every oracle box back within {worst:.4f} px through "
          f"the native NMS ({detect.nms_backend()})", flush=True)


def _zipf_ids(rng, n: int):
    """``n`` token ids in [0, EMB_VOCAB) with a code corpus's Zipf skew
    (a few ids take most rows: the gathers' and the atomics' hot rows)."""
    import numpy as np
    return ((rng.zipf(1.2, n) - 1) % EMB_VOCAB).astype(np.int64)


def _baseline_step(model, loss_fn, batch):
    """One step's loss and parameter gradients on the host."""
    import torch
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}


def baselines_phase(dev, work: str) -> None:
    """The baseline detectors and their embedding trainers
    (``tools/embeddings.py``, ``models/baselines.py``,
    ``train/train_baseline.py``, ``tools/eval_patches.py``) on the card at
    the JAX modules' default widths. (a) GloVe (``glove_fit``) over
    EMB_PAIRS seeded Zipf nonzeros at V = EMB_VOCAB, dim EMB_DIM for
    GLOVE_EPOCHS epochs and SGNS (``sgns_fit``) for SGNS_EPOCHS 8192-pair
    steps: ms per epoch, peak memory; both card against CPU on
    EMB_CHECK_PAIRS for 5 epochs at EMB_CHECK_LR in fp64 (rel L2 to the
    update ≤ BASE_TOL64) and fp32 (max |Δ| ≤ BASE_TOL32, the update ≥
    1000 × that). (b) SGNS and GloVe tables trained on the
    train split of BASE_CORPUS seeded synthetic functions, features built
    by ``build_graph_features`` / ``build_ivdetect_features`` over
    ``CodeRows`` (no pandas); one step's loss and gradients of Devign,
    GGNNSum, IVDetect and the metric learner card against CPU in fp64 on
    the same weights (loss and gradients ≤ BASE_TOL64); a
    warm-up epoch, then BASE_EPOCHS
    timed epochs of ``_bce_train`` (Devign), ``train_reveal`` (GGNNSum,
    SMOTE, metric learner) and ``train_ivdetect``, finite losses; each
    step timed on CUDA events and profiled (idle share), the TreeLSTM's
    forward + backward timed alone, peak memory. (c) The three trained
    detectors written by ``save_baseline_ckpt`` and served by
    ``eval_patches.make_baseline_fns`` on 24 ``make_patch_pairs`` twins:
    finite probabilities in [0, 1]."""
    import copy
    import random

    import numpy as np
    import torch

    from mvuld_tpu_torch.models import baselines as bl
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.tools import embeddings as E
    from mvuld_tpu_torch.tools.eval_patches import (_valid_code,
                                                    make_baseline_fns)
    from mvuld_tpu_torch.tools.patch_eval import make_patch_pairs
    from mvuld_tpu_torch.tools.synthetic import generate_function
    from mvuld_tpu_torch.train import train_baseline as tb

    t_phase = time.perf_counter()
    card = card_line()
    cpu = torch.device("cpu")
    f64 = torch.float64

    # (a) the embedding trainers at the vocabulary cap
    rng = np.random.RandomState(0)
    rows, cols = _zipf_ids(rng, EMB_PAIRS), _zipf_ids(rng, EMB_PAIRS)
    vals = rng.uniform(0.1, 100.0, EMB_PAIRS).astype(np.float32)
    pairs = np.stack([_zipf_ids(rng, EMB_PAIRS), _zipf_ids(rng, EMB_PAIRS)],
                     1)
    C = EMB_CHECK_PAIRS
    fits = {
        "glove": (lambda n, e, d, dt, lr=0.05: E.glove_fit(
            rows[:n], cols[:n], vals[:n], EMB_VOCAB, EMB_DIM, e, lr, seed=0,
            device=d, dtype=dt), GLOVE_EPOCHS, EMB_PAIRS),
        "sgns": (lambda n, e, d, dt, lr=0.05: E.sgns_fit(
            pairs[:n], EMB_VOCAB, EMB_DIM, e, lr, negatives=5, seed=0,
            device=d, dtype=dt), SGNS_EPOCHS, min(8192, EMB_PAIRS)),
    }
    # the vectors both fits start from, as they draw them (float32 draws)
    r0 = np.random.RandomState(0)
    starts = {"glove": sum((r0.uniform(-0.5, 0.5, (EMB_VOCAB, EMB_DIM))
                            / EMB_DIM).astype(np.float32).astype(np.float64)
                           for _ in range(2)),
              "sgns": (np.random.RandomState(0).randn(EMB_VOCAB, EMB_DIM)
                       * 0.1).astype(np.float32).astype(np.float64)}
    for name, (fit, epochs, per_step) in fits.items():
        fit(EMB_PAIRS, 2, dev, None)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vec, losses = fit(EMB_PAIRS, epochs, dev, None)    # host copy: synced
        ms = (time.perf_counter() - t0) * 1e3 / epochs
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not (np.isfinite(vec).all() and np.isfinite(losses).all()):
            raise AssertionError(f"{name}: non-finite vectors or losses")
        lr = EMB_CHECK_LR[name]
        exact, _ = fit(C, 5, cpu, f64, lr)
        want, _ = fit(C, 5, cpu, None, lr)
        got64, _ = fit(C, 5, dev, f64, lr)
        got, _ = fit(C, 5, dev, None, lr)
        update = exact - starts[name]
        moved = float(np.abs(update).max())
        e64 = float(np.linalg.norm(got64 - exact) / np.linalg.norm(update))
        e32 = float(np.abs(got - want).max())
        own = float(np.abs(want - exact).max())
        print(f"baselines {name}: V {EMB_VOCAB}, dim {EMB_DIM}, P "
              f"{EMB_PAIRS} ({per_step} rows per step), {epochs} epochs "
              f"{ms:.3f} ms/epoch (upload included), loss {losses[0]:.4g} "
              f"→ {losses[-1]:.4g}, peak {peak:.2f} GiB; card vs CPU on "
              f"{C} pairs × 5 epochs at lr {lr:g} (update max |Δ| "
              f"{moved:.3g}): fp64 rel L2 to the update {e64:.2e} (tol "
              f"{BASE_TOL64:.0e}), fp32 max |Δ| {e32:.2e} (tol "
              f"{BASE_TOL32:.0e}; the CPU fp32's own from fp64 {own:.2e}) "
              f"[{card}]", flush=True)
        if not (e64 <= BASE_TOL64 and e32 <= BASE_TOL32
                and moved >= 1000 * BASE_TOL32):
            raise AssertionError(f"{name}: card disagrees with the CPU, or "
                                 f"the check's update is too small")
    del rows, cols, vals, pairs

    # (b) the three trainers on features of the port's build_*_features
    n_train, n_val, n_test = BASE_CORPUS
    gen_rng = random.Random(0)
    funcs = [generate_function(gen_rng, hard=i % 2 == 1)
             for i in range(sum(BASE_CORPUS))]
    parts = ["train"] * n_train + ["val"] * n_val + ["test"] * n_test
    source = tb.CodeRows([f for f, _ in funcs], [v for _, v in funcs], parts)
    corpus = [f for (f, _), p in zip(funcs, parts) if p == "train"]
    t0 = time.perf_counter()
    w2v = E.train_sgns(corpus, dim=EMB_DIM, epochs=60, device=dev)
    glove = E.train_glove(corpus, dim=EMB_DIM, epochs=40, device=dev)
    emb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = tb.build_graph_features(source, w2v, BASE_NODES)
    ivd = tb.build_ivdetect_features(source, glove, BASE_NODES)
    host_s = time.perf_counter() - t0
    sizes = {p: len(d["label"]) for p, d in graph.items()}
    print(f"baselines corpus: {sum(BASE_CORPUS)} seeded functions "
          f"{sizes}, vocabulary {len(w2v.vocab)}; SGNS + GloVe on the "
          f"train split {emb_s:.2f} s; features (CPG, {BASE_NODES} nodes, "
          f"IVDetect's 4 × {tb.SEQ_LEN} tokens) {host_s:.2f} s on the host",
          flush=True)

    def fresh(model):
        init_jax_like(model, torch.Generator().manual_seed(0))
        return model

    models = {"devign": fresh(bl.DevignModel()),
              "ggnn_sum": fresh(bl.GGNNSum()),
              "metric": fresh(bl.MetricLearningModel(200)),
              "ivdetect": fresh(bl.IVDetect())}
    B = BASE_BATCH

    def batch_of(split, keys, device, dtype=torch.float32):
        out = {}
        for k in list(keys) + ["label"]:
            t = torch.as_tensor(split[k][:B])
            out[k] = (t.to(device, dtype) if t.is_floating_point()
                      else t.to(device))
        return out

    x_rep = torch.randn(2 * B, 200, generator=torch.Generator().manual_seed(1))
    keep = models["metric"].keep_masks(B, torch.Generator().manual_seed(2),
                                       cpu)

    def metric_loss(ml, batch):
        idx = torch.arange(B, device=batch["x"].device)
        return tb.metric_step(ml, batch["x"], batch["label"], idx,
                              (idx + 3) % (2 * B), (idx + 7) % (2 * B),
                              [m.to(batch["x"].device) for m in batch["keep"]])

    steps = {
        "devign": (tb.bce_loss, lambda d, t: batch_of(graph["train"],
                                                      tb.GRAPH_KEYS, d, t)),
        "ggnn_sum": (tb.bce_loss, lambda d, t: batch_of(graph["train"],
                                                        tb.GRAPH_KEYS, d, t)),
        "metric": (metric_loss, lambda d, t: {
            "x": x_rep.to(d, t), "keep": keep,
            "label": torch.arange(2 * B, device=d) % 2}),
        "ivdetect": (tb.ce_loss, lambda d, t: batch_of(ivd["train"],
                                                       tb.IVDETECT_KEYS, d,
                                                       t)),
    }
    for name, (loss_fn, make) in steps.items():
        l_cpu, g_cpu = _baseline_step(copy.deepcopy(models[name]).double(),
                                      loss_fn, make(cpu, f64))
        l_dev, g_dev = _baseline_step(
            copy.deepcopy(models[name]).double().to(dev), loss_fn,
            make(dev, f64))
        e_loss = abs(l_dev - l_cpu) / max(abs(l_cpu), 1e-30)
        worst = max(g_cpu, key=lambda k: _rel_l2(g_dev[k], g_cpu[k]))
        e_grad = _rel_l2(g_dev[worst], g_cpu[worst])
        print(f"baselines {name}: one step at batch {B} card vs CPU in fp64 "
              f"on the same weights: loss {l_dev:.6f} (rel {e_loss:.2e}, "
              f"tol {BASE_TOL64:.0e}), gradients worst rel L2 {e_grad:.2e} "
              f"({worst}; tol {BASE_TOL64:.0e})", flush=True)
        if not (e_loss <= BASE_TOL64 and e_grad <= BASE_TOL64):
            raise AssertionError(f"baselines {name}: card vs CPU in fp64")

    def run_log(name):
        """A logger of the trainer's lines into ``work``/baseline_run_NAME/
        log_rank0.txt (``results_table`` reads its test line)."""
        path = os.path.join(work, f"baseline_run_{name}", "log_rank0.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)

        def info(msg):
            with open(path, "a") as f:
                f.write(f"{msg}\n")
        return SimpleNamespace(info=info)

    def train(name, epochs):
        """The trainer of ``name`` on copies of the seeded models; the
        trained modules."""
        common = dict(lr=1e-3, seed=0, batch_size=B, logger=run_log(name),
                      device=dev)
        if name == "devign":
            m = copy.deepcopy(models["devign"]).to(dev)
            tb._bce_train(m, graph, epochs, **common)
            return [m]
        if name == "reveal":
            g = copy.deepcopy(models["ggnn_sum"]).to(dev)
            ml = copy.deepcopy(models["metric"]).to(dev)
            tb.train_reveal(g, ml, graph, epochs, **common)
            return [g, ml]
        m = copy.deepcopy(models["ivdetect"]).to(dev)
        tb.train_ivdetect(m, ivd, epochs, **common)
        return [m]

    trained = {}
    per_epoch = max(sizes["train"] // B, 1)
    for name in ("devign", "reveal", "ivdetect"):
        train(name, 1)                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train(name, BASE_EPOCHS)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [x for m in out for x in m.losses]
        if not np.isfinite(losses).all():
            raise AssertionError(f"baselines {name}: losses {losses}")
        trained[name] = out
        print(f"baselines train {name}: {BASE_EPOCHS} epochs of {per_epoch} "
              f"steps at batch {B} in {secs:.2f} s (eval, "
              f"{'SMOTE, metric learner, ' if name == 'reveal' else ''}"
              f"uploads included), losses "
              f"{[round(x, 4) for x in losses]}, peak {peak:.2f} GiB "
              f"[{card}]", flush=True)

    def timed_step(name, model):
        loss_fn, make = steps[name]
        model = copy.deepcopy(model).to(dev)
        opt = tb.adam(model, 1e-3)
        batch = make(dev, torch.float32)

        def step():
            opt.update(torch.autograd.grad(loss_fn(model, batch),
                                           opt.params))
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, BASE_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"baselines step {name}: {ms:.2f} ms per train step at batch "
              f"{B} (forward, backward, Adam; CUDA events), peak "
              f"{peak:.2f} GiB [{card}]", flush=True)
        profile_run(f"baselines {name} train step", step)
        return ms, model

    for name in ("devign", "ggnn_sum", "metric"):
        timed_step(name, models[name])
    iv_ms, iv = timed_step("ivdetect", models["ivdetect"])
    b = batch_of(ivd["train"], tb.IVDETECT_KEYS, dev)
    x = torch.randn(B, BASE_NODES, iv.hidden, device=dev, requires_grad=True)
    tree = list(iv.treelstm.parameters())
    tl_ms = time_ms(lambda: torch.autograd.grad(
        iv.treelstm(x, b["ast"], b["node_mask"]).sum(), [x] + tree),
        BASE_TIMED)
    print(f"baselines step ivdetect: the TreeLSTM's forward + backward "
          f"alone ({BASE_NODES}-step loop each way) {tl_ms:.2f} ms = "
          f"{tl_ms / iv_ms:.1%} of the step [{card}]", flush=True)

    # (c) serve the trained detectors through eval_patches
    vul, fix = make_patch_pairs(24, seed=7)
    codes = vul + fix
    n_valid = sum(_valid_code(c) for c in codes)
    ckpts = {
        "devign": {"model": "devign", "params": trained["devign"][0],
                   "emb_vocab": w2v.vocab, "emb_vectors": w2v.vectors},
        "reveal": {"model": "reveal", "params": trained["reveal"][0],
                   "ml_params": trained["reveal"][1], "emb_vocab": w2v.vocab,
                   "emb_vectors": w2v.vectors},
        "ivdetect": {"model": "ivdetect", "params": trained["ivdetect"][0],
                     "emb_vocab": glove.vocab, "emb_vectors": glove.vectors,
                     "hidden": trained["ivdetect"][0].hidden},
    }
    for name, payload in ckpts.items():
        out = os.path.join(work, f"baseline_{name}")
        tb.save_baseline_ckpt(out, {**payload, "max_nodes": BASE_NODES,
                                    "emb_dim": EMB_DIM})
        run, _ = make_baseline_fns(out, B, dev)
        run(codes[:B])                                     # warm-up
        t0 = time.perf_counter()
        probs, reprs = run(codes)
        ms = (time.perf_counter() - t0) * 1e3
        ok = (len(probs) == n_valid and np.isfinite(probs).all()
              and ((probs >= 0) & (probs <= 1)).all()
              and (reprs is None or np.isfinite(reprs).all()))
        print(f"baselines serve {name}: {len(probs)} of {len(codes)} twins "
              f"(vulnerable + patched) through eval_patches in {ms:.1f} ms "
              f"(host features included), P(vul) "
              f"{probs.min():.4f}-{probs.max():.4f}"
              f"{'' if reprs is None else f', reprs {reprs.shape}'}"
              f"{'' if ok else ' FAILED'} [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"baselines serve {name}")
    print(f"baselines: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -------------------------------------------------------------- Swin family

def _family_config(opts, extra=()):
    from mvuld_tpu_torch.config import get_config
    return get_config(SimpleNamespace(
        cfg=None, opts=list(opts) + ["MODEL.NUM_CLASSES", 2,
                                     "PARALLEL.DTYPE", "bfloat16",
                                     "SEED", 0] + list(extra),
        output=tempfile.gettempdir()))


def _family_models():
    """(label, opts, kind) of the four types; swinv2 at the published 448
    fine-tune config, every stage checkpointed (build_model's rule)."""
    v2 = (["MODEL.TYPE", "swinv2"] + MODEL_OPTS[:16]
          + ["TRAIN.FUSED_MLP", True, "TRAIN.USE_CHECKPOINT", True])
    return [("SwinV1-B 224", SWIN_B, "swin"),
            ("Swin-MLP-B 224", SWIN_MLP_B, "swin_mlp"),
            ("Swin-MoE-S 192 (8 experts on one card)", SWIN_MOE_S,
             "swin_moe"),
            ("SwinV2-B 448 (window 28)", v2, "swinv2")]


def _family_step(model, x, labels, moe: bool):
    """One train-mode step's (logits, aux, loss, {name: gradient}) on the
    host; no dropout (the config's rates are 0), no gate noise."""
    import torch

    from mvuld_tpu_torch.core.train_state import cross_entropy

    gen = torch.Generator(device=x.device).manual_seed(0)
    out = model(x, train=True, gen=gen)
    logits, aux = out if moe else (out, None)
    loss = cross_entropy(logits, labels, 0.0)
    if moe:
        loss = loss + aux
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return (logits.detach().cpu(),
            None if aux is None else aux.detach().cpu().reshape(1),
            loss.detach().cpu().reshape(1),
            {n: g.cpu() for n, g in zip(names, grads)})


def _routes(model):
    """Every MoE layer's (experts [k, T], keep [k, T]) of the last
    forward, on the host."""
    return [(m.routing[0].cpu(), m.routing[1].cpu())
            for m in model.moe_layers()]


def _rerouted(card, cpu, batch: int):
    """(token slots whose expert or keep differ between two runs' routings,
    their total, the set of images that hold one)."""
    moved, total, images = 0, 0, set()
    for (e_a, k_a), (e_b, k_b) in zip(card, cpu):
        diff = ((e_a != e_b) | (k_a != k_b)).any(0)           # [T]
        moved += int(diff.sum())
        total += diff.numel()
        per_image = diff.numel() // batch
        images |= {int(t) // per_image for t in diff.nonzero().flatten()}
    return moved, total, images


def _family_check(dev, label, opts, kind):
    """Card against CPU at depths 2-2-2-2, one train-mode step: fp64
    within FAMILY_TOL64; fp32 by the zoo's rule, the MoE's routings
    compared first."""
    import copy

    import numpy as np
    import torch

    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_variants import build_model

    sec = {"swin": "SWIN", "swin_mlp": "SWIN_MLP", "swin_moe": "SWIN_MOE",
           "swinv2": "SWINV2"}[kind]
    extra = [f"MODEL.{sec}.DEPTHS", [2, 2, 2, 2], "MODEL.DROP_PATH_RATE",
             0.0, "MODEL.DROP_RATE", 0.0, "TRAIN.USE_CHECKPOINT", False]
    if kind == "swin_moe":
        extra += ["MODEL.SWIN_MOE.MOE_BLOCKS", [[-1], [-1], [1], [1]],
                  "MODEL.SWIN_MOE.GATE_NOISE", 0.0]
    moe = kind == "swin_moe"
    c64 = _family_config(opts, extra + ["PARALLEL.DTYPE", "float64"])
    c32 = _family_config(opts, extra + ["PARALLEL.DTYPE", "float32"])
    ref = build_model(c32)
    init_jax_like(ref, torch.Generator().manual_seed(0))
    m64 = build_model(c64)
    m64.load_state_dict(ref.state_dict())
    m64.double()
    S = c32.DATA.IMG_SIZE
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(FAMILY_CHECK, S, S, 3))
    y = torch.as_tensor(np.arange(FAMILY_CHECK) % 2)
    t0 = time.perf_counter()
    exact = _family_step(m64, x, y, moe)
    got64 = _family_step(copy.deepcopy(m64).to(dev), x.to(dev), y.to(dev),
                         moe)
    want = _family_step(ref, x.float(), y, moe)
    if moe:
        want_routes = _routes(ref)
    card = copy.deepcopy(ref).to(dev)
    got = _family_step(card, x.float().to(dev), y.to(dev), moe)
    cpu_s = time.perf_counter() - t0
    outs = [i for i in (0, 1, 2) if exact[i] is not None]
    e64 = max([_rel_l2(got64[i], exact[i]) for i in outs]
              + [_rel_l2(got64[3][k], exact[3][k]) for k in exact[3]])
    moved, images = 0, set()
    if moe:
        moved, total, images = _rerouted(_routes(card), want_routes,
                                         FAMILY_CHECK)
    # a token re-routed near a tie is no fault: hold the logits of the
    # other images, and print the rest
    keep = [i for i in range(FAMILY_CHECK) if i not in images]
    held = [_held(got[0][keep], want[0][keep], exact[0][keep], ZOO_TOL)]
    held += [_held(got[i], want[i], exact[i], ZOO_TOL) for i in outs[1:]]
    e_grad, worst, r_grad, ok_grad = _held_all(
        got[3], want[3], {k: v.double() for k, v in exact[3].items()},
        ZOO_GRAD_TOL)
    ok = e64 <= FAMILY_TOL64 and held[0][2] and (
        moved > 0 or (all(h[2] for h in held) and ok_grad))
    names = ["logits", "aux", "loss"]
    fp32 = ", ".join(f"{names[i]} {h[0]:.2e}{_ratio(h[1])}"
                     for i, h in zip(outs, held))
    route = (f"; routing: {moved} of {total} token slots change expert or "
             f"keep between card and CPU in fp32"
             + (f" (images {sorted(images)}: the logits held on the others, "
                f"aux, loss and gradients printed, not held)" if moved
                else "") if moe else "")
    print(f"family {label} card vs CPU (depths 2-2-2-2, batch "
          f"{FAMILY_CHECK}, one train-mode step, {cpu_s:.1f} s): fp64 worst "
          f"rel L2 {e64:.2e} (tol {FAMILY_TOL64:.0e}); fp32 {fp32}, "
          f"gradients {e_grad:.2e} ({worst}){_ratio(r_grad)} (tol "
          f"{ZOO_TOL:.0e} / {ZOO_GRAD_TOL:.0e}, else ≤ ×{ZOO_NOISE:g})"
          f"{route}{'' if ok else ' FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"family {label}: card vs CPU")


def swin_family_phase(dev, counters):
    """``build_model``'s four types at full width on the card: a warm-up
    and FAMILY_TIMED AdamW steps at FAMILY_BATCH (CE, plus the MoE's aux
    loss), CUDA events per step, images/s, peak memory, the MoE's dropped
    share; swinv2 runs the kernels (K1, K2, K3, K3b counted). Then each
    type card against CPU (``_family_check``). Returns the launches."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.schedule import build_schedule
    from mvuld_tpu_torch.core.train_state import image_inputs, train_step
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_variants import build_model

    t_phase = time.perf_counter()
    total = dict.fromkeys(_counts(counters), 0)
    B = FAMILY_BATCH
    for label, opts, kind in _family_models():
        cfg = _family_config(opts, ["DATA.BATCH_SIZE", B])
        model = build_model(cfg, **({"kernels": True} if kind == "swinv2"
                                    else {}))
        init_jax_like(model, torch.Generator().manual_seed(0))
        model.to(dev)
        n_params = sum(p.numel() for p in model.parameters())
        opt = build_optimizer(cfg, build_schedule(cfg, 10, B), model)
        S = cfg.DATA.IMG_SIZE
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"image": torch.randn(B, S, S, 3, device=dev, generator=gen),
                 "label": torch.arange(B, device=dev) % 2}
        moe = kind == "swin_moe"

        def step():
            return train_step(model, opt, batch, gen, 0.1, image_inputs,
                              aux_loss=moe)

        step()                                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(FAMILY_TIMED + 1)]
        metrics, dropped = [], []
        events[0].record()
        for i in range(FAMILY_TIMED):
            metrics.append(step())
            events[i + 1].record()
            if moe:
                _, keep = zip(*(m.routing for m in model.moe_layers()))
                dropped.append(sum((~k).sum() for k in keep)
                               / sum(k.numel() for k in keep))
        torch.cuda.synchronize()
        counts = _counts(counters)
        for k, v in counts.items():
            total[k] += v
        times = [events[i].elapsed_time(events[i + 1])
                 for i in range(FAMILY_TIMED)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        ms = statistics.median(times)
        drop = (f", dropped share of token slots at capacity factor "
                f"{cfg.MODEL.SWIN_MOE.CAPACITY_FACTOR} "
                f"{float(sum(dropped)) / len(dropped):.4f} (per step "
                f"{[round(float(d), 4) for d in dropped]})" if moe else "")
        print(f"family {label}: {n_params / 1e6:.2f}M params, batch {B} "
              f"bf16, {FAMILY_TIMED} AdamW steps after a warm-up, median "
              f"{ms:.1f} ms/step = {B / ms * 1e3:.1f} images/s (steps "
              f"{', '.join(f'{t:.1f}' for t in times)} ms), peak memory "
              f"{peak:.2f} GiB, loss/grad_norm "
              f"{[(round(a, 4), round(g, 3)) for a, g in vals]}{drop}"
              f"{'' if kind != 'swinv2' else f', launches { {k: v for k, v in counts.items() if v} }'}"
              f" [{card_line()}]", flush=True)
        if not np.isfinite(vals).all():
            raise AssertionError(f"family {label}: non-finite {vals}")
        if kind == "swinv2" and not all(
                counts[k] for k in ("window_attention_flat",
                                    "window_attention_flat_bwd", "mlp_ln",
                                    "mlp_ln_bwd")):
            raise AssertionError(f"family {label}: launches {counts}")
        profile_run(f"family {label} train step (batch {B})", step)
        del model, opt, batch
        torch.cuda.empty_cache()
        _family_check(dev, label, opts, kind)
        torch.cuda.empty_cache()
    print(f"family: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# ------------------------------------------------------------------- causal

def _lm(dtype, fused: bool, layers: int = 12):
    """``UniXcoderLM`` at UniXcoder-base width (``layers`` deep), seed-0
    weights (fp32 parameters, ``dtype`` activations)."""
    import torch

    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.roberta import RobertaConfig
    from mvuld_tpu_torch.models.unixcoder import UniXcoderLM

    model = UniXcoderLM(RobertaConfig(num_layers=layers, dtype=dtype,
                                      use_pallas_mlp=fused))
    init_jax_like(model, torch.Generator().manual_seed(0))
    return model.eval()


def causal_phase(dev, counters):
    """The causal text model (``UniXcoderLM``, ``beam_search_generate``)
    at UniXcoder-base width, bf16. Main path, launches counted: the
    logits of CAUSAL_BATCH × CAUSAL_TOKENS seeded tokens through K4
    (``use_pallas_mlp``, TRAIN.FUSED_MLP), then beam search at beam
    BEAM to BEAM_MAX tokens over BEAM_PREFIXES seeded prefixes, ms per
    generated token. Checks: the kernel logits' error from the plain fp32
    layers within CAUSAL_NOISE × the plain bf16 layers' own; card = CPU
    in fp64 at CAUSAL_DEPTH64 layers; in fp32 the kernel and plain paths
    generate identical ids, in bf16 their agreement is printed. Returns
    the launches."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.models.unixcoder import beam_search_generate

    t_phase = time.perf_counter()
    rng = np.random.RandomState(11)
    kern = _lm(torch.bfloat16, True).to(dev)
    plain = _lm(torch.bfloat16, False).to(dev)
    V = kern.config.vocab_size
    layers, hidden = kern.config.num_layers, kern.config.hidden_size
    ids = rng.randint(3, V, (CAUSAL_BATCH, CAUSAL_TOKENS))
    for i in range(1, CAUSAL_BATCH):                # padded tails
        ids[i, CAUSAL_TOKENS - 37 * i:] = 1
    ids = torch.as_tensor(ids, device=dev)
    prefixes = rng.randint(3, V, (BEAM_PREFIXES, BEAM_PREFIX))
    _reset(counters)
    with torch.no_grad():
        got = kern(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_k = beam_search_generate(kern, prefixes, BEAM, BEAM_MAX)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    counts = _counts(counters)
    n_new = sum(len(g) - BEAM_PREFIX for g in gen_k)
    with torch.no_grad():
        base = plain(ids)
        gen_p = beam_search_generate(plain, prefixes, BEAM, BEAM_MAX)
        ref = _lm(torch.float32, False).to(dev)(ids)
    e_k, e_p = rel_l2(got, ref), rel_l2(base, ref)
    agree = np.mean([a == b for g, h in zip(gen_k, gen_p)
                     for a, b in zip(g, h)])
    del kern, plain, got, base, ref
    torch.cuda.empty_cache()

    with torch.no_grad():
        k32 = _lm(torch.float32, True).to(dev)
        ids32 = beam_search_generate(k32, prefixes, BEAM, BEAM_MAX)
        del k32
        p32 = _lm(torch.float32, False).to(dev)
        ids32_plain = beam_search_generate(p32, prefixes, BEAM, BEAM_MAX)
        del p32
        m64 = _lm(torch.float64, False, CAUSAL_DEPTH64).double()
        short = ids[:2, :64].cpu()
        want64 = m64(short)
        got64 = m64.to(dev)(short.to(dev)).cpu()
    e64 = float((got64 - want64).norm() / want64.norm())
    del m64
    torch.cuda.empty_cache()
    ok = (e_k <= CAUSAL_NOISE * e_p and e64 <= CAUSAL_TOL64
          and ids32 == ids32_plain and counts["mlp_ln_res"] > 0)
    print(f"causal: UniXcoderLM ({layers} layers, H {hidden}, vocab {V}) "
          f"bf16 logits [{CAUSAL_BATCH}, {CAUSAL_TOKENS}, {V}] through K4: "
          f"rel L2 from plain fp32 {e_k:.3e} (plain bf16 {e_p:.3e}, bound "
          f"×{CAUSAL_NOISE:g}); card vs CPU fp64 at {CAUSAL_DEPTH64} layers "
          f"{e64:.2e} (tol {CAUSAL_TOL64:.0e}); beam {BEAM} to {BEAM_MAX} "
          f"over {BEAM_PREFIXES} prefixes of {BEAM_PREFIX}: fp32 kernel ids "
          f"{'==' if ids32 == ids32_plain else '!='} plain ids, bf16 "
          f"kernel/plain agreement {agree:.4f}, {n_new} tokens in "
          f"{t_gen:.2f} s = {t_gen / max(n_new, 1) * 1e3:.2f} ms per "
          f"generated token (bf16, kernels); launches "
          f"{ {k: v for k, v in counts.items() if v} }; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line()}]"
          f"{'' if ok else ' FAILED'}", flush=True)
    if not ok:
        raise AssertionError("causal: the LM's checks failed")
    return counts


# ----------------------------------------------------------------- parallel

def _grads_of(model, loss):
    import torch
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    return dict(zip(names, torch.autograd.grad(loss, params,
                                               allow_unused=True)))


def _worst(got, want):
    """(the relative L2 of all the tensors of two {name: tensor} dicts
    joined, the largest per-tensor relative L2, its name); None entries
    skipped. The joined error is the one held: a tensor whose exact value
    cancels (the attention key bias's gradient) has a per-tensor error of
    pure rounding noise."""
    keys = [k for k in want if want[k] is not None
            and got.get(k) is not None]
    errs = {k: rel_l2(got[k], want[k]) for k in keys}
    k = max(errs, key=errs.get)
    num = sum(float((got[n].float() - want[n].float()).norm()) ** 2
              for n in keys)
    den = sum(float(want[n].float().norm()) ** 2 for n in keys)
    return (num / max(den, 1e-30)) ** 0.5, errs[k], k


def _dp_e2e(rank, dev, counters):
    """The data-parallel e2e step at batch PAR_BATCH (PAR_BATCH / 2 per
    rank), fp32 through the kernels, against the one-rank step (rank 0,
    the whole batch): loss, gradients (after the dp mean), BatchNorm
    statistics. Launches of the dp step counted."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.train_state import (cross_entropy,
                                                  model_inputs)
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.parallel.mesh import (make_mesh, mean_over_dp,
                                               reduce_gradients, shard_batch,
                                               sync_batch_norm)
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_e2e import build_e2e_model

    opts = MODEL_OPTS + TRAIN_OPTS + ["PARALLEL.DTYPE", "float32"]
    cfg = get_config(SimpleNamespace(cfg=None, opts=opts,
                                     output=tempfile.gettempdir()))
    host = requests(cfg, PAR_BATCH, seed=3)
    host["label"] = (np.arange(PAR_BATCH) % 2).astype(np.int32)

    def model():
        m, _, _ = build_e2e_model(cfg, VOCAB, node_capacity=NODE_CAPACITY,
                                  use_pallas=True, roberta_pallas_mlp=True,
                                  use_pallas_mlp=True)
        init_jax_like(m, torch.Generator().manual_seed(0))
        return m.to(dev)

    def step(m, batch, mesh=None):
        out = m(**model_inputs(batch), train=True, gen=None)
        loss = cross_entropy(out, batch["label"], 0.1)
        grads = _grads_of(m, loss)
        if mesh is not None:
            names = list(grads)
            grads = dict(zip(names, reduce_gradients(
                mesh, [grads[n] if grads[n] is not None
                       else torch.zeros(1, device=dev) for n in names])))
            loss = mean_over_dp(mesh, loss)
        stats = {k: v.detach().clone() for k, v in m.state_dict().items()
                 if "running_" in k}
        return loss.detach(), grads, stats

    ref = None
    if rank == 0:
        m1 = model()
        ref = step(m1, to_device(host, dev))
        ref = (ref[0].cpu(), {k: None if g is None else g.cpu()
                              for k, g in ref[1].items()},
               {k: v.cpu() for k, v in ref[2].items()})
        del m1
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh()
    m2 = sync_batch_norm(mesh, model())
    _reset(counters)
    got = step(m2, to_device(shard_batch(mesh, host), dev), mesh)
    torch.cuda.synchronize()
    counts = _counts(counters)
    out = {"counts": counts}
    if rank == 0:
        out.update(loss=(float(got[0]), float(ref[0])),
                   grad=_worst({k: None if g is None else g.cpu()
                                for k, g in got[1].items()}, ref[1]),
                   stats=_worst({k: v.cpu() for k, v in got[2].items()},
                                ref[2]))
    del m2
    torch.cuda.empty_cache()
    return out


def _sp_plain(H, N, nW):
    """The sharded attention's plain version: K1 and K2 replaced by their
    plain versions over slices of whole images' windows (``by_windows``),
    the gathers and sums as they are; a quarter of SCORE_BYTES per slice,
    as two ranks share the card. A context: the module's names are
    restored on exit."""
    import contextlib

    from mvuld_tpu_torch.ops import window_attention as wa

    def fwd(q, b, s, shift, nWh, nWw, return_rowsum=False, mxu_bf16=False):
        return by_windows(lambda w: wa.window_attention_flat_plain(
            q[w], b, s, shift, nWh, nWw, return_rowsum=True),
            q.shape[0], nW, H, N, budget=SCORE_BYTES // 4)

    def bwd(q, b, s, o, r, g, shift, nWh, nWw, mxu_bf16=False):
        return by_windows(lambda w: wa.window_attention_flat_bwd_plain(
            q[w], b, s, o[w], r[w], g[w], shift, nWh, nWw),
            q.shape[0], nW, H, N, 2, budget=SCORE_BYTES // 4)

    @contextlib.contextmanager
    def patched():
        kept = wa.window_attention_flat, wa.window_attention_flat_bwd
        wa.window_attention_flat, wa.window_attention_flat_bwd = fwd, bwd
        try:
            yield
        finally:
            wa.window_attention_flat, wa.window_attention_flat_bwd = kept

    return patched()


def _sp_attention(rank, dev, group):
    """The sharded flat attention (K1 forward, K2 backward per block) at
    the fine-tune's batch-64 shapes against the unsharded one on the same
    inputs, and both timed (forward + backward), beside the sharded op's
    plain version (K1/K2's plain versions) and its bound: K1's and K2's
    bounds (§6's rule) on this rank's half of the windows."""
    import torch

    from mvuld_tpu_torch.ops.window_attention import (
        flat_attention, window_attention_flat_sharded)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for stage, Bn, N, C, H, shift, nWh, _per in SWIN_K1_SHAPES:
        qkv = torch.randn(Bn, N, 3 * C, device=dev, generator=gen,
                          dtype=torch.bfloat16)
        bias = torch.randn(H, N, N, device=dev, generator=gen)
        scale = torch.rand(H, device=dev, generator=gen) * 9 + 1
        g = torch.randn(Bn, N, C, device=dev, generator=gen,
                        dtype=torch.bfloat16)

        def run(sharded):
            q, b, s = (t.clone().requires_grad_(True)
                       for t in (qkv, bias, scale))
            out, _ = (window_attention_flat_sharded(q, b, s, shift, nWh, nWh,
                                                    group) if sharded
                      else flat_attention(q, b, s, shift, nWh, nWh))
            out.backward(g)
            return out.detach(), q.grad, b.grad, s.grad

        want, got = run(False), run(True)
        errs = ([rel_err(got[i], want[i]) for i in (0, 1)]
                + [rel_l2(got[i], want[i]) for i in (2, 3)])
        with _sp_plain(H, N, nWh * nWh):
            plain_ms = time_ms(lambda: run(True), 1)
        torch.cuda.empty_cache()        # the plain versions' score blocks
        n, hd = Bn // 2, C // H            # this rank's windows
        exps = n * H * N * N / SFU_EXP_S
        k1 = max(4 * n * H * N * N * hd / BF16_TC_FLOP_S, exps,
                 (n * N * 3 * C * 2 + H * N * N * 4 + n * N * C * 2)
                 / HBM_BYTES_S)
        k2 = max(10 * n * H * N * N * hd / BF16_TC_FLOP_S, exps,
                 (2 * n * N * 3 * C * 2 + 2 * n * N * C * 2 + n * H * N * 4
                  + 2 * H * N * N * 4) / HBM_BYTES_S)
        bound_ms = (k1 + k2) * 1e3
        rows.append((stage, shift, Bn, errs, time_ms(lambda: run(True), 3),
                     time_ms(lambda: run(False), 3), plain_ms, bound_ms))
    return rows


def _sp_model(rank, dev, group, counters):
    """SwinV2-B 448 at the fine-tune's batch with the sequence-parallel
    attention: one train step (kernels, every stage checkpointed), K1/K2
    launches counted per rank; rank 0 then takes the same step unsharded
    and compares loss and gradients."""
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.core.train_state import cross_entropy
    from mvuld_tpu_torch.models.swin_v2 import sequence_parallel
    from mvuld_tpu_torch.train.train_swin import build_swin_training

    cfg = _family_config(SWIN_OPTS, ["DATA.BATCH_SIZE", SWIN_BATCH,
                                     "TRAIN.REMAT_STAGES", []])
    S = cfg.DATA.IMG_SIZE
    x = torch.randn(SWIN_BATCH, S, S, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    y = torch.arange(SWIN_BATCH, device=dev) % 2

    def step(model):
        loss = cross_entropy(model(x, train=True), y, 0.1)
        return loss.detach().cpu(), {k: g.cpu() for k, g in
                                     _grads_of(model, loss).items()}

    run = build_swin_training(cfg, dev, kernels=True)
    sequence_parallel(run.model, group)
    _reset(counters)
    got = step(run.model)
    torch.cuda.synchronize()
    counts = _counts(counters)
    del run
    torch.cuda.empty_cache()
    out = {"counts": counts}
    dist.barrier()
    if rank == 0:
        run = build_swin_training(cfg, dev, kernels=True)
        want = step(run.model)
        del run
        torch.cuda.empty_cache()
        out.update(loss=(float(got[0]), float(want[0])),
                   grad=_worst(got[1], want[1]))
    dist.barrier()
    return out


def _tp_swin(rank, dev):
    """One AdamW step of SwinV2-B 448 at mp 2, fp32 (``shard_params_tp``;
    the MLP on its plain layers, the attention through K1/K2 on the rank's
    heads) against the one-rank step on the same batch: loss, the global
    gradient norm, and each rank's gradient slices."""
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.core.optim import build_optimizer
    from mvuld_tpu_torch.core.train_state import image_inputs, train_step
    from mvuld_tpu_torch.parallel.mesh import (make_mesh, shard_params_tp,
                                               tp_global_norm)
    from mvuld_tpu_torch.train.train_swin import build_swin_training

    cfg = _family_config(SWIN_OPTS, ["DATA.BATCH_SIZE", TP_BATCH,
                                     "PARALLEL.DTYPE", "float32"])
    gen = torch.Generator(device=dev).manual_seed(3)
    S = cfg.DATA.IMG_SIZE
    batch = {"image": torch.randn(TP_BATCH, S, S, 3, device=dev,
                                  generator=gen),
             "label": torch.arange(TP_BATCH, device=dev) % 2}
    mesh = make_mesh(dp=1, mp=2)

    def step(tp: bool):
        """(model, loss, grad norm, {name: gradient}) of one step."""
        model = build_swin_training(cfg, dev, kernels=True).model
        sharded = shard_params_tp(mesh, model) if tp else []
        opt = build_optimizer(cfg, lambda count: 1e-5, model)
        if tp:
            opt.norm = tp_global_norm(mesh, sharded, model)
        got, update = {}, opt.update
        opt.update = lambda g: (got.setdefault("g", g), update(g))
        m = train_step(model, opt, batch, None, 0.1, image_inputs)
        names = [n for n, _ in model.named_parameters()]
        return (model, float(m["loss"]), float(m["grad_norm"]),
                dict(zip(names, got["g"])), len(sharded))

    one, loss1, norm1, g1, _ = step(False)
    # the one-rank gradients sliced as shard_params_tp slices parameters
    with torch.no_grad():
        for n, p in one.named_parameters():
            p.data = g1[n].to(p.dtype)
    shard_params_tp(mesh, one)
    want = {n: p.detach().clone() for n, p in one.named_parameters()}
    del one, g1
    torch.cuda.empty_cache()
    tp, loss2, norm2, g2, n_sharded = step(True)
    grad = _worst(g2, want)
    del tp, g2, want
    torch.cuda.empty_cache()
    dist.barrier()
    return {"loss": (loss2, loss1), "norm": (norm2, norm1),
            "grad": grad, "sharded": n_sharded}


def _ep_moe(rank, world, dev, group):
    """Swin-MoE-S 192 with its 8 experts over the group (E/2 per rank),
    fp32 eval forward on this rank's half of PAR_MOE_BATCH images, against
    the one-card model on the whole batch: routings first, then logits of
    the images no token of which was re-routed."""
    import copy

    import torch

    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.moe import expert_parallel
    from mvuld_tpu_torch.models.swin_variants import build_model

    cfg = _family_config(SWIN_MOE_S, ["PARALLEL.DTYPE", "float32",
                                      "MODEL.SWIN_MOE.GATE_NOISE", 0.0])
    model = build_model(cfg)
    init_jax_like(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    ep = expert_parallel(copy.deepcopy(model), group)
    S = cfg.DATA.IMG_SIZE
    x = torch.randn(PAR_MOE_BATCH, S, S, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    n = PAR_MOE_BATCH // world
    with torch.no_grad():
        want, _ = model(x)
        want_routes = _routes(model)
        got, _ = ep(x[rank * n:(rank + 1) * n])
        got_routes = _routes(ep)
    # this rank's tokens are its block of each layer's global token order
    mine = [(e[:, rank * e.shape[1] // world:(rank + 1) * e.shape[1] // world],
             k[:, rank * k.shape[1] // world:(rank + 1) * k.shape[1] // world])
            for e, k in want_routes]
    moved, total, images = _rerouted(got_routes, mine, n)
    keep = [i for i in range(n) if i not in images]
    err = rel_l2(got[keep], want[rank * n:(rank + 1) * n][keep])
    return {"moved": (moved, total), "err": err, "held": len(keep),
            "experts": f"{ep.moe_layers()[0].w1.shape[0]} of "
                       f"{ep.moe_layers()[0].num_experts}"}


def parallel_world(rank: int, world: int, device: str):
    """One rank of the two-rank world on ``device`` (gloo): each check's
    results, with the launches of its main-path runs."""
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    counters = [wa.window_attention_flat, wa.window_attention_flat_bwd,
                fd.mlp_ln, fd.mlp_ln_bwd, fd.mlp_ln_res, fd.mlp_ln_res_bwd]
    group = dist.group.WORLD
    out, t = {}, time.perf_counter()
    out["dp"] = _dp_e2e(rank, dev, counters)
    out["sp_ops"] = _sp_attention(rank, dev, group)
    out["sp_model"] = _sp_model(rank, dev, group, counters)
    out["tp"] = _tp_swin(rank, dev)
    out["moe"] = _ep_moe(rank, world, dev, group)
    out["seconds"] = time.perf_counter() - t
    out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _nccl_e2e(dev, counters):
    """A world-1 group of the device's backend (NCCL on the card) through
    ``train_e2e.main``'s data-parallel path: one batch-16 step and the
    eval, from a seeded cache."""
    import torch
    import torch.distributed as dist

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.parallel.distributed import backend_for, free_port
    from mvuld_tpu_torch.train.train_e2e import main as train_main

    work = tempfile.mkdtemp(prefix="mvuld_nccl_")
    backend = backend_for(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev if backend == "nccl" else None)
    try:
        opts = MODEL_OPTS + TRAIN_OPTS
        cfg = get_config(SimpleNamespace(cfg=None, opts=opts, output=work))
        write_cache(cfg.OUTPUT, cfg, BATCH, BATCH)
        _reset(counters)
        t0 = time.perf_counter()
        res = train_main(["--output", work, "--device", dev.type,
                          "--node-capacity", str(NODE_CAPACITY), "--opts",
                          *_opts_args(opts)])
        torch.cuda.synchronize()
        counts = _counts(counters)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    val = {k: round(res["history"][0][k], 4) for k in ("acc", "f1")}
    print(f"parallel: world-1 {backend} group through train_e2e.main's dp "
          f"path, 1 step of batch {BATCH} + eval in "
          f"{time.perf_counter() - t0:.1f} s, val {val}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts


def _pp_text(dev, counters):
    """``train_text``'s pipelined classifier (PARALLEL.PP 2 × 4
    microbatches, both stages on the card) at UniXcoder-base, batch 16 ×
    512 through K4/K4b: a warm-up and TRAIN_STEPS timed AdamW steps
    (dropout on, launches counted), then one step without dropout against
    the sequential classifier on the same weights."""
    import numpy as np
    import torch

    from mvuld_tpu_torch.config import get_config
    from mvuld_tpu_torch.core.train_state import cross_entropy
    from mvuld_tpu_torch.data.loader import ArrayDataset
    from mvuld_tpu_torch.train.harness import to_device
    from mvuld_tpu_torch.train.train_text import build_text_training

    def build(pp):
        opts = MODEL_OPTS + ["DATA.BATCH_SIZE", BATCH, "SEED", 0,
                             "PARALLEL.PP", pp,
                             "PARALLEL.PP_MICROBATCHES", PP_MICRO]
        cfg = get_config(SimpleNamespace(cfg=None, opts=opts,
                                         output=tempfile.gettempdir()))
        arrs = requests(cfg, BATCH, seed=6)
        labels = (np.arange(BATCH) % 2).astype(np.int32)
        ds = {"train": ArrayDataset({"input_ids": arrs["func_ids"],
                                     "label": labels})}
        run = build_text_training(cfg, ds, VOCAB, dev, kernels=True)
        return run, to_device({"input_ids": arrs["func_ids"],
                               "label": labels}, dev)

    run, batch = build(2)
    gen = torch.Generator(device=dev).manual_seed(1)
    run.step(batch, gen)                                # warm-up
    torch.cuda.synchronize()
    _reset(counters)
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = run.step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _counts(counters)
    loss = float(m["loss"])

    def grads(r):
        out, _ = r.model(batch["input_ids"], train=True, gen=None)
        lval = cross_entropy(out, batch["label"], 0.1)
        return float(lval.detach()), {k: g.float().cpu() for k, g in
                             _grads_of(r.model, lval).items()}

    pp_loss, pp_grads = grads(run)
    state = run.model.state_dict()
    del run
    seq, _ = build(1)
    seq.model.load_state_dict(state)
    seq_loss, seq_grads = grads(seq)
    seq_ms = time_ms(lambda: seq.step(batch, gen), 2)
    del seq, state
    torch.cuda.empty_cache()
    err, worst, name = _worst(pp_grads, seq_grads)
    ok = (np.isfinite(loss) and abs(pp_loss - seq_loss) <= LOSS_TOL
          and err <= PAR_TOL16 and counts["mlp_ln_res"] > 0
          and counts["mlp_ln_res_bwd"] > 0)
    print(f"parallel: train_text PP 2 × {PP_MICRO} microbatches (both stages "
          f"on the card), UniXcoder-base batch {BATCH} × "
          f"{batch['input_ids'].shape[1]} through K4/K4b: "
          f"median {statistics.median(times):.1f} ms/step (steps "
          f"{', '.join(f'{t:.1f}' for t in times)}; sequential "
          f"{seq_ms:.1f} ms/step), loss {loss:.4f}; no-dropout step vs the "
          f"sequential encoder: loss {pp_loss:.5f} / {seq_loss:.5f}, "
          f"gradients rel L2 {err:.2e} (tol {PAR_TOL16:g}; worst tensor "
          f"{worst:.2e}, {name}); launches "
          f"{ {k: v for k, v in counts.items() if v} }"
          f"{'' if ok else ' FAILED'}", flush=True)
    if not ok:
        raise AssertionError("parallel: the pipelined text encoder")
    return counts


def parallel_phase(dev, counters):
    """The parallel layer on the card: (a) a world-1 NCCL group through
    ``train_e2e.main``'s dp path; (b) the pipelined ``train_text``
    classifier; (c) a two-rank gloo world on the one card
    (``parallel_world``): the dp e2e step, the sequence-parallel attention
    (ops and SwinV2-B 448 batch 64), a tensor-parallel SwinV2 step at mp
    2, Swin-MoE-S's experts over the two ranks, each against one rank.
    Returns the main paths' launches (both ranks' summed)."""
    import torch

    from mvuld_tpu_torch.parallel.distributed import run_local_world

    t_phase = time.perf_counter()
    total = dict.fromkeys(_counts(counters), 0)
    for counts in (_nccl_e2e(dev, counters), _pp_text(dev, counters)):
        for k, v in counts.items():
            total[k] += v
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local_world(parallel_world, 2, str(dev), backend="gloo",
                            timeout=PAR_TIMEOUT)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    bad = []
    for r in ranks:
        for part in ("dp", "sp_model"):
            for k, v in r[part]["counts"].items():
                total[k] += v
    dp = r0["dp"]
    per_rank = [{k: v for k, v in r["dp"]["counts"].items() if v}
                for r in ranks]
    print(f"parallel: dp e2e step, batch {PAR_BATCH} over 2 ranks on one "
          f"card (gloo) vs 1 rank: loss {dp['loss'][0]:.5f} / "
          f"{dp['loss'][1]:.5f}, gradients rel L2 {dp['grad'][0]:.2e} (worst "
          f"tensor {dp['grad'][1]:.2e}, {dp['grad'][2]}), BatchNorm "
          f"statistics rel L2 {dp['stats'][0]:.2e} (worst {dp['stats'][1]:.2e}"
          f", {dp['stats'][2]}), tol {PAR_TOL:g} (fp32); launches per rank "
          f"{per_rank}", flush=True)
    if abs(dp["loss"][0] - dp["loss"][1]) > PAR_TOL * abs(dp["loss"][1]) \
            or dp["grad"][0] > PAR_TOL or dp["stats"][0] > PAR_TOL:
        bad.append("dp")
    for stage, shift, Bn, errs, ms, ms1, plain, bound in r0["sp_ops"]:
        tol = 2.0 ** -6
        ok = errs[0] <= tol and errs[1] <= tol and max(errs[2:]) <= SP_TOL
        print(f"parallel: sharded flat attention stage {stage} shift {shift} "
              f"Bn {Bn} over 2 ranks vs unsharded: out {errs[0]:.2e}, dqkv "
              f"{errs[1]:.2e} (tol {tol:.1e} of the max), dbias "
              f"{errs[2]:.2e}, dscale {errs[3]:.2e} (rel L2, tol "
              f"{SP_TOL:.0e}); fwd+bwd {ms:.3f} ms per rank at world 2 "
              f"(unsharded {ms1:.3f} ms; plain version {plain:.3f} ms; bound "
              f"{bound:.4f} ms: K1 + K2 on {Bn // 2} windows)", flush=True)
        if not ok:
            bad.append(f"sp stage {stage}")
    spm = r0["sp_model"]
    sp_counts = [{k: v for k, v in r["sp_model"]["counts"].items() if v}
                 for r in ranks]
    print(f"parallel: SwinV2-B 448 batch {SWIN_BATCH} step with the "
          f"sequence-parallel attention vs unsharded: loss "
          f"{spm['loss'][0]:.5f} / {spm['loss'][1]:.5f}, gradients rel L2 "
          f"{spm['grad'][0]:.2e} (tol {PAR_TOL16:g}; worst tensor "
          f"{spm['grad'][1]:.2e}, {spm['grad'][2]}); launches per rank "
          f"{sp_counts}", flush=True)
    if abs(spm["loss"][0] - spm["loss"][1]) > LOSS_TOL or \
            spm["grad"][0] > PAR_TOL16 or not all(
                c.get("window_attention_flat") == SWIN_BLOCKS and
                c.get("window_attention_flat_bwd") == SWIN_BLOCKS
                for c in sp_counts):
        bad.append("sp model")
    for rank, r in enumerate(ranks):
        tp = r["tp"]
        print(f"parallel: tensor-parallel SwinV2-B 448 step at mp 2, batch "
              f"{TP_BATCH}, rank {rank} ({tp['sharded']} tensors split): "
              f"loss {tp['loss'][0]:.6f} / {tp['loss'][1]:.6f} (1 rank), "
              f"grad norm {tp['norm'][0]:.5f} / {tp['norm'][1]:.5f}, gradient "
              f"slices rel L2 {tp['grad'][0]:.2e} (worst tensor "
              f"{tp['grad'][1]:.2e}, {tp['grad'][2]}), tol {PAR_TOL:g} (fp32)",
              flush=True)
        (l2, l1), (n2, n1) = tp["loss"], tp["norm"]
        if abs(l2 - l1) > PAR_TOL * abs(l1) or \
                abs(n2 - n1) > PAR_TOL * n1 or tp["grad"][0] > PAR_TOL:
            bad.append(f"tp rank {rank}")
        moe = r["moe"]
        print(f"parallel: Swin-MoE-S 192, experts {moe['experts']} of each "
              f"MoE layer's on rank {rank} of 2, fp32 eval, "
              f"{PAR_MOE_BATCH // 2} images "
              f"vs the one-card MoEFFN on {PAR_MOE_BATCH}: {moe['moved'][0]} "
              f"of {moe['moved'][1]} token slots re-routed; logits of "
              f"{moe['held']} images rel L2 {moe['err']:.2e} (tol "
              f"{ZOO_TOL:.0e})", flush=True)
        if moe["err"] > ZOO_TOL or moe["held"] == 0:
            bad.append(f"moe rank {rank}")
    print(f"parallel: world 2 on one card in {wall:.1f} s (rank 0's checks "
          f"{r0['seconds']:.1f} s, peak {max(r['peak'] for r in ranks):.2f} "
          f"GiB per rank); phase {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line()}]", flush=True)
    if bad:
        raise AssertionError(f"parallel: {bad}")
    return total


# -------------------------------------------------------------------- tools

def tools_phase(dev, work: str) -> None:
    """The host tools on what earlier phases left in ``work``: (a)
    ``convert_checkpoint swinv2`` of a reference-layout SwinV2-B (384²,
    window 24, pretrained windows 12-12-12-6, a 1000-class head) to the
    448/28 fine-tune, loaded as ``pipeline --swin-ckpt`` loads it into the
    production model on the card: its logits equal, to the bit, those of
    ``load_pretrained_swinv2`` on the same file; (b) ``traceparse`` over
    the e2e train step's Chrome trace: its device total within TRACE_TOL
    of ``key_averages()``'; (c) ``joern_json`` on a node/edge pair; (d)
    ``results_table`` over the staged and baselines run directories."""
    import glob

    import torch

    from mvuld_tpu_torch.core.checkpoint import load_checkpoint
    from mvuld_tpu_torch.models.convert import init_jax_like
    from mvuld_tpu_torch.models.swin_convert import load_pretrained_swinv2
    from mvuld_tpu_torch.models.swin_v2 import (SwinTransformerV2,
                                                SwinV2Config)
    from mvuld_tpu_torch.models.swin_variants import build_model
    from mvuld_tpu_torch.tools import (convert_checkpoint, joern_json,
                                       results_table, traceparse)
    from mvuld_tpu_torch.train.pipeline import _swin_checkpoint

    t_phase = time.perf_counter()
    card = card_line()
    # (a) the conversion, then both loaders on the card
    src = SwinTransformerV2(SwinV2Config(
        img_size=384, window_size=24, pretrained_window_sizes=(12, 12, 12, 6)),
        num_classes=1000)
    init_jax_like(src, torch.Generator().manual_seed(0))
    sd = dict(src.state_dict())
    for name, buf in src.named_buffers():     # the reference's buffers too
        sd[name] = buf
    pth = os.path.join(work, "swinv2_base_384.pth")
    torch.save({"model": sd}, pth)
    out_dir = os.path.join(work, "converted")
    t0 = time.perf_counter()
    convert_checkpoint.main(["swinv2", pth, out_dir, "--img-size", "448",
                             "--window", "28", "--pretrained-windows",
                             "12,12,12,6", "--num-classes", "2"])
    conv_s = time.perf_counter() - t0
    cfg = _family_config(["MODEL.TYPE", "swinv2"] + MODEL_OPTS[:16])
    a = build_model(cfg, kernels=True)
    a.load_state_dict(load_checkpoint(_swin_checkpoint(out_dir))["params"])
    b = build_model(cfg, kernels=True)
    load_pretrained_swinv2(b, pth)
    x = torch.randn(4, 448, 448, 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        la = a.to(dev)(x)
        lb = b.to(dev)(x)
    same = bool(torch.equal(la, lb)) and bool(torch.isfinite(la).all())
    print(f"tools convert_checkpoint swinv2: SwinV2-B 384²/window 24 → "
          f"448²/28 in {conv_s:.1f} s on the host; pipeline --swin-ckpt's "
          f"load and load_pretrained_swinv2 give logits equal to the bit on "
          f"the card: {same} (batch 4, bf16, kernels) [{card}]", flush=True)
    del a, b, src, sd
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("convert_checkpoint: logits differ")

    # (b) traceparse against key_averages on the e2e step's trace
    (label, prof), = [(k, v) for k, v in PROFILES.items()
                      if k.startswith("kernels train step")]
    s = traceparse.main([prof["trace"], "--top", "5"])
    rel = abs(s["device_ms"] - prof["self_device_ms"]) / max(
        prof["self_device_ms"], 1e-9)
    print(f"tools traceparse {label}: device total {s['device_ms']:.3f} ms "
          f"over {s['events']} events against key_averages()' device self "
          f"time {prof['self_device_ms']:.3f} ms (rel {rel:.2e}, tol "
          f"{TRACE_TOL}); idle share of the traced window "
          f"{s['idle_share']:.3f}", flush=True)
    if not rel <= TRACE_TOL:
        raise AssertionError("traceparse disagrees with key_averages")

    # (c) one Joern node/edge JSON pair
    base = os.path.join(work, "joern", "42.c")
    os.makedirs(os.path.dirname(base))
    for suffix, rows in ((".nodes.json", JOERN_NODES),
                         (".edges.json", JOERN_EDGES)):
        with open(base + suffix, "w") as f:
            json.dump(rows, f)
    cpg = joern_json.get_node_edges(base)
    lines = {n[0]: n[2] for n in cpg.nodes}
    ok = (lines == {1: "METHOD", 3: "Assignment Operator",
                    4: "Builtin Function Call", 5: "RETURN"}
          and (3, 5, "REACHING_DEF") in cpg.edges
          and not any(t == "CONTAINS" for *_, t in cpg.edges))
    print(f"tools joern_json: {len(cpg.nodes)} line nodes {lines}, "
          f"{len(cpg.edges)} edges{'' if ok else ' FAILED'}", flush=True)
    if not ok:
        raise AssertionError("joern_json parse")

    # (d) the run directories the staged and baselines phases wrote
    runs = sorted(
        {os.path.dirname(p) for pat in ("**/history.json", "**/log_rank*")
         for p in glob.glob(os.path.join(work, pat), recursive=True)})
    specs = [f"{os.path.relpath(r, work)}={r}" for r in runs]
    table = results_table.main(specs)
    filled = [k for k, m in table.items() if m]
    print(f"tools results_table: {len(table)} run directories, "
          f"{len(filled)} with metrics {filled}", flush=True)
    if not any("fusion" in k for k in filled) or not any(
            "baseline" in k for k in filled):
        raise AssertionError(f"results_table: no metrics in {table}")
    print("tools make_images, hardprobe, fontbench: host tools (pandas, "
          "PIL, sklearn, matplotlib), which this machine lacks; they run "
          "only in the CPU tests (tests/test_torch_tools.py)", flush=True)
    print(f"tools: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def profile_run(label: str, fn, category=None, trace_path=None):
    """``tools/traceparse.profile_run``: one call of ``fn`` profiled, its
    device time by kernel category printed (``category``: a function of
    the kernel name, ``traceparse.category`` unless given); with
    ``trace_path`` its Chrome trace exported and its result kept in
    PROFILES."""
    from mvuld_tpu_torch.tools import traceparse
    res = traceparse.profile_run(label, fn, category, trace_path)
    if trace_path:
        PROFILES[label] = {**res, "trace": trace_path}
    return res


KERNELS = {
    "window_attention_flat": ("mvuld_tpu_torch/csrc/window_attention.cu",
                              "mvuld_tpu/ops/window_attention.py:883"),
    "window_attention_flat_bwd": (
        "mvuld_tpu_torch/csrc/window_attention.cu",
        "mvuld_tpu/ops/window_attention.py:1317"),
    "mlp_ln": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
               "mvuld_tpu/ops/fused_dense.py:407"),
    "mlp_ln_bwd": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                   "mvuld_tpu/ops/fused_dense.py:442"),
    "mlp_ln_res": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                   "mvuld_tpu/ops/fused_dense.py:613"),
    "mlp_ln_res_bwd": ("mvuld_tpu_torch/csrc/mlp_ln.cu",
                       "mvuld_tpu/ops/fused_dense.py:646"),
    "window_attention_flat_bwd_v1": (
        "mvuld_tpu_torch/csrc/window_attention.cu",
        "mvuld_tpu/ops/window_attention.py:1042"),
    "dense_fwd": ("mvuld_tpu_torch/csrc/fused_dense.cu",
                  "mvuld_tpu/ops/fused_dense.py:74"),
    "dense_bwd": ("mvuld_tpu_torch/csrc/fused_dense.cu",
                  "mvuld_tpu/ops/fused_dense.py:165"),
    "window_attention_fwd": ("mvuld_tpu_torch/csrc/window_attention.cu",
                             "mvuld_tpu/ops/window_attention.py:96"),
    "window_attention_bwd": ("mvuld_tpu_torch/csrc/window_attention.cu",
                             "mvuld_tpu/ops/window_attention.py:189"),
    "window_attention_map_fwd": ("mvuld_tpu_torch/csrc/window_attention.cu",
                                 "mvuld_tpu/ops/window_attention.py:440"),
    "window_attention_map_bwd": ("mvuld_tpu_torch/csrc/window_attention.cu",
                                 "mvuld_tpu/ops/window_attention.py:627"),
}


# the path whose rows give a kernel's times in the kernels line: its first
# main path (K1-K4b the e2e model's, whose rows earlier slices reported)
SUMMARY_PATH = {"window_attention_flat_bwd_v1": "swin",
                "dense_fwd": "blockbench", "dense_bwd": "blockbench",
                "window_attention_fwd": "ops", "window_attention_bwd": "ops",
                "window_attention_map_fwd": "ops",
                "window_attention_map_bwd": "ops"}


def summarise(rows, launches):
    """One entry per kernel. Times: Σ over the shapes of its summary path
    of (launches per bucket-16 forward, per batch-16 training step for the
    attention and MLP backward kernels, per batch-64 fine-tune step for K5,
    per blockbench iteration for K6/K6b, or per pass of the op entry
    points for K7-K8b) × ms per launch; its largest
    error over every path. ``launches``: every counted main-path run's
    launches."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        every = [r for r in rows if r["kernel"] == name]
        mine = [r for r in every
                if r["path"] == SUMMARY_PATH.get(name, "e2e")]
        tot = lambda key: sum(r["per_fwd"] * r[key] for r in mine)  # noqa: E731
        t_bytes, t_ops = tot("t_bytes"), tot("t_ops")
        lib = (None if any(r["lib_ms"] is None for r in mine)
               else tot("lib_ms"))
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(r["err"] for r in every),
                    "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from mvuld_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.time()
    _build.build_all(["window_attention", "mlp_ln", "fused_dense"])
    print(f"build: {time.time() - t0:.1f}s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled kernel name and template arguments
                entry = line.split("'")[1].split("_cu_")[-1].split("EEv")[0]
            if "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry[-48:]}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    check_attention(dev, gen, rows, K1_SHAPES, "e2e")
    check_attention(dev, gen, rows, SWIN_K1_SHAPES, "swin")
    check_attention_variants(dev, gen)
    check_layouts(dev, gen, rows)
    check_layouts_variants(dev, gen)
    check_mlp(dev, gen, rows, "mlp_ln", K3_SHAPES)
    check_mlp(dev, gen, rows, "mlp_ln", SWIN_K3_SHAPES, "swin")
    check_mlp(dev, gen, rows, "mlp_ln_res", K4_SHAPES)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", K3_SHAPES)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", SWIN_K3_SHAPES, "swin")
    check_mlp_bwd(dev, gen, rows, "mlp_ln_res_bwd", K4_SHAPES)
    check_dense(dev, gen, rows)
    # F6: fp32 x through the same kernels, one shape each
    check_mlp(dev, gen, rows, "mlp_ln", K3_SHAPES[2:], "fp32", fp32=True)
    check_mlp(dev, gen, rows, "mlp_ln_res", K4_SHAPES[:1], "fp32", fp32=True)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_bwd", K3_SHAPES[2:], "fp32",
                  fp32=True)
    check_mlp_bwd(dev, gen, rows, "mlp_ln_res_bwd", K4_SHAPES[:1], "fp32",
                  fp32=True)
    check_dense(dev, gen, rows, fp32=True)
    bad = []
    per = lambda r: {"blockbench": "blockbench iteration",  # noqa: E731
                     "ops": "entry-point pass", "fp32": "launch (fp32 x)",
                     "ragged": "launch (ragged M)",
                     "fp32 ragged": "launch (fp32 x, ragged M)",
                     "swin": f"batch-{SWIN_BATCH} fine-tune step"}.get(
        r["path"], "batch-16 step" if "bwd" in r["kernel"]
        else "bucket-16 forward")
    for r in rows:
        lib = "n/a" if r["lib_ms"] is None else f"{r['lib_ms']:.3f}"
        check = (r["detail"] if "detail" in r
                 else f"max_abs_err={r['err']:.3e} (tol {r['tol']:.3e})")
        print(f"{r['kernel']} {r['shape']}: {check} ms={r['ms']:.3f} "
              f"plain_ms={r['plain_ms']:.3f} library_ms={lib} "
              f"bound_ms={max(r['t_bytes'], r['t_ops']):.4f} "
              f"(bytes {r['t_bytes']:.4f}, operations {r['t_ops']:.4f}) "
              f"×{r['per_fwd']}/{per(r)}",
              flush=True)
        if not r.get("ok", r["err"] <= (r["tol"] or 0.0)):
            bad.append(f"{r['kernel']} {r['shape']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")

    from mvuld_tpu_torch.ops import fused_dense as fd
    from mvuld_tpu_torch.ops import window_attention as wa
    counters = [wa.window_attention_flat, wa.window_attention_flat_bwd,
                wa.window_attention_flat_bwd_v1, fd.mlp_ln, fd.mlp_ln_bwd,
                fd.mlp_ln_res, fd.mlp_ln_res_bwd, fd.dense_fwd, fd.dense_bwd]
    launches = dict.fromkeys(KERNELS, 0)
    e2e = [c for c in counters if c not in (wa.window_attention_flat_bwd_v1,
                                            fd.dense_fwd, fd.dense_bwd)]
    layouts = [wa.window_attention_fwd, wa.window_attention_bwd,
               wa.window_attention_map_fwd, wa.window_attention_map_bwd]
    work = tempfile.mkdtemp(prefix="mvuld_staged_")
    try:
        for phase in (lambda: serve_phase(dev),
                      lambda: train_phase(dev, e2e, work),
                      lambda: swin_phase(dev, counters),
                      lambda: fused_steps_phase(dev, counters),
                      lambda: blockbench_phase(dev, counters),
                      lambda: ops_phase(dev, layouts),
                      lambda: swin_family_phase(dev, e2e),
                      lambda: causal_phase(dev, e2e),
                      lambda: parallel_phase(dev, e2e)):
            for name, n in phase().items():
                launches[name] += n
        fopts = staged_phase(dev, work)
        zoo_phase(dev, work, fopts)
        ocr_phase(dev, work)
        baselines_phase(dev, work)
        tools_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"no main path launched {idle}")
    print(json.dumps({"kernels": summarise(rows, launches)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
