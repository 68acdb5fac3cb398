#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and holds each against its plain PyTorch version on the card.  Then it
drives the port's serving paths, each at full published width:

  * diffusion (Stable-Diffusion-v1): a split-serving engine answers 8
    requests with int8 boundary payloads, each group's latent and context
    quantised in one launch (phase ``kernels`` holds the kernel to its
    plain version first), and the device side completes one request of
    each group;
  * the paper's scheduler end to end (phase ``replay``): the fleet
    simulator records the golden workload's decision trace, every plan is
    re-derived from it, and its first 12 dispatch records run through a
    fresh full-width diffusion engine on the serve's weights; executables,
    cache hit rate and int8 payload bytes are reconciled with the model's,
    one int8 launch a dispatch;
  * layer split (RecurrentGemma-9B, 38 layers, bf16): the cloud engine
    runs groups [0, g) of 4 requests of 4096 tokens at g = 6 and of one
    request at g = 0 and g = 12, ships the fp16 hidden state, and the
    device side finishes each; the flash-attention and RG-LRU kernels
    carry every attention and recurrent layer.  One more g = 6 round then
    runs under ``torch.profiler`` (phase ``lm_profile``): device time by
    kernel class and the device's idle share;
    Request 0 is then prefilled and decoded 16 steps (phase
    ``lm_decode``): decode attention over a window inside a longer cache,
    the RG-LRU kernel at one step;
  * the same layer split on Mamba-2-780M (48 SSD layers, bf16), after
    RecurrentGemma's weights are freed: the SSD kernel is held against its
    plain version and timed at batch 4 and batch 1 (phase
    ``ssd_kernels``), then 4 requests of 4096 tokens
    are split at g = 24 and request 0 at g = 0 and g = 48, with the SSD
    kernel in every layer, and one more g = 24 round is profiled (phase
    ``mamba_serve``); request 0 is decoded 16 steps (``mamba_decode``);
  * decode (Qwen2-7B, 28 attention layers, bf16), after Mamba-2's weights
    are freed: the decode-attention kernel is held against its plain
    version and timed at Qwen2-7B's and RecurrentGemma-9B's decode shapes
    (phase ``decode_kernels``), then 8 sequences of 4096 tokens
    are prefilled through the flash kernel and decoded 64 teacher-forced
    steps through a 4160-row cache, every layer's attention through the
    decode kernel; fp32 and int8-cache decodes are held to a one-machine
    forward and to the plain version (``decode_serve``), and 8 more steps
    are profiled (``decode_profile``).  Then, on the same weights, the
    28 groups are pipelined as 4 stages of 7 in 4 ranks on this card
    (``distributed/pipeline.py::gpipe_forward`` over ``gloo``: NCCL
    refuses two ranks on one GPU, so each hop goes through pinned host
    memory): flash is first held to its plain version at the stages'
    shape (2 x 2048 tokens, 28 query heads on 4 kv heads of 128, causal,
    bf16); each rank copies its stage out of this process's memory
    (CUDA IPC), checks its checksum and allocates at most its stage and
    PIPE_RANK_MARGIN_BYTES, the ring all-gather of one
    layer's 3584 x 18944 MLP weight is held to ``all_gather_into_tensor``
    and to the weight, reduce-scatter + gather of integer-valued fp32 to
    ``all_reduce``, and 4 microbatches of 2 x 2048 tokens through the
    pipeline, 7 flash launches a microbatch on each stage, to the
    sequential ``run_layer_range(0, 28)`` here, all to the bit; the
    stages share the card's SMs, so this shows no speed-up (phase
    ``pipeline_qwen2``).  Then the same weights under dense tensor
    parallelism in 4 ranks (phase ``tp_qwen2``): flash and decode
    attention held to their plain versions at the ranks' shapes, then
    the whole tree cut by ``param_specs`` over the model axis of (1, 4)
    and (2, 2) (attention by heads, the MLP by ``d_ff``, the vocabulary),
    2 x 2048 tokens prefilled and 8 steps decoded through
    ``launch/dryrun.py``'s step builders; every rank's logits and cache
    held to the bit to one process computing as the ranks do
    (``tp_as_ranks``), the logits and each layer to the one-process bf16
    run, the first 2 groups in fp32, the sums counted.
  * Mixture-of-Experts (OLMoE-1B-7B, 16 MHA attention layers, 64 experts
    top-8, bf16), after Qwen2-7B's weights are freed: the flash kernel
    held to its plain version and timed at the MHA prefill layout, then
    4 requests of 4096 tokens split at g = 8 and request 0 at g = 0 and
    g = 16 through the layer-split engines, each split held to a
    one-machine forward of the same batch, the router's capacity, drops
    and largest load per layer and the aux sums reported, one g = 8 round
    profiled (MoE dispatch and gather, expert products, attention, the
    rest), and the first two layers held in fp32, layer by layer,
    through the kernels against the plain versions with routing flips
    counted (phase ``moe_serve``); the 4 prompts prefilled and decoded
    32 steps (drops at 4 tokens a step), the decode kernel held to its
    plain version and timed on that cache, and request 0 decoded at
    capacity factor 16 in bf16 and fp32 against the one-machine forward
    at the same factor (``moe_decode``).  Then, on the same weights, the
    MoE layers are cut over the model axis of a mesh of 4 ``gloo`` ranks
    on this card (``distributed/sharding.py``'s specs, MoE leaves only,
    placed by ``train/checkpoint.py::reshard`` from CUDA IPC mappings):
    ``ep`` and ``tp`` on a (1, 4) mesh, ``ep`` on (2, 2), 2 x 2048 tokens
    through ``run_layer_range(0, 16)`` on flash; each rank's last hidden
    held to the one-process forward of its data shard's tokens (bf16,
    relative L2) and to the bit to the one process computing each MoE
    layer as the ranks do, layer 0's keep masks to the one process's,
    one fp32 layer to ``apply_moe`` on one device, every rank's aux to
    data shard 0's, each rank's peak to its blocks + 2 GiB, the sums over
    the model axis counted and timed (``moe_sharded``).
  * the encoder-decoder (seamless-m4t-medium, 12 encoder and 12 decoder
    layers, MHA: 16 heads of 64, bf16), after OLMoE's weights are freed:
    the flash kernel held to its plain version and timed at the
    encoder's non-causal layout (4 x 1024 frames) and at the
    cross-attention layout (64 prompt tokens against 1024 frames), the
    decode kernel at the cross-decode layout (one token against the
    1024-row static cache) (phase ``encdec_kernels``); 4 requests of
    1024 random frames of 1024 and a 64-token prompt prefilled (encoder,
    decoder with cross-attention, ``build_enc_kv``), the encoder and the
    prefill timed, the decoder split at group 6 of 12 through
    ``run_layer_range(..., enc_out=...)`` held to ``forward_hidden`` to
    the bit, the first two encoder and decoder blocks held in fp32,
    kernels against plain versions (``encdec_serve``); the 4 requests
    decoded 32 steps through the self-attention cache and the static
    ``enc_kv``, the decode kernel held to its plain version on the served
    ``enc_kv``, and request 0 decoded in bf16 and fp32 against the
    one-machine forward, its last steps profiled (``encdec_decode``).
  * the modality frontend of a decoder-only model (internvl2-1b, 24
    attention layers, 14 query heads on 2 kv heads of 64, qkv biases,
    bf16; the vision tower a stub whose 256 patch embeddings are drawn at
    random), after the encoder-decoder's weights are freed: the flash
    kernel held to its plain version and timed at its prefill layout,
    then 4 requests of 256 patches and 1792 text tokens split at g = 12,
    the patches prepended at the cloud's embedding, held to a one-machine
    forward of the same batch, and request 0 prefilled and decoded 8
    steps in bf16 and fp32, the fp32 decode held to the fp32 forward
    (phase ``frontend_serve``);
  * sliding-window decode through a ring cache (h2o-danube-1.8b at full
    width, its first 8 of 24 attention layers, 32 query heads on 8 kv
    heads of 80, window 4096, bf16), after internvl2-1b's weights are
    freed: 4 sequences decoded
    4160 teacher-forced steps from an empty ring of 4096 rows, so that it
    wraps, every step's attention on the decode kernel; the 64 steps past
    the window held to prefill of the first 4096 tokens into a linear
    cache of 4160 rows and 64 steps through the window inside it, and the
    last to the one-machine forward; the last 8 steps once more through
    the plain version, and the kernel timed on that ring; a ring of 256
    rows in fp32 (the window narrowed, batch 1, 320 steps) against a
    linear cache and the fp32 forward
    (phase ``swa_ring_decode``);
  * RegNet-Y-128GF, the paper's classifier (phase ``regnet``): one 384 x
    384 image through the forward and split at each point of paper Table
    1, the activation through the host, held to the forward; its
    segments and forward timed at batch 1 and 8;
  * training, outside inference mode (an inference tensor cannot be
    saved for backward): the backwards of flash attention (at
    h2o-danube-1.8b's training layout, d = 80, after its forward and
    row log-sum-exp are held to the plain version's, and at the layout
    of the reference's flash VJP test), the RG-LRU scan (RecurrentGemma-9B's
    scan shape) and the SSD scan (Mamba-2-780M's, batch 2), each held
    against autograd through the plain version in fp32 and bf16 and
    timed beside it, flash beside SDPA's backward (phase
    ``train_kernels``); then h2o-danube-1.8b (24 layers, d 2560, window
    4096) and Mamba-2-780M (48 SSD layers) at full width, each trained 4
    steps of 2 x 4096 tokens from ``data.pipeline`` through the port's
    ``make_train_step`` (bf16 parameters, fp32 AdamW state, each group's
    blocks recomputed in the backward pass), step 0's loss held to a
    no-grad forward, the first two layers' fp32 gradients through the
    kernels held leaf by leaf to the plain versions', one more step
    profiled (``train_danube``, ``train_mamba``); then smollm-135m at
    full width: its parameters and AdamW state after one step saved with
    ``train/checkpoint.py``, restored and held to the bit, and the
    training launcher ``launch/train.py`` run twice on one checkpoint
    directory (100 steps of 8 x 2048 tokens each), the second run resuming
    at step 100 from the first's checkpoint (``train_cli``); then the
    launcher trains it 4 steps of 8 x 2048 tokens on one device and
    again with ``--data-parallel 2``: 2 ``gloo`` ranks on this card, each
    on 4 of the 8 rows, the gradients summed in fp32, the AdamW state cut
    by ZeRO-1, the new parameters gathered; flash first held to its
    plain version at the ranks' shape (4 x 2048, 9 query heads on 3 kv
    heads of 64, causal, bf16), forward and backward; the 2-rank loss and
    gradient norm held to the one-device run's, every rank's parameters
    to each other's by checksum, each rank's optimizer state to half the
    one-device state's, each rank's flash launches counted; the sum's and
    the gather's bytes and rates printed; the ranks share the card's SMs,
    so no speed-up is claimed (``train_dp``); then h2o-danube-1.8b at
    full width, its first 4 of 24 layers, under dense tensor
    parallelism over (1, 4) and over (2, 2): flash held to its plain
    version at each mesh's rank shape (2 x 1024, 8 query heads on 2 kv
    heads of 80; 1 x 1024, 16 on 4; causal, bf16), forward with its lse
    and backward; then the launcher trains the bf16 model 3 steps of 2 x
    1024 tokens on one device and again with ``--data-parallel D
    --model-parallel M``: 4 ``gloo`` ranks on this card, each on its rows
    and its ``param_specs`` blocks, on (2, 2) the gradients summed over
    the data axis and the AdamW state cut by ZeRO-1; each step's loss and
    gradient norm held to one device's, every leaf held whole bit-equal
    across the ranks and every leaf across the ranks of a model index
    after each step, each rank's leaves and state of their expected
    shapes, its flash launches and its hops over both axes counted; then
    in the same ranks one fp32 step, its loss and gradient norm and every
    leaf's gathered gradient held to one device's (``tp_train``);
  * calibration (phase ``calibrate``): the port's dry run
    (``launch/dryrun.py``) over every architecture and shape cell, host
    arithmetic on meta tensors, then four steps timed above -- Qwen2-7B's
    warm prefill of 8 x 4096 tokens and its median decode step at batch
    8, the median warm training steps of h2o-danube-1.8b and Mamba-2-780M
    -- each counted at its shape and its measured rate held to the
    roofline's estimate on the H100 (``calibration_ratio``, at most
    1.05); the capacity artifact is written from the calibrated records
    and read back.

Each phase prints one JSON line (``total``: the script's own time, the
kernels' build included).  The line before the last two is
``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` gives them, and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises: the exit code
is then non-zero and no result line is printed.  There is no CPU mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): the bounds below
# are stated against these, whatever the card's power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

MAIN_PATH_SHAPES = ((4, 4096), (2, 59136))     # latent, context per request
RAGGED_SHAPES = ((509, 256), (1, 8), (130, 64))
# int8 groups of the diffusion serve (requests, with the context): the
# serve's end group is 7 requests without it
INT8_GROUPS = ((1, True), (3, True), (8, True), (7, False))
N_REQUESTS = 8
SEED = 0
# Images lie in [-1, 1]; the split run and the one-machine run do the same
# fp32 arithmetic on the same card, so they should agree far inside this.
SPLIT_ATOL = 1e-3

# The paper's scheduler end to end: the golden fleet-sim workload of the
# reference's engine-replay bench (benchmarks/engine_replay.py FULL_CELL),
# its decision trace re-derived (490 plans, no replans), and its first
# dispatch records (the bench's smoke cap) through a fresh full-width
# engine on the card.
REPLAY_CELL = dict(seed=7, rate=12.0, duration=40.0, gpus_init=10,
                   max_gpus=32, metrics_interval_s=10.0)
REPLAY_PLANS = 490
REPLAY_RECORDS = 12

# RegNet-Y-128GF, the paper's classifier, uncut: its parameters as the
# reference's jax.eval_shape counts them, the activation bytes at each
# split point of paper Table 1 (batch 1, 384 x 384, fp32), and the
# floating-point operations of one image through the reference's forward
# as XLA's cost_analysis counts them (a count, not a time).
REGNET_PARAMETERS = 644_733_224
REGNET_PARAMETER_BYTES = 2_578_932_896
REGNET_TABLE1_BYTES = {"stem": 4_718_592, "block1": 19_464_192,
                       "block2": 9_732_096, "block3": 6_690_816,
                       "block4": 4_257_792, "avgpool": 29_568}
REGNET_FLOPS_PER_IMAGE = 739_913_170_944
REGNET_BATCHES = (1, 8)
# The split runs the same fp32 convolutions on the same card as forward,
# with an exact copy through the host between its halves: summation order
# is all that may differ, far inside this share of the largest logit.
REGNET_SPLIT_RTOL = 1e-5

# The layer-split path: full-width RecurrentGemma-9B, uncut.
LM_ARCH = "recurrentgemma-9b"
LM_BATCH, LM_SEQ = 4, 4096
# jax.eval_shape of the reference's init_params for this config (the
# analytic ModelConfig.param_count() says 5,915,025,408)
LM_PARAMETERS = 7_714_385_920
LM_PARAMETER_BYTES = 15_430_041_600
# the reference's fp16-boundary tolerance (tests/test_serving.py)
LM_SPLIT_ATOL, LM_SPLIT_RTOL = 0.15, 0.1
# kernels against plain versions over the whole 38-layer forward, as the
# relative L2 error of the last-token logits.  The check that can see a
# kernel's fault runs in fp32 (every parameter cast to fp32, request 0),
# where both kernels agree with their plain versions to a few 1e-6 and
# nothing is rounded to bf16 between layers.  Measured 5.5e-6 on an H100
# (PERF.md); the limit is about nine times that
LM_FP32_PLAIN_REL_L2 = 5e-5
# The bf16 forward as served (4 requests) is held to its plain versions
# too, but that distance is rounding noise: any difference in the last
# bits flips some bf16 roundings, which 38 layers of random bf16 weights
# carry to ~2 % of the logits (PERF.md: the scan alone, 3.8e-6 from its
# plain version, moves them 1.98e-2).  So it gets a loose limit, and the
# bf16 forward through the kernels may lie at most LM_FP32_RATIO times
# as far from the fp32 forward as the one through the plain versions.
LM_PLAIN_REL_L2 = 3e-2
LM_FP32_RATIO = 1.5
# the reference's kernel grids (tests/test_kernels.py) and tolerances
FLASH_GRID = (
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 8, 128, True, 0),
    (2, 256, 256, 4, 1, 80, True, 64),
    (1, 128, 128, 2, 2, 128, False, 0),
    (1, 512, 512, 3, 3, 64, True, 128),
)
# ragged tails the kernel masks by bounds (no tile divides these lengths),
# d = 16, a kv_len below Skv, and d = 36 (rows of 72 bytes: 8-byte
# copies) with every mask at once: (case, kv_len)
FLASH_RAGGED = (
    ((2, 100, 100, 4, 1, 16, True, 32), None),
    ((1, 77, 203, 6, 2, 32, False, 0), 150),
    ((1, 97, 150, 3, 1, 36, True, 24), 121),
)
# (atol, rtol).  fp32 as tests/test_kernels.py holds the Pallas kernel.
# In bf16 kernel and plain version both accumulate in fp32 and round the
# output once, so they differ by at most one bf16 step (2^-7 relative) of
# the output: rtol 2e-2 covers that, and atol 2e-3 is set against the
# path's outputs (std ~0.04 where a query sees 2048 keys), not against 1
FLASH_TOL = {torch.float32: (5e-6, 5e-6), torch.bfloat16: (2e-3, 2e-2)}
RGLRU_GRID = ((2, 128, 256), (1, 512, 128), (3, 96, 200))
RGLRU_ATOL = 2e-5

# The layer-split path's attention-free model: full-width Mamba-2-780M,
# uncut (48 SSD layers, no tail), split at its middle group.
SSD_ARCH = "mamba2-780m"
SSD_SPLIT = 24
# jax.eval_shape of the reference's init_params for this config (the
# analytic ModelConfig.param_count() says 857,070,336)
SSD_PARAMETERS = 860_045_568
SSD_PARAMETER_BYTES = 1_720_550_400
# the fp32 forward of request 0 (every parameter cast to fp32), through
# the SSD kernel against the same forward through its plain version, as
# the relative L2 error of the last-token logits
SSD_FP32_PLAIN_REL_L2 = 1e-4
# the reference's kernel grid (b, S, H, P, G, N, chunk_size), with
# init_state, then one chunk holding the whole sequence (Q == S, the chunk
# size above S); tolerances as tests/test_kernels.py holds the Pallas
# kernel, inputs drawn as it draws them
SSD_GRID = ((1, 256, 4, 64, 1, 128, 128), (2, 128, 8, 64, 2, 64, 64),
            (1, 512, 2, 32, 1, 16, 128), (2, 256, 8, 64, 2, 64, 512))
SSD_Y_ATOL, SSD_FINAL_ATOL = 2e-4, 2e-5
# single-chunk calls, each with and without init_state: one decode step of
# Mamba-2-780M's heads at its chunk of 256 (the step kernel, also held to
# the three phases to the bit), and the grid's Q == S case (the three
# phases, one chunk)
SSD_ONE_CHUNK = ((1, 1, 48, 64, 1, 128, 256), (2, 256, 8, 64, 2, 64, 512))

# Decode of the two layer-split models above: request 0's prompt, then
# teacher-forced steps on tokens drawn from SEED + 1, through a linear
# cache of LM_SEQ + LM_DECODE_STEPS rows.  Held to a one-machine fp32
# forward over the same tokens as the relative L2 error of the logits.
LM_DECODE_STEPS = 16
# of which the last are decoded once more under the profiler
MODEL_PROFILE_STEPS = 4
DECODE_FP32_REL_L2 = 1e-4

# The decode path: full-width Qwen2-7B, uncut (28 attention layers, 28
# query heads on 4 kv heads, head_dim 128).
DECODE_ARCH = "qwen2-7b"
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 8, 4096, 64
DECODE_LEN = DECODE_PROMPT + DECODE_STEPS
# jax.eval_shape of the reference's init_params for this config, and of
# its init_decode_cache(cfg, 8, 4160): 28 layers of bf16 k and v
DECODE_PARAMETERS = 7_626_626_560
DECODE_PARAMETER_BYTES = 15_253_919_744
DECODE_CACHE_BYTES = 1_908_408_320
# request 0 in fp32 through this many steps (the check that can see a
# routing or kernel fault), an int8 cache from empty through as many, and
# this many more steps profiled
DECODE_FP32_STEPS = DECODE_INT8_STEPS = 16
DECODE_PROFILE_STEPS = 8
# the reference's grid (tests/test_kernels.py; ragged lengths), Qwen2-7B's
# group of 7 at head_dim 128 and RecurrentGemma-9B's 16 at 256:
# (B, Skv, Hq, Hkv, D)
DECODE_GRID = ((4, 512, 8, 2, 64), (2, 384, 4, 4, 128), (3, 512, 16, 1, 80),
               (2, 1000, 28, 4, 128), (1, 2100, 16, 1, 256))
# the path's shape: q (8, 1, 28, 128), the cache (8, 4160, 4, 128), every
# sequence at 4096 valid keys (the first decode step's 4097, rounded)
DECODE_PATH = (DECODE_BATCH, DECODE_LEN, 28, 4, 128)
DECODE_PATH_LENGTH = DECODE_PROMPT
# (atol, rtol): fp32 as tests/test_kernels.py holds the Pallas kernel;
# bf16 as the flash kernel (one bf16 step of the output)
DECODE_TOL = {torch.float32: (5e-6, 0.0), torch.bfloat16: (2e-3, 2e-2)}
# calls in each CUDA-event sample of decode attention, so that a sample of
# the ~15 us C entry at the RecurrentGemma-9B shape lasts over 1 ms
DECODE_TIMING_CALLS = 100
# RecurrentGemma-9B's decode attention at lm_decode's first step: the
# 2048-key window [position - 2047, position] of a 4112-row cache, read in
# place, at position 4096
RG_DECODE_CACHE = LM_SEQ + LM_DECODE_STEPS
RG_DECODE_VIEW = (LM_SEQ - 2047, LM_SEQ + 1)
# The kernels' times before their redesign, printed beside the new ones
# in the ssd_kernels and decode_kernels lines (never in the kernels line,
# which holds only this run's measurements): the parent tree's kernels,
# this script's phases (run P18-0 in PERF.md, NVIDIA H100 80GB HBM3,
# 700 W); ms of the wrapper and of the C entry alone (decode), or of a
# wrapper call (SSD)
DECODE_BEFORE_MS = {
    "path": {"ms": 0.14776480197906494, "raw_launch_ms": 0.14580560326576233},
    "rg_shape": {"ms": 0.11321839690208435,
                 "raw_launch_ms": 0.11024159789085389}}
SSD_BEFORE_MS = {"path": 8.187647819519043, "batch_1": 4.073232173919678}

# The pipeline phase: Qwen2-7B's weights, still held after decode, as 4
# stages of 7 groups in 4 ranks on this one card (gloo: NCCL refuses two
# ranks on one GPU, so every hop goes through pinned host memory); 4
# microbatches of 2 x 2048 tokens.  One layer's largest MLP weight (wi_up,
# 3584 x 18944 bf16) is gathered row-sharded, and an fp32 tensor of its
# shape with integer values (every sum exact) is reduced.
PIPE_STAGES = 4
PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 4, 2, 2048
PIPE_GATHERED = ("mlp", "wi_up")
PIPE_GATHERED_SHAPE = (3584, 18944)
PIPE_INT_RANGE = 1024
# the world's time limit, ranks' start and every check included
PIPE_TIMEOUT_S = 300
# what a rank may allocate on the card beyond its own stage: the
# collectives' buffers (at most ~1 GB at once) and one microbatch's
# activations through 7 groups, 1.41-1.56 GB as measured on an H100.  One
# more stage (3.26 GB) does not fit under it.
PIPE_RANK_MARGIN_BYTES = 2 * 2 ** 30

# Mixture-of-Experts (phases moe_serve, moe_decode): full-width
# OLMoE-1B-7B, uncut (16 attention layers, MHA: 16 heads of 128 on 16 kv
# heads; 64 experts of 1024, top-8, at the published capacity factor
# 1.25), through the layer split at g = 8 of 16 and prefill + decode.
MOE_ARCH = "olmoe-1b-7b"
MOE_SPLIT = 8
# jax.eval_shape of the reference's init_params for this config
MOE_PARAMETERS = 6_922_766_336
MOE_PARAMETER_BYTES = 13_849_862_144
MOE_DECODE_STEPS = 32
# the layer-by-layer fp32 check, kernels against plain versions: groups
# [0, MOE_FP32_GROUPS) at full width on request 0's first MOE_FP32_SEQ
# tokens, each layer fed the same input in both runs.  A token may route
# to other experts through the kernels than through the plain versions
# only where the plain run's k-th and (k+1)-th probabilities lie closer
# than MOE_FLIP_GAP (such a flip changes its output by O(1)); the layer's
# output on the tokens whose routing agreed is held to the fp32 limit of
# the earlier slices
MOE_FP32_GROUPS, MOE_FP32_SEQ = 2, 1024
MOE_FLIP_GAP = 1e-5
MOE_LAYER_REL_L2 = 5e-5
# decode is held to the forward at this capacity factor, as
# tests/test_models.py does: the capacity depends on the tokens in the
# call, so at 1.25 a decode step may drop a choice the forward keeps
MOE_CHECK_FACTOR = 16.0

# The sharded Mixture-of-Experts phase (moe_sharded): OLMoE-1B-7B's
# weights, still held after moe_decode, in 4 gloo ranks on this card, the
# MoE layers cut over the model axis of a (data, model) mesh by
# distributed/sharding.py (moe_only_specs: attention and the embeddings
# stay whole) and placed by train/checkpoint.py::reshard: ep and tp on
# (1, 4), ep on (2, 2); 2 x 2048 tokens (ep: 16 of 64 experts a rank,
# capacity 640 a layer; tp: 256 of each expert's 1024)
MOE_SHARDED = (("ep_1x4", (1, 4), "ep"), ("tp_1x4", (1, 4), "tp"),
               ("ep_2x2", (2, 2), "ep"))
MOE_SHARDED_BATCH, MOE_SHARDED_SEQ = 2, 2048
# the bf16 forward's last hidden on each rank against the one-process
# forward of its data shard's tokens, as a relative L2 (set before the
# first run, PERF.md §6).  Each layer's output differs from the one
# process's by the rounding of the rank's partial sum to bf16 before the
# sum over the model axis (the reference's algorithm); a one-process
# emulation of that rounding at narrower widths (d 256-1024, 16 layers)
# moved the last hidden 1.6e-2-2.1e-2, through routing flips in the
# early layers; on an H100 (80GB HBM3, 700 W) over 6 token seeds,
# 1.61e-2-1.99e-2.  This limit has little room: the per-layer check
# below is the stable one
MOE_SHARDED_REL_L2 = 2e-2
# each layer alone, fed the one-process forward's input to that layer
# (bf16): the routing equal to the bit (the same input, the same router),
# the layer's output against the one process's as a relative L2.  What
# is left is the rounding of the ranks' partial sums alone, with no
# routing flip to carry it.  On an H100 (80GB HBM3, 700 W) over 6 token
# seeds (moe_sharded_seeds.py, PERF.md §6) a layer's largest reading was
# 2.54e-3-2.80e-3 in ep and 4.26e-3-4.28e-3 in tp (layer 0 each time):
# the limit is twice the largest, rounded up
MOE_SHARDED_LAYER_REL_L2 = 9e-3
# one MoE layer in fp32 (layer 0's weights upcast), request-sized input
# (1 x 2048, random): every rank's output against apply_moe on one device
MOE_SHARDED_FP32_REL_L2 = 1e-5
# the world's time limit, ranks' start and every check included
MOE_SHARDED_TIMEOUT_S = 300

# Dense tensor parallelism (phase tp_qwen2): Qwen2-7B's weights, still held
# after pipeline_qwen2, in 4 gloo ranks on this card, the whole tree cut
# by distributed/sharding.py::param_specs over the model axis and placed
# by train/checkpoint.py::reshard: (1, 4), 7 query heads on 1 kv head of
# 128, 4736 of d_ff and 38,400 vocabulary rows a rank; (2, 2), 14 on 2,
# 9472 and 76,800, one row of the batch a rank.  2 x 2048 tokens
# prefilled through launch/dryrun.py::build_prefill_step, then
# TP_DECODE_STEPS teacher-forced steps through build_decode_step (cut from
# 16 to 8 to make room for tp_train's (2, 2) run, the whole script near
# its 760 s budget)
TP_MESHES = (("tp_1x4", (1, 4)), ("tp_2x2", (2, 2)))
TP_BATCH, TP_PROMPT, TP_DECODE_STEPS = 2, 2048, 8
# the limits of moe_sharded, fixed here before any reading: the last-token
# logits at prefill and at each step against the one-process bf16 run,
# each layer alone on the one process's input to it against its output
TP_REL_L2 = MOE_SHARDED_REL_L2
TP_LAYER_REL_L2 = MOE_SHARDED_LAYER_REL_L2
# the first TP_FP32_GROUPS groups (with the embedding, the final norm and
# the head) in fp32 on (1, 4): the ranks' prefill logits against one
# process's
TP_FP32_GROUPS = 2
TP_FP32_REL_L2 = MOE_SHARDED_FP32_REL_L2
# the ranks teacher-forced at these decode steps (the first and the
# last): each group's step fed the one process's input and its state
# (cut to the rank) within TP_LAYER_REL_L2, and the ranks' head on the
# one process's last hidden within TP_REL_L2 (at prefill too).  The
# free-running logits of a bf16 run sit at the model's own rounding
# floor: one bf16 ulp added to one embedding element moves the one
# process's logits by 1.50e-2 (Qwen2-7B), 1.91e-2 (RecurrentGemma-9B),
# 3.25e-2 (Mamba-2-780M) (tp_nudge.py on an NVIDIA H100 80GB HBM3 at
# 700 W); tp_qwen2 holds them to TP_REL_L2, the recurrent phases report
# them beside that nudge
TP_FORCED_STEPS = (0, TP_DECODE_STEPS - 1)
# the world's time limit, ranks' start and every check included
TP_TIMEOUT_S = 300
# The same for the recurrent blocks (phases tp_recurrentgemma and
# tp_mamba), on the weights their serve phases drew, with the same
# tokens, steps and limits: RecurrentGemma-9B on (1, 4), 4 query heads on
# the one kv head of 256, 1024 LRU channels in 4 gate blocks, 3072 of
# d_ff and 64,000 vocabulary rows a rank; Mamba-2-780M on (1, 4), 12 SSD
# heads of 64 (768 of d_inner) a rank, B, C and dt whole, the gated
# norm's sum of squares summed over the axis.  Mamba-2-780M's (2, 2) run
# (24 SSD heads, 1536 of d_inner a rank) was cut to make room for
# tp_train, when the whole script had passed 760 s; tp_qwen2 keeps the
# (2, 2) mesh on the card
TP_RECURRENTGEMMA_MESHES = TP_MESHES[:1]
TP_MAMBA_MESHES = TP_MESHES[:1]
# The same for the encoder-decoder (phase tp_seamless), on the weights
# encdec_serve drew: seamless-m4t-medium on (1, 4), 4 of 16 heads of 64 a
# rank in the encoder's 12 blocks and in the decoder's 12 self- and
# cross-attention branches (enc_kv by kv heads), 1024 of d_ff and 64,512
# vocabulary rows, 2 requests of 1024 frames and ENCDEC_PROMPT tokens.
# The free-running logits are held to TP_REL_L2, as in tp_qwen2: the
# one-ulp nudge moves the one process's by 8.85e-3-9.39e-3 (this
# phase's line on an NVIDIA H100 80GB HBM3 at 700 W), inside that limit
TP_SEAMLESS_MESHES = TP_MESHES[:1]

# The encoder-decoder (phases encdec_kernels, encdec_serve,
# encdec_decode): full-width seamless-m4t-medium, uncut (12 encoder and
# 12 decoder layers, MHA: 16 heads of 64; the audio frontend a stub whose
# 1024 frames of 1024 are drawn at random), 4 requests of a 64-token
# prompt each, the decoder split at group 6 of 12 through the
# segmentation hook, then 32 decode steps.
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_SPLIT = 6
ENCDEC_PROMPT, ENCDEC_DECODE_STEPS = 64, 32
# jax.eval_shape of the reference's init_params for this config (the
# analytic ModelConfig.param_count() says 877,092,864)
ENCDEC_PARAMETERS = 880_930_816
ENCDEC_PARAMETER_BYTES = 1_762_115_584
# the first blocks of the encoder and of the decoder in fp32, layer by
# layer, kernels against plain versions: held to the fp32 limit of the
# earlier slices
ENCDEC_FP32_BLOCKS = 2


# The modality frontend of a decoder-only model (phase frontend_serve):
# full-width internvl2-1b, uncut (24 attention layers, 14 query heads on 2
# kv heads of 64, qkv biases, vocabulary 151,655; the vision tower a stub
# whose 256 patch embeddings of 896 are drawn at random and prepended to
# the text), 4 requests of 1792 text tokens (2048 positions with the
# patches) split at group 12 of 24, then request 0 prefilled and decoded
# FRONTEND_DECODE_STEPS steps after its patches and text.
FRONTEND_ARCH = "internvl2-1b"
FRONTEND_SPLIT = 12
FRONTEND_TEXT = 1792
FRONTEND_DECODE_STEPS = 8
# jax.eval_shape of the reference's init_params for this config
FRONTEND_PARAMETERS = 633_149_312
FRONTEND_PARAMETER_BYTES = 1_266_441_728

# Training on the card (phases train_kernels, train_danube, train_mamba),
# outside inference mode: TRAIN_STEPS steps of the port's make_train_step
# (train_forward with each group's blocks recomputed in the backward pass,
# the backward, AdamW with fp32 masters) on TRAIN_BATCH x TRAIN_SEQ tokens
# of data.pipeline.batch_for_config, at full width, bf16 parameters; one
# more step profiled.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 4
DANUBE_ARCH = "h2o-danube-1.8b"
TRAIN_SSD_ARCH = SSD_ARCH
# jax.eval_shape of the reference's init_params for h2o-danube-1.8b
DANUBE_PARAMETERS = 1_835_133_440
DANUBE_PARAMETER_BYTES = 3_670_517_760
# the backwards against autograd through the plain versions, as the
# relative L2 error of each gradient (written before the first run on
# the card).  fp32: the kernels' forwards sit within a few 1e-6 of the
# plain versions and both backwards are fp32 arithmetic (a CPU run of the
# flash backward: 3e-7).  bf16 flash: the output is rounded to bf16 and
# the backward's delta = sum(do * o) is taken from that o where autograd
# of the plain version uses its exact softmax (a CPU run: 1.4e-3)
FLASH_BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the forward's row log-sum-exp against the plain version's, absolute
FLASH_LSE_ATOL = {torch.float32: 2e-5, torch.bfloat16: 5e-4}
RGLRU_BWD_REL_L2 = 1e-5
SSD_BWD_REL_L2 = 1e-4
# the flash backward at h2o-danube-1.8b's training layout and at the
# layout of tests/test_kernels.py::test_flash_custom_vjp_grads:
# (B, Sq, Skv, Hq, Hkv, D, causal, window)
FLASH_REF_TEST_LAYOUT = (2, 256, 256, 4, 2, 64, True, 0)
# step 0's loss against a no_grad train_forward of the same batch, and
# the fp32 copy of the first TRAIN_FP32_LAYERS layers at full width:
# every leaf's gradient through the kernels against the same through
# the plain versions (request 0), relative L2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_FP32_LAYERS = 2
TRAIN_FP32_GRAD_REL_L2 = 2e-4

# Sliding-window decode through a ring cache: full-width h2o-danube-1.8b,
# RING_BATCH sequences decoded RING_PAST teacher-forced steps past its
# window from an empty ring (init_decode_cache caps the cache at the
# window), held to prefill of the window's tokens into a linear cache of
# window + RING_PAST rows and RING_PAST steps through the window inside it
# at LM_PLAIN_REL_L2; the last RING_PLAIN_STEPS steps of the ring once
# more through decode attention's plain version
RING_BATCH, RING_PAST, RING_PLAIN_STEPS = 4, 64, 8
# the phase runs the first RING_LAYERS of the model's 24 layers, its
# widths uncut: each decode step is paced by the host, layer by layer,
# and at 24 layers the phase took 199-267 s of the script's time (cut
# to 8, then to 4, each time the whole script had passed 760 s; then to
# 2 to make room for tp_seamless)
RING_LAYERS = 2
# RING_LAYERS layers x (k, v) x 4 x 4096 rows x 8 kv heads x 80 x 2 B,
# and the linear cache of 4160 rows
RING_CACHE_BYTES = 83_886_080
RING_LINEAR_CACHE_BYTES = 85_196_800
# the fp32 ring (parameters cast to fp32, batch 1) at a narrowed window,
# RING_PAST steps past it, held to a linear cache and to the fp32 forward
# at DECODE_FP32_REL_L2
RING_FP32_WINDOW = 256

# The calibrate phase: four steps the phases above time, each counted at
# its shape by the port's dry run (launch/dryrun.py::count_cell): (key of
# the measured seconds, arch, (kind, sequence, batch), count keywords).
# The decode steps run at positions DECODE_PROMPT .. DECODE_LEN - 1; the
# count takes the middle one
CALIBRATION_STEPS = (
    ("qwen2_prefill", DECODE_ARCH, ("prefill", DECODE_PROMPT, DECODE_BATCH),
     {}),
    ("qwen2_decode", DECODE_ARCH, ("decode", DECODE_LEN, DECODE_BATCH),
     {"position": DECODE_PROMPT + DECODE_STEPS // 2 - 1}),
    ("train_danube", DANUBE_ARCH, ("train", TRAIN_SEQ, TRAIN_BATCH), {}),
    ("train_mamba", TRAIN_SSD_ARCH, ("train", TRAIN_SEQ, TRAIN_BATCH), {}),
)
# A card cannot beat its own roofline: a measured rate above the
# estimate by more than this share means the count holds work that the
# step does not do
CALIBRATION_RATIO_MAX = 1.05
# the dry run: 10 architectures x 4 shape cells, 7 of them the
# reference's SKIP (long_500k of a model without sub-quadratic state)
DRYRUN_RECORDS, DRYRUN_SKIPS = 40, 7

# The training launcher at full smollm-135m width: CLI_STEPS steps of
# CLI_BATCH x CLI_SEQ tokens (the launcher checkpoints every 100), then
# CLI_RESUME_STEPS more on the same checkpoint directory (cut from 100 to
# 20 when the whole script had passed 760 s).  The
# checkpoint round trip saves the parameters and the AdamW state after
# one step.  jax.eval_shape of the reference's init_params:
CLI_ARCH = "smollm-135m"
CLI_PARAMETERS = 134_515_008
CLI_PARAMETER_BYTES = 269_100_288
CLI_BATCH, CLI_SEQ, CLI_STEPS, CLI_RESUME_STEPS = 8, 2048, 100, 20

# Data parallelism through the launcher: full-width smollm-135m, DP_STEPS
# steps of CLI_BATCH x CLI_SEQ tokens on one device and again over
# DP_RANKS gloo ranks on this card (each rank CLI_BATCH / DP_RANKS rows,
# the gradient summed in fp32, the AdamW state cut by ZeRO-1), from the
# same seed, batches and schedule.  The 2-rank run's logged loss and
# gradient norm against the one-device run's, relative: the ranks'
# matmuls run on half the rows and their bf16 gradients are summed in
# fp32, where one device sums all rows inside its bf16 products.  Set
# from the first run on an H100 (step-0 loss equal to the bit, step-0
# gradient norm 1.40e-3, step-9 loss 1.9e-6), down from 1e-3, 1e-2, 1e-2.
# DP_STEPS was cut from 10 to 4 to make room for tp_train, when the whole
# script had passed 760 s: the launcher then logs step 0 only, so every
# step's loss, gradient norm and clock are read through its on_step hook
# (record_step), and the last step's loss is held to DP_LOSS_LAST_RTOL
DP_RANKS, DP_STEPS = 2, 4
DP_LOSS0_RTOL, DP_GNORM0_RTOL, DP_LOSS_LAST_RTOL = 1e-5, 3e-3, 1e-4
# the one-device AdamW state: masters, m and v, fp32, 3 x 538,060,032 B
DP_ONE_DEVICE_STATE_BYTES = 1_614_180_096

# Training under dense tensor parallelism (phase tp_train): h2o-danube-1.8b
# at full width (d 2560, 32 query heads on 8 kv heads of 80, d_ff 6912, a
# vocabulary of 32000 padded to 32768, an untied head), its depth cut to
# the first TP_TRAIN_LAYERS of its 24 layers, through launch/train.py
# --data-parallel D --model-parallel M for each (D, M) of TP_TRAIN_MESHES:
# TP_TRAIN_RANKS gloo ranks on this card, each on its rows and its
# param_specs blocks (on (1, 4) 8 query heads on 2 kv heads, 1728 of d_ff,
# 8192 vocabulary rows and columns; on (2, 2) 16 on 4, 3456, 16384) and
# its ZeRO-1 blocks of their AdamW state, TP_TRAIN_STEPS steps of
# TP_TRAIN_BATCH x TP_TRAIN_SEQ tokens; the same on one device.  Limits,
# fixed before the first run on the card: one fp32 step at the ranks'
# layers, its loss and gradient norm against one device's within
# TP_TRAIN_FP32_RTOL and each leaf's gradient, gathered, within
# TP_TRAIN_FP32_GRAD_REL of one device's (relative L2 by the leaf's norm);
# the bf16 steps' loss and gradient norm against one device's within
# TP_TRAIN_BF16_RTOL, relative
TP_TRAIN_LAYERS, TP_TRAIN_RANKS = 4, 4
TP_TRAIN_MESHES = ((1, 4), (2, 2))
TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 2, 1024, 3
TP_TRAIN_FP32_RTOL, TP_TRAIN_FP32_GRAD_REL = 1e-4, 1e-3
TP_TRAIN_BF16_RTOL = 2e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def tool_output(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_env() -> str:
    from repro_torch.kernels import _build
    smi = tool_output(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]).splitlines()[0].strip()
    nvcc = tool_output([_build.find_nvcc(), "--version"])
    release = next((ln.split("release", 1)[1].strip()
                    for ln in nvcc.splitlines() if "release" in ln), nvcc)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         nvcc_release=release,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def ptxas_report(log: str, needle: str) -> list:
    """Registers, spills and static shared memory of each kernel whose
    (mangled) name holds ``needle``, from ptxas' ``-v`` report."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": m.group(1)} if needle in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m[1])
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build
    info = _build.build_library()
    _build.load_library()
    keep = ("registers", "spill", "Compiling entry")
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if any(k in ln for k in keep)]
    flash = ptxas_report(info.log, "flash_attention")
    # every kernel of the sources this script's decode, SSD and int8
    # phases hold to their plain versions (the file's name is in each
    # mangled name)
    decode = ptxas_report(info.log, "decode_attention_cu")
    ssd = ptxas_report(info.log, "ssd_scan_cu")
    int8 = ptxas_report(info.log, "int8_quant_cu")
    occupancy = flash_occupancy()
    decode_occ = decode_occupancy()
    emit("build", seconds=info.seconds, compiled=info.compiled,
         sources=info.sources, ptxas=ptxas, flash_ptxas=flash,
         flash_occupancy=occupancy, decode_ptxas=decode,
         decode_occupancy=decode_occ, ssd_ptxas=ssd, int8_ptxas=int8)
    if not info.compiled:
        raise RuntimeError("the kernel library was not built in this run")
    # flash: bf16 at d <= 64, 128, 256 and, writing the lse, at d <= 64,
    # 128; fp32 at the three classes
    for name, report, count in (("flash", flash, 8), ("decode", decode, 7),
                                ("ssd", ssd, 4), ("int8", int8, 2)):
        if len(report) != count or any(f.get("spill_store_bytes", 1)
                                       or f.get("spill_load_bytes", 1)
                                       for f in report):
            raise RuntimeError(f"{name}: {count} kernels without spills "
                               f"expected, ptxas reports {report}")
    at256 = [o for o in occupancy if (o["head_dim"], o["dtype"]) == (
        256, "bf16")]
    if at256[0]["warps_per_sm"] < 8:
        raise RuntimeError(f"flash bf16 at d = 256: {at256} (fewer than 8 "
                           "resident warps an SM)")


def flash_occupancy() -> list:
    """Shared memory, threads and resident blocks an SM of the flash
    launch at the top of each head-dim class, as the card reports them."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load_library()
    out = []
    for d in (64, 128, 256):
        for code, name in ((1, "bf16"), (0, "fp32")):
            smem, blocks, threads = (ctypes.c_int() for _ in range(3))
            _build.check_launch(lib, lib.repro_flash_attention_occupancy(
                d, code, ctypes.byref(smem), ctypes.byref(blocks),
                ctypes.byref(threads)), "flash_attention occupancy")
            out.append({"head_dim": d, "dtype": name,
                        "smem_bytes": smem.value, "threads": threads.value,
                        "blocks_per_sm": blocks.value,
                        "warps_per_sm": blocks.value * threads.value // 32})
    return out


def decode_occupancy() -> list:
    """Shared memory, threads and resident blocks an SM of the bf16
    decode split kernel at the top of each head-dim class."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load_library()
    out = []
    for d in (64, 128, 256):
        smem, blocks, threads = (ctypes.c_int() for _ in range(3))
        _build.check_launch(lib, lib.repro_decode_attention_occupancy(
            d, ctypes.byref(smem), ctypes.byref(blocks),
            ctypes.byref(threads)), "decode_attention occupancy")
        out.append({"head_dim": d, "dtype": "bf16",
                    "smem_bytes": smem.value, "threads": threads.value,
                    "blocks_per_sm": blocks.value,
                    "warps_per_sm": blocks.value * threads.value // 32})
    return out


def make_input(shape, gen) -> torch.Tensor:
    """Seeded input with the awkward rows: row 0 all zeros (when there is
    more than one row), the last row scaled so that s == 1 exactly and
    filled with exact .5 ties."""
    T, d = shape
    x = torch.randn(shape, generator=gen, device="cuda") * 3.0
    if T > 1:
        x[0].zero_()
    ties = (torch.arange(d, device="cuda", dtype=torch.float32) % 250
            - 125.0) + 0.5
    ties[0] = 127.0
    x[T - 1] = ties
    return x.contiguous()


def time_ms(fn, inner: int = 50, samples: int = 20) -> float:
    """Median over ``samples`` of (CUDA-event time of ``inner`` calls) /
    ``inner``, after a warm-up."""
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def int8_bound(shapes):
    """Least time for one quantisation of each shape: the larger of bytes
    moved (fp32 in, int8 out, one fp32 scale a row) over the memory rate
    and operations (abs, max, divide, round, two clamps an element) over
    the fp32 rate."""
    nbytes = sum(T * d * 5 + T * 4 for T, d in shapes)
    flops = sum(T * d * 6 for T, d in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def group_shapes(B: int, with_ctx: bool = True) -> list:
    """The int8 segments of a group of B requests: its latent rows, and
    its context rows where it ends before the last iteration."""
    return [(T * B, d) for T, d in MAIN_PATH_SHAPES[:2 if with_ctx else 1]]


def check_int8(name, x, q, s, checks: list) -> float:
    """Hold one segment's kernel output to the plain version (codes
    equal, scales within one ulp), to numpy on the host (equal) and the
    ties row to even; returns the largest difference."""
    from repro_torch.kernels import int8_quant
    q_ref, s_ref = int8_quant.int8_quantize_ref(x)
    q_err = int((q.int() - q_ref.int()).abs().max())
    # distance in units in the last place: positive fp32 values order
    # like their bit patterns
    s_ulp = int((s.view(torch.int32) - s_ref.view(torch.int32))
                .abs().max())
    s_err = float((s - s_ref).abs().max())
    x_np = x.cpu().numpy()
    s_np = np.maximum(np.abs(x_np).max(1, keepdims=True)
                      / np.float32(127.0), np.float32(1e-12))
    q_np = np.clip(np.round(x_np / s_np), -127, 127).astype(np.int8)
    host_equal = bool(np.array_equal(q.cpu().numpy(), q_np)
                      and np.array_equal(s.cpu().numpy(), s_np))
    checks.append({"check": name, "shape": list(x.shape),
                   "q_max_abs_err": q_err, "s_ulp": s_ulp,
                   "equal_to_numpy": host_equal})
    if q.shape != x.shape or s.shape != (x.shape[0], 1):
        raise RuntimeError(f"int8 {name}: wrong output shapes")
    if q_err != 0 or s_ulp > 1:
        raise RuntimeError(
            f"int8 {name} disagrees with its plain version: "
            f"max|dq|={q_err}, scales differ by {s_ulp} ulp")
    if not host_equal:
        raise RuntimeError(f"int8 {name} disagrees with numpy on the host")
    return max(float(q_err), s_err)


def int8_group_cases(gen) -> list:
    """(name, segments) of the grouped checks: groups of 1, 3 and 8
    requests at full width, a ragged mix, rows that start off 16 bytes,
    and rows whose max sits in the last block's slice (and in a ragged
    tail, d % 4 = 1)."""
    cases = [(f"group of {B}", [make_input(sh, gen)
                                for sh in group_shapes(B)])
             for B, _ in INT8_GROUPS[:3]]
    cases.append(("ragged mix", [make_input(sh, gen) for sh in
                                 RAGGED_SHAPES + ((3, 333), (7, 1024))]))
    base = torch.randn(3 * 4096 + 2 * 59136 + 2, generator=gen,
                       device="cuda")
    cases.append(("misaligned starts", [
        base[1:1 + 3 * 4096].view(3, 4096),
        base[2 + 3 * 4096:].view(2, 59136)]))
    last = torch.randn((2, 59136), generator=gen, device="cuda") * 0.01
    last[:, -1] = torch.tensor([40.0, -75.5], device="cuda")
    tail = torch.randn((2, 59137), generator=gen, device="cuda") * 0.01
    tail[:, -1] = torch.tensor([-9.0, 33.0], device="cuda")
    cases.append(("max in the last block", [last, tail]))
    return cases


def phase_kernels() -> dict:
    from quant_ab import group_c_entry, traced
    from repro_torch.kernels import _build, int8_quant
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    checks = []
    inputs = {}
    for shape in MAIN_PATH_SHAPES + RAGGED_SHAPES:
        x = make_input(shape, gen)
        inputs[shape] = x
        q, s = int8_quant.int8_quantize(x)
        torch.cuda.synchronize()
        max_err = max(max_err, check_int8("int8_quantize", x, q, s, checks))
        if ties_row_wrong(q, x):
            raise RuntimeError(f"int8_quantize{shape}: ties not to even")
    for name, segs in int8_group_cases(gen):
        shapes = [tuple(x.shape) for x in segs]
        buf = int8_quant.int8_quantize_group(segs)
        torch.cuda.synchronize()
        for x, (q, s) in zip(segs, int8_quant.split_group(buf, shapes)):
            max_err = max(max_err, check_int8(name, x, q, s, checks))

    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def c_entry(segs, buf):
        """The C entry alone, its table and output made beforehand."""
        return group_c_entry(lib, int8_quant, segs, buf, stream)

    per_shape = []
    for sh in MAIN_PATH_SHAPES:
        b_ms, _, nbytes = int8_bound([sh])
        x = inputs[sh]
        per_shape.append({
            "shape": list(sh), "bytes": nbytes, "bound_ms": b_ms,
            "ms": time_ms(lambda: int8_quant.int8_quantize(x)),
            "raw_launch_ms": time_ms(c_entry(
                [x], int8_quant.int8_quantize_group([x]))),
            "plain_ms": time_ms(lambda: int8_quant.int8_quantize_ref(x))})
    per_group = []
    for B, with_ctx in INT8_GROUPS:
        shapes = group_shapes(B, with_ctx)
        # values like the serve's: no zero row, whose quotients 0 / 1e-12
        # take the slow path of an IEEE divide
        segs = [torch.randn(sh, generator=gen, device="cuda") * 3.0
                for sh in shapes]
        b_ms, b_by, nbytes = int8_bound(shapes)
        rows, max_d = sum(T for T, _ in shapes), max(d for _, d in shapes)

        def kernel():
            return int8_quant.int8_quantize_group(segs)

        def plain():
            return int8_quant.int8_quantize_group_ref(segs)

        def empty():
            return lib.repro_int8_empty_launch(rows, max_d, stream)
        _build.check_launch(lib, empty(), "int8 empty launch")
        # kernel and plain version in turns, on this one card
        plain_a, kern_a = time_ms(plain), time_ms(kernel)
        kern_b, plain_b = time_ms(kernel), time_ms(plain)
        before = int8_quant.launch_count
        trace = traced(torch, kernel, 20)
        if int8_quant.launch_count - before != 21:
            raise RuntimeError(f"a group of {B} took more than one launch")
        floor = traced(torch, empty, 20)
        per_group.append({
            "requests": B, "context": with_ctx, "shapes": shapes,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
            "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "raw_launch_ms": time_ms(c_entry(segs, kernel())),
            "device_us": trace["int8_us"],
            "kernels_in_trace": trace["int8_launches"],
            "empty_launch": {"raw_launch_ms": time_ms(empty),
                             "device_us": floor["empty_us"]}})
    one = per_group[0]
    entry = {
        "name": "int8_quantize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
        "replaces": "src/repro/kernels/int8_quant.py:30",
        "launches": None,                      # filled in by the serve phase
        "max_abs_err": max_err,
        # one request's boundary, the latent and the context, in one launch
        "ms": one["ms"], "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "library_ms": None,
        "timed": "int8_quantize_group, latent (4,4096) + context (2,59136), "
                 "inputs warm in L2; median of 20 x 50 calls, best of 2",
        "per_shape": per_shape, "per_group": per_group,
    }
    emit("kernels", checks=checks, int8_quantize=entry)
    return entry


def ties_row_wrong(q: torch.Tensor, x: torch.Tensor) -> bool:
    """The last row holds k + 0.5 with s == 1: every code must be the even
    neighbour."""
    row = x[-1, 1:]
    want = torch.where(torch.floor(row) % 2 == 0, torch.floor(row),
                       torch.ceil(row)).clamp(-127, 127).to(torch.int8)
    return not torch.equal(q[-1, 1:], want)


def phase_serve(kernel_entry: dict):
    from repro_torch.configs import stable_diffusion_v1
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.telemetry import generate_fleet
    from repro_torch.core.transport import WAN_LINK, wire_nbytes
    from repro_torch.kernels import int8_quant
    from repro_torch.models import diffusion
    from repro_torch.serving.engine import DiffusionSplitEngine, Request

    cfg = stable_diffusion_v1.CONFIG
    t0 = time.perf_counter()
    params = diffusion.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in diffusion.DiffusionModel(
        params, cfg).parameters())
    cost = CostParams(r_cloud=40.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=3.0, k_decode=1.0)
    link = WAN_LINK
    engine = DiffusionSplitEngine(params, cfg, cost, link=link, wire="int8",
                                  device="cuda")
    fleet = generate_fleet(N_REQUESTS, 2.25, 0.8, seed=SEED, rtt=link.rtt)
    rng = np.random.default_rng(SEED)
    reqs = [Request(d.device_id, d,
                    rng.integers(0, cfg.text_vocab, (1, cfg.text_len),
                                 dtype=np.int32),
                    np.zeros((1, cfg.text_len), np.int32)) for d in fleet]

    # the engine's int8 encoding of each group, timed on the host, and its
    # fp32 boundary kept on the card for the checks after the serve
    encoded = []
    encode_group = engine._encode_int8_group

    def timed_encode(lat, ctx2, fmt):
        t0 = time.perf_counter()
        payloads = encode_group(lat, ctx2, fmt)
        encoded.append({"seconds": time.perf_counter() - t0, "lat": lat,
                        "ctx2": ctx2, "payloads": payloads})
        return payloads
    engine._encode_int8_group = timed_encode

    torch.cuda.reset_peak_memory_stats()
    int8_quant.launch_count = 0
    t0 = time.perf_counter()
    results = engine.serve(reqs, seed=SEED)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = int8_quant.launch_count
    del engine._encode_int8_group

    n_total = cfg.n_total_iterations
    groups = {}
    for r in reqs:
        groups.setdefault(results[r.request_id].n_cloud, []).append(r)
    if len(groups) < 2 or not any(0 < n < n_total for n in groups):
        raise RuntimeError(f"fleet gave split groups {sorted(groups)}: need "
                           f"two groups and one with 0 < n_cloud < {n_total}")
    shapes_mid = {"latent": (cfg.latent_channels, cfg.latent_size,
                             cfg.latent_size),
                  "context": (2, cfg.text_len, cfg.text_width)}
    shapes_end = {"latent": shapes_mid["latent"]}
    for res in results.values():
        mid = res.n_cloud < n_total
        want = wire_nbytes(shapes_mid if mid else shapes_end, "int8")
        if len(res.payload) != want:
            raise RuntimeError(f"{res.request_id}: payload of "
                               f"{len(res.payload)} B, expected {want} B")
    # one launch a group: the group's latent and context together
    expected = len(groups)
    if launches <= 0 or launches != expected or len(encoded) != expected:
        raise RuntimeError(f"int8 kernel launched {launches} times in "
                           f"{len(encoded)} encodings on the serving path, "
                           f"expected {expected}")
    kernel_entry["launches"] = launches
    equal = check_served_payloads(engine, encoded)
    emit("serve", config=cfg.name, parameters=n_params,
         init_seconds=init_s, serve_seconds=serve_s,
         groups=[{"n_cloud": n, "batch": len(m),
                  "gpu_seconds": results[m[0].request_id].cloud_seconds
                  * len(m),
                  "payload_bytes": [len(results[r.request_id].payload)
                                    for r in m]}
                 for n, m in sorted(groups.items())],
         stats=engine.stats, int8_launches=launches,
         int8_launches_expected=expected,
         int8_encode_seconds=[e["seconds"] for e in encoded],
         payloads_bit_equal=equal,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return params, cfg, cost, link, results, groups


def check_served_payloads(engine, encoded: list) -> dict:
    """Each served payload against the same group's boundary encoded
    through the quantiser's plain version on the card, and through
    ``pack_boundary_wire`` with the numpy quantiser on the host: equal
    byte for byte, or this raises."""
    from repro_torch.core.transport import (get_wire_format,
                                            pack_boundary_wire,
                                            rowwise_quantize_int8)
    from repro_torch.kernels import int8_quant
    fmt = get_wire_format(engine.wire)
    kernel = int8_quant.int8_quantize_group
    counts = {"plain": 0, "numpy": 0}
    for e in encoded:
        lat, ctx2, served = e["lat"], e["ctx2"], e["payloads"]
        int8_quant.int8_quantize_group = int8_quant.int8_quantize_group_ref
        try:
            plain = engine._encode_int8_group(lat, ctx2, fmt)
        finally:
            int8_quant.int8_quantize_group = kernel
        lat_np = lat.float().cpu().numpy()
        ctx_np = None if ctx2 is None else ctx2.float().cpu().numpy()
        host = [pack_boundary_wire(
            lat_np[i], None if ctx_np is None else ctx_np[:, i], fmt,
            rowwise=rowwise_quantize_int8) for i in range(len(served))]
        for name, want in (("plain", plain), ("numpy", host)):
            if want != served:
                raise RuntimeError(f"served int8 payloads differ from the "
                                   f"{name} version's")
            counts[name] += len(want)
    return counts


def phase_device(params, cfg, cost, link, results, groups) -> None:
    from repro_torch.core.transport import deserialize, unpack_boundary
    from repro_torch.serving.engine import (DiffusionDeviceSim,
                                            DiffusionSplitEngine)
    sim = DiffusionDeviceSim(params, cfg, device="cuda")
    size = cfg.image_size
    done = []
    for n_cloud, members in sorted(groups.items()):
        res = results[members[0].request_id]
        t0 = time.perf_counter()
        img = sim.complete(res)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if tuple(img.shape) != (1, 3, size, size):
            raise RuntimeError(f"image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError("image has non-finite values")
        if float(img.abs().max()) > 1.0:
            raise RuntimeError("image leaves [-1, 1]")
        done.append({"n_cloud": n_cloud, "request": res.request_id,
                     "seconds": seconds, "min": float(img.min()),
                     "max": float(img.max())})

    # One shipped payload against the fp32 latent it encodes: the same
    # group, same seed, through an engine that ships fp32.
    n_mid = min(n for n in groups if 0 < n < cfg.n_total_iterations)
    members = groups[n_mid]
    ref_engine = DiffusionSplitEngine(params, cfg, cost, link=link,
                                      wire="fp32", device="cuda")
    ref = ref_engine.process_group(members, n_mid, seed=SEED)
    lat_ref, _ = unpack_boundary(ref[0].payload)
    payload = results[members[0].request_id].payload
    lat_deq, ctx_deq = unpack_boundary(payload)
    scales = deserialize(payload)["latent_rowscales"]          # (C, 1)
    rows = lat_ref.shape[0]
    err = np.abs(lat_deq - lat_ref).reshape(rows, -1).max(axis=1)
    # half a quantisation step, plus room for the two runs' latents
    # differing in their last bits
    limit = scales[:, 0] / 2 + 1e-4 * np.abs(lat_ref).max()
    if ctx_deq is None or not np.all(err <= limit):
        raise RuntimeError(f"dequantised latent off by {err.tolist()}, "
                           f"limit {limit.tolist()}")

    # The paper's claim that splitting does not change the output: the
    # fp32-wire split of that group, finished on the device side, against
    # all iterations and the VAE on one machine from the same start.
    from repro_torch.models import diffusion
    split_img = sim.complete(ref[0])
    dev = torch.device("cuda")
    cond = torch.from_numpy(np.concatenate(
        [r.cond_tokens for r in members])).to(dev)
    uncond = torch.from_numpy(np.concatenate(
        [r.uncond_tokens for r in members])).to(dev)
    lat0 = torch.randn(
        (len(members), cfg.latent_channels, cfg.latent_size,
         cfg.latent_size),
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    ctx2 = diffusion.encode_prompt(params, cfg, cond, uncond)
    mono_img = diffusion.apply_vae_decoder(
        params["vae"], cfg, diffusion.denoise_range(
            params, cfg, lat0, ctx2, 0, cfg.n_total_iterations))
    split_err = float((split_img - mono_img[:1]).abs().max())
    if not split_err <= SPLIT_ATOL:
        raise RuntimeError(f"split and one-machine images differ by "
                           f"{split_err} > {SPLIT_ATOL}")
    emit("device", completed=done, stats=sim.stats,
         payload_check={"n_cloud": n_mid, "row_max_err": err.tolist(),
                        "row_limit": limit.tolist()},
         split_vs_one_machine={"n_cloud": n_mid, "max_abs_err": split_err,
                               "atol": SPLIT_ATOL})


def _within(got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: dict) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def flash_bound(B, Hq, Hkv, Sq, Skv, d, causal, window, itemsize):
    """Least time for one call: the larger of q, k, v read and o written
    once over the memory rate, and 4 d operations (two products) for
    each unmasked (query, key) pair over the bf16 tensor-core rate."""
    q_pos = np.arange(Sq)
    hi = np.minimum(q_pos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(Sq)
    pairs = float(np.clip(hi - lo, 0, None).sum())
    flops = 4.0 * B * Hq * d * pairs
    nbytes = (2 * B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def rglru_bound(B, S, W):
    """a and b read, h written, fp32; two operations an element."""
    nbytes = 3 * B * S * W * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * B * S * W / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def lm_path_shapes():
    """The shapes the layer-split path gives the two kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    flash = (LM_BATCH, LM_SEQ, LM_SEQ, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim(), True, cfg.window)
    return cfg, flash, (LM_BATCH, LM_SEQ, cfg.rglru.lru_width)


def prefill_flash_shape():
    """The shape decode_serve's prefill gives the flash kernel: Qwen2-7B,
    8 sequences of 4096 tokens, causal, no window."""
    from repro_torch.configs import get_config
    cfg = get_config(DECODE_ARCH)
    return (DECODE_BATCH, DECODE_PROMPT, DECODE_PROMPT, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim(), True, cfg.window)


def time_in_turns(run_kernel, run_plain, run_library) -> dict:
    """CUDA-event medians of a kernel's wrapper (5 samples of 2 calls)
    and its plain version (3 of 1) in turns, plain, kernel, kernel,
    plain, the best of each pair; then the library call as the kernel."""
    plain_a = time_ms(run_plain, inner=1, samples=3)
    kern_a = time_ms(run_kernel, inner=2, samples=5)
    kern_b = time_ms(run_kernel, inner=2, samples=5)
    plain_b = time_ms(run_plain, inner=1, samples=3)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "library_ms": time_ms(run_library, inner=2, samples=5)}


def flash_prefill_entry(fa, gen, checks: list) -> dict:
    """The flash kernel at Qwen2-7B's prefill shape: held to its plain
    version at batch 1, batch 8 held to batch 1 bit for bit on the
    sequence they share, then timed at batch 8 beside the plain version
    (whose fp32 scores take 15 GB there) and SDPA."""
    import torch.nn.functional as F
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape = prefill_flash_shape()

    def n(*s):
        return torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = n(B * Hq, Sq, D), n(B * Hkv, Skv, D), n(B * Hkv, Skv, D)
    q1, k1, v1 = q[:Hq], k[:Hkv], v[:Hkv]
    o1 = fa.flash_attention(q1, k1, v1, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q1, k1, v1, causal=causal, window=window)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    err = float((o1.float() - want.float()).abs().max())
    checks.append({"shape": [1] + list(shape[1:]), "kv_len": None,
                   "dtype": str(torch.bfloat16), "max_abs_err": err,
                   "atol": atol, "rtol": rtol,
                   "out_std": float(want.float().std())})
    if not _within(o1, want, atol, rtol):
        raise RuntimeError(f"flash_attention{shape} at batch 1 disagrees "
                           f"with its plain version: max|d|={err}")

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D),
            v.view(B, Hkv, Skv, D), is_causal=True, enable_gqa=True)
    o = run_kernel()
    torch.cuda.synchronize()
    if not torch.equal(o[:Hq], o1) or not bool(torch.isfinite(o).all()):
        raise RuntimeError(f"flash_attention{shape}: batch 8 differs from "
                           "batch 1 on their shared sequence")
    lib_err = float((run_library()[:1].reshape(q1.shape).float()
                     - want.float()).abs().max())
    del o, o1, want
    times = time_in_turns(run_kernel, run_plain, run_library)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, q.element_size())
    return {
        "shape": list(shape), "dtype": str(torch.bfloat16),
        "launches": None,                 # filled in by decode_serve
        "max_abs_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        "library_max_abs_err_vs_plain": lib_err,
        "timed": "one Qwen2-7B prefill attention layer at batch 8, bf16; "
                 "kernel and SDPA median of 5 x 2 calls, plain version of "
                 "3 x 1; best of 2",
        "bytes": nbytes, "flops": flops,
    }


def phase_lm_kernels() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as lru
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _, flash_path, lru_path = lm_path_shapes()
    # the path's head_dim, window and length in fp32, one request (the
    # d = 256 instantiation is held to the fp32 tolerance here)
    flash_path32 = (1,) + flash_path[1:]

    def qkv(B, Sq, Skv, Hq, Hkv, D, dtype):
        def n(*shape):
            return torch.randn(shape, generator=gen,
                               device="cuda").to(dtype)
        return n(B * Hq, Sq, D), n(B * Hkv, Skv, D), n(B * Hkv, Skv, D)

    flash_checks = []
    path_inputs = path32_inputs = None
    cases = [(c, None, dt) for c in FLASH_GRID for dt in FLASH_TOL]
    cases += [(c, kv_len, dt) for c, kv_len in FLASH_RAGGED
              for dt in FLASH_TOL]
    cases.append((flash_path32, None, torch.float32))
    cases.append((flash_path, None, torch.bfloat16))
    # the prefill path's head_dim 128 and group 7 in fp32, one sequence
    cases.append(((1,) + prefill_flash_shape()[1:], None, torch.float32))
    for case, kv_len, dtype in cases:
        B, Sq, Skv, Hq, Hkv, D, causal, window = case
        q, k, v = qkv(B, Sq, Skv, Hq, Hkv, D, dtype)
        o = fa.flash_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
        atol, rtol = FLASH_TOL[dtype]
        diff = o.float() - want.float()
        err = float(diff.abs().max())
        flash_checks.append({
            "shape": list(case), "kv_len": kv_len, "dtype": str(dtype),
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "rel_l2": float(diff.norm() / want.float().norm()),
            "out_std": float(want.float().std())})
        if o.dtype != dtype or not _within(o, want, atol, rtol):
            raise RuntimeError(f"flash_attention{case} {dtype} disagrees "
                               f"with its plain version: max|d|={err}")
        del o, want, diff
        if case == flash_path:
            path_inputs, path_err = (q, k, v), err
        elif case == flash_path32:
            path32_inputs = (q, k, v)

    lru_checks = []
    for (B, S, W), with_h0 in [(c, True) for c in RGLRU_GRID] + [
            (lru_path, False)]:
        a = 0.8 + 0.199 * torch.rand((B, S, W), generator=gen, device="cuda")
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        h0 = (torch.randn((B, W), generator=gen, device="cuda")
              if with_h0 else None)
        h = lru.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err = float((h - lru.rglru_scan_ref(a, b, h0)).abs().max())
        lru_checks.append({"shape": [B, S, W], "h0": with_h0,
                           "max_abs_err": err, "atol": RGLRU_ATOL})
        if not err <= RGLRU_ATOL:
            raise RuntimeError(f"rglru_scan{(B, S, W)} disagrees with its "
                               f"plain version: max|d|={err}")
    lru_inputs = (a, b)

    # times at the path's shapes; kernel and plain version in turns
    B, Sq, Skv, Hq, Hkv, D, causal, window = flash_path
    q, k, v = path_inputs
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda").tril()
    mask &= ~torch.ones_like(mask).tril(-window)

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D),
            v.view(B, Hkv, Skv, D), attn_mask=mask, enable_gqa=True)
    lib_err = float((run_library().reshape(q.shape).float()
                     - run_plain().float()).abs().max())
    plain_a = time_ms(run_plain, inner=2, samples=5)
    kern_a = time_ms(run_kernel, inner=2, samples=5)
    kern_b = time_ms(run_kernel, inner=2, samples=5)
    plain_b = time_ms(run_plain, inner=2, samples=5)
    library = time_ms(run_library, inner=2, samples=5)
    q32, k32, v32 = path32_inputs
    fp32_ms = time_ms(lambda: fa.flash_attention(
        q32, k32, v32, causal=causal, window=window), inner=2, samples=5)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, q.element_size())
    prefill = flash_prefill_entry(fa, gen, flash_checks)
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": None,                     # filled in by lm_serve
        "max_abs_err": path_err,
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True, "
                        "boolean causal-window mask)",
        "library_max_abs_err_vs_plain": lib_err,
        "timed": f"one RecurrentGemma-9B attention layer {list(flash_path)} "
                 "bf16; median of 5 x 2 calls, best of 2",
        "bytes": nbytes, "flops": flops,
        "fp32_ms": fp32_ms,
        "fp32_timed": f"the fp32 kernel at {list(flash_path32)}; median of "
                      "5 x 2 calls",
        "qwen2_7b_prefill": prefill,
    }

    a, b = lru_inputs
    plain_a = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    kern_a = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    kern_b = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    plain_b = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    bound_ms, bound_by, nbytes = rglru_bound(*lru_path)
    lru_entry = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:43",
        "launches": None,                     # filled in by lm_serve
        "max_abs_err": lru_checks[-1]["max_abs_err"],
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # no single PyTorch call computes a linear recurrence
        "library_ms": None,
        "timed": f"one RecurrentGemma-9B recurrent layer {list(lru_path)} "
                 "fp32, h0 None as the model passes it; median of 5 x 2 "
                 "calls, best of 2",
        "bytes": nbytes,
    }
    emit("lm_kernels", flash_checks=flash_checks, rglru_checks=lru_checks,
         flash_attention=flash_entry, rglru_scan=lru_entry)
    return {"flash_attention": flash_entry, "rglru_scan": lru_entry}


def _layers_run(cfg, start: int, stop: int, cross: bool = False) -> dict:
    """Kernel launches one run of ``run_layer_range(start, stop)`` makes:
    one a layer of each kind, and the tail whenever ``stop == G``; with
    ``cross`` (an encoder's output given) two an attention layer."""
    kinds = list(cfg.block_pattern) * (stop - start)
    if stop == cfg.num_groups():
        kinds += list(cfg.tail_pattern())
    return {"flash_attention": kinds.count("attn") * (2 if cross else 1),
            "decode_attention": 0, "rglru_scan": kinds.count("rec"),
            "ssd_scan": kinds.count("ssd")}


def _train_launches(cfg) -> dict:
    """Kernel launches one train step makes: each group's layers twice
    (the forward, and again where the backward recomputes the group), the
    tail's once (it is not recomputed); of the backwards, torch code, only
    the RG-LRU's launches its scan, once a layer."""
    groups = list(cfg.block_pattern) * cfg.num_groups()
    tail = list(cfg.tail_pattern())

    def runs(kind):
        return 2 * groups.count(kind) + tail.count(kind)
    return {"flash_attention": runs("attn"), "decode_attention": 0,
            "rglru_scan": runs("rec") + (groups + tail).count("rec"),
            "ssd_scan": runs("ssd")}


def _prefill_launches(cfg) -> dict:
    """Kernel launches one ``prefill`` makes: the decoder's layers, with
    cross-attention and one flash launch an encoder layer where the
    model has an encoder."""
    run = _layers_run(cfg, 0, cfg.num_groups(), cross=cfg.encoder_layers > 0)
    run["flash_attention"] += cfg.encoder_layers
    return run


def _decode_step_launches(cfg, steps: int) -> dict:
    """Kernel launches ``steps`` decode steps make: one a layer, decode
    attention for each attention layer (twice with cross-attention)."""
    run = _layers_run(cfg, 0, cfg.num_groups(), cross=cfg.encoder_layers > 0)
    return {"flash_attention": 0,
            "decode_attention": steps * run["flash_attention"],
            "rglru_scan": steps * run["rglru_scan"],
            "ssd_scan": steps * run["ssd_scan"]}


def _launch_modules() -> dict:
    from repro_torch.serving.profile_split import WRAPPERS
    return WRAPPERS


def launch_counts() -> dict:
    """The hand kernels' wrapper counts, by kernel."""
    return {n: m.launch_count for n, m in _launch_modules().items()}


def reset_launch_counts() -> None:
    for m in _launch_modules().values():
        m.launch_count = 0


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launch_counts().items()}


def _ssd_plain(x, dt, A, Bm, Cm, *, chunk_size, init_state=None):
    from repro_torch.kernels import ssd_scan as ssd
    return ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk_size, init_state)


class plain_versions:
    """Within the block, the named wrappers ("flash_attention",
    "decode_attention", "rglru_scan", "ssd_scan") run their plain versions
    on CUDA tensors, so the model's forward can be held against itself
    without those kernels on this card."""

    def __init__(self, *names):
        modules = _launch_modules()
        plain = {"flash_attention": modules["flash_attention"]
                 .flash_attention_ref,
                 "decode_attention": modules["decode_attention"]
                 .decode_attention_ref,
                 "rglru_scan": modules["rglru_scan"].rglru_scan_ref,
                 "ssd_scan": _ssd_plain}
        self._swaps = [(modules[n], n, plain[n]) for n in names]

    def __enter__(self):
        self._saved = [getattr(m, n) for m, n, _ in self._swaps]
        for m, n, plain in self._swaps:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for (m, n, _), kernel in zip(self._swaps, self._saved):
            setattr(m, n, kernel)
        return False


def init_full_width(arch: str, want_params: int, want_bytes: int):
    """Full-width parameters of ``arch`` drawn on the card from SEED;
    raises unless the tree holds the reference's count and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = tr.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = _nbytes(params)
    if (n_params, n_bytes) != (want_params, want_bytes):
        raise RuntimeError(f"{arch}: {n_params} parameters in {n_bytes} B, "
                           f"the reference's tree holds {want_params} in "
                           f"{want_bytes} B")
    return cfg, params, {"config": cfg.name, "parameters": n_params,
                         "parameter_bytes": n_bytes, "init_seconds": init_s}


def serve_plan(cfg, params, plan):
    """Each (g, tokens) of ``plan`` through a new pair of layer-split
    engines on the card: payload bytes checked, the launch counts set to
    0 just before the first split and read just after the last.  A side
    runs its layers twice where its key missed the cache (the warm-up,
    then the timed run).  Returns the engines, each split's logits and the
    record of the serve."""
    from repro_torch.core.segmentation import hidden_payload_bytes
    from repro_torch.core.transport import WAN_LINK
    from repro_torch.serving.engine import LayerSplitDevice, LayerSplitEngine
    G = cfg.num_groups()
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cuda")
    device = LayerSplitDevice(params, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    expected = dict.fromkeys(launch_counts(), 0)
    forwards = 0                     # whole forwards, warm-ups included
    splits, logits = [], {}
    t_serve = time.perf_counter()
    for g, toks in plan:
        cloud_before, device_before = dict(cloud.stats), dict(device.stats)
        payload, t_net = cloud.process({"tokens": toks}, g)
        out = device.complete(payload, g)
        torch.cuda.synchronize()
        logits[g] = out
        split = {"group": g, "batch": toks.shape[0],
                 "payload_bytes": payload.nbytes, "t_net_seconds": t_net}
        sides_runs = []
        for name, side, (start, stop), before in (
                ("cloud", cloud, (0, g), cloud_before),
                ("device", device, (g, G), device_before)):
            runs = 2 if side.stats["cache_misses"] > before[
                "cache_misses"] else 1           # a miss warms up first
            sides_runs.append(runs)
            per_run = _layers_run(cfg, start, stop)
            for kname, n in per_run.items():
                expected[kname] += runs * n
            split[name] = {
                "gpu_seconds": side.stats["gpu_seconds"]
                - before["gpu_seconds"],
                "compile_seconds": side.stats["compile_seconds"]
                - before["compile_seconds"],
                "runs": runs, "launches_per_run": per_run}
        if sides_runs[0] != sides_runs[1]:
            raise RuntimeError(f"g={g}: the sides ran {sides_runs} times")
        forwards += sides_runs[0]
        want_bytes = hidden_payload_bytes(cfg, toks.shape[0],
                                          toks.shape[1], 2)
        if payload.nbytes != want_bytes or payload.dtype != np.float16:
            raise RuntimeError(f"g={g}: payload of {payload.nbytes} B "
                               f"{payload.dtype}, expected {want_bytes} B "
                               "fp16")
        splits.append(split)
    record = {"serve_seconds": time.perf_counter() - t_serve,
              "splits": splits, "launches": launch_counts(),
              "launches_expected": expected, "whole_forwards": forwards,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if record["launches"] != expected:
        raise RuntimeError(f"layer-split path launched {record['launches']},"
                           f" expected {expected}")
    return cloud, device, logits, record


def profile_split(cloud, device, tokens, group: int) -> dict:
    """One more round at ``group`` through the warm engines under
    ``torch.profiler``; raises if nothing ran on the card or the wrappers
    launched other than one run of each side's layers."""
    from repro_torch.serving.profile_split import profile_round
    cfg = cloud.cfg
    out = profile_round(cloud, device, tokens, group)
    if out["device_seconds"] is None:
        raise RuntimeError("the profiler recorded no device activity")
    device_run = _layers_run(cfg, group, cfg.num_groups())
    per_run = {k: n + device_run[k]
               for k, n in _layers_run(cfg, 0, group).items()}
    if out["wrapper_launches"] != per_run:
        raise RuntimeError(f"profiled round launched "
                           f"{out['wrapper_launches']}, expected {per_run}")
    return out


def phase_lm_serve(entries: dict):
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(LM_ARCH, LM_PARAMETERS,
                                        LM_PARAMETER_BYTES)
    G = cfg.num_groups()
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)
    # the paper's split at the middle group for the whole batch, and the
    # two ends of the range (all on the device, all in the cloud) for one
    # request, the split points tests/test_serving.py uses
    plan = ((G // 2, tokens), (0, tokens[:1]), (G, tokens[:1]))
    cloud, device, logits, record = serve_plan(cfg, params, plan)
    splits, launches = record["splits"], record["launches"]
    if 0 in (launches[n] for n in entries):
        raise RuntimeError(f"layer-split path launched {launches}")
    for name in entries:
        entries[name]["launches"] = launches[name]

    # one machine, same tokens, same kernels: forward_hidden + head
    kernels = ops.kernel_registry()
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    hidden, _, _ = tr.forward_hidden(params, batch, cfg, kernels=kernels)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    # at g == G the reference's engines run the tail layers on both sides
    # (run_layer_range runs the tail whenever stop_group == G); the port
    # keeps that, so that split is held to the same forward with the tail
    # run twice
    pos = torch.arange(LM_SEQ, device="cuda")
    x = tr.run_layer_range(params, tr.embed_inputs(
        params, {"tokens": batch["tokens"][:1]}, cfg), cfg, None,
        start_group=0, stop_group=G, positions=pos, kernels=kernels)
    x = tr.run_layer_range(params, x, cfg, None, start_group=G,
                           stop_group=G, positions=pos, kernels=kernels)
    want_tail_twice = tr.unembed(
        params, tr.apply_norm(params["final_norm"], x)[:, -1:], cfg)
    targets = {G // 2: (want, "forward_hidden + unembed"),
               0: (want[:1], "forward_hidden + unembed"),
               G: (want_tail_twice, "one machine, tail twice as in the "
                   "split")}
    for split in splits:
        g = split["group"]
        target, what = targets[g]
        err = float((logits[g].float() - target.float()).abs().max())
        split.update(logit_max_abs_err=err, compared_with=what)
        if not _within(logits[g], target, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
            raise RuntimeError(f"g={g}: split logits differ from {what} "
                               f"by {err}")
        if not bool(torch.isfinite(logits[g]).all()):
            raise RuntimeError(f"g={g}: non-finite logits")

    # the same forward through the plain versions, on this card: both at
    # once (the check), then each alone (how far one kernel's rounding
    # carries through the 38 layers)
    V = cfg.vocab_size

    def rel_l2(got, ref):
        diff = got[..., :V].float() - ref[..., :V].float()
        return float(diff.norm() / ref[..., :V].float().norm())

    vs_plain, plain_both = {}, None
    both = ("flash_attention", "rglru_scan")
    for names in (both, ("flash_attention",), ("rglru_scan",)):
        counts = launch_counts()
        with plain_versions(*names):
            hidden_p, _, _ = tr.forward_hidden(params, batch, cfg,
                                               kernels=kernels)
            plain = tr.unembed(params, hidden_p[:, -1:], cfg).float()
        torch.cuda.synchronize()
        launched = launches_since(counts)
        if launched != {k: 0 if k in names else n
                        for k, n in _layers_run(cfg, 0, G).items()}:
            raise RuntimeError(f"plain_versions{names}: launched {launched}")
        vs_plain["plain " + " + ".join(names)] = {
            "logits_rel_l2": rel_l2(want, plain),
            "logits_max_abs_err": float((want.float() - plain).abs().max())}
        if names == both:
            plain_both = plain
    del hidden_p
    kernels_vs_plain = vs_plain["plain flash_attention + rglru_scan"][
        "logits_rel_l2"]
    if not kernels_vs_plain <= LM_PLAIN_REL_L2:
        raise RuntimeError(f"kernels vs plain versions: relative L2 error "
                           f"of the logits {kernels_vs_plain} > "
                           f"{LM_PLAIN_REL_L2}")

    # every parameter cast to fp32, request 0: the forward through the
    # kernels against the one through the plain versions (the check that
    # can see a kernel's fault), and the latter as exact arithmetic for
    # the bf16 forwards
    params32 = _tree_map(lambda t: t.float(), params)
    batch0 = {"tokens": batch["tokens"][:1]}

    def forward32():
        hidden32, _, _ = tr.forward_hidden(params32, batch0, cfg,
                                           kernels=kernels)
        return tr.unembed(params32, hidden32[:, -1:], cfg)
    counts = launch_counts()
    kernels32 = forward32()
    torch.cuda.synchronize()
    launched = launches_since(counts)
    if launched != _layers_run(cfg, 0, G):
        raise RuntimeError(f"fp32 forward launched {launched}")
    with plain_versions(*both):
        exact = forward32()
    torch.cuda.synchronize()
    del params32
    torch.cuda.empty_cache()
    fp32_vs_plain = {
        "logits_rel_l2": rel_l2(kernels32, exact),
        "logits_max_abs_err": float((kernels32[..., :V].float()
                                     - exact[..., :V].float()).abs().max()),
        "logits_rms": float(exact[..., :V].float().square().mean().sqrt())}
    if not fp32_vs_plain["logits_rel_l2"] <= LM_FP32_PLAIN_REL_L2:
        raise RuntimeError(f"fp32 forward, kernels vs plain versions: "
                           f"relative L2 error of the logits "
                           f"{fp32_vs_plain['logits_rel_l2']} > "
                           f"{LM_FP32_PLAIN_REL_L2}")
    vs_fp32 = {"kernels": rel_l2(want[:1], exact),
               "plain versions": rel_l2(plain_both[:1], exact)}
    if not vs_fp32["kernels"] <= LM_FP32_RATIO * vs_fp32["plain versions"]:
        raise RuntimeError(f"bf16 forward against fp32: relative L2 error "
                           f"{vs_fp32['kernels']} through the kernels, "
                           f"{vs_fp32['plain versions']} through the plain "
                           f"versions (limit {LM_FP32_RATIO}x)")
    emit("lm_serve", **info, batch=LM_BATCH, seq=LM_SEQ, groups=G,
         tail=list(cfg.tail_pattern()), **record, engine_stats=cloud.stats,
         device_stats=device.stats, fp32_kernels_vs_plain=fp32_vs_plain,
         limit_fp32_rel_l2=LM_FP32_PLAIN_REL_L2,
         kernels_vs_plain=vs_plain, limit_rel_l2=LM_PLAIN_REL_L2,
         bf16_vs_fp32_rel_l2=vs_fp32, limit_fp32_ratio=LM_FP32_RATIO)
    return cloud, device, tokens


def phase_lm_profile(cloud, device, tokens) -> None:
    """One more round of the served batch at g = G // 2, through the
    warm engines of ``lm_serve``, under ``torch.profiler``."""
    emit("lm_profile", **profile_split(cloud, device, tokens,
                                       cloud.cfg.num_groups() // 2))


def ssd_path_shape():
    """(b, S, H, P, G, N, Q) the layer-split path gives the SSD kernel."""
    from repro_torch.configs import get_config
    cfg = get_config(SSD_ARCH)
    s = cfg.ssm
    return (LM_BATCH, LM_SEQ, s.n_heads(cfg.d_model), s.head_dim,
            s.n_groups, s.d_state, s.chunk_size)


def ssd_bound(b, S, H, P, G, N, Q, with_init=False):
    """Least time for one call.  Operations: each chunk's Q(Q+1)/2
    causal (query, key) pairs take N multiply-adds for the score and P
    for its product with x, and the state's read and update 2 Q N P more,
    over the fp32 rate (the masked upper triangle is work no kernel needs;
    ``flops_full_square`` counts the Q x Q square the TPU kernel
    computes).  Bytes: x, dt, A, B, C (and init_state) read once, y and
    the final state written once, fp32."""
    chunks = b * H * (S // Q)
    pairs = Q * (Q + 1) // 2
    flops = chunks * (2 * pairs * (N + P) + 4 * Q * N * P)
    square = chunks * (2 * Q * Q * (N + P) + 4 * Q * N * P)
    nbytes = 4 * (2 * b * S * H * P + b * S * H + H + 2 * b * S * G * N
                  + b * H * P * N * (2 if with_init else 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            square)


def ssd_three_phases(x, dt, A, Bm, Cm, Q, init_state=None):
    """The SSD C entry handed scratch, so that it runs the three phases at
    any length, S = 1 included (where the wrapper hands none and gets the
    step kernel).  Not a launch of the main path: it counts nowhere."""
    from repro_torch.kernels import _build
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // Q
    y, final = torch.empty_like(x), x.new_empty((b, H, P, N))
    states, decay = x.new_empty((b, H, nc, P, N)), x.new_empty((b, H, nc))
    lib = _build.load_library()
    _build.check_launch(lib, lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), states.data_ptr(), decay.data_ptr(),
        b, S, H, P, G, N, Q, torch.cuda.current_stream().cuda_stream),
        "ssd_scan")
    return y, final


def phase_ssd_kernels() -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    path = ssd_path_shape()
    batch1 = (1,) + path[1:]
    checks, timed_inputs = [], {}
    cases = ([(c, True) for c in SSD_GRID] + [(c, w) for c in SSD_ONE_CHUNK
                                              for w in (True, False)]
             + [(batch1, False), (path, False)])
    for case, with_init in cases:
        b, S, H, P, G, N, Q = case
        x, dt = normal(b, S, H, P), uniform(0.001, 0.1, b, S, H)
        A = -uniform(0.5, 2.0, H)
        Bm, Cm = normal(b, S, G, N), normal(b, S, G, N)
        st = normal(b, H, P, N) if with_init else None
        y, final = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=Q,
                                init_state=st)
        torch.cuda.synchronize()
        y_ref, final_ref = ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, Q, st)
        y_err = float((y - y_ref).abs().max())
        final_err = float((final - final_ref).abs().max())
        checks.append({"shape": list(case), "init_state": with_init,
                       "chunks": S // min(Q, S),
                       "y_max_abs_err": y_err, "y_atol": SSD_Y_ATOL,
                       "final_max_abs_err": final_err,
                       "final_atol": SSD_FINAL_ATOL,
                       "y_max_abs": float(y_ref.abs().max())})
        if (y.shape != y_ref.shape or final.shape != final_ref.shape
                or not bool(torch.isfinite(y).all())
                or not bool(torch.isfinite(final).all())):
            raise RuntimeError(f"ssd_scan{case}: wrong shapes or non-finite "
                               "values")
        if not (y_err <= SSD_Y_ATOL and final_err <= SSD_FINAL_ATOL):
            raise RuntimeError(f"ssd_scan{case} disagrees with its plain "
                               f"version: max|dy|={y_err}, "
                               f"max|dfinal|={final_err}")
        if S == 1:
            y3, final3 = ssd_three_phases(x, dt, A, Bm, Cm, 1, st)
            torch.cuda.synchronize()
            checks[-1]["step_kernel_equals_three_phases"] = bool(
                torch.equal(y, y3) and torch.equal(final, final3))
            if not checks[-1]["step_kernel_equals_three_phases"]:
                raise RuntimeError(f"ssd_scan{case}: the step kernel and "
                                   "the three phases differ")
        if case in (batch1, path):
            timed_inputs[case] = ((x, dt, A, Bm, Cm),
                                  max(y_err, final_err))
        del y, final, y_ref, final_ref

    def times(case):
        """Kernel and plain version in turns (no init_state, as the model
        passes it)."""
        args, err = timed_inputs[case]
        Q = case[-1]
        plain_a = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                          samples=5)
        kern_a = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q),
                         inner=2, samples=5)
        kern_b = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q),
                         inner=2, samples=5)
        plain_b = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                          samples=5)
        bound_ms, bound_by, nbytes, flops, square = ssd_bound(*case)
        return {"max_abs_err": err, "ms": min(kern_a, kern_b),
                "plain_ms": min(plain_a, plain_b), "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                "flops_full_square": square,
                "bound_ms_full_square": square / FP32_FLOP_PER_S * 1e3}
    at_path = times(path)
    at_batch1 = times(batch1)
    at_batch1.update(timed=f"one Mamba-2-780M SSD layer {list(batch1)} "
                           "fp32 (request 0 alone, as the g = 0 and g = 48 "
                           "splits run it); median of 5 x 2 calls, best "
                           "of 2")
    entry = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": None,                     # filled in by mamba_serve
        **{key: at_path[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        # no single PyTorch call computes a chunked state-space scan
        "library_ms": None,
        "timed": f"one Mamba-2-780M SSD layer {list(path)} fp32, "
                 "init_state None as the model passes it; median of 5 x 2 "
                 "calls, best of 2",
        **{key: at_path[key] for key in (
            "bytes", "flops", "flops_full_square", "bound_ms_full_square")},
        "batch_1": at_batch1,
    }
    emit("ssd_kernels", checks=checks, ssd_scan=entry,
         before_ms=SSD_BEFORE_MS,
         memory_allocated_bytes=torch.cuda.memory_allocated())
    return entry


def _rel_l2(got, ref, vocab):
    diff = got[..., :vocab].float() - ref[..., :vocab].float()
    return float(diff.norm() / ref[..., :vocab].float().norm())


def phase_mamba_serve(entry: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(SSD_ARCH, SSD_PARAMETERS,
                                        SSD_PARAMETER_BYTES)
    G = cfg.num_groups()
    if cfg.tail_pattern() or cfg.block_pattern != ("ssd",):
        raise RuntimeError(f"{SSD_ARCH}: expected {G} ssd layers, no tail")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)
    plan = ((SSD_SPLIT, tokens), (0, tokens[:1]), (G, tokens[:1]))
    cloud, device, logits, record = serve_plan(cfg, params, plan)
    splits, launches = record["splits"], record["launches"]
    if launches["ssd_scan"] != G * record["whole_forwards"] or not launches[
            "ssd_scan"]:
        raise RuntimeError(f"layer-split path launched {launches}, not {G} "
                           f"SSD launches in each of "
                           f"{record['whole_forwards']} whole forwards")
    entry["launches"] = launches["ssd_scan"]

    # one machine, same tokens, same kernel: forward_hidden + head (no
    # tail, so the g == G split runs nothing twice)
    kernels = ops.kernel_registry()
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    counts = launch_counts()
    hidden, _, _ = tr.forward_hidden(params, batch, cfg, kernels=kernels)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    del hidden
    torch.cuda.synchronize()
    if launches_since(counts) != _layers_run(cfg, 0, G):
        raise RuntimeError(f"one-machine forward launched "
                           f"{launches_since(counts)}")
    for split in splits:
        g = split["group"]
        target = want if g == SSD_SPLIT else want[:1]
        err = float((logits[g].float() - target.float()).abs().max())
        split.update(logit_max_abs_err=err,
                     compared_with="forward_hidden + unembed")
        if not bool(torch.isfinite(logits[g]).all()):
            raise RuntimeError(f"g={g}: non-finite logits")
        if not _within(logits[g], target, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
            raise RuntimeError(f"g={g}: split logits differ from the "
                               f"one-machine forward by {err}")

    # every parameter cast to fp32, request 0: the forward through the
    # kernel against the one through its plain version
    params32 = _tree_map(lambda t: t.float(), params)
    batch0 = {"tokens": batch["tokens"][:1]}

    def forward32():
        hidden32, _, _ = tr.forward_hidden(params32, batch0, cfg,
                                           kernels=kernels)
        return tr.unembed(params32, hidden32[:, -1:], cfg)
    counts = launch_counts()
    kernels32 = forward32()
    torch.cuda.synchronize()
    if launches_since(counts) != _layers_run(cfg, 0, G):
        raise RuntimeError(f"fp32 forward launched {launches_since(counts)}")
    counts = launch_counts()
    with plain_versions("ssd_scan"):
        exact = forward32()
    torch.cuda.synchronize()
    if launches_since(counts)["ssd_scan"] != 0:
        raise RuntimeError("the plain fp32 forward launched the kernel")
    del params32
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    fp32_vs_plain = {
        "logits_rel_l2": _rel_l2(kernels32, exact, V),
        "logits_max_abs_err": float((kernels32[..., :V].float()
                                     - exact[..., :V].float()).abs().max()),
        "logits_rms": float(exact[..., :V].float().square().mean().sqrt())}
    if not fp32_vs_plain["logits_rel_l2"] <= SSD_FP32_PLAIN_REL_L2:
        raise RuntimeError(f"fp32 forward, kernel vs plain version: "
                           f"relative L2 error of the logits "
                           f"{fp32_vs_plain['logits_rel_l2']} > "
                           f"{SSD_FP32_PLAIN_REL_L2}")
    bf16_vs_fp32 = _rel_l2(want[:1], exact, V)

    # one more round at g = SSD_SPLIT through the warm engines, traced
    prof = profile_split(cloud, device, tokens, SSD_SPLIT)
    prof["ssd_share"] = (prof["by_class"].get("ssd_scan", 0.0)
                         / prof["device_seconds"])
    emit("mamba_serve", **info, batch=LM_BATCH, seq=LM_SEQ, groups=G,
         **record, engine_stats=cloud.stats, device_stats=device.stats,
         fp32_kernel_vs_plain=fp32_vs_plain,
         limit_fp32_rel_l2=SSD_FP32_PLAIN_REL_L2,
         bf16_vs_fp32_rel_l2=bf16_vs_fp32, profile=prof)
    return cfg, params, tokens


def decode_bound(lengths, Hq, Hkv, d, itemsize):
    """Least time for one call: the larger of the valid keys and values
    read once (with q, lengths and o) over the memory rate, and 4 d
    operations (two products) for each (query head, valid key) over the
    bf16 tensor-core rate."""
    keys = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * keys * Hkv * d + 2 * B * Hq * d) * itemsize + 4 * B
    flops = 4.0 * keys * Hq * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def rg_decode_inputs(gen):
    """RecurrentGemma-9B's decode attention as ``lm_decode`` gives it at
    its first step: q (1, 16, 256) against the 2048-key window, a view
    inside a (1, 4112, 1, 256) bf16 cache."""
    lo, hi = RG_DECODE_VIEW
    q = torch.randn((1, 16, 256), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, RG_DECODE_CACHE, 1, 256), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    lens = torch.full((1,), hi - lo, dtype=torch.int32, device="cuda")
    return q, k[:, lo:hi], v[:, lo:hi], lens


def time_decode(q, k, v, lens) -> dict:
    """The wrapper, its plain version (in turns), SDPA, and the C entry
    alone (output and scratch allocated beforehand) on one input, with
    its bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    import torch.nn.functional as F
    B, Skv, Hkv, D = k.shape
    Hq = q.shape[1]
    mask = (torch.arange(Skv, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
    lib_err = float((run_library().float() - dec.decode_attention_ref(
        q, k, v, lens).float()).abs().max())

    def timed(fn):
        return time_ms(fn, inner=DECODE_TIMING_CALLS, samples=10)
    plain_a = timed(lambda: dec.decode_attention_ref(q, k, v, lens))
    kern_a = timed(lambda: dec.decode_attention(q, k, v, lens))
    kern_b = timed(lambda: dec.decode_attention(q, k, v, lens))
    plain_b = timed(lambda: dec.decode_attention_ref(q, k, v, lens))
    library = timed(run_library)

    lib = _build.load_library()
    chunk, n_splits = dec.split_plan(B * Hkv, Skv)
    o = torch.empty_like(q)
    part_acc = torch.empty((B * Hkv, n_splits, Hq // Hkv, D),
                           device="cuda")
    part_ml = torch.empty((B * Hkv, n_splits, Hq // Hkv, 2), device="cuda")
    raw_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, Hq,
                Hkv, Skv, D, *k.stride()[:3], *v.stride()[:3], chunk,
                n_splits, D ** -0.5, 1, torch.cuda.current_stream()
                .cuda_stream)
    _build.check_launch(lib, lib.repro_decode_attention(*raw_args),
                        "decode_attention")
    torch.cuda.synchronize()
    if not torch.equal(o, dec.decode_attention(q, k, v, lens)):
        raise RuntimeError("the raw launch and the wrapper differ")
    raw_ms = [timed(lambda: lib.repro_decode_attention(*raw_args))
              for _ in range(2)]
    bound_ms, bound_by, nbytes, flops = decode_bound(
        lens.tolist(), Hq, Hkv, D, q.element_size())
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library, "raw_launch_ms": min(raw_ms),
            "raw_launch_ms_turns": raw_ms,
            "library_max_abs_err_vs_plain": lib_err, "bytes": nbytes,
            "flops": flops, "split": [chunk, n_splits]}


def phase_decode_kernels() -> dict:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import rglru_scan as lru
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    checks = []

    def check(what, o, want, dtype, exact=None):
        atol, rtol = DECODE_TOL[dtype]
        err = float((o.float() - want.float()).abs().max())
        checks.append({"case": what, "dtype": str(dtype), "max_abs_err": err,
                       "atol": atol, "rtol": rtol})
        if (o.dtype != dtype or o.shape != want.shape
                or not bool(torch.isfinite(o).all())
                or not _within(o, want, atol, rtol)):
            raise RuntimeError(f"decode_attention {what} {dtype} disagrees "
                               f"with its plain version: max|d|={err}")
        if exact is not None and not torch.equal(o, exact):
            raise RuntimeError(f"decode_attention {what} {dtype}: a view "
                               "and its contiguous copy differ")
        return err

    path_err, path_inputs = None, None
    for case in DECODE_GRID + (DECODE_PATH,):
        B, Skv, Hq, Hkv, D = case
        for dtype in DECODE_TOL:
            q = normal(B, Hq, D).to(dtype)
            k, v = normal(B, Skv, Hkv, D).to(dtype), normal(
                B, Skv, Hkv, D).to(dtype)
            ragged = torch.randint(1, Skv + 1, (B,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            variants = [("ragged", ragged)]
            if case == DECODE_PATH:
                variants = [("path", torch.full_like(ragged,
                                                     DECODE_PATH_LENGTH))]
            variants += [("length 1", torch.ones_like(ragged)),
                         ("length Skv", torch.full_like(ragged, Skv))]
            for name, lens in variants:
                o = dec.decode_attention(q, k, v, lens)
                torch.cuda.synchronize()
                err = check(f"{list(case)} {name}", o,
                            dec.decode_attention_ref(q, k, v, lens), dtype)
                if name == "path":
                    path_err = err
                    if dtype == torch.bfloat16:
                        path_inputs = (q, k, v, lens)
            # a window inside the cache, read in place
            lo, hi = Skv // 3, Skv // 3 + Skv // 2
            lens = torch.full_like(ragged, hi - lo)
            o = dec.decode_attention(q, k[:, lo:hi], v[:, lo:hi], lens)
            copy = dec.decode_attention(q, k[:, lo:hi].contiguous(),
                                        v[:, lo:hi].contiguous(), lens)
            torch.cuda.synchronize()
            check(f"{list(case)} view [{lo}:{hi}]", o,
                  dec.decode_attention_ref(q, k[:, lo:hi], v[:, lo:hi], lens),
                  dtype, exact=copy)

    # the two scans at one step, as decode runs them (never launched at
    # S = 1 by the layer split): RecurrentGemma-9B's width, Mamba-2-780M's
    # heads with a chunk of one step
    one_step = []
    a = 0.8 + 0.199 * torch.rand((1, 1, 4096), generator=gen, device="cuda")
    b, h0 = normal(1, 1, 4096), normal(1, 4096)
    h = lru.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    err = float((h - lru.rglru_scan_ref(a, b, h0)).abs().max())
    one_step.append({"kernel": "rglru_scan", "shape": [1, 1, 4096],
                     "max_abs_err": err, "atol": RGLRU_ATOL})
    if not err <= RGLRU_ATOL:
        raise RuntimeError(f"rglru_scan at one step: max|d|={err}")
    x, dt = normal(1, 1, 48, 64), 0.001 + 0.099 * torch.rand(
        (1, 1, 48), generator=gen, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((48,), generator=gen, device="cuda"))
    Bm, Cm, st = normal(1, 1, 1, 128), normal(1, 1, 1, 128), normal(
        1, 48, 64, 128)
    y, fin = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=256, init_state=st)
    torch.cuda.synchronize()
    y_ref, fin_ref = ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, 256, st)
    y_err = float((y - y_ref).abs().max())
    fin_err = float((fin - fin_ref).abs().max())
    one_step.append({"kernel": "ssd_scan", "shape": [1, 1, 48, 64, 1, 128],
                     "y_max_abs_err": y_err, "final_max_abs_err": fin_err})
    if not (y_err <= SSD_Y_ATOL and fin_err <= SSD_FINAL_ATOL):
        raise RuntimeError(f"ssd_scan at one step: max|dy|={y_err}, "
                           f"max|dfinal|={fin_err}")

    # times at the path's shape and at RecurrentGemma-9B's decode shape
    q, k, v, lens = path_inputs
    B, Skv, Hq, Hkv, D = DECODE_PATH
    path_times = time_decode(q, k, v, lens)
    rg = rg_decode_inputs(gen)
    rg_err = check("RecurrentGemma-9B decode shape, window view", dec
                   .decode_attention(*rg), dec.decode_attention_ref(*rg),
                   torch.bfloat16)
    rg_times = time_decode(*rg)
    rg_times.update(max_abs_err=rg_err,
                    timed=f"one RecurrentGemma-9B decode layer: q (1, 1, 16, "
                          f"256) against the view [{RG_DECODE_VIEW[0]}:"
                          f"{RG_DECODE_VIEW[1]}] of a (1, {RG_DECODE_CACHE}, "
                          "1, 256) bf16 cache; median of 10 x "
                          f"{DECODE_TIMING_CALLS} calls, best of 2")
    entry = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:65",
        "launches": None,                     # filled in by decode_serve
        "max_abs_err": path_err,
        **{key: path_times[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "raw_launch_ms", "raw_launch_ms_turns")},
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True, "
                        "boolean length mask, transposed views)",
        "library_max_abs_err_vs_plain": path_times[
            "library_max_abs_err_vs_plain"],
        "timed": f"one Qwen2-7B decode layer, q ({B}, 1, {Hq}, {D}), cache "
                 f"({B}, {Skv}, {Hkv}, {D}) bf16, {DECODE_PATH_LENGTH} valid "
                 f"keys a sequence; median of 10 x {DECODE_TIMING_CALLS} "
                 "calls, best of 2. "
                 "raw_launch_ms is the C entry alone (output and scratch "
                 "allocated beforehand): the kernels' pace; ms is the "
                 "wrapper (checks, three torch.empty, one ctypes call): "
                 "what a caller pays",
        "bytes": path_times["bytes"], "flops": path_times["flops"],
        "split": path_times["split"],
        "rg_shape": rg_times,
    }
    emit("decode_kernels", checks=checks, one_step_scans=one_step,
         decode_attention=entry, before_ms=DECODE_BEFORE_MS)
    return entry


def decode_steps(params, cfg, tokens, cache, start: int, steps: int):
    """``steps`` teacher-forced decode steps from position ``start``
    (token ``tokens[:, t]`` at position t) through ``cache``, in place.
    Returns the last logits and each step's CUDA-event milliseconds."""
    from repro_torch.models import transformer as tr
    marks, logits = [], None
    for t in range(start, start + steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache, t,
                                       cfg)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return logits, [a.elapsed_time(b) for a, b in marks]


def _lm_batch(tokens, frames=None) -> dict:
    """A model's batch: the tokens, and an encoder-decoder's frames."""
    return ({"tokens": tokens} if frames is None
            else {"tokens": tokens, "frontend": frames})


def prefill_decode(params, cfg, tokens, prompt: int, steps: int,
                   frames=None):
    """Prefill ``tokens[:, :prompt]`` (and an encoder-decoder's
    ``frames``) into a cache of ``prompt + steps`` rows, then ``steps``
    teacher-forced decode steps; the launch counts set to 0 just before
    and read after each part.  Returns (last logits, cache, record)."""
    from repro_torch.models import transformer as tr
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = tr.prefill(params, _lm_batch(tokens[:, :prompt], frames), cfg,
                          pad_to=prompt + steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_launches = launch_counts()
    logits, step_ms = decode_steps(params, cfg, tokens, cache, prompt, steps)
    decode_s = time.perf_counter() - t1
    record = {
        "batch": int(tokens.shape[0]), "prompt": prompt, "steps": steps,
        "prefill_seconds": t1 - t0, "decode_seconds": decode_s,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "tokens_per_second": tokens.shape[0] * steps / decode_s,
        "launches": {"prefill": prefill_launches,
                     "decode": launches_since(prefill_launches)}}
    want = {"prefill": _prefill_launches(cfg),
            "decode": _decode_step_launches(cfg, steps)}
    if record["launches"] != want:
        raise RuntimeError(f"prefill + decode launched {record['launches']}"
                           f", expected {want}")
    return logits, cache, record


def one_machine(params, cfg, tokens, frames=None):
    """Last-token logits of the forward over all of ``tokens`` (and an
    encoder-decoder's ``frames``).  An SSD model whose chunk does not
    divide the length (Mamba-2's 256 and 4112 tokens) runs with the
    largest chunk that does (16): the chunked scan computes the same
    function at any chunk length."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    S = tokens.shape[1]
    if cfg.ssm is not None and S % cfg.ssm.chunk_size:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=math.gcd(S, cfg.ssm.chunk_size)))
    hidden, _, _ = tr.forward_hidden(params, _lm_batch(tokens, frames), cfg,
                                     kernels=ops.kernel_registry())
    return tr.unembed(params, hidden[:, -1:], cfg)


def phase_model_decode(phase: str, cfg, params, prompts, frames=None,
                       **extra) -> None:
    """Request 0 of a layer-split model (and of an encoder-decoder's
    ``frames``): its prompt prefilled into a cache of ``prompt +
    LM_DECODE_STEPS`` rows, then as many teacher-forced steps, in bf16
    and in fp32, and the last MODEL_PROFILE_STEPS bf16 steps once more
    under ``torch.profiler`` (each cache row rewritten; a recurrent state
    steps on).  The fp32 decode is held to the fp32 one-machine forward
    over the same tokens; the bf16 distances are reported; ``extra``
    fields join the phase's line.  The fp32 runs cast every parameter
    to fp32; an encoder-decoder's also take its config's parameter dtype
    as fp32, which the frames are cast to."""
    from repro_torch.serving.profile_split import profile_decode
    prompt = prompts.shape[1]
    steps = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, LM_DECODE_STEPS)).astype(np.int32)
    tokens = torch.from_numpy(np.concatenate([prompts[:1], steps],
                                             axis=1)).cuda()
    frames0 = None if frames is None else frames[:1]
    logits, cache, record = prefill_decode(params, cfg, tokens, prompt,
                                           LM_DECODE_STEPS, frames0)
    record["cache_rows"] = prompt + LM_DECODE_STEPS
    profile = profile_decode(params, cfg, tokens, cache,
                             prompt + LM_DECODE_STEPS - MODEL_PROFILE_STEPS,
                             MODEL_PROFILE_STEPS)
    del cache
    launches = _decode_step_launches(cfg, MODEL_PROFILE_STEPS)
    if profile["device_seconds"] is None or profile[
            "wrapper_launches"] != launches:
        raise RuntimeError(f"{phase}: the profiled steps launched "
                           f"{profile['wrapper_launches']}, expected "
                           f"{launches}; device seconds "
                           f"{profile['device_seconds']}")
    V = cfg.vocab_size
    want = one_machine(params, cfg, tokens, frames0)
    params32 = _tree_map(lambda t: t.float(), params)
    cfg32 = (cfg if frames is None
             else dataclasses.replace(cfg, param_dtype="float32"))
    logits32, cache32, record32 = prefill_decode(params32, cfg32, tokens,
                                                 prompt, LM_DECODE_STEPS,
                                                 frames0)
    del cache32
    want32 = one_machine(params32, cfg32, tokens, frames0)
    del params32
    torch.cuda.empty_cache()
    for t in (logits, want, logits32, want32):
        if not bool(torch.isfinite(t[..., :V]).all()):
            raise RuntimeError(f"{phase}: non-finite logits")
    held = _rel_l2(logits32, want32, V)
    emit(phase, config=cfg.name, **record, profile=profile,
         fp32={k: record32[k] for k in ("prefill_seconds", "step_ms_median",
                                        "launches")},
         fp32_decode_vs_forward_rel_l2=held,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2,
         bf16_decode_vs_forward_rel_l2=_rel_l2(logits, want, V),
         bf16_decode_vs_fp32_forward_rel_l2=_rel_l2(logits, want32, V),
         bf16_forward_vs_fp32_forward_rel_l2=_rel_l2(want, want32, V),
         **extra)
    if not held <= DECODE_FP32_REL_L2:
        raise RuntimeError(f"{phase}: fp32 decode against the fp32 forward: "
                           f"relative L2 error of the logits {held} > "
                           f"{DECODE_FP32_REL_L2}")


def phase_decode_serve(entry: dict, flash_entry: dict, measured: dict):
    """Qwen2-7B at full width: 8 prompts of 4096 tokens prefilled and
    decoded DECODE_STEPS steps (the main path), held to the forward, in
    fp32 to the plain version, and from an int8 cache; the prefill once
    more, warm.  Writes the warm prefill's seconds and the median decode
    step's into ``measured`` for ``calibrate``."""
    from repro_torch.models import transformer as tr

    cfg, params, info = init_full_width(DECODE_ARCH, DECODE_PARAMETERS,
                                        DECODE_PARAMETER_BYTES)
    if (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()) != tuple(
            DECODE_PATH[2:]):
        raise RuntimeError(f"{DECODE_ARCH}: heads and head_dim differ from "
                           f"the decode path's {DECODE_PATH}")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_LEN)).astype(
            np.int32)).cuda()
    V = cfg.vocab_size

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    logits, cache, record = prefill_decode(params, cfg, tokens,
                                           DECODE_PROMPT, DECODE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches = record["launches"]["decode"]["decode_attention"]
    if launches != cfg.num_layers * DECODE_STEPS:
        raise RuntimeError(f"decode attention launched {launches} times")
    entry["launches"] = launches
    flash_entry["qwen2_7b_prefill"]["launches"] = record["launches"][
        "prefill"]["flash_attention"]
    cache_bytes = _nbytes(cache)
    if cache_bytes != DECODE_CACHE_BYTES:
        raise RuntimeError(f"the cache holds {cache_bytes} B, the "
                           f"reference's {DECODE_CACHE_BYTES} B")
    # the prefill once more, warm (the first one grew the allocator's
    # pool), unpadded as the count has it; its cache is dropped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.prefill(params, {"tokens": tokens[:, :DECODE_PROMPT]}, cfg)
    torch.cuda.synchronize()
    prefill_warm = time.perf_counter() - t0
    measured["qwen2_prefill"] = prefill_warm
    measured["qwen2_decode"] = record["step_ms_median"] / 1e3

    # bf16: against the one-machine forward over the same 4160 tokens
    want = one_machine(params, cfg, tokens)
    if not bool(torch.isfinite(logits[..., :V]).all()):
        raise RuntimeError("non-finite decode logits")
    bf16 = _rel_l2(logits, want, V)

    # fp32, request 0: the decode through the kernel against the fp32
    # forward and against the same decode through the plain version
    params32 = _tree_map(lambda t: t.float(), params)
    tok0 = tokens[:1, :DECODE_PROMPT + DECODE_FP32_STEPS]
    _, c32 = tr.prefill(params32, {"tokens": tok0[:, :DECODE_PROMPT]}, cfg,
                        pad_to=tok0.shape[1])
    c32_plain = _tree_map(torch.clone, c32)
    counts = launch_counts()
    k32, _ = decode_steps(params32, cfg, tok0, c32, DECODE_PROMPT,
                          DECODE_FP32_STEPS)
    if launches_since(counts) != _decode_step_launches(cfg,
                                                       DECODE_FP32_STEPS):
        raise RuntimeError(f"fp32 decode launched {launches_since(counts)}")
    counts = launch_counts()
    with plain_versions("decode_attention"):
        p32, _ = decode_steps(params32, cfg, tok0, c32_plain, DECODE_PROMPT,
                              DECODE_FP32_STEPS)
    if launches_since(counts)["decode_attention"] != 0:
        raise RuntimeError("the plain fp32 decode launched the kernel")
    del c32, c32_plain
    f32 = one_machine(params32, cfg, tok0)
    del params32
    torch.cuda.empty_cache()
    fp32 = {"vs_forward_rel_l2": _rel_l2(k32, f32, V),
            "vs_plain_rel_l2": _rel_l2(k32, p32, V),
            "max_abs_err_vs_plain": float((k32[..., :V] - p32[..., :V])
                                          .abs().max()),
            "logits_rms": float(f32[..., :V].square().mean().sqrt())}

    # an int8 cache from empty: through the kernel, through the plain
    # version, and the same steps over a bf16 cache
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def from_empty(c):
        cache0 = tr.init_decode_cache(c, DECODE_BATCH, DECODE_INT8_STEPS,
                                      device="cuda")
        return decode_steps(params, c, tokens, cache0, 0,
                            DECODE_INT8_STEPS)[0]
    counts = launch_counts()
    k8 = from_empty(cfg8)
    if launches_since(counts) != _decode_step_launches(cfg,
                                                       DECODE_INT8_STEPS):
        raise RuntimeError(f"int8 decode launched {launches_since(counts)}")
    with plain_versions("decode_attention"):
        p8 = from_empty(cfg8)
    b16 = from_empty(cfg)
    int8 = {"kernel_vs_plain_rel_l2": _rel_l2(k8, p8, V),
            "vs_bf16_cache_rel_l2": _rel_l2(k8, b16, V),
            "plain_vs_bf16_cache_rel_l2": _rel_l2(p8, b16, V)}
    emit("decode_serve", **info, **record, cache_bytes=cache_bytes,
         prefill_seconds_warm=prefill_warm, peak_memory_bytes=peak, bf16_decode_vs_forward_rel_l2=bf16,
         limit_bf16_rel_l2=LM_PLAIN_REL_L2, fp32=fp32,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2, fp32_steps=DECODE_FP32_STEPS,
         int8=int8, int8_steps=DECODE_INT8_STEPS)
    for name, err, limit in (
            ("bf16 decode vs the bf16 forward", bf16, LM_PLAIN_REL_L2),
            ("fp32 decode vs the fp32 forward", fp32["vs_forward_rel_l2"],
             DECODE_FP32_REL_L2),
            ("fp32 decode, kernel vs plain version", fp32["vs_plain_rel_l2"],
             DECODE_FP32_REL_L2),
            ("int8-cache decode, kernel vs plain version",
             int8["kernel_vs_plain_rel_l2"], LM_PLAIN_REL_L2)):
        if not err <= limit:
            raise RuntimeError(f"{name}: relative L2 error of the logits "
                               f"{err} > {limit}")
    return cfg, params, tokens, cache


def phase_decode_profile(cfg, params, tokens, cache) -> None:
    """The last DECODE_PROFILE_STEPS positions of the main path decoded
    again through its cache (each row rewritten with what it held) under
    ``torch.profiler``."""
    from repro_torch.serving.profile_split import profile_decode
    start = DECODE_LEN - DECODE_PROFILE_STEPS
    out = profile_decode(params, cfg, tokens, cache, start,
                         DECODE_PROFILE_STEPS)
    if out["device_seconds"] is None:
        raise RuntimeError("the profiler recorded no device activity")
    want = _decode_step_launches(cfg, DECODE_PROFILE_STEPS)
    if out["wrapper_launches"] != want:
        raise RuntimeError(f"profiled decode launched "
                           f"{out['wrapper_launches']}, expected {want}")
    out["decode_attention_share"] = (
        out["by_class"].get("decode_attention", 0.0) / out["device_seconds"])
    emit("decode_profile", **out)


def tree_checksum(tree: dict) -> int:
    """A checksum of every leaf's bytes, in leaf order: each chunk's
    position-weighted byte sum on the card (int64, exact), folded on the
    host.  Equal trees give equal sums on any process."""
    total, chunk = 0, 1 << 24
    for t in _leaves(tree):
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        weight = torch.arange(chunk, device=flat.device, dtype=torch.int64)
        weight = weight % 65521 + 1
        for i in range(0, flat.numel(), chunk):
            part = flat[i:i + chunk].to(torch.int64)
            s = int((part * weight[:part.numel()]).sum())
            total = (total * 1_000_003 + s) % (2 ** 61 - 1)
    return total


def _gb_per_s(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def _pipeline_rank(rank, world_size, stages, checksums, cfg, micro_x, want,
                   weight):
    """One rank of ``pipeline_qwen2``: copy this stage's groups out of the
    parent's memory, then the collectives and the pipeline, each held to
    the bit.  Returns what it measured (host floats and ints).

    ``stages`` arrive as CUDA IPC mappings of the parent's stacked leaves
    (a slice maps its whole storage, so every stage is mapped); they stay
    mapped until this function returns, since ``run_world`` holds the
    arguments, and add nothing to this rank's allocations.  The rank
    computes only from its own copy of its stage."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tr

    torch.cuda.set_device(0)
    out = {"rank": rank}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        # this stage's groups on this rank's own allocation
        own = _tree_map(torch.clone, stages[rank])
        torch.cuda.synchronize()
        out["stage_bytes"] = _nbytes(own)
        out["checksum_equal"] = tree_checksum(own) == checksums[rank]
        mesh = Mesh((world_size,), ("stage",))
        group = mesh.group("stage")

        def timed(fn, *args):
            dist.barrier(group=group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(*args)
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0

        # the library's collectives, through host memory as gloo needs
        def all_gather(t):
            res = torch.empty((world_size * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype)
            dist.all_gather_into_tensor(res, t.cpu(), group=group)
            return res.cuda()

        def all_reduce(t):
            res = t.cpu()
            dist.all_reduce(res, group=group)
            return res.cuda()

        # 1. the ring gather of one layer's wi_up, row-sharded
        chunk = weight.shape[0] // world_size
        shard = weight[rank * chunk:(rank + 1) * chunk].clone()
        coll.ring_all_gather(shard, "stage", mesh=mesh)          # cold
        stats = coll.HopStats()
        ring, ring_s = timed(lambda: coll.ring_all_gather(
            shard, "stage", mesh=mesh, stats=stats))
        agt, agt_s = timed(all_gather, shard)
        whole, make_s = timed(coll.make_ring_all_gather(mesh, "stage"),
                              weight)
        nbytes = weight.numel() * weight.element_size()
        out["ring"] = {
            "equal_all_gather": torch.equal(ring, agt),
            "equal_unsharded": torch.equal(ring, weight),
            "make_ring_equal_unsharded": torch.equal(whole, weight),
            "bytes": nbytes, "hops": stats.hops, "hop_bytes": stats.bytes,
            "host_copy_seconds": stats.host_copy_seconds,
            "transfer_seconds": stats.transfer_seconds,
            "seconds": ring_s, "gb_per_s": _gb_per_s(nbytes, ring_s),
            "all_gather_seconds": agt_s,
            "all_gather_gb_per_s": _gb_per_s(nbytes, agt_s),
            "make_ring_seconds": make_s,
            "make_ring_gb_per_s": _gb_per_s(nbytes, make_s)}
        del ring, agt, whole, shard

        # 2. reduce-scatter then gather, integer-valued fp32
        gen = torch.Generator(device="cuda").manual_seed(SEED + rank)
        ints = torch.randint(-PIPE_INT_RANGE, PIPE_INT_RANGE + 1,
                             PIPE_GATHERED_SHAPE, generator=gen,
                             device="cuda").float()
        rsg, rsg_s = timed(lambda: coll.reduce_scatter_then_gather(
            ints, "stage", mesh=mesh))
        summed, ar_s = timed(all_reduce, ints)
        nbytes = ints.numel() * ints.element_size()
        out["reduce"] = {
            "equal_all_reduce": torch.equal(rsg, summed), "bytes": nbytes,
            "seconds": rsg_s, "gb_per_s": _gb_per_s(nbytes, rsg_s),
            "all_reduce_seconds": ar_s,
            "all_reduce_gb_per_s": _gb_per_s(nbytes, ar_s)}
        del ints, rsg, summed

        # 3. the pipeline: this rank's stage of 7 groups on flash
        per = cfg.num_groups() // world_size
        positions = torch.arange(micro_x.shape[2], device="cuda")
        x = micro_x.clone()
        # the stacked tree gpipe_forward takes, every stage's entry a view
        # of this rank's own copy (it reads only its own)
        params = _tree_map(lambda a: a.unsqueeze(0).expand(
            (world_size,) + tuple(a.shape)), own)

        def stage_fn(p, h):
            return tr.run_layer_range(p, h, cfg, None, start_group=0,
                                      stop_group=per, positions=positions,
                                      kernels=ops.kernel_registry())

        fa.launch_count = 0
        got, cold_s = timed(lambda: gpipe_forward(
            stage_fn, params, x, mesh=mesh, axis_name="stage"))
        out["flash_launches"] = fa.launch_count
        stats = coll.HopStats()
        warm, warm_s = timed(lambda: gpipe_forward(
            stage_fn, params, x, mesh=mesh, axis_name="stage", stats=stats))
        out["pipeline"] = {
            "equal_sequential": torch.equal(got, want),
            "warm_equal_sequential": torch.equal(warm, want),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "cold_seconds": cold_s, "warm_seconds": warm_s,
            "hops": stats.hops, "hop_bytes": stats.bytes,
            "host_copy_seconds": stats.host_copy_seconds,
            "transfer_seconds": stats.transfer_seconds}
        out["peak_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


def pipeline_flash_check(cfg, batch: int = PIPE_BATCH,
                         seq: int = PIPE_SEQ) -> dict:
    """flash held to its plain version on the card at the shape a phase's
    ranks give it (``batch`` x ``seq``, causal, the config's heads, bf16),
    on random inputs; raises outside FLASH_TOL.  The launch is a
    comparison's, made before the phase sets the count to 0."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, S, D = batch, seq, cfg.resolved_head_dim()
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads

    def n(heads):
        return torch.randn((B * heads, S, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
    q, k, v = n(Hq), n(Hkv), n(Hkv)
    o = fa.flash_attention(q, k, v, causal=True, window=0)
    want = fa.flash_attention_ref(q, k, v, causal=True, window=0)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    err = float((o.float() - want.float()).abs().max())
    shape = [B, S, S, Hq, Hkv, D, True, 0]
    if (o.dtype != torch.bfloat16 or not _within(o, want, atol, rtol)
            or not bool(torch.isfinite(o).all())):
        raise RuntimeError(f"flash_attention{tuple(shape)} bf16 disagrees "
                           f"with its plain version: max|d|={err}")
    return {"shape": shape, "dtype": "bfloat16", "max_abs_err": err,
            "atol": atol, "rtol": rtol}


def phase_pipeline_qwen2(cfg, params) -> None:
    """Qwen2-7B's 28 groups pipelined as 4 stages of 7 in 4 ranks on this
    card (``distributed/pipeline.py::gpipe_forward``, gloo), every rank's
    outputs held to the bit to the sequential ``run_layer_range`` here
    (flash first held to its plain version at the stages' shape);
    the ring gather and reduce-scatter + gather of one layer's largest
    MLP weight held to ``all_gather_into_tensor`` and ``all_reduce``."""
    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    mode = tool_output(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"]).splitlines()[0].strip()
    if mode != "Default":
        raise RuntimeError(f"compute mode {mode!r}: {PIPE_STAGES} ranks "
                           f"cannot share the card (needs 'Default')")
    G, S = cfg.num_groups(), PIPE_STAGES
    if G % S or cfg.tail_pattern():
        raise RuntimeError(f"{G} groups and a tail do not split in {S}")
    per = G // S
    stages = [{"blocks": _tree_map(lambda a: a[s * per:(s + 1) * per],
                                   params["blocks"])} for s in range(S)]
    checksums = [tree_checksum(t) for t in stages]
    weight = params["blocks"]["b0"][PIPE_GATHERED[0]][PIPE_GATHERED[1]][0]
    if tuple(weight.shape) != PIPE_GATHERED_SHAPE:
        raise RuntimeError(f"the gathered weight is {tuple(weight.shape)}")
    flash = pipeline_flash_check(cfg)

    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (PIPE_MICRO * PIPE_BATCH, PIPE_SEQ)).astype(
            np.int32)).cuda()
    micro_x = tr.embed_tokens(params, tokens, cfg).reshape(
        PIPE_MICRO, PIPE_BATCH, PIPE_SEQ, cfg.d_model)
    positions = torch.arange(PIPE_SEQ, device="cuda")

    def sequential():
        return torch.stack([tr.run_layer_range(
            params, micro_x[m], cfg, None, start_group=0, stop_group=G,
            positions=positions, kernels=ops.kernel_registry())
            for m in range(PIPE_MICRO)])
    fa.launch_count = 0
    want = sequential()                                   # cold
    seq_launches = fa.launch_count
    if seq_launches != G * PIPE_MICRO:
        raise RuntimeError(f"the sequential forward launched flash "
                           f"{seq_launches} times")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = sequential()
    torch.cuda.synchronize()
    seq_warm = time.perf_counter() - t0
    if not torch.equal(again, want):
        raise RuntimeError("two sequential forwards differ")
    del again

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ranks = run_world(_pipeline_rank, S, (stages, checksums, cfg,
                                              micro_x, want, weight),
                          workdir=workdir, timeout=PIPE_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    hop_bytes = micro_x[0].numel() * micro_x.element_size()
    whole_bytes = _nbytes(params)
    emit("pipeline_qwen2", config=cfg.name, stages=S, groups_per_stage=per,
         microbatches=PIPE_MICRO, microbatch=[PIPE_BATCH, PIPE_SEQ],
         backend="gloo", compute_mode=mode,
         bubble_fraction=bubble_fraction(PIPE_MICRO, S),
         hop_bytes=hop_bytes, hops=(S - 1) * PIPE_MICRO,
         hop_bytes_total=(S - 1) * PIPE_MICRO * hop_bytes,
         sequential_seconds_warm=seq_warm,
         sequential_flash_launches=seq_launches,
         pipelined_seconds_warm=max(r["pipeline"]["warm_seconds"]
                                    for r in ranks),
         world_seconds=world_s, model_bytes=whole_bytes,
         rank_margin_bytes=PIPE_RANK_MARGIN_BYTES, flash_check=flash,
         ranks=ranks)
    for r in ranks:
        failed = [name for name, ok in (
            ("stage checksum", r["checksum_equal"]),
            ("ring gather vs all_gather_into_tensor",
             r["ring"]["equal_all_gather"]),
            ("ring gather vs the unsharded weight",
             r["ring"]["equal_unsharded"]),
            ("make_ring_all_gather vs the unsharded weight",
             r["ring"]["make_ring_equal_unsharded"]),
            ("reduce_scatter_then_gather vs all_reduce",
             r["reduce"]["equal_all_reduce"]),
            ("pipelined vs sequential forward",
             r["pipeline"]["equal_sequential"]),
            ("warm pipelined vs sequential forward",
             r["pipeline"]["warm_equal_sequential"]),
            (f"flash launched {r['flash_launches']} times, not "
             f"{per * PIPE_MICRO}", r["flash_launches"] == per * PIPE_MICRO),
            (f"the rank allocated {r['peak_memory_allocated_bytes']} B, "
             f"more than its stage and {PIPE_RANK_MARGIN_BYTES} B",
             r["peak_memory_allocated_bytes"]
             < r["stage_bytes"] + PIPE_RANK_MARGIN_BYTES)) if not ok]
        if failed:
            raise RuntimeError(f"pipeline_qwen2, rank {r['rank']}: "
                               f"{'; '.join(failed)}")


#: how long a thread of ``tp_as_ranks`` waits for its peers at a sum
AS_RANKS_TIMEOUT_S = 300


def tp_as_ranks(target, shape, *args) -> list:
    """``target(mesh, *args)`` for every rank of a (data, model) mesh of
    ``shape``, each rank a thread of this one process under
    ``torch.inference_mode()``; their returns in rank order.  A thread's
    ``mesh`` answers ``axis_index`` with its rank's coordinates, so
    ``reshard`` and the model cut and compute that rank's blocks, and the
    port's ``collectives.ring_all_gather`` (hence ``psum``) and
    ``broadcast`` over such a mesh hand the ranks' tensors over in memory,
    in group-rank order.  One process computing each rank's partial
    products from its own blocks and summing them with the ranks' own
    fp32-once function: a yardstick for a world of ranks that carries
    their rounding without their processes, pinned copies or sockets (as
    ``moe_as_ranks`` is for the MoE layer alone)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import Mesh

    names = ("data", "model")
    grid = np.arange(math.prod(shape)).reshape(shape)
    lines = {}                      # (axis, rank) -> the ranks of its group
    for a, axis in enumerate(names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            for r in line:
                lines[(axis, int(r))] = tuple(int(x) for x in line)
    barriers = {line: threading.Barrier(len(line), timeout=AS_RANKS_TIMEOUT_S)
                for line in set(lines.values())}
    board = {}

    class RankMesh(Mesh):
        def __init__(self, rank):
            super().__init__(shape, names)
            self.rank = rank

        def axis_index(self, axis_name, rank=None):
            return super().axis_index(axis_name,
                                      self.rank if rank is None else rank)

        def group(self, axis_name):
            return lines[(axis_name, self.rank)]

    def exchange(x, axis_name, mesh):
        line = mesh.group(axis_name)
        board[(line, mesh.rank)] = x
        barriers[line].wait()
        parts = [board[(line, r)] for r in line]
        barriers[line].wait()
        return parts

    plain_gather, plain_broadcast = coll.ring_all_gather, coll.broadcast

    def gather(x, axis_name=None, *, mesh=None, group=None, stats=None):
        if isinstance(mesh, RankMesh):
            return torch.cat(exchange(x, axis_name, mesh))
        return plain_gather(x, axis_name, mesh=mesh, group=group,
                            stats=stats)

    def broadcast(x, axis_name=None, *, mesh=None, group=None, stats=None):
        if isinstance(mesh, RankMesh):
            return exchange(x, axis_name, mesh)[0].clone()
        return plain_broadcast(x, axis_name, mesh=mesh, group=group,
                               stats=stats)

    results, errors = [None] * grid.size, []

    def run(rank):
        try:
            with torch.inference_mode():
                results[rank] = target(RankMesh(rank), *args)
        except BaseException as e:          # re-raised below
            errors.append(e)
            for b in barriers.values():
                b.abort()

    coll.ring_all_gather, coll.broadcast = gather, broadcast
    try:
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(grid.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        coll.ring_all_gather, coll.broadcast = plain_gather, plain_broadcast
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


def tp_batch(mesh, tokens, frames=None):
    """The batch of ``tokens`` (and an encoder-decoder's ``frames``), or
    one rank's rows of it under ``batch_specs`` (``mesh`` not None)."""
    from repro_torch.distributed import sharding as shd
    batch = _lm_batch(tokens, frames)
    if mesh is None:
        return batch
    return shd.tree_map_with_path(
        lambda path, t, s: shd.local_shard(t, s, mesh), batch,
        shd.batch_specs(batch, ("data",), mesh))


def tp_serve(mesh, cfg, own, tokens, counted: bool = True,
             prompt: int = TP_PROMPT, frames=None):
    """``tokens``' rows (and ``frames``' where the model has an encoder)
    of one rank of ``mesh`` (``None``: one device) through the step
    builders of ``launch/dryrun.py`` on ``own``: prefill of ``prompt``
    tokens, the cache grown by TP_DECODE_STEPS rows, then as many
    teacher-forced decode steps.  Returns (each call's logits on the
    host, stacked; the cache; a record of the host seconds of each call
    and, with ``counted``, each part's launches and the hops of its sums
    and gathers, counted from 0 just before the prefill, which the
    world's ranks enter together)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tr

    batch = tp_batch(mesh, tokens, frames)
    toks = batch["tokens"]
    batch["tokens"] = toks[:, :prompt]
    prefill, _ = dryrun.build_prefill_step(cfg, mesh)
    decode, _ = dryrun.build_decode_step(cfg, mesh)
    sums, gathers = coll.HopStats(), coll.HopStats()
    record = {}
    with (coll.counting(sums, gathers) if counted
          else contextlib.nullcontext()):
        if counted:
            dist.barrier()
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(own, batch)
        torch.cuda.synchronize()
        record["prefill_seconds"] = time.perf_counter() - t0
        if counted:
            record.update(prefill_launches=launch_counts(),
                          prefill_psum=dataclasses.asdict(sums),
                          prefill_gather=dataclasses.asdict(gathers))
        out = [logits]
        cache = tr.pad_kv_caches(cache, prompt + TP_DECODE_STEPS)
        record["step_seconds"] = []
        for t in range(prompt, prompt + TP_DECODE_STEPS):
            t0 = time.perf_counter()
            logits, cache = decode(own, toks[:, t:t + 1], cache, t)
            torch.cuda.synchronize()
            record["step_seconds"].append(time.perf_counter() - t0)
            out.append(logits)
    if counted:
        record.update(
            decode_launches=launches_since(record["prefill_launches"]),
            psum=dataclasses.asdict(sums), gather=dataclasses.asdict(gathers))
    return torch.stack(out).cpu(), cache, record


def tp_decode_check(gen, B: int, Hq: int, Hkv: int, D: int,
                    Skv: int = TP_PROMPT + TP_DECODE_STEPS) -> dict:
    """Decode attention at a rank's cache shape (B rows of ``Skv`` keys,
    by default TP_PROMPT + TP_DECODE_STEPS, Hq query heads on Hkv, bf16,
    every key valid) held to its plain version within FLASH_TOL[bf16],
    then timed (``time_decode``); the launches are a comparison's."""
    from repro_torch.kernels import decode_attention as dec
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, Skv, Hkv, D), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    lens = torch.full((B,), Skv, dtype=torch.int32, device="cuda")
    o = dec.decode_attention(q, k, v, lens)
    want = dec.decode_attention_ref(q, k, v, lens)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    err = float((o.float() - want.float()).abs().max())
    if not (_within(o, want, atol, rtol) and bool(torch.isfinite(o).all())):
        raise RuntimeError(f"decode_attention at {[B, Skv, Hq, Hkv, D]} "
                           f"bf16 disagrees with its plain version: "
                           f"max|d|={err}")
    return {"shape": [B, Skv, Hq, Hkv, D], "dtype": "bfloat16",
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            **time_decode(q, k, v, lens)}


def rglru_rank_check(gen, B: int, S: int, W: int) -> dict:
    """The RG-LRU scan at a rank's shape, (B, S, W) fp32 from no state as
    prefill runs it and one step from a state as decode does, held to its
    plain version within RGLRU_ATOL, the prefill shape then timed in
    turns with its bound; the launches are a comparison's."""
    from repro_torch.kernels import rglru_scan as lru
    checks = []
    for steps, with_h0 in ((S, False), (1, True)):
        a = 0.8 + 0.199 * torch.rand((B, steps, W), generator=gen,
                                     device="cuda")
        b = torch.randn((B, steps, W), generator=gen, device="cuda")
        h0 = (torch.randn((B, W), generator=gen, device="cuda")
              if with_h0 else None)
        h = lru.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err = float((h - lru.rglru_scan_ref(a, b, h0)).abs().max())
        checks.append({"shape": [B, steps, W], "h0": with_h0,
                       "max_abs_err": err, "atol": RGLRU_ATOL})
        if not (err <= RGLRU_ATOL and bool(torch.isfinite(h).all())):
            raise RuntimeError(f"rglru_scan{(B, steps, W)} disagrees with "
                               f"its plain version: max|d|={err}")
        if steps == S:
            inputs = (a, b)
    a, b = inputs
    plain_a = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    kern_a = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    kern_b = time_ms(lambda: lru.rglru_scan(a, b), inner=2, samples=5)
    plain_b = time_ms(lambda: lru.rglru_scan_ref(a, b), inner=2, samples=5)
    bound_ms, bound_by, nbytes = rglru_bound(B, S, W)
    return {"shape": [B, S, W], "checks": checks,
            "max_abs_err": checks[0]["max_abs_err"],
            "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "library_ms": None,
            "timed": "a rank's RG-LRU layer, fp32, h0 None; median of 5 x 2 "
                     "calls, best of 2"}


def ssd_rank_check(gen, b: int, S: int, H: int, P: int, G: int, N: int,
                   Q: int) -> dict:
    """The SSD scan at a rank's heads, (b, S, H, P) with whole B and C (G
    groups of N) from no state as prefill runs it, and one token from a
    state as decode does (the step kernel), held to the plain chunked
    version within SSD_Y_ATOL and SSD_FINAL_ATOL, the prefill shape then
    timed in turns with its bound; the launches are a comparison's."""
    from repro_torch.kernels import ssd_scan as ssd
    checks = []
    for steps, with_init in ((S, False), (1, True)):
        x = torch.randn((b, steps, H, P), generator=gen, device="cuda")
        dt = 0.001 + 0.099 * torch.rand((b, steps, H), generator=gen,
                                        device="cuda")
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
        Bm, Cm = (torch.randn((b, steps, G, N), generator=gen,
                              device="cuda") for _ in range(2))
        st = (torch.randn((b, H, P, N), generator=gen, device="cuda")
              if with_init else None)
        y, final = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk_size=Q,
                                init_state=st)
        torch.cuda.synchronize()
        y_ref, final_ref = ssd.ssd_chunked_ref(x, dt, A, Bm, Cm, Q, st)
        y_err = float((y - y_ref).abs().max())
        final_err = float((final - final_ref).abs().max())
        checks.append({"shape": [b, steps, H, P, G, N, Q],
                       "init_state": with_init, "y_max_abs_err": y_err,
                       "y_atol": SSD_Y_ATOL, "final_max_abs_err": final_err,
                       "final_atol": SSD_FINAL_ATOL})
        if not (y_err <= SSD_Y_ATOL and final_err <= SSD_FINAL_ATOL
                and bool(torch.isfinite(y).all())):
            raise RuntimeError(f"ssd_scan{(b, steps, H, P, G, N, Q)} "
                               f"disagrees with its plain version: "
                               f"max|dy|={y_err}, max|dfinal|={final_err}")
        if steps == S:
            args, err = (x, dt, A, Bm, Cm), max(y_err, final_err)
    plain_a = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                      samples=5)
    kern_a = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q), inner=2,
                     samples=5)
    kern_b = time_ms(lambda: ssd.ssd_scan(*args, chunk_size=Q), inner=2,
                     samples=5)
    plain_b = time_ms(lambda: ssd.ssd_chunked_ref(*args, Q), inner=2,
                      samples=5)
    bound_ms, bound_by, nbytes, flops, _ = ssd_bound(b, S, H, P, G, N, Q)
    return {"shape": [b, S, H, P, G, N, Q], "checks": checks,
            "max_abs_err": err, "ms": min(kern_a, kern_b),
            "plain_ms": min(plain_a, plain_b), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "library_ms": None,
            "timed": "a rank's SSD layer, fp32, init_state None; median of "
                     "5 x 2 calls, best of 2"}


def rank_cache(cache, cfg, mesh):
    """This rank's copy of a whole decode cache of ``cfg`` on ``mesh``,
    as the rank's own prefill lays it out: its rows over the data axis;
    over the model axis its kv heads where they divide it (else all), of
    the self-attention cache and of ``enc_kv``, its RG-LRU channels
    (``h``, ``conv``), its SSD heads (``ssm``) and an SSD's ``conv`` as
    [its x channels | B | C] (ROADMAP C)."""
    import re
    from repro_torch.distributed import sharding as shd
    M = mesh.shape["model"]
    kinds = {**{f"b{i}": k for i, k in enumerate(cfg.block_pattern)},
             **{f"t{i}": k for i, k in enumerate(cfg.tail_pattern())}}
    di = cfg.ssm.d_inner(cfg.d_model) if cfg.ssm is not None else 0
    W = (cfg.rglru.lru_width or cfg.d_model) if cfg.rglru is not None else 0

    def one(path, t):
        leaf = re.findall(r"\['(\w+)'\]", path)[-2:]
        kind, name = kinds[leaf[0]], leaf[1]
        i0 = 1 if "['groups']" in path else 0    # enc_kv's too
        spec = [None] * t.dim()
        spec[i0] = "data"
        if name in ("k", "v") and cfg.num_kv_heads % M == 0:
            spec[i0 + 2] = "model"
        elif kind == "rec" and W % M == 0:
            spec[-1] = "model"
        elif name == "ssm" and di % M == 0:
            spec[i0 + 1] = "model"
        elif kind == "ssd" and di % M == 0:        # conv: [x | B | C]
            return torch.cat([
                shd.local_shard(t[..., :di], shd.P(*spec[:-1], "model"),
                                mesh),
                shd.local_shard(t[..., di:], shd.P(*spec), mesh)], dim=-1)
        return shd.local_shard(t, shd.P(*spec), mesh).clone()
    return shd.tree_map_with_path(one, cache)


def tp_forced_io(params, cfg, tokens, prompt: int = TP_PROMPT,
                 frames=None) -> list:
    """The one process's bf16 prefill (of an encoder-decoder's ``frames``
    too) and teacher-forced decode of ``tokens``, recorded at the
    TP_FORCED_STEPS steps: each one's position, a copy of the whole cache
    it starts from (``enc_kv`` with it), and every group's input with the
    last hidden, (G + 1, B, 1, d), through ``decode_layer_range`` a group
    at a time."""
    from repro_torch.models import transformer as tr
    _, cache = tr.prefill(params, _lm_batch(tokens[:, :prompt], frames),
                          cfg)
    cache = tr.pad_kv_caches(cache, prompt + TP_DECODE_STEPS)
    out = []
    for t in range(TP_DECODE_STEPS):
        pos = prompt + t
        token = tokens[:, pos:pos + 1]
        if t not in TP_FORCED_STEPS:
            tr.decode_step(params, token, cache, pos, cfg)
            continue
        start = _tree_map(torch.clone, cache)
        xs = [tr.embed_tokens(params, token, cfg)]
        for g in range(cfg.num_groups()):
            xs.append(tr.decode_layer_range(params, xs[-1], cache, pos, cfg,
                                            start_group=g, stop_group=g + 1))
        out.append({"step": t, "position": pos, "cache": start,
                    "inputs": torch.stack(xs)})
    return out


def tp_head(params, h, cfg, ctx=None):
    """The logits of the hidden state ``h`` (its final norm, the head, the
    vocabulary gathered over ``ctx``'s model axis)."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import apply_norm
    return tr.gather_vocab(tr.unembed(
        params, apply_norm(params["final_norm"], h), cfg, ctx), cfg, ctx)


@contextlib.contextmanager
def nudged_prompt():
    """Within the block, the embedding of a prompt (more than one token)
    has one bf16 ulp added to channel 0 of its first token, in every
    row: the smallest change to the one process's input."""
    from repro_torch.models import transformer as tr
    plain = tr.embed_tokens

    def nudged(params, tokens, *args, **kwargs):
        x = plain(params, tokens, *args, **kwargs)
        if tokens.shape[1] > 1:
            x = x.clone()
            x.view(torch.int16)[:, 0, 0] += 1
        return x
    tr.embed_tokens = nudged
    try:
        yield
    finally:
        tr.embed_tokens = plain


def tp_sum_bytes(cfg, rows: int, S: int, S_enc: int = 0) -> list:
    """The bytes of a rank's partial in each sum over the model axis that
    one pass of ``rows`` rows of ``S`` tokens (and, with ``S_enc``, the
    encoder over as many frames first) makes, where every block's heads,
    channels and ``d_ff`` are cut (as in the phases' models and meshes):
    the embedding lookup's bf16 rows, each encoder layer's two fp32
    partials at the encoder's length, then each decoder layer's fp32
    partials (``common.matmul_f32``): an attention output, with an
    encoder a cross-attention output, and an MLP's; an RG-LRU's
    ``w_out`` and its MLP's; or an SSD's gated norm's sum of squares (one
    a token) and its ``out_proj``."""
    act = rows * S * cfg.d_model
    attn = [4 * act] * (3 if cfg.encoder_layers else 2)
    each = {"attn": attn, "rec": [4 * act, 4 * act],
            "ssd": [rows * S * 4, 4 * act]}
    encoder = [4 * rows * S_enc * cfg.d_model] * (2 * cfg.encoder_layers
                                                  if S_enc else 0)
    return [2 * act] + encoder + [n for kind in cfg.pattern_for_layers()
                                  for n in each[kind]]


def _spans(marks: dict) -> dict:
    """Seconds between consecutive ``time.perf_counter`` marks, by the
    later mark's name (a dict keeps its insertion order)."""
    names, times = list(marks), list(marks.values())
    return {names[i]: times[i] - times[i - 1] for i in range(1, len(names))}


def _tp_rank(rank, world_size, cfg, params, tokens, io, forced, params32,
             cfg32, meshes, prompt=TP_PROMPT, enc=None):
    """One rank of a ``tp_phase``: for each mesh of ``meshes``, its blocks
    cut out of the parent's memory (CUDA IPC mappings of the whole tree)
    by ``reshard``, prefill and decode through the step builders
    (``tp_serve``), then each group alone on the one-process forward's
    input to it (``io``: every group's input and the last output; with an
    encoder, each encoder block alone on ``enc["io"]`` likewise, and each
    decoder group attending to the one process's ``enc["out"]``), each
    group's decode step teacher-forced at the ``forced`` steps
    (``tp_forced_io``: the one process's inputs and its cache, cut by
    ``rank_cache``), the head on the one process's last hidden, and, on
    the first mesh, the fp32 prefill of ``params32``.  Returns what it
    measured (host values); the parent checks.  The rank computes only
    from its own blocks, freed before the next mesh's."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint

    torch.cuda.set_device(0)
    kernels = ops.kernel_registry()
    positions = torch.arange(prompt, device="cuda")
    frames = enc["frames"] if enc else None
    out = {"rank": rank, "meshes": {}}
    with torch.inference_mode():
        for name, shape in meshes:
            marks = {"start": time.perf_counter()}
            mesh = Mesh(shape, ("data", "model"))
            ctx = shd.make_ctx(mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            own = checkpoint.reshard(params, shd.named(
                mesh, shd.param_specs(params, cfg, mesh)), device="cuda")
            torch.cuda.synchronize()
            marks["blocks"] = time.perf_counter()
            # the axis's process groups, and the first collective's one-time
            # costs (torch.distributed's lazy imports: ~4 s of CPU), before
            # the timed path
            coll.psum(torch.zeros(1, device="cuda"), "model", mesh=mesh)
            marks["warm_up"] = time.perf_counter()
            logits, cache, r = tp_serve(mesh, cfg, own, tokens,
                                        prompt=prompt, frames=frames)
            marks["serve"] = time.perf_counter()
            d = mesh.axis_index("data")
            rows = slice(d * (TP_BATCH // shape[0]),
                         (d + 1) * (TP_BATCH // shape[0]))
            r.update(data_index=d, model_index=mesh.axis_index("model"),
                     blocks_bytes=_nbytes(own), cache_bytes=_nbytes(cache),
                     cache_checksum=tree_checksum(cache), logits=logits,
                     finite=bool(torch.isfinite(
                         logits[..., :cfg.vocab_size].float()).all()))
            del cache

            def rel_l2(y, ref):
                ref = ref.float()
                return float((y.float() - ref).norm() / ref.norm())
            r["encoder_layer_rel_l2"] = []
            if enc:
                pos_enc = torch.arange(enc["io"].shape[2], device="cuda")
                for i in range(cfg.encoder_layers):
                    y = tr.apply_attn_block_seq(
                        _tree_map(lambda t: t[i], own["encoder"]["blocks"]),
                        enc["io"][i, rows], cfg, ctx, positions=pos_enc,
                        causal=False)[0]
                    r["encoder_layer_rel_l2"].append(
                        rel_l2(y, enc["io"][i + 1, rows]))
                    del y
            r["layer_rel_l2"] = []
            for g in range(cfg.num_groups()):
                y = tr.run_layer_range(
                    own, io[g, rows], cfg, ctx, start_group=g,
                    stop_group=g + 1, positions=positions, kernels=kernels,
                    enc_out=enc["out"][rows] if enc else None)
                r["layer_rel_l2"].append(rel_l2(y, io[g + 1, rows]))
                del y
            torch.cuda.synchronize()
            marks["layers"] = time.perf_counter()
            r["peak_memory_allocated_bytes"] = (
                torch.cuda.max_memory_allocated())
            # teacher-forced: the head at prefill, then each forced step's
            # groups and head
            G = cfg.num_groups()
            r["forced_logits"] = [
                tp_head(own, io[G, rows][:, -1:], cfg, ctx).cpu()]
            r["forced_rel_l2"] = []
            for snap in forced:
                cache = rank_cache(snap["cache"], cfg, mesh)
                xs = snap["inputs"][:, rows]
                errs = []
                for g in range(G):
                    y = tr.decode_layer_range(
                        own, xs[g], cache, snap["position"], cfg, ctx,
                        start_group=g, stop_group=g + 1)
                    errs.append(rel_l2(y, xs[g + 1]))
                r["forced_rel_l2"].append(errs)
                r["forced_logits"].append(tp_head(own, xs[G], cfg, ctx).cpu())
                del cache
            torch.cuda.synchronize()
            marks["forced"] = time.perf_counter()
            del own
            if name == meshes[0][0]:
                own32 = checkpoint.reshard(params32, shd.named(
                    mesh, shd.param_specs(params32, cfg32, mesh)),
                    device="cuda")
                prefill32, _ = dryrun.build_prefill_step(cfg32, mesh)
                r["fp32_logits"] = prefill32(own32, tp_batch(
                    mesh, tokens[:, :prompt], frames))[0].cpu()
                del own32
                marks["fp32"] = time.perf_counter()
            r["seconds"] = _spans(marks)
            out["meshes"][name] = r
    return out


def _rank_heads(cfg, shape) -> tuple:
    """(rows, query heads, kv heads, head dim) of a rank of a mesh of
    ``shape``: the kv heads its query heads read where only those are
    cut."""
    D, M = shape
    b, hq, hd = TP_BATCH // D, cfg.num_heads // M, cfg.resolved_head_dim()
    hkv = (cfg.num_kv_heads // M if cfg.num_kv_heads % M == 0
           else max(1, hq * cfg.num_kv_heads // cfg.num_heads))
    return b, hq, hkv, hd


def _attention_rank_checks(gen, cfg, name, shape) -> dict:
    """Flash and decode attention at a rank's heads of ``cfg`` on a mesh
    of ``shape`` (``_rank_heads``): ``flash_layout_check`` and
    ``tp_decode_check``."""
    b, hq, hkv, hd = _rank_heads(cfg, shape)
    window = cfg.window if cfg.attention_kind == "swa" else 0
    return {"flash_attention": flash_layout_check(
                gen, (b, TP_PROMPT, TP_PROMPT, hq, hkv, hd, True, window),
                f"{name} rank"),
            "decode_attention": tp_decode_check(gen, b, hq, hkv, hd)}


def phase_tp_qwen2(cfg, params) -> None:
    """Qwen2-7B under dense tensor parallelism on (1, 4) and (2, 2)
    (``tp_phase``), flash and decode attention first held to their plain
    versions at the ranks' shapes."""
    tp_phase("tp_qwen2", cfg, params, TP_MESHES, lambda gen, name, shape:
             _attention_rank_checks(gen, cfg, name, shape))


def phase_tp_recurrentgemma(cfg, params) -> None:
    """RecurrentGemma-9B under dense tensor parallelism on (1, 4)
    (``tp_phase``): its RG-LRU blocks by channel, the attention blocks by
    query heads.  First, at the ranks' shapes, flash (window 2048) and
    decode attention, and the RG-LRU scan at prefill and at one step."""
    W = cfg.rglru.lru_width or cfg.d_model

    def check(gen, name, shape):
        return {**_attention_rank_checks(gen, cfg, name, shape),
                "rglru_scan": rglru_rank_check(
                    gen, TP_BATCH // shape[0], TP_PROMPT, W // shape[1])}
    tp_phase("tp_recurrentgemma", cfg, params, TP_RECURRENTGEMMA_MESHES,
             check, gate_free_running=False)


def phase_tp_mamba(cfg, params) -> None:
    """Mamba-2-780M under dense tensor parallelism on (1, 4)
    (``tp_phase``): its SSD blocks by whole heads.  First, at the ranks'
    heads, the SSD scan at prefill and the step kernel at one token."""
    s = cfg.ssm

    def check(gen, name, shape):
        return {"ssd_scan": ssd_rank_check(
            gen, TP_BATCH // shape[0], TP_PROMPT,
            s.n_heads(cfg.d_model) // shape[1], s.head_dim, s.n_groups,
            s.d_state, s.chunk_size)}
    tp_phase("tp_mamba", cfg, params, TP_MAMBA_MESHES, check,
             gate_free_running=False)


def phase_tp_seamless(cfg, params) -> None:
    """seamless-m4t-medium under dense tensor parallelism on (1, 4)
    (``tp_phase``): its encoder's blocks, the decoder's self- and
    cross-attention by heads and every MLP by ``d_ff``, 2 requests of the
    frontend's 1024 frames and an ENCDEC_PROMPT-token prompt.  First, at
    the ranks' heads, flash over the encoder (non-causal), for
    cross-attention (the prompt against the frames, non-causal) and for
    the decoder's self-attention (causal), and decode attention on the
    self-attention cache and on the rank's ``enc_kv``."""
    S, S_enc = ENCDEC_PROMPT, cfg.frontend.num_positions

    def check(gen, name, shape):
        b, hq, hkv, hd = _rank_heads(cfg, shape)
        flash = {layout: flash_layout_check(
                     gen, (b, sq, skv, hq, hkv, hd, causal, 0),
                     f"{name} rank {layout}")
                 for layout, sq, skv, causal in (
                     ("encoder", S_enc, S_enc, False),
                     ("cross", S, S_enc, False), ("self", S, S, True))}
        return {**{f"flash_attention_{k}": v for k, v in flash.items()},
                "decode_attention_self": tp_decode_check(
                    gen, b, hq, hkv, hd, S + TP_DECODE_STEPS),
                "decode_attention_enc_kv": tp_decode_check(
                    gen, b, hq, hkv, hd, S_enc)}
    tp_phase("tp_seamless", cfg, params, TP_SEAMLESS_MESHES, check,
             prompt=S)


def tp_phase(phase: str, cfg, params, meshes, check_kernels,
             gate_free_running: bool = True,
             prompt: int = TP_PROMPT) -> None:
    """``cfg``'s model under dense tensor parallelism in 4 gloo ranks on
    this card, on each (data, model) mesh of ``meshes``
    (``models/transformer.py``, each rank on its ``param_specs`` blocks;
    ``check_kernels(gen, name, shape)`` first holds the path's kernels to
    their plain versions at a mesh's rank shapes, before any count is set
    to 0), TP_BATCH rows of ``prompt`` tokens (and of frames, drawn at
    the frontend's shape, where the model has an encoder).  Each rank's
    logits at prefill and every decode step are measured against the
    one-process bf16 run's (relative L2), beside the distance one bf16
    ulp added to the one process's prompt moves them
    (``nudged_prompt``), and held to TP_REL_L2 with
    ``gate_free_running``.  Teacher-forced, each group alone is held
    to the one process's (fed its input, and its encoder's output) at
    prefill and at the TP_FORCED_STEPS decode steps (fed its state too),
    each encoder block alone at prefill likewise, and the head on the
    one process's last hidden to its logits.  Every rank's logits and
    cache are held to ``tp_as_ranks`` (one process computing as the ranks
    do) to the bit, a data shard's model ranks to each other, the fp32
    first groups to one process's; the launches and the sums' and
    gathers' hops to what the path makes, each rank's memory to its
    blocks and cache, and every block sent to the ranks freed once they
    are gone.  One card time-shares the ranks: no speed-up is claimed."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import apply_norm, pdtype
    from repro_torch.train import checkpoint

    mode = tool_output(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"]).splitlines()[0].strip()
    if mode != "Default":
        raise RuntimeError(f"compute mode {mode!r}: 4 ranks cannot share "
                           f"the card (needs 'Default')")
    marks = {"start": time.perf_counter()}
    G, V, Vp = cfg.num_groups(), cfg.vocab_size, cfg.padded_vocab()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the kernels at the ranks' shapes, before any count is set to 0
    kernel_checks = {name: check_kernels(gen, name, shape)
                     for name, shape in meshes}
    marks["kernel_checks"] = time.perf_counter()
    kernels = ops.kernel_registry()
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, V, (TP_BATCH, prompt + TP_DECODE_STEPS)).astype(
            np.int32)).cuda()
    positions = torch.arange(prompt, device="cuda")
    # the one process, bf16: each encoder block's input and the last
    # output, the encoder's output, each layer's input and the last
    # output, then prefill and decode through the step builders without a
    # mesh
    enc, enc_out, frames = None, None, None
    if cfg.encoder_layers:
        f = cfg.frontend
        frames = torch.randn((TP_BATCH, f.num_positions, f.embed_dim),
                             generator=gen, device="cuda")
        es = [frames.to(pdtype(cfg))]
        pos_enc = torch.arange(frames.shape[1], device="cuda")
        for i in range(cfg.encoder_layers):
            es.append(tr.apply_attn_block_seq(
                _tree_map(lambda t: t[i], params["encoder"]["blocks"]),
                es[-1], cfg, None, positions=pos_enc, causal=False)[0])
        enc_out = apply_norm(params["encoder"]["final_norm"], es[-1])
        enc = {"frames": frames, "io": torch.stack(es), "out": enc_out}
        del es
    xs = [tr.embed_tokens(params, tokens[:, :prompt], cfg)]
    for g in range(G):
        xs.append(tr.run_layer_range(params, xs[-1], cfg, None, start_group=g,
                                     stop_group=g + 1, positions=positions,
                                     kernels=kernels, enc_out=enc_out))
    io = torch.stack(xs)
    del xs
    serve = dict(counted=False, prompt=prompt, frames=frames)
    one_logits, cache, one = tp_serve(None, cfg, params, tokens, **serve)
    del cache
    with nudged_prompt():
        nudged, cache, _ = tp_serve(None, cfg, params, tokens, **serve)
    del cache
    nudge = [_rel_l2(nudged[t], one_logits[t], V)
             for t in range(1 + TP_DECODE_STEPS)]
    # the same decode a group at a time, the forced steps recorded; its
    # head must give the one process's logits to the bit
    forced = tp_forced_io(params, cfg, tokens, prompt, frames)
    forced_same = all(torch.equal(
        tp_head(params, f["inputs"][G], cfg).cpu(),
        one_logits[1 + f["step"]]) for f in forced)
    marks["one_process"] = time.perf_counter()
    # the same, each rank a thread of this process on its own blocks
    as_ranks = {}
    for name, shape in meshes:
        def rank_serve(mesh):
            own = checkpoint.reshard(params, shd.named(
                mesh, shd.param_specs(params, cfg, mesh)), device="cuda")
            logits, cache, _ = tp_serve(mesh, cfg, own, tokens, **serve)
            return logits, tree_checksum(cache)
        as_ranks[name] = tp_as_ranks(rank_serve, shape)
        gc.collect()
        torch.cuda.empty_cache()
        marks[f"as_ranks_{name}"] = time.perf_counter()
    # the first groups in fp32 (no tail), and one process's prefill of them
    n32 = min(TP_FP32_GROUPS, G)
    cfg32 = dataclasses.replace(
        cfg, num_layers=n32 * len(cfg.block_pattern), param_dtype="float32")
    # copies, the leaves already in fp32 too (the ranks map this tree)
    params32 = _tree_map(lambda t: t.to(torch.float32, copy=True), {
        **{k: v for k, v in params.items() if k != "tail"},
        "blocks": _tree_map(lambda t: t[:n32], params["blocks"])})
    want32 = tr.prefill(params32, _lm_batch(tokens[:, :prompt], frames),
                        cfg32)[0].cpu()
    marks["fp32"] = time.perf_counter()
    # each mesh's blocks, by arithmetic on the specs (rank 0's views)
    blocks = {}
    for name, shape in meshes:
        mesh = Mesh(shape, ("data", "model"))
        blocks[name] = sum(
            shd.local_shard(t, s, mesh, rank=0).numel() * t.element_size()
            for t, s in zip(_leaves(params), _leaves(
                shd.param_specs(params, cfg, mesh))))
    # what the ranks map (the parameters apart, freed by main)
    sent = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in (tokens, io, *_leaves(params32), *_leaves(enc or {}),
                      *(t for f in forced
                        for t in (f["inputs"], *_leaves(f["cache"]))))}
    gc.collect()
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()

    marks["sent"] = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ranks = run_world(_tp_rank, 4,
                          (cfg, params, tokens, io, forced, params32, cfg32,
                           meshes, prompt, enc),
                          workdir=workdir, timeout=TP_TIMEOUT_S)
    marks["world"] = time.perf_counter()
    del tokens, io, forced, params32, enc, enc_out, frames, serve
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.synchronize()
    freed = allocated_before - torch.cuda.memory_allocated()
    # each block sent, by its address: the caching allocator's own record
    # (the total allocated moves with anything else the process holds)
    held = {b["address"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] != "inactive"}
    kept = {ptr: n for ptr, n in sent.items() if ptr in held}

    failed, per_mesh = [], {}
    S_enc = cfg.frontend.num_positions if cfg.encoder_layers else 0
    if not forced_same:
        failed.append("the group-at-a-time decode's logits are not the one "
                      "process's")
    if kept:
        failed.append(f"blocks of {sorted(kept.values())} B sent to the ranks "
                      f"still allocated after the world: a rank kept a "
                      f"block it mapped")
    for name, (D, M) in meshes:
        rs = [r["meshes"][name] for r in ranks]
        rows = TP_BATCH // D
        # each sum: the rank's partial sent to the M - 1 others
        sums = {"prefill": tp_sum_bytes(cfg, rows, prompt, S_enc),
                "decode": tp_sum_bytes(cfg, rows, 1)}
        gather_hop = rows * (Vp // M) * 2
        want_hops = {
            "prefill_psum": (len(sums["prefill"]) * (M - 1),
                             sum(sums["prefill"]) * (M - 1)),
            "prefill_gather": (M - 1, (M - 1) * gather_hop),
            "psum": ((len(sums["prefill"])
                      + TP_DECODE_STEPS * len(sums["decode"])) * (M - 1),
                     (sum(sums["prefill"])
                      + TP_DECODE_STEPS * sum(sums["decode"])) * (M - 1)),
            "gather": ((M - 1) * (1 + TP_DECODE_STEPS),
                       (M - 1) * (1 + TP_DECODE_STEPS) * gather_hop)}
        for i, r in enumerate(rs):
            dd = r["data_index"]
            ref = one_logits[:, dd * rows:(dd + 1) * rows]
            r["rel_l2"] = [_rel_l2(r["logits"][t], ref[t], V)
                           for t in range(1 + TP_DECODE_STEPS)]
            first = next(s for s in rs if s["data_index"] == dd)
            emulated_logits, emulated_cache = as_ranks[name][i]
            r["forced_logits_rel_l2"] = [
                _rel_l2(lg, ref[t], V) for lg, t in zip(
                    r["forced_logits"], (0,) + tuple(
                        1 + step for step in TP_FORCED_STEPS))]
            forced_max = max(max(e) for e in r["forced_rel_l2"])
            checks = [
                ("non-finite logits", r["finite"]),
                ("logits not bit-equal to the one process computing as the "
                 "ranks", torch.equal(r["logits"], emulated_logits)),
                ("cache not bit-equal to the one process computing as the "
                 "ranks", r["cache_checksum"] == emulated_cache),
                ("logits not bit-equal to the data shard's first rank's",
                 torch.equal(r["logits"], first["logits"])),
                (f"rel L2 {max(r['rel_l2'])} > {TP_REL_L2}",
                 max(r["rel_l2"]) <= TP_REL_L2 or not gate_free_running),
                (f"a layer's rel L2 {max(r['layer_rel_l2'])} > "
                 f"{TP_LAYER_REL_L2}",
                 max(r["layer_rel_l2"]) <= TP_LAYER_REL_L2),
                (f"an encoder layer's rel L2 "
                 f"{max(r['encoder_layer_rel_l2'], default=0.0)} > "
                 f"{TP_LAYER_REL_L2}",
                 max(r["encoder_layer_rel_l2"], default=0.0)
                 <= TP_LAYER_REL_L2),
                (f"a teacher-forced decode group's rel L2 {forced_max} > "
                 f"{TP_LAYER_REL_L2}", forced_max <= TP_LAYER_REL_L2),
                (f"teacher-forced logits' rel L2 "
                 f"{max(r['forced_logits_rel_l2'])} > {TP_REL_L2}",
                 max(r["forced_logits_rel_l2"]) <= TP_REL_L2),
                (f"prefill launched {r['prefill_launches']}",
                 r["prefill_launches"] == _prefill_launches(cfg)),
                (f"decode launched {r['decode_launches']}",
                 r["decode_launches"]
                 == _decode_step_launches(cfg, TP_DECODE_STEPS)),
                (f"blocks of {r['blocks_bytes']} B, not {blocks[name]}",
                 r["blocks_bytes"] == blocks[name]),
                (f"peak {r['peak_memory_allocated_bytes']} B over its "
                 f"blocks, cache and {PIPE_RANK_MARGIN_BYTES}",
                 r["peak_memory_allocated_bytes"] < blocks[name]
                 + r["cache_bytes"] + PIPE_RANK_MARGIN_BYTES)]
            checks += [(f"{key} {r[key]}, not (hops, bytes) {want}",
                        (r[key]["hops"], r[key]["bytes"]) == want)
                       for key, want in want_hops.items()]
            if "fp32_logits" in r:
                r["fp32_rel_l2"] = _rel_l2(
                    r["fp32_logits"], want32[dd * rows:(dd + 1) * rows], V)
                checks.append((f"fp32 rel L2 {r['fp32_rel_l2']} > "
                               f"{TP_FP32_REL_L2}",
                               r["fp32_rel_l2"] <= TP_FP32_REL_L2))
            failed += [f"{name}, rank {i}: {what}"
                       for what, ok in checks if not ok]

        def rate(r, key):
            return r[key]["bytes"] / max(r[key]["transfer_seconds"]
                                         + r[key]["host_copy_seconds"], 1e-9)
        per_mesh[name] = {
            "mesh": [D, M], "blocks_bytes": blocks[name],
            "rel_l2_max": max(max(r["rel_l2"]) for r in rs),
            "layer_rel_l2_max": max(max(r["layer_rel_l2"]) for r in rs),
            "encoder_layer_rel_l2_max": max(
                max(r["encoder_layer_rel_l2"], default=0.0) for r in rs),
            "forced_rel_l2_max": max(max(max(e) for e in r["forced_rel_l2"])
                                     for r in rs),
            "forced_logits_rel_l2_max": max(max(r["forced_logits_rel_l2"])
                                            for r in rs),
            "fp32_rel_l2": [r.get("fp32_rel_l2") for r in rs],
            "prefill_seconds": [r["prefill_seconds"] for r in rs],
            "step_seconds_median": [statistics.median(r["step_seconds"])
                                    for r in rs],
            "psum_gb_per_s": [rate(r, "psum") / 1e9 for r in rs],
            "expected_hops": want_hops,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("logits", "fp32_logits", "step_seconds",
                                    "forced_logits")}
                      for r in rs]}
    emit(phase, config=cfg.name, batch=TP_BATCH, prompt=prompt,
         frames=S_enc, encoder_layers=cfg.encoder_layers,
         decode_steps=TP_DECODE_STEPS, groups=G, backend="gloo",
         compute_mode=mode, kernel_checks=kernel_checks,
         one_process={"prefill_seconds": one["prefill_seconds"],
                      "step_seconds_median": statistics.median(
                          one["step_seconds"])},
         limit_rel_l2=TP_REL_L2, limit_layer_rel_l2=TP_LAYER_REL_L2,
         limit_fp32_rel_l2=TP_FP32_REL_L2, model_bytes=_nbytes(params),
         free_running_gated=gate_free_running, one_ulp_nudge_rel_l2=nudge,
         forced_steps=TP_FORCED_STEPS,
         rank_margin_bytes=PIPE_RANK_MARGIN_BYTES,
         world_seconds=marks["world"] - marks["sent"],
         sent_bytes=sum(sent.values()), freed_after_world_bytes=freed,
         sent_blocks=len(sent), sent_blocks_still_allocated=len(kept),
         meshes=per_mesh, failed=failed, spans=_spans(marks),
         seconds=time.perf_counter() - marks["start"])
    if failed:
        raise RuntimeError(f"{phase}: " + "; ".join(failed))


class record_routing:
    """Within the block, every ``apply_moe`` call first records what its
    router does with the layer's input: ``moe.routing_stats`` (host
    values), or with ``detail`` each token's routing (see
    ``routing_of``)."""

    def __init__(self, detail: bool = False):
        self.detail = detail
        self.layers = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._apply = moe, moe.apply_moe

        def apply(p, x, cfg, ctx=moe.LOCAL_CTX):
            self.layers.append(routing_of(p, x, cfg) if self.detail
                               else moe.routing_stats(p, x, cfg))
            return self._apply(p, x, cfg, ctx)
        moe.apply_moe = apply
        return self

    def __exit__(self, *exc):
        self._moe.apply_moe = self._apply
        return False


def routing_of(p, x, cfg) -> dict:
    """Each token's routing at ``cfg``'s capacity as an (E,) code (0: not
    routed there, 1: routed and kept, 2: routed and dropped), and the gap
    between its k-th and (k+1)-th router probability."""
    from repro_torch.models import moe
    m = cfg.moe
    x2d = x.reshape(-1, x.shape[-1])
    T = x2d.shape[0]
    _, ids, _ = moe._route(x2d, p["router"], m.top_k)
    cap = moe._capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    _, keep, _ = moe._slots(ids, cap, 0, m.num_experts)
    code = torch.zeros((T, m.num_experts), dtype=torch.int8,
                       device=x.device)
    code.scatter_(1, ids, 2 - keep.view(T, -1).to(torch.int8))
    probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
    top = torch.topk(probs, m.top_k + 1, dim=-1).values
    return {"code": code, "gap": top[:, -2] - top[:, -1], "capacity": cap}


def moe_layer_check(cfg, params, tokens) -> list:
    """Groups [0, MOE_FP32_GROUPS) in fp32 on request 0's first
    MOE_FP32_SEQ tokens, each layer run through the flash kernel and
    through its plain version on the same input (the plain run's output
    of the layer before).  Routing flips (the set of experts differs) are
    counted and allowed only below MOE_FLIP_GAP; tokens whose routing
    differs only in what the capacity dropped (a flip earlier in an
    expert's queue) are counted too; the other tokens' outputs are held
    to MOE_LAYER_REL_L2."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    kernels = ops.kernel_registry()
    toks = tokens[:1, :MOE_FP32_SEQ]
    x = tr.embed_inputs(params, {"tokens": toks}, cfg).float()
    pos = torch.arange(MOE_FP32_SEQ, device=x.device)
    layers = []
    for g in range(MOE_FP32_GROUPS):
        p32 = _tree_map(lambda t: t[g].float(), params["blocks"]["b0"])
        runs = {}
        for name, plain in (("kernel", ()), ("plain", ("flash_attention",))):
            counts = launch_counts()
            with record_routing(detail=True) as rec, plain_versions(*plain):
                y, _, _ = tr.apply_block_seq("attn", p32, x, cfg,
                                             moe.LOCAL_CTX, positions=pos,
                                             kernels=kernels)
            launched = launches_since(counts)["flash_attention"]
            if launched != (0 if plain else 1):
                raise RuntimeError(f"layer {g}, {name} run: flash launched "
                                   f"{launched} times")
            runs[name] = (y[0], rec.layers[0])
        (yk, rk), (yp, rp) = runs["kernel"], runs["plain"]
        flip = ((rk["code"] > 0) != (rp["code"] > 0)).any(-1)
        knock_on = ~flip & (rk["code"] != rp["code"]).any(-1)
        agree = ~flip & ~knock_on
        gaps = rp["gap"][flip]
        worst = float(gaps.max()) if gaps.numel() else None
        diff = yk[agree] - yp[agree]
        rel = float(diff.norm() / yp[agree].norm())
        layers.append({
            "group": g, "tokens": MOE_FP32_SEQ, "capacity": rp["capacity"],
            "routing_flips": int(flip.sum()), "knock_on": int(knock_on.sum()),
            "agreed": int(agree.sum()), "max_flip_gap": worst,
            "drop_share_plain": float((rp["code"] == 2).sum()
                                      / (rp["code"] > 0).sum()),
            "rel_l2_agreed": rel,
            "max_abs_err_agreed": float(diff.abs().max())})
        if worst is not None and worst >= MOE_FLIP_GAP:
            raise RuntimeError(f"layer {g}: a token routed to other experts "
                               f"through the kernel where the plain run's "
                               f"k-th probability leads by {worst} >= "
                               f"{MOE_FLIP_GAP}")
        if not rel <= MOE_LAYER_REL_L2:
            raise RuntimeError(f"layer {g}: fp32 kernels vs plain versions "
                               f"on the tokens whose routing agreed: "
                               f"relative L2 {rel} > {MOE_LAYER_REL_L2}")
        x = yp[None]
    return layers


def flash_mha_entry(cfg, gen) -> dict:
    """The flash kernel at OLMoE-1B-7B's prefill layout (MHA: 16 heads of
    128 on 16 kv heads, 4 x 4096 tokens, causal), bf16: held to its plain
    version, then timed beside it and SDPA, with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = LM_BATCH, LM_SEQ, cfg.num_heads, cfg.resolved_head_dim()

    def n():
        return torch.randn((B * H, S, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
    q, k, v = n(), n(), n()

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=True, window=0)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=True, window=0)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, H, S, D), k.view(B, H, S, D), v.view(B, H, S, D),
            is_causal=True)
    o, want = run_kernel(), run_plain()
    atol, rtol = FLASH_TOL[torch.bfloat16]
    err = float((o.float() - want.float()).abs().max())
    if not _within(o, want, atol, rtol) or not bool(torch.isfinite(o).all()):
        raise RuntimeError(f"flash_attention at the MHA layout disagrees with "
                           f"its plain version: max|d|={err}")
    lib_err = float((run_library().reshape(o.shape).float()
                     - want.float()).abs().max())
    del o, want
    times = time_in_turns(run_kernel, run_plain, run_library)
    bound_ms, bound_by, _, _ = flash_bound(B, H, H, S, S, D, True, 0,
                                          q.element_size())
    return {"shape": [B, S, S, H, H, D, True, 0], "dtype": "bfloat16",
            "max_abs_err": err, "atol": atol, "rtol": rtol, **times,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_call": "F.scaled_dot_product_attention(is_causal=True)",
            "library_max_abs_err_vs_plain": lib_err,
            "timed": "one OLMoE-1B-7B prefill attention layer at batch 4, "
                     "bf16; kernel and SDPA median of 5 x 2 calls, plain "
                     "version of 3 x 1; best of 2"}


def phase_moe_serve():
    """OLMoE-1B-7B at full width through the layer split: see the
    module's docstring."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    mha = flash_mha_entry(get_config(MOE_ARCH),
                          torch.Generator(device="cuda").manual_seed(SEED))
    cfg, params, info = init_full_width(MOE_ARCH, MOE_PARAMETERS,
                                        MOE_PARAMETER_BYTES)
    G = cfg.num_groups()
    if (cfg.block_pattern != ("attn",) or cfg.tail_pattern()
            or cfg.num_heads != cfg.num_kv_heads):
        raise RuntimeError(f"{MOE_ARCH}: expected {G} MHA attention layers, "
                           "no tail")
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)
    plan = ((MOE_SPLIT, tokens), (0, tokens[:1]), (G, tokens[:1]))
    cloud, device, logits, record = serve_plan(cfg, params, plan)
    flash = record["launches"]["flash_attention"]
    if not flash or flash != G * record["whole_forwards"]:
        raise RuntimeError(f"layer-split path launched {record['launches']}, "
                           f"not one flash launch an attention layer")

    # one machine, same batches, same kernels: the served batch (whose
    # 16384 tokens set the capacity of the g = 8 split) with the router's
    # choices recorded layer by layer, and request 0 alone (the g = 0 and
    # g = G splits)
    kernels = ops.kernel_registry()
    batch = torch.from_numpy(tokens).cuda()
    counts = launch_counts()
    with record_routing() as rec:
        hidden, aux, _ = tr.forward_hidden(params, {"tokens": batch}, cfg,
                                           kernels=kernels)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    hidden, _, _ = tr.forward_hidden(params, {"tokens": batch[:1]}, cfg,
                                     kernels=kernels)
    want0 = tr.unembed(params, hidden[:, -1:], cfg)
    del hidden
    torch.cuda.synchronize()
    if launches_since(counts)["flash_attention"] != 2 * G:
        raise RuntimeError(f"one-machine forwards launched "
                           f"{launches_since(counts)}")
    for split in record["splits"]:
        g = split["group"]
        target = want if g == MOE_SPLIT else want0
        err = float((logits[g].float() - target.float()).abs().max())
        split.update(logit_max_abs_err=err, compared_with=(
            f"forward_hidden + unembed of the same {split['batch']} "
            "request(s)"))
        if not bool(torch.isfinite(logits[g]).all()):
            raise RuntimeError(f"g={g}: non-finite logits")
        if not _within(logits[g], target, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
            raise RuntimeError(f"g={g}: split logits differ from the "
                               f"one-machine forward by {err}")
    aux_sums = {"load_balance": float(aux[0]), "router_z": float(aux[1])}
    for i, name in enumerate(aux_sums):
        layer_sum = sum(lay[name] for lay in rec.layers)
        if not math.isclose(layer_sum, aux_sums[name], rel_tol=1e-4):
            raise RuntimeError(f"aux {name}: forward_hidden summed "
                               f"{aux_sums[name]}, the layers {layer_sum}")
    routing = [{k: lay[k] for k in ("capacity", "drop_share",
                                    "max_load_over_mean")}
               for lay in rec.layers]
    dropped = sum(lay["dropped"] for lay in rec.layers)
    choices = sum(lay["choices"] for lay in rec.layers)

    # one more g = MOE_SPLIT round through the warm engines, traced; the
    # moe scopes of models/moe.py split the MoE layers' device time
    prof = profile_split(cloud, device, tokens, MOE_SPLIT)
    scope = prof["by_scope"]
    attention = prof["by_class"].get("flash_attention", 0.0)
    prof["classes"] = {
        "moe_dispatch_and_gather": scope["moe_dispatch"],
        "moe_expert_products": scope["moe_experts"],
        "attention_kernels": attention,
        "rest": prof["device_seconds"] - scope["moe_dispatch"]
        - scope["moe_experts"] - attention}
    if not (scope["moe_dispatch"] > 0 and scope["moe_experts"] > 0):
        raise RuntimeError(f"the trace shows no device time in the moe "
                           f"scopes: {scope}")
    del cloud, device
    layer_check = moe_layer_check(cfg, params, batch)
    torch.cuda.empty_cache()
    emit("moe_serve", **info, batch=LM_BATCH, seq=LM_SEQ, groups=G,
         heads=[cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()],
         experts=[cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff],
         capacity_factor=cfg.moe.capacity_factor, **record,
         aux_sums=aux_sums, routing_per_layer=routing,
         drop_share=dropped / choices, flash_mha=mha, profile=prof,
         fp32_layer_check=layer_check, limit_flip_gap=MOE_FLIP_GAP,
         limit_layer_rel_l2=MOE_LAYER_REL_L2)
    return cfg, params, tokens


def phase_moe_decode(cfg, params, prompts) -> None:
    """The served batch's 4 prompts prefilled through flash and decoded
    MOE_DECODE_STEPS teacher-forced steps through decode attention at the
    published capacity factor (timed; then decoded again through the same
    cache with the routing recorded: the drops at 4 tokens a step); the
    decode kernel held to its plain version on that cache and timed; then
    request 0 at capacity factor MOE_CHECK_FACTOR through
    ``phase_model_decode`` (bf16 and fp32 decode against the one-machine
    forward at the same factor), which prints the line."""
    from repro_torch.kernels import decode_attention as dec
    extra = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (LM_BATCH, MOE_DECODE_STEPS)).astype(np.int32)
    tokens = torch.from_numpy(np.concatenate([prompts, extra],
                                             axis=1)).cuda()
    rows = LM_SEQ + MOE_DECODE_STEPS
    torch.cuda.reset_peak_memory_stats()
    logits, cache, record = prefill_decode(params, cfg, tokens, LM_SEQ,
                                           MOE_DECODE_STEPS)
    record["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise RuntimeError("non-finite decode logits")
    hd = cfg.resolved_head_dim()
    record["cache_bytes"] = _nbytes(cache)
    want_bytes = 2 * cfg.num_layers * LM_BATCH * rows * cfg.num_kv_heads \
        * hd * 2
    if record["cache_bytes"] != want_bytes:
        raise RuntimeError(f"the cache holds {record['cache_bytes']} B, "
                           f"expected {want_bytes} B")
    with record_routing() as rec:
        decode_steps(params, cfg, tokens, cache, LM_SEQ, MOE_DECODE_STEPS)
    dropped = sum(lay["dropped"] for lay in rec.layers)
    choices = sum(lay["choices"] for lay in rec.layers)
    record["routing"] = {
        "capacity": sorted({lay["capacity"] for lay in rec.layers}),
        "choices": choices, "dropped": dropped,
        "drop_share": dropped / choices,
        "max_load_over_mean_median": statistics.median(
            lay["max_load_over_mean"] for lay in rec.layers)}

    # the decode kernel at this layout (MHA) on layer 0's cache, every
    # sequence at its last step's length
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k, v = cache["groups"]["b0"]["k"][0], cache["groups"]["b0"]["v"][0]
    q = torch.randn((LM_BATCH, cfg.num_heads, hd), generator=gen,
                    device="cuda").bfloat16()
    lens = torch.full((LM_BATCH,), rows, dtype=torch.int32, device="cuda")
    got = dec.decode_attention(q, k, v, lens)
    want = dec.decode_attention_ref(q, k, v, lens)
    atol, rtol = DECODE_TOL[torch.bfloat16]
    err = float((got.float() - want.float()).abs().max())
    if not _within(got, want, atol, rtol):
        raise RuntimeError(f"decode_attention at the MHA layout disagrees "
                           f"with its plain version: max|d|={err}")
    kernel = {"shape": [LM_BATCH, rows, cfg.num_heads, cfg.num_kv_heads, hd],
              "dtype": "bfloat16", "max_abs_err": err, "atol": atol,
              "rtol": rtol, **time_decode(q, k, v, lens)}
    del cache, k, v
    torch.cuda.empty_cache()
    cfg16 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CHECK_FACTOR))
    phase_model_decode("moe_decode", cfg16, params, prompts,
                       served=record, decode_attention_mha=kernel,
                       check_capacity_factor=MOE_CHECK_FACTOR)


class moe_recorder:
    """Within the block, what every ``apply_moe`` call does: the keep mask
    of its first dispatch (``keeps``, on the host), each call's router
    choices (``ids``, on the device), its aux losses from its own router
    (``local_aux``) and as returned (``aux``), as host floats."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe = moe
        self._plain = moe._slots, moe._route, moe.apply_moe
        slots, route, apply = self._plain
        self.keeps, self.ids, self.local_aux, self.aux = [], [], [], []

        def recorded_slots(*args):
            out = slots(*args)
            if not self.keeps:
                self.keeps.append(out[1].cpu())
            return out

        def recorded_route(*args):
            out = route(*args)
            self.ids.append(out[1])
            self.local_aux.append([float(v) for v in out[2].values()])
            return out

        def recorded_apply(*args, **kwargs):
            y, aux = apply(*args, **kwargs)
            self.aux.append([float(v) for v in aux.values()])
            return y, aux
        moe._slots, moe._route, moe.apply_moe = (
            recorded_slots, recorded_route, recorded_apply)
        return self

    def __exit__(self, *exc):
        self._moe._slots, self._moe._route, self._moe.apply_moe = self._plain
        return False


@contextlib.contextmanager
def moe_as_ranks(model_size: int):
    """Within the block, ``apply_moe`` computes in this one process what
    ``model_size`` ranks of the model axis compute: each rank's partial
    output from its contiguous block (as ``reshard`` cuts it) in the
    config's mode, the partials summed in fp32 and rounded once (as
    ``moe._psum``).  A yardstick for the sharded forward: it carries the
    ranks' rounding without the collectives."""
    from repro_torch.models import moe
    plain = moe.apply_moe

    def apply(p, x, cfg, ctx=moe.LOCAL_CTX):
        m, (B, S, d) = cfg.moe, x.shape
        x2d = x.reshape(B * S, d)
        gates, ids, aux = moe._route(x2d, p["router"], m.top_k)
        cap = moe._capacity(B * S, m.top_k, m.num_experts,
                            m.capacity_factor)
        total = None
        for r in range(model_size):
            if m.partitioning == "ep":
                n = m.num_experts // model_size
                block = {k: v if k == "router" else
                         v[r * n:(r + 1) * n].contiguous()
                         for k, v in p.items()}
                part = moe._dispatch_compute_combine(
                    block, x2d, gates, ids, cap, cfg.activation,
                    expert_offset=r * n, n_local_experts=n)
            else:
                f = m.d_ff // model_size
                block = {k: v if k == "router" else
                         (v[:, r * f:(r + 1) * f] if k == "w_down"
                          else v[..., r * f:(r + 1) * f]).contiguous()
                         for k, v in p.items()}
                part = moe._dispatch_compute_combine(
                    block, x2d, gates, ids, cap, cfg.activation)
            total = part.float() if total is None else total + part.float()
        return total.to(x.dtype).reshape(B, S, d), aux
    moe.apply_moe = apply
    try:
        yield
    finally:
        moe.apply_moe = plain


def _moe_sharded_rank(rank, world_size, cfg, params, tokens, layer_io, ids,
                      as_ranks, x32, want32):
    """One rank of ``moe_sharded``: for each mesh of MOE_SHARDED, its
    blocks cut out of the parent's memory (CUDA IPC mappings of the whole
    tree) by ``reshard``, then the bf16 forward twice (cold, recorded;
    warm, timed, its sums counted), each layer alone on the one-process
    forward's input to it (``layer_io``: (data shards, G + 1, ...), the
    inputs and the last output; ``ids``: that forward's router choices)
    and, on a (1, 4) mesh, one fp32 MoE layer.  Returns what it measured
    (host values); the parent checks.  The rank computes only from its
    own blocks, freed before the next mesh's."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint

    torch.cuda.set_device(0)
    kernels = ops.kernel_registry()
    out = {"rank": rank, "meshes": {}}

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    with torch.inference_mode():
        for name, shape, mode in MOE_SHARDED:
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, partitioning=mode))
            mesh = Mesh(shape, ("data", "model"))
            ctx = shd.make_ctx(mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            own = checkpoint.reshard(params, shd.named(
                mesh, shd.moe_only_specs(params, c, mesh)), device="cuda")
            torch.cuda.synchronize()
            toks = shd.local_shard(tokens, shd.P(ctx.data_axes, None), mesh)
            positions = torch.arange(toks.shape[1], device="cuda")

            def forward():
                return tr.run_layer_range(
                    own, tr.embed_tokens(own, toks, c), c, ctx,
                    start_group=0, stop_group=c.num_groups(),
                    positions=positions, kernels=kernels)

            fa.launch_count = 0
            with moe_recorder() as rec:
                y, cold_s = timed(forward)
            flash = fa.launch_count
            stats = coll.HopStats()
            with coll.counting(stats):
                warm, warm_s = timed(forward)
            d = mesh.axis_index("data")
            io = layer_io[name][d]
            ref = io[-1].float()
            diff = y.float() - ref
            emulated = as_ranks[name][d]
            r = {"data_index": d, "model_index": mesh.axis_index("model"),
                 "equal_one_process_as_ranks": torch.equal(y, emulated),
                 "rel_l2_one_process_as_ranks": float(
                     (y.float() - emulated.float()).norm()
                     / emulated.float().norm()),
                 "blocks_bytes": _nbytes(own), "flash_launches": flash,
                 "cold_seconds": cold_s, "warm_seconds": warm_s,
                 "warm_equal_cold": torch.equal(warm, y),
                 "finite": bool(torch.isfinite(y).all()),
                 "rel_l2": float(diff.norm() / ref.norm()),
                 "max_abs_err": float(diff.abs().max()),
                 "psum": dataclasses.asdict(stats),
                 "keep0": np.packbits(rec.keeps[0].numpy()),
                 "local_aux": rec.local_aux, "aux": rec.aux}
            del y, warm, diff, ref
            # each layer on the one process's input to it: the same routes,
            # and the output as far from the one process's as the ranks'
            # rounding alone puts it
            r["layer_rel_l2"], r["layer_routing_equal"] = [], []
            for g in range(c.num_groups()):
                with moe_recorder() as lrec:
                    yg = tr.run_layer_range(
                        own, io[g], c, ctx, start_group=g, stop_group=g + 1,
                        positions=positions, kernels=kernels)
                ref_g = io[g + 1].float()
                r["layer_rel_l2"].append(float((yg.float() - ref_g).norm()
                                               / ref_g.norm()))
                r["layer_routing_equal"].append(
                    torch.equal(lrec.ids[0], ids[name][d][g]))
                del yg, ref_g
            if shape[0] == 1:
                p32 = _tree_map(lambda t: t[0].float(),
                                own["blocks"]["b0"]["moe"])
                y32, _ = moe.apply_moe(p32, x32, c, ctx)
                r["fp32_rel_l2"] = float((y32 - want32).norm()
                                         / want32.norm())
                del p32, y32
            torch.cuda.synchronize()
            r["peak_memory_allocated_bytes"] = (
                torch.cuda.max_memory_allocated())
            del own
            out["meshes"][name] = r
    return out


def phase_moe_sharded(cfg, params) -> None:
    """``moe_sharded`` on tokens drawn from SEED + 4; raises if a check
    failed."""
    failed = moe_sharded(cfg, params, SEED + 4)
    if failed:
        raise RuntimeError("moe_sharded: " + "; ".join(failed))


def moe_sharded(cfg, params, token_seed: int) -> list:
    """OLMoE-1B-7B's MoE layers over a mesh of 4 gloo ranks on this card
    (``models/moe.py``'s ``ep`` and ``tp``), flash first held to its
    plain version at the ranks' shapes.  Each rank's forward is held to
    the one-process forward of its data shard's tokens (bf16, relative
    L2), and each layer alone, fed the one process's input to it, to that
    layer's output there (the routing to the bit, a relative L2); to the
    bit, to the one process computing each MoE layer as the ranks do
    (``moe_as_ranks``); layer 0's keep masks to the one process's to the
    bit, one fp32 layer to ``apply_moe`` on one device, every rank's aux
    to data shard 0's, each rank's memory to its blocks, and every block
    sent to the ranks freed once they are gone; the sums over the model
    axis counted and timed.  Prints the phase's line; returns the checks
    that failed."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    mode = tool_output(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"]).splitlines()[0].strip()
    if mode != "Default":
        raise RuntimeError(f"compute mode {mode!r}: 4 ranks cannot share "
                           f"the card (needs 'Default')")
    t_phase = time.perf_counter()
    G, T = cfg.num_groups(), MOE_SHARDED_BATCH * MOE_SHARDED_SEQ
    # the ranks' attention shapes: the whole batch on (1, 4), a row on (2, 2)
    flash_checks = [pipeline_flash_check(cfg, b, MOE_SHARDED_SEQ)
                    for b in sorted({MOE_SHARDED_BATCH // D
                                     for _, (D, _), _ in MOE_SHARDED})]
    kernels = ops.kernel_registry()
    tokens = torch.from_numpy(np.random.default_rng(token_seed).integers(
        0, cfg.vocab_size, (MOE_SHARDED_BATCH, MOE_SHARDED_SEQ)).astype(
            np.int32)).cuda()
    positions = torch.arange(MOE_SHARDED_SEQ, device="cuda")

    def one_process(toks):
        """Layer by layer: (each layer's input and the last output,
        stacked; each layer's router choices, stacked; the recorder)."""
        fa.launch_count = 0
        xs = [tr.embed_tokens(params, toks, cfg)]
        with moe_recorder() as rec:
            for g in range(G):
                xs.append(tr.run_layer_range(
                    params, xs[-1], cfg, moe.LOCAL_CTX, start_group=g,
                    stop_group=g + 1, positions=positions, kernels=kernels))
        if fa.launch_count != G:
            raise RuntimeError(f"the one-process forward launched flash "
                               f"{fa.launch_count} times, not {G}")
        return torch.stack(xs), torch.stack(rec.ids), rec

    whole_io, whole_ids, whole_rec = one_process(tokens)
    whole = whole_io[G]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tr.run_layer_range(
        params, tr.embed_tokens(params, tokens, cfg), cfg, moe.LOCAL_CTX,
        start_group=0, stop_group=G, positions=positions, kernels=kernels)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if not torch.equal(again, whole):
        raise RuntimeError("the one-process forward layer by layer and "
                           "over the whole range differ")
    del again
    shards = [one_process(tokens[d:d + 1]) for d in range(2)]
    layer_io = {"ep_1x4": whole_io[None], "tp_1x4": whole_io[None],
                "ep_2x2": torch.stack([io for io, _, _ in shards])}
    ids = {"ep_1x4": whole_ids[None], "tp_1x4": whole_ids[None],
           "ep_2x2": torch.stack([i for _, i, _ in shards])}
    want = {name: io[:, G] for name, io in layer_io.items()}
    # the same forwards with each MoE layer computed as the ranks compute
    # it (moe_as_ranks), and how far that rounding alone moves them
    as_ranks, as_ranks_rel_l2 = {}, {}
    for name, (D, M), mode_ in MOE_SHARDED:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, partitioning=mode_))
        with moe_as_ranks(M):
            as_ranks[name] = torch.stack([tr.run_layer_range(
                params, tr.embed_tokens(params, tokens[
                    d * (MOE_SHARDED_BATCH // D):
                    (d + 1) * (MOE_SHARDED_BATCH // D)], c), c,
                moe.LOCAL_CTX, start_group=0, stop_group=G,
                positions=positions, kernels=kernels) for d in range(D)])
        as_ranks_rel_l2[name] = float(
            (as_ranks[name].float() - want[name].float()).norm()
            / want[name].float().norm())
    want_keeps = {"ep_1x4": [whole_rec.keeps[0]],
                  "tp_1x4": [whole_rec.keeps[0]],
                  "ep_2x2": [rec.keeps[0] for _, _, rec in shards]}
    want_aux0 = {"ep_1x4": whole_rec.local_aux[0],
                 "tp_1x4": whole_rec.local_aux[0],
                 "ep_2x2": shards[0][2].local_aux[0]}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x32 = torch.randn((1, MOE_SHARDED_SEQ, cfg.d_model), generator=gen,
                      device="cuda")
    want32, _ = moe.apply_moe(_tree_map(
        lambda t: t[0].float(), params["blocks"]["b0"]["moe"]), x32, cfg)
    # each mesh's blocks, by arithmetic on the specs (rank 0's views)
    blocks = {}
    for name, shape, mode_ in MOE_SHARDED:
        mesh = Mesh(shape, ("data", "model"))
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, partitioning=mode_))
        specs = shd.moe_only_specs(params, c, mesh)
        blocks[name] = sum(
            shd.local_shard(t, s, mesh, rank=0).numel() * t.element_size()
            for t, s in zip(_leaves(params), _leaves(specs)))
    del shards, whole_rec
    # the blocks the ranks map (the parameters apart, freed by main)
    sent = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in (tokens, x32, want32, *layer_io.values(),
                      *ids.values(), *as_ranks.values())}
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ranks = run_world(_moe_sharded_rank, 4,
                          (cfg, params, tokens, layer_io, ids, as_ranks,
                           x32, want32),
                          workdir=workdir, timeout=MOE_SHARDED_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    # what this phase sent the ranks is freed once every rank released it
    del (tokens, want, layer_io, ids, as_ranks, x32, want32, whole,
         whole_io, whole_ids)
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.synchronize()
    freed = allocated_before - torch.cuda.memory_allocated()

    failed, meshes = [], {}
    if freed < sum(sent.values()):
        failed.append(f"{freed} B freed of the {sum(sent.values())} B sent "
                      f"to the ranks: a rank kept a block it mapped")
    for name, shape, mode_ in MOE_SHARDED:
        D, M = shape
        rs = [r["meshes"][name] for r in ranks]
        t_local = T // D
        # each rank's bf16 partial sent to the M - 1 others around the ring
        want_hops = G * (M - 1)
        want_bytes = want_hops * t_local * cfg.d_model * 2
        for i, r in enumerate(rs):
            checks = [
                ("non-finite output", r["finite"]),
                ("not bit-equal to the one process computing as the ranks",
                 r["equal_one_process_as_ranks"]),
                (f"rel L2 {r['rel_l2']} > {MOE_SHARDED_REL_L2}",
                 r["rel_l2"] <= MOE_SHARDED_REL_L2),
                (f"flash launched {r['flash_launches']} times, not {G}",
                 r["flash_launches"] == G),
                (f"blocks of {r['blocks_bytes']} B, not {blocks[name]}",
                 r["blocks_bytes"] == blocks[name]),
                (f"peak {r['peak_memory_allocated_bytes']} B over its "
                 f"blocks + {PIPE_RANK_MARGIN_BYTES}",
                 r["peak_memory_allocated_bytes"]
                 < blocks[name] + PIPE_RANK_MARGIN_BYTES),
                (f"summed {r['psum']} over the model axis, not {G} sums "
                 f"of {M - 1} hops of {t_local * cfg.d_model * 2} B",
                 (r["psum"]["hops"], r["psum"]["bytes"])
                 == (want_hops, want_bytes)),
                (f"{len(r['aux'])} aux records, not {G}",
                 len(r["aux"]) == len(r["local_aux"]) == G),
                ("a layer fed the one process's input routed otherwise",
                 len(r["layer_routing_equal"]) == G
                 and all(r["layer_routing_equal"])),
                (f"a layer's rel L2 {max(r['layer_rel_l2'])} > "
                 f"{MOE_SHARDED_LAYER_REL_L2}",
                 max(r["layer_rel_l2"]) <= MOE_SHARDED_LAYER_REL_L2)]
            if D == 1:
                checks.append((f"fp32 layer rel L2 {r['fp32_rel_l2']} > "
                               f"{MOE_SHARDED_FP32_REL_L2}",
                               r["fp32_rel_l2"] <= MOE_SHARDED_FP32_REL_L2))
            # every rank returns data shard 0's aux, bit for bit
            source = next(s for s in rs if s["data_index"] == 0
                          and s["model_index"] == r["model_index"])
            checks.append(("aux is not data shard 0's",
                           r["aux"] == source["local_aux"]))
            failed += [f"{name}, rank {i}: {what}"
                       for what, ok in checks if not ok]
        keep_rows = []
        for d in range(D):
            masks = np.stack([np.unpackbits(r["keep0"])[:T // D * cfg.moe.top_k]
                              for r in rs if r["data_index"] == d]).astype(bool)
            keep = want_keeps[name][d].numpy()
            keep_rows.append({"data_index": d, "kept": int(keep.sum()),
                              "choices": int(keep.size)})
            if not np.array_equal(masks.any(0), keep):
                failed.append(f"{name}, data shard {d}: the ranks' layer-0 "
                              f"keep masks do not union to the one "
                              f"process's")
            if mode_ == "ep" and (masks.sum(0) > 1).any():
                failed.append(f"{name}, data shard {d}: a choice kept on "
                              f"two ranks")
        aux0 = next(r for r in rs if r["data_index"] == 0)["local_aux"][0]
        if not all(math.isclose(a, b, rel_tol=1e-5)
                   for a, b in zip(aux0, want_aux0[name])):
            failed.append(f"{name}: layer 0's aux {aux0} is not the one "
                          f"process's {want_aux0[name]}")
        if D > 1 and all(r["local_aux"] == rs[0]["local_aux"] for r in rs):
            failed.append(f"{name}: the data shards' own aux agree, so the "
                          f"broadcast of shard 0's went unseen")
        meshes[name] = {
            "mesh": list(shape), "mode": mode_, "blocks_bytes": blocks[name],
            "capacity": moe._capacity(t_local, cfg.moe.top_k,
                                      cfg.moe.num_experts,
                                      cfg.moe.capacity_factor),
            "psum_bytes_expected": want_bytes,
            "one_process_as_ranks_rel_l2": as_ranks_rel_l2[name],
            "rel_l2_max": max(r["rel_l2"] for r in rs),
            "layer_rel_l2_max": max(max(r["layer_rel_l2"]) for r in rs),
            "warm_seconds_max": max(r["warm_seconds"] for r in rs),
            "keep0": keep_rows,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("keep0", "local_aux", "aux",
                                    "layer_routing_equal")}
                      | {"aux_layer0": r["aux"][0]} for r in rs]}
    emit("moe_sharded", config=cfg.name, batch=MOE_SHARDED_BATCH,
         seq=MOE_SHARDED_SEQ, token_seed=token_seed, groups=G,
         backend="gloo", compute_mode=mode, flash_checks=flash_checks,
         one_process_seconds_warm=one_s, model_bytes=_nbytes(params),
         rank_margin_bytes=PIPE_RANK_MARGIN_BYTES,
         limit_rel_l2=MOE_SHARDED_REL_L2,
         limit_layer_rel_l2=MOE_SHARDED_LAYER_REL_L2,
         limit_fp32_rel_l2=MOE_SHARDED_FP32_REL_L2, world_seconds=world_s,
         sent_bytes=sum(sent.values()), freed_after_world_bytes=freed,
         meshes=meshes,
         failed=failed, seconds=time.perf_counter() - t_phase)
    return failed


def encdec_shapes():
    """seamless-m4t-medium's attention layouts: (config, heads, head_dim,
    encoder frames)."""
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    return (cfg, cfg.num_heads, cfg.resolved_head_dim(),
            cfg.frontend.num_positions)


def encdec_flash_entry(gen, B, Sq, Skv, H, D, layout: str) -> dict:
    """The flash kernel at one of the encoder-decoder's non-causal
    layouts (MHA, no window): held to its plain version in bf16 at batch
    B and in fp32 at batch 1, then timed in bf16 beside the plain version
    and SDPA, with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    checks, inputs = [], None
    for dtype, b in ((torch.bfloat16, B), (torch.float32, 1)):
        q, k, v = (torch.randn((b * H, n, D), generator=gen,
                               device="cuda").to(dtype)
                   for n in (Sq, Skv, Skv))
        o = fa.flash_attention(q, k, v, causal=False, window=0)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=False, window=0)
        atol, rtol = FLASH_TOL[dtype]
        diff = o.float() - want.float()
        checks.append({"batch": b, "dtype": str(dtype),
                       "max_abs_err": float(diff.abs().max()),
                       "rel_l2": float(diff.norm() / want.float().norm()),
                       "atol": atol, "rtol": rtol,
                       "out_std": float(want.float().std())})
        if not _within(o, want, atol, rtol) or not bool(
                torch.isfinite(o).all()):
            raise RuntimeError(f"flash_attention at the {layout} layout "
                               f"{[b, Sq, Skv, H, D]} {dtype} disagrees with "
                               f"its plain version: "
                               f"max|d|={checks[-1]['max_abs_err']}")
        if dtype == torch.bfloat16:
            inputs = (q, k, v)
        del o, want, diff
    q, k, v = inputs

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=False, window=0)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=False, window=0)

    def run_library():
        # a yardstick only: the port never calls it
        return F.scaled_dot_product_attention(
            q.view(B, H, Sq, D), k.view(B, H, Skv, D), v.view(B, H, Skv, D),
            is_causal=False)
    lib_err = float((run_library().reshape(q.shape).float()
                     - run_plain().float()).abs().max())
    times = time_in_turns(run_kernel, run_plain, run_library)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, H, H, Sq, Skv, D, False, 0, q.element_size())
    return {"launches": None,              # filled in by encdec_serve
            "shape": [B, Sq, Skv, H, H, D, False, 0], "dtype": "bfloat16",
            "max_abs_err": checks[0]["max_abs_err"], "checks": checks,
            **times, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_call": "F.scaled_dot_product_attention(is_causal=False)",
            "library_max_abs_err_vs_plain": lib_err,
            "timed": f"one seamless-m4t-medium {layout} attention layer at "
                     f"batch {B}, bf16; kernel and SDPA median of 5 x 2 "
                     "calls, plain version of 3 x 1; best of 2",
            "bytes": nbytes, "flops": flops}


def phase_encdec_kernels() -> dict:
    """The two attention kernels at the encoder-decoder's layouts, which
    no earlier path runs at full width: flash non-causal over the
    encoder's 1024 frames (Sq = Skv) and for cross-attention (the
    64-token prompt against the 1024 frames), decode attention of one
    token against the static cross cache (G = 1, every sequence at all
    1024 rows); each held to its plain version and timed."""
    from repro_torch.kernels import decode_attention as dec
    _, H, D, S_enc = encdec_shapes()
    B = LM_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {
        "encoder": encdec_flash_entry(gen, B, S_enc, S_enc, H, D, "encoder"),
        "cross": encdec_flash_entry(gen, B, ENCDEC_PROMPT, S_enc, H, D,
                                    "cross-attention")}
    checks, inputs = [], None
    for dtype, b in ((torch.bfloat16, B), (torch.float32, 1)):
        q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, S_enc, H, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        lens = torch.full((b,), S_enc, dtype=torch.int32, device="cuda")
        got = dec.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        want = dec.decode_attention_ref(q, k, v, lens)
        atol, rtol = DECODE_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        checks.append({"batch": b, "dtype": str(dtype), "max_abs_err": err,
                       "atol": atol, "rtol": rtol})
        if not _within(got, want, atol, rtol):
            raise RuntimeError(f"decode_attention at the cross-decode layout "
                               f"{[b, S_enc, H, H, D]} {dtype} disagrees "
                               f"with its plain version: max|d|={err}")
        if dtype == torch.bfloat16:
            inputs = (q, k, v, lens)
    entries["cross_decode"] = {
        "launches": None,                 # filled in by encdec_decode
        "shape": [B, S_enc, H, H, D], "dtype": "bfloat16",
        "max_abs_err": checks[0]["max_abs_err"], "checks": checks,
        **time_decode(*inputs),
        "timed": "one seamless-m4t-medium decode step's cross-attention at "
                 "batch 4, bf16; wrapper, plain version and SDPA median of "
                 f"10 x {DECODE_TIMING_CALLS} calls"}
    emit("encdec_kernels", **entries)
    return entries


def encdec_layer_check(cfg, params, tokens, frames) -> list:
    """The first ENCDEC_FP32_BLOCKS encoder blocks (non-causal) and
    decoder blocks (causal, cross-attention to the fp32 encoder's output)
    in fp32 on request 0, each run through the flash kernel and through
    its plain version on the same input (the plain run's output of the
    block before), held to MOE_LAYER_REL_L2."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.moe import LOCAL_CTX
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    enc32 = {"encoder": _tree_map(lambda t: t.float(), params["encoder"])}
    x_enc = frames[:1].float()
    with plain_versions("flash_attention"):
        enc_out = tr.encode(enc32, x_enc, cfg32, LOCAL_CTX)
    x_dec = tr.embed_tokens(params, tokens[:1], cfg).float()
    layers = []
    for stack, x, blocks, causal, memory in (
            ("encoder", x_enc, enc32["encoder"]["blocks"], False, None),
            ("decoder", x_dec, params["blocks"]["b0"], True, enc_out)):
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(ENCDEC_FP32_BLOCKS):
            p32 = _tree_map(lambda t: t[i].float(), blocks)
            runs = {}
            for name, plain in (("kernel", ()),
                                ("plain", ("flash_attention",))):
                counts = launch_counts()
                with plain_versions(*plain):
                    y, _, _ = tr.apply_attn_block_seq(
                        p32, x, cfg32, LOCAL_CTX, positions=pos,
                        causal=causal, enc_out=memory)
                launched = launches_since(counts)["flash_attention"]
                want = 0 if plain else (1 if memory is None else 2)
                if launched != want:
                    raise RuntimeError(f"{stack} block {i}, {name} run: "
                                       f"flash launched {launched} times")
                runs[name] = y
            diff = runs["kernel"] - runs["plain"]
            rel = float(diff.norm() / runs["plain"].norm())
            layers.append({"stack": stack, "block": i,
                           "tokens": int(x.shape[1]), "rel_l2": rel,
                           "max_abs_err": float(diff.abs().max())})
            if not rel <= MOE_LAYER_REL_L2:
                raise RuntimeError(f"{stack} block {i}: fp32 kernels vs "
                                   f"plain versions: relative L2 {rel} > "
                                   f"{MOE_LAYER_REL_L2}")
            x = runs["plain"]
    return layers


def phase_encdec_serve(entries: dict):
    """seamless-m4t-medium at full width: 4 requests of 1024 frames and a
    64-token prompt prefilled (the encoder, the decoder with
    cross-attention, build_enc_kv), the encoder and the whole prefill
    timed, the decoder split through the segmentation hook held to the
    one-machine forward to the bit, and the first blocks held in fp32,
    kernels against plain versions."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import pdtype
    from repro_torch.models.moe import LOCAL_CTX
    cfg, params, info = init_full_width(ENCDEC_ARCH, ENCDEC_PARAMETERS,
                                        ENCDEC_PARAMETER_BYTES)
    G, L, H = cfg.num_groups(), cfg.num_layers, cfg.num_heads
    D, f = cfg.resolved_head_dim(), cfg.frontend
    if (cfg.block_pattern != ("attn",) or cfg.tail_pattern()
            or H != cfg.num_kv_heads or "frontend_proj" in params):
        raise RuntimeError(f"{ENCDEC_ARCH}: expected {G} MHA decoder "
                           "layers, no tail, frames of the model's width")
    rows = ENCDEC_PROMPT + ENCDEC_DECODE_STEPS
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, rows)).astype(np.int32)
    frames = torch.randn((LM_BATCH, f.num_positions, f.embed_dim),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED + 3), device="cuda")
    toks = torch.from_numpy(tokens).cuda()
    batch = _lm_batch(toks[:, :ENCDEC_PROMPT], frames)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    logits, cache = tr.prefill(params, batch, cfg, pad_to=rows)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != _prefill_launches(cfg):
        raise RuntimeError(f"prefill launched {launches}, expected "
                           f"{_prefill_launches(cfg)}")
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise RuntimeError("non-finite prefill logits")
    enc_kv_bytes = _nbytes(cache["enc_kv"])
    cache_bytes = _nbytes(cache) - enc_kv_bytes
    want_enc = 2 * L * LM_BATCH * f.num_positions * H * D * 2
    want_self = 2 * L * LM_BATCH * rows * H * D * 2
    if (enc_kv_bytes, cache_bytes) != (want_enc, want_self):
        raise RuntimeError(f"enc_kv {enc_kv_bytes} B and self cache "
                           f"{cache_bytes} B, expected {want_enc} and "
                           f"{want_self}")
    for leaf in _leaves(cache["enc_kv"]):
        if leaf.shape != (G, LM_BATCH, f.num_positions, H, D) or not (
                leaf[0].is_contiguous()):
            raise RuntimeError(f"enc_kv leaf {tuple(leaf.shape)} is not "
                               "(G, B, S_enc, H, D) with contiguous groups")
    del cache

    # the encoder alone and the whole prefill, CUDA events
    frames_p = frames.to(pdtype(cfg))
    counts = launch_counts()
    tr.encode(params, frames_p, cfg, LOCAL_CTX)
    encoder_launches = launches_since(counts)
    encoder_ms = time_ms(lambda: tr.encode(params, frames_p, cfg, LOCAL_CTX),
                         inner=1, samples=5)
    prefill_ms = time_ms(lambda: tr.prefill(params, batch, cfg, pad_to=rows),
                         inner=1, samples=5)

    # the segmentation hook: the decoder over [0, g) then [g, G) with the
    # encoder's output, against forward_hidden's hidden state
    hidden, _, _ = tr.forward_hidden(params, batch, cfg)
    enc_out = tr.encode(params, frames_p, cfg, LOCAL_CTX)
    pos = torch.arange(ENCDEC_PROMPT, device="cuda")
    counts = launch_counts()
    x = tr.embed_tokens(params, batch["tokens"], cfg)
    for start, stop in ((0, ENCDEC_SPLIT), (ENCDEC_SPLIT, G)):
        x = tr.run_layer_range(params, x, cfg, LOCAL_CTX, start_group=start,
                               stop_group=stop, positions=pos,
                               enc_out=enc_out)
    split_launches = launches_since(counts)
    x = tr.apply_norm(params["final_norm"], x)
    torch.cuda.synchronize()
    split = {"groups": [[0, ENCDEC_SPLIT], [ENCDEC_SPLIT, G]],
             "launches": split_launches,
             "max_abs_err_vs_forward": float((x.float() - hidden.float())
                                             .abs().max()),
             "equal_to_forward": bool(torch.equal(x, hidden))}
    if split_launches != _layers_run(cfg, 0, G, cross=True):
        raise RuntimeError(f"the split decoder launched {split_launches}")
    if not split["equal_to_forward"]:
        raise RuntimeError(f"the split decoder differs from forward_hidden "
                           f"by {split['max_abs_err_vs_forward']}")
    del hidden, enc_out, x
    layer_check = encdec_layer_check(cfg, params, toks[:, :ENCDEC_PROMPT],
                                     frames)
    torch.cuda.empty_cache()
    entries["encoder"]["launches"] = encoder_launches["flash_attention"]
    entries["cross"]["launches"] = (launches["flash_attention"]
                                    - encoder_launches["flash_attention"]) // 2
    emit("encdec_serve", **info, batch=LM_BATCH, prompt=ENCDEC_PROMPT,
         frames=[f.num_positions, f.embed_dim],
         layers=[cfg.encoder_layers, L],
         heads=[H, cfg.num_kv_heads, D], launches=launches,
         encoder_launches=encoder_launches,
         encoder_ms=encoder_ms, prefill_ms=prefill_ms,
         encoder_share_of_prefill=encoder_ms / prefill_ms,
         timed="CUDA events, median of 5 calls after one warm-up",
         enc_kv_bytes=enc_kv_bytes, cache_bytes=cache_bytes,
         cache_rows=rows, peak_memory_bytes=peak, split=split,
         fp32_layer_check=layer_check, limit_layer_rel_l2=MOE_LAYER_REL_L2)
    return cfg, params, tokens, frames


def phase_encdec_decode(cfg, params, tokens, frames, entries: dict) -> None:
    """The 4 requests prefilled and decoded ENCDEC_DECODE_STEPS
    teacher-forced steps through the self-attention cache and the static
    ``enc_kv`` (decode attention twice a layer), timed; the decode kernel
    held to its plain version on the served ``enc_kv``; then request 0
    through ``phase_model_decode`` (bf16 and fp32 decode against the
    one-machine forward, the last steps profiled), which prints the
    line."""
    from repro_torch.kernels import decode_attention as dec
    toks = torch.from_numpy(tokens).cuda()
    torch.cuda.reset_peak_memory_stats()
    logits, cache, record = prefill_decode(params, cfg, toks, ENCDEC_PROMPT,
                                           ENCDEC_DECODE_STEPS, frames)
    record["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise RuntimeError("non-finite decode logits")
    record["enc_kv_bytes"] = _nbytes(cache["enc_kv"])
    record["cache_bytes"] = _nbytes(cache) - record["enc_kv_bytes"]
    entries["cross_decode"]["launches"] = record["launches"]["decode"][
        "decode_attention"] // 2

    # the decode kernel on layer 0's enc_kv as decode reads it (a view)
    k = cache["enc_kv"]["groups"]["b0"]["k"][0]
    v = cache["enc_kv"]["groups"]["b0"]["v"][0]
    B, S_enc, H, D = k.shape
    q = torch.randn((B, H, D), generator=torch.Generator(device="cuda")
                    .manual_seed(SEED), device="cuda").to(k.dtype)
    lens = torch.full((B,), S_enc, dtype=torch.int32, device="cuda")
    got = dec.decode_attention(q, k, v, lens)
    want = dec.decode_attention_ref(q, k, v, lens)
    atol, rtol = DECODE_TOL[k.dtype]
    err = float((got.float() - want.float()).abs().max())
    if not _within(got, want, atol, rtol):
        raise RuntimeError(f"decode_attention on the served enc_kv disagrees "
                           f"with its plain version: max|d|={err}")
    served_kernel = {"shape": [B, S_enc, H, H, D], "dtype": str(k.dtype),
                     "max_abs_err": err, "atol": atol, "rtol": rtol}
    del cache, k, v
    torch.cuda.empty_cache()
    layouts = {name: {k: e[k] for k in KERNEL_LINE_KEYS if k in e}
               for name, e in entries.items()}
    phase_model_decode("encdec_decode", cfg, params,
                       tokens[:, :ENCDEC_PROMPT], frames=frames,
                       served=record, decode_attention_on_enc_kv=served_kernel,
                       kernel_layouts=layouts)


# --------------------------------------------------------------------------
# The modality frontend of a decoder-only model: internvl2-1b
# --------------------------------------------------------------------------
def flash_layout_check(gen, shape, layout: str, lse: bool = False) -> dict:
    """The flash kernel at a model's attention layout (B, Sq, Skv, Hq,
    Hkv, D, causal, window): held to its plain version in bf16 at batch B
    and in fp32 at batch 1 (with ``lse``, the row log-sum-exp the
    backward needs too), then timed in bf16 beside the plain version and
    SDPA, with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape
    checks, inputs = [], None
    for dtype, b in ((torch.bfloat16, B), (torch.float32, 1)):
        q = torch.randn((b * Hq, Sq, D), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((b * Hkv, Skv, D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        o, got_lse = fa._forward(q, k, v, causal=causal, window=window,
                                 kv_len=Skv, scale=D ** -0.5, want_lse=lse)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_ref(
            q, k, v, causal=causal, window=window, return_lse=True)
        atol, rtol = FLASH_TOL[dtype]
        diff = o.float() - want.float()
        check = {"batch": b, "dtype": str(dtype),
                 "max_abs_err": float(diff.abs().max()),
                 "rel_l2": float(diff.norm() / want.float().norm()),
                 "atol": atol, "rtol": rtol,
                 "out_std": float(want.float().std())}
        ok = _within(o, want, atol, rtol) and bool(torch.isfinite(o).all())
        if lse:
            check["lse_max_abs_err"] = float((got_lse - want_lse).abs().max())
            check["lse_atol"] = FLASH_LSE_ATOL[dtype]
            ok = ok and check["lse_max_abs_err"] <= FLASH_LSE_ATOL[dtype]
        checks.append(check)
        if not ok:
            raise RuntimeError(f"flash_attention at the {layout} layout "
                               f"{list(shape)} {dtype} disagrees with its "
                               f"plain version: {check}")
        if dtype == torch.bfloat16:
            inputs = (q, k, v)
        del o, want, diff, got_lse, want_lse
    q, k, v = inputs

    def run_kernel():
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    def run_plain():
        return fa.flash_attention_ref(q, k, v, causal=causal, window=window)

    def run_library():
        # a yardstick only: the port never calls it (the window, where
        # there is one, spans the whole sequence)
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D),
            v.view(B, Hkv, Skv, D), is_causal=causal, enable_gqa=True)
    if window and window < Sq:
        raise RuntimeError(f"{layout}: SDPA's causal mask is not the window")
    times = time_in_turns(run_kernel, run_plain, run_library)
    bound_ms, bound_by, nbytes, flops = flash_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, q.element_size())
    return {"layout": layout, "shape": list(shape), "dtype": "bfloat16",
            "checks": checks, **times, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_call": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa=True)",
            "timed": f"one {layout} attention layer, bf16; kernel and SDPA "
                     "median of 5 x 2 calls, plain version of 3 x 1; best "
                     "of 2", "bytes": nbytes, "flops": flops}


def frontend_decode(params, cfg, tokens, frames, prompt: int, steps: int):
    """Request 0's patches and ``prompt`` text tokens prefilled into a
    cache of P + prompt + steps rows, then ``steps`` teacher-forced
    decode steps at positions after the patches; the launch counts set to
    0 just before and read after each part.  Returns (last logits,
    record)."""
    from repro_torch.models import transformer as tr
    P = frames.shape[1]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = tr.prefill(params, {"tokens": tokens[:, :prompt],
                                   "frontend": frames}, cfg,
                          pad_to=P + prompt + steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_launches = launch_counts()
    marks, logits = [], None
    for t in range(prompt, prompt + steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = tr.decode_step(params, tokens[:, t:t + 1], cache,
                                       P + t, cfg)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    step_ms = [a.elapsed_time(b) for a, b in marks]
    record = {"prompt": [P, prompt], "steps": steps,
              "prefill_seconds": t1 - t0, "decode_seconds": decode_s,
              "step_ms_median": statistics.median(step_ms),
              "step_ms": step_ms,
              "launches": {"prefill": prefill_launches,
                           "decode": launches_since(prefill_launches)}}
    want = {"prefill": _prefill_launches(cfg),
            "decode": _decode_step_launches(cfg, steps)}
    if record["launches"] != want:
        raise RuntimeError(f"frontend prefill + decode launched "
                           f"{record['launches']}, expected {want}")
    return logits, record


def phase_frontend_serve() -> None:
    """internvl2-1b at full width: the flash kernel at its prefill layout
    (GQA 7, d = 64) held to its plain version first; 4 requests of 256
    patch embeddings and 1792 text tokens through the layer split at g =
    12, the patches entering at the cloud's embedding, held to a
    one-machine forward_hidden of the same batch; request 0 prefilled and
    decoded FRONTEND_DECODE_STEPS steps in bf16 and fp32, the fp32 decode
    held to the fp32 forward."""
    from repro_torch.configs import get_config
    from repro_torch.core.segmentation import hidden_payload_bytes
    from repro_torch.core.transport import WAN_LINK
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import LayerSplitDevice, LayerSplitEngine
    c = get_config(FRONTEND_ARCH)
    P, E = c.frontend.num_positions, c.frontend.embed_dim
    S = P + FRONTEND_TEXT
    flash = flash_layout_check(
        torch.Generator(device="cuda").manual_seed(SEED),
        (LM_BATCH, S, S, c.num_heads, c.num_kv_heads, c.resolved_head_dim(),
         True, 0), "internvl2-1b prefill")
    cfg, params, info = init_full_width(FRONTEND_ARCH, FRONTEND_PARAMETERS,
                                        FRONTEND_PARAMETER_BYTES)
    G, V = cfg.num_groups(), cfg.vocab_size
    if (cfg.block_pattern != ("attn",) or cfg.tail_pattern()
            or "frontend_proj" in params
            or "bq" not in params["blocks"]["b0"]):
        raise RuntimeError(f"{FRONTEND_ARCH}: expected {G} attention layers "
                           "with qkv biases, no tail, patches of the model's "
                           "width")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, V, (LM_BATCH, FRONTEND_TEXT +
                                 FRONTEND_DECODE_STEPS)).astype(np.int32)
    frames = rng.standard_normal((LM_BATCH, P, E)).astype(np.float32)
    batch = {"tokens": tokens[:, :FRONTEND_TEXT], "frontend": frames}

    # the main path, the layer split: counts set to 0 just before, read
    # just after; each side warms up once, then runs timed
    cloud = LayerSplitEngine(params, cfg, link=WAN_LINK, device="cuda")
    device = LayerSplitDevice(params, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    payload, t_net = cloud.process(batch, FRONTEND_SPLIT)
    logits = device.complete(payload, FRONTEND_SPLIT)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    expected = {k: 2 * n for k, n in _layers_run(cfg, 0, G).items()}
    if launches != expected:
        raise RuntimeError(f"frontend split launched {launches}, expected "
                           f"{expected}")
    want_bytes = hidden_payload_bytes(cfg, LM_BATCH, S, 2)
    if payload.nbytes != want_bytes or payload.shape[1] != S:
        raise RuntimeError(f"frontend split shipped {payload.shape} "
                           f"({payload.nbytes} B), expected {S} positions "
                           f"in {want_bytes} B")
    sides = {name: {k: side.stats[k] for k in ("gpu_seconds",
                                               "compile_seconds")}
             for name, side in (("cloud", cloud), ("device", device))}
    peak = torch.cuda.max_memory_allocated()
    del cloud, device

    # one machine, the same batch
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    hidden, _, _ = tr.forward_hidden(params, tb, cfg,
                                     kernels=ops.kernel_registry())
    want = tr.unembed(params, hidden[:, -1:], cfg)
    del hidden
    err = float((logits.float() - want.float()).abs().max())
    if not bool(torch.isfinite(logits).all()) or not _within(
            logits, want, LM_SPLIT_ATOL, LM_SPLIT_RTOL):
        raise RuntimeError(f"frontend split logits differ from the "
                           f"one-machine forward by {err}")

    # request 0: prefill + decode after its patches, bf16 and fp32
    steps = np.random.default_rng(SEED + 1).integers(
        0, V, (1, FRONTEND_DECODE_STEPS)).astype(np.int32)
    toks0 = torch.from_numpy(np.concatenate(
        [tokens[:1, :FRONTEND_TEXT], steps], axis=1)).cuda()
    frames0 = tb["frontend"][:1]
    decoded, record = frontend_decode(params, cfg, toks0, frames0,
                                      FRONTEND_TEXT, FRONTEND_DECODE_STEPS)
    whole = {"tokens": toks0, "frontend": frames0}
    hidden, _, _ = tr.forward_hidden(params, whole, cfg)
    want_dec = tr.unembed(params, hidden[:, -1:], cfg)
    params32 = _tree_map(lambda t: t.float(), params)
    decoded32, record32 = frontend_decode(params32, cfg, toks0, frames0,
                                          FRONTEND_TEXT,
                                          FRONTEND_DECODE_STEPS)
    hidden, _, _ = tr.forward_hidden(params32, whole, cfg)
    want32 = tr.unembed(params32, hidden[:, -1:], cfg)
    del hidden, params32
    torch.cuda.empty_cache()
    for t in (decoded, want_dec, decoded32, want32):
        if not bool(torch.isfinite(t[..., :V]).all()):
            raise RuntimeError("frontend_serve: non-finite logits")
    held = _rel_l2(decoded32, want32, V)
    emit("frontend_serve", **info, batch=LM_BATCH, patches=[P, E],
         text=FRONTEND_TEXT, positions=S, groups=G, group=FRONTEND_SPLIT,
         heads=[cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()],
         flash=flash, serve_seconds=serve_s, sides=sides,
         payload_bytes=payload.nbytes, t_net_seconds=t_net,
         launches=launches, launches_expected=expected,
         peak_memory_bytes=peak, split_logit_max_abs_err=err,
         split_atol=LM_SPLIT_ATOL, split_rtol=LM_SPLIT_RTOL,
         decode=record, fp32={k: record32[k] for k in (
             "prefill_seconds", "step_ms_median", "launches")},
         fp32_decode_vs_forward_rel_l2=held,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2,
         bf16_decode_vs_forward_rel_l2=_rel_l2(decoded, want_dec, V),
         bf16_decode_vs_fp32_forward_rel_l2=_rel_l2(decoded, want32, V))
    if not held <= DECODE_FP32_REL_L2:
        raise RuntimeError(f"frontend_serve: fp32 decode against the fp32 "
                           f"forward: relative L2 error {held} > "
                           f"{DECODE_FP32_REL_L2}")


def _ring_steps(params, cfg, tokens, cache, start: int, stop: int,
                keep_from: int):
    """Teacher-forced decode steps at positions [start, stop) through
    ``cache``; returns the logits of the steps at ``keep_from`` and later
    and every step's CUDA-event milliseconds."""
    _, step_ms = decode_steps(params, cfg, tokens, cache, start,
                              keep_from - start)
    kept = []
    for t in range(keep_from, stop):
        logits, ms = decode_steps(params, cfg, tokens, cache, t, 1)
        kept.append(logits)
        step_ms += ms
    return kept, step_ms


def ring_fp32_check(params, cfg, tokens) -> dict:
    """Request 0 in fp32 at a window narrowed to RING_FP32_WINDOW: a ring
    of that many rows against a linear cache of RING_FP32_WINDOW +
    RING_PAST rows grown from one (``pad_kv_caches``), both from empty,
    at each of the RING_PAST steps past the window, and the ring's last
    logits against the fp32 one-machine forward."""
    from repro_torch.models import transformer as tr
    cfg32 = dataclasses.replace(cfg, window=RING_FP32_WINDOW,
                                param_dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    W, T, V = RING_FP32_WINDOW, RING_FP32_WINDOW + RING_PAST, cfg.vocab_size
    tok = tokens[:1, :T]
    caches = {"ring": tr.init_decode_cache(cfg32, 1, T, device="cuda"),
              "linear": tr.pad_kv_caches(
                  tr.init_decode_cache(cfg32, 1, 1, device="cuda"), T)}
    out, logits = {}, {}
    for name, cache in caches.items():
        reset_launch_counts()
        logits[name], step_ms = _ring_steps(params32, cfg32, tok, cache, 0,
                                            T, W)
        out[name] = {"rows": cache["groups"]["b0"]["k"].shape[2],
                     "step_ms_median": statistics.median(step_ms),
                     "launches": launch_counts()}
    want = one_machine(params32, cfg32, tok)
    del params32, caches
    torch.cuda.empty_cache()
    rel = [_rel_l2(r, lin, V)
           for r, lin in zip(logits["ring"], logits["linear"])]
    return dict(out, window=W, steps=T,
                ring_vs_linear_rel_l2_max=max(rel),
                ring_vs_forward_rel_l2=_rel_l2(logits["ring"][-1], want, V),
                finite=all(bool(torch.isfinite(t[..., :V]).all())
                           for t in logits["ring"] + logits["linear"]
                           + [want]),
                launches_expected=_decode_step_launches(cfg32, T))


def ring_kernel_entry(ring, cfg) -> dict:
    """Decode attention on the wrapped ring's first layer as the ring
    path gives it (q (RING_BATCH, 32, 80) against all 4096 slots, the
    cache's own K and V): held to its plain version at DECODE_TOL, then
    timed beside it, SDPA and its bound."""
    from repro_torch.kernels import decode_attention as dec
    k, v = ring["groups"]["b0"]["k"][0], ring["groups"]["b0"]["v"][0]
    B, W = k.shape[:2]
    q = torch.randn((B, cfg.num_heads, cfg.resolved_head_dim()),
                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda").to(k.dtype)
    lens = torch.full((B,), W, dtype=torch.int32, device="cuda")
    o = dec.decode_attention(q, k, v, lens)
    want = dec.decode_attention_ref(q, k, v, lens)
    err = float((o.float() - want.float()).abs().max())
    atol, rtol = DECODE_TOL[k.dtype]
    if not _within(o, want, atol, rtol):
        raise RuntimeError(f"decode_attention on the ring {list(k.shape)} "
                           f"disagrees with its plain version: max|d|={err}")
    return {"shape": [B, W, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim()], "max_abs_err": err,
            "atol": atol, "rtol": rtol, **time_decode(q, k, v, lens)}


def phase_swa_ring_decode() -> None:
    """h2o-danube-1.8b at full width, its first RING_LAYERS layers,
    decoded past its window through a ring cache: RING_BATCH sequences of window + RING_PAST teacher-forced
    steps from an empty ring of window rows (the launch counts set to 0
    just before and read just after), held to prefill of the window's
    tokens into a linear cache and RING_PAST steps through the window
    inside it, at each of those steps (the last MODEL_PROFILE_STEPS of
    each path decoded once more under the profiler, every row rewritten);
    the ring's last logits to the
    one-machine forward over every token; its last RING_PLAIN_STEPS steps
    once more from a copy of the ring through decode attention's plain
    version, and the kernel timed on that copy's first layer; then the
    fp32 ring at a narrowed window.  Raises on any
    miss, after printing its line."""
    from repro_torch.models import transformer as tr
    from repro_torch.serving.profile_split import profile_decode
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, info = init_full_width(DANUBE_ARCH, DANUBE_PARAMETERS,
                                        DANUBE_PARAMETER_BYTES)
    cfg = dataclasses.replace(cfg, num_layers=RING_LAYERS)
    params = dict(params, blocks=_tree_map(lambda t: t[:RING_LAYERS].clone(),
                                           params["blocks"]))
    info["layers"] = RING_LAYERS
    W, V = cfg.window, cfg.vocab_size
    T = W + RING_PAST
    cut = T - RING_PLAIN_STEPS
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, V, (RING_BATCH, T)).astype(np.int32)).cuda()
    ring = tr.init_decode_cache(cfg, RING_BATCH, T, device="cuda")
    ring_rows, ring_bytes = ring["groups"]["b0"]["k"].shape[2], _nbytes(ring)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring_logits, step_ms = _ring_steps(params, cfg, tokens, ring, 0, cut, W)
    at_cut = _tree_map(torch.clone, ring)
    more, ms = _ring_steps(params, cfg, tokens, ring, cut, T, cut)
    ring_s = time.perf_counter() - t0
    ring_launches = launch_counts()
    ring_logits += more
    step_ms += ms
    profiles = {"ring": profile_decode(params, cfg, tokens, ring,
                                       T - MODEL_PROFILE_STEPS,
                                       MODEL_PROFILE_STEPS)}
    del ring

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, linear = tr.prefill(params, {"tokens": tokens[:, :W]}, cfg, pad_to=T)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    lin_rows, lin_bytes = (linear["groups"]["b0"]["k"].shape[2],
                           _nbytes(linear))
    lin_logits, lin_ms = _ring_steps(params, cfg, tokens, linear, W, T, W)
    lin_launches = {"prefill": prefill_launches,
                    "decode": launches_since(prefill_launches)}
    profiles["linear"] = profile_decode(params, cfg, tokens, linear,
                                        T - MODEL_PROFILE_STEPS,
                                        MODEL_PROFILE_STEPS)
    del linear

    before = launch_counts()
    with plain_versions("decode_attention"):
        plain_logits, _ = _ring_steps(params, cfg, tokens, at_cut, cut, T,
                                      cut)
    plain_launches = launches_since(before)["decode_attention"]
    kernel = ring_kernel_entry(at_cut, cfg)
    del at_cut
    want = one_machine(params, cfg, tokens)
    peak = torch.cuda.max_memory_allocated()
    fp32 = ring_fp32_check(params, cfg, tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    vs_linear = [_rel_l2(r, lin, V) for r, lin in zip(ring_logits,
                                                      lin_logits)]
    vs_plain = [_rel_l2(k, p, V) for k, p in zip(ring_logits[-len(
        plain_logits):], plain_logits)]
    vs_forward = _rel_l2(ring_logits[-1], want, V)
    finite = all(bool(torch.isfinite(t[..., :V]).all()) for t in
                 ring_logits + lin_logits + plain_logits + [want])
    expected = {"ring": _decode_step_launches(cfg, T), "linear": {
        "prefill": _prefill_launches(cfg),
        "decode": _decode_step_launches(cfg, RING_PAST)}}
    emit("swa_ring_decode", **info, window=W, batch=RING_BATCH, steps=T,
         heads=[cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()],
         ring_rows=ring_rows, ring_cache_bytes=ring_bytes,
         linear_rows=lin_rows, linear_cache_bytes=lin_bytes,
         decode_seconds=ring_s,
         step_ms_median=statistics.median(step_ms),
         step_ms_median_past_window=statistics.median(step_ms[W:]),
         tokens_per_second=RING_BATCH * T / ring_s,
         peak_memory_bytes=peak, launches=ring_launches,
         linear={"prefill_seconds": prefill_s,
                 "step_ms_median": statistics.median(lin_ms),
                 "launches": lin_launches},
         launches_expected=expected, profiles=profiles,
         ring_vs_linear_rel_l2=vs_linear,
         ring_vs_linear_rel_l2_max=max(vs_linear),
         ring_vs_forward_rel_l2=vs_forward,
         kernel_vs_plain_rel_l2=vs_plain, plain_kernel_launches=plain_launches,
         decode_attention=kernel,
         limit_rel_l2=LM_PLAIN_REL_L2, fp32=fp32,
         limit_fp32_rel_l2=DECODE_FP32_REL_L2,
         seconds=time.perf_counter() - t_phase)
    misses = [what for what, ok in (
        ("ring rows", ring_rows == W),
        ("ring cache bytes", ring_bytes == RING_CACHE_BYTES),
        ("linear cache bytes", lin_bytes == RING_LINEAR_CACHE_BYTES),
        ("ring launches", ring_launches == expected["ring"]),
        ("linear launches", lin_launches == expected["linear"]),
        ("profiled steps", all(
            pr["device_seconds"] is not None and pr["wrapper_launches"]
            == _decode_step_launches(cfg, MODEL_PROFILE_STEPS)
            for pr in profiles.values())),
        ("finite logits", finite and fp32["finite"]),
        ("ring vs linear", max(vs_linear) <= LM_PLAIN_REL_L2),
        ("ring vs the forward", vs_forward <= LM_PLAIN_REL_L2),
        ("kernel vs plain", max(vs_plain) <= LM_PLAIN_REL_L2),
        ("plain version launched the kernel", plain_launches == 0),
        ("fp32 rows", (fp32["ring"]["rows"], fp32["linear"]["rows"])
         == (RING_FP32_WINDOW, RING_FP32_WINDOW + RING_PAST)),
        ("fp32 launches", fp32["ring"]["launches"]
         == fp32["linear"]["launches"] == fp32["launches_expected"]),
        ("fp32 ring vs linear",
         fp32["ring_vs_linear_rel_l2_max"] <= DECODE_FP32_REL_L2),
        ("fp32 ring vs the forward",
         fp32["ring_vs_forward_rel_l2"] <= DECODE_FP32_REL_L2)) if not ok]
    if misses:
        raise RuntimeError(f"swa_ring_decode: missed {misses}")


# --------------------------------------------------------------------------
# Training: the kernels' backwards, then h2o-danube-1.8b and Mamba-2-780M
# --------------------------------------------------------------------------
def _grads_of(fn, inputs, cot):
    """Gradients of ``fn(*inputs)`` (a tensor or tuple) for the
    cotangent(s) ``cot``, and a closure that reruns only the backward."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)

    def backward():
        return torch.autograd.grad(outs, leaves, cots, retain_graph=True)
    return backward(), backward


def _rel_errs(got, want) -> list:
    return [float((g.float() - w.float()).norm() / w.float().norm())
            for g, w in zip(got, want)]


def _time_backwards(kernel_bwd, plain_bwd, library_bwd=None) -> dict:
    """CUDA-event medians of the backwards alone (their graphs built
    once): plain, kernel, kernel, plain, the best of each pair; then the
    library's."""
    plain_a = time_ms(plain_bwd, inner=1, samples=3)
    kern_a = time_ms(kernel_bwd, inner=1, samples=5)
    kern_b = time_ms(kernel_bwd, inner=1, samples=5)
    plain_b = time_ms(plain_bwd, inner=1, samples=3)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "library_ms": (None if library_bwd is None else
                           time_ms(library_bwd, inner=1, samples=5))}


def flash_bwd_bound(B, Hq, Hkv, Sq, Skv, d, causal, window, itemsize):
    """Least time for the backward: q, k, v, o, do and lse read, dq, dk,
    dv written once; 10 d operations (the five products: scores again,
    dv, dp, dq, dk) for each unmasked (query, key) pair at the inputs'
    tensor-core rate."""
    _, _, _, flops = flash_bound(B, Hq, Hkv, Sq, Skv, d, causal, window,
                                 itemsize)
    flops *= 2.5
    nbytes = ((4 * B * Hq * Sq * d + 4 * B * Hkv * Skv * d) * itemsize
              + 4 * B * Hq * Sq)
    rate = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_backward_entry(gen, shape, layout: str) -> dict:
    """The flash backward (``FlashAttention``: the kernel's forward with
    its lse, the torch backward) against autograd through the plain
    version, fp32 at batch 1 and bf16 at batch B, each gradient's
    relative L2 error within FLASH_BWD_REL_L2; the bf16 backward timed
    beside the plain version's and SDPA's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, Hq, Hkv, D, causal, window = shape
    checks, timed = [], None
    for dtype, b in ((torch.float32, 1), (torch.bfloat16, B)):
        def n(rows, heads):
            return torch.randn((b * heads, rows, D), generator=gen,
                               device="cuda").to(dtype)
        q, k, v, do = n(Sq, Hq), n(Skv, Hkv), n(Skv, Hkv), n(Sq, Hq)

        def kernel(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q, k, v):
            return fa.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
        got, kernel_bwd = _grads_of(kernel, (q, k, v), do)
        want, plain_bwd = _grads_of(plain, (q, k, v), do)
        errs = _rel_errs(got, want)
        checks.append({"batch": b, "dtype": str(dtype),
                       "rel_l2": dict(zip("qkv", errs)),
                       "limit": FLASH_BWD_REL_L2[dtype]})
        if not max(errs) <= FLASH_BWD_REL_L2[dtype] or not all(
                bool(torch.isfinite(g).all()) for g in got):
            raise RuntimeError(f"flash backward at the {layout} layout "
                               f"{dtype}: {checks[-1]}")
        if dtype == torch.bfloat16:
            sq = q.view(B, Hq, Sq, D)
            sk, sv = k.view(B, Hkv, Skv, D), v.view(B, Hkv, Skv, D)
            _, sdpa_bwd = _grads_of(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True),
                (sq, sk, sv), do.view(B, Hq, Sq, D))
            timed = _time_backwards(kernel_bwd, plain_bwd, sdpa_bwd)
        del got, want, kernel_bwd, plain_bwd
    if window and window < Sq:
        raise RuntimeError(f"{layout}: SDPA's causal mask is not the window")
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound(
        B, Hq, Hkv, Sq, Skv, D, causal, window, 2)
    return {"layout": layout, "shape": list(shape), "checks": checks,
            **timed, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_call": "backward of F.scaled_dot_product_attention("
                            "is_causal, enable_gqa=True)",
            "timed": "the backward alone (its graph built once), bf16; "
                     "median of 5 calls (plain 3); best of 2",
            "bytes": nbytes, "flops": flops}


def rglru_backward_entry(gen) -> dict:
    """The RG-LRU backward (the same kernel on the reversed, one-shifted
    a and the reversed dh) at RecurrentGemma-9B's scan shape, with h0,
    against autograd through the plain associative scan; timed."""
    from repro_torch.kernels import rglru_scan as lru
    B, S, W = lm_path_shapes()[2]
    a = torch.rand((B, S, W), generator=gen, device="cuda") * 0.5 + 0.5
    b, h0 = (torch.randn(s, generator=gen, device="cuda")
             for s in ((B, S, W), (B, W)))
    dh = torch.randn((B, S, W), generator=gen, device="cuda")
    got, kernel_bwd = _grads_of(lru.rglru_scan, (a, b, h0), dh)
    want, plain_bwd = _grads_of(lru.rglru_scan_ref, (a, b, h0), dh)
    errs = _rel_errs(got, want)
    if not max(errs) <= RGLRU_BWD_REL_L2:
        raise RuntimeError(f"rglru backward: relative L2 errors {errs}")
    times = _time_backwards(kernel_bwd, plain_bwd)
    # a, h, dh read, da, db written (h0 and dh0 are one step); the
    # reverse scan's two operations and two products an element
    nbytes = 5 * B * S * W * 4
    t_bytes, t_ops = (nbytes / HBM_BYTES_PER_S,
                      4 * B * S * W / FP32_FLOP_PER_S)
    return {"shape": [B, S, W], "rel_l2": dict(zip(("a", "b", "h0"), errs)),
            "limit": RGLRU_BWD_REL_L2, **times,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "timed": "the backward alone, fp32; median of 5 calls (plain "
                     "3); best of 2"}


def ssd_backward_entry(gen) -> dict:
    """The SSD backward (the kernel's forward, the vjp of the plain
    chunked scan recomputed from its inputs) at Mamba-2-780M's training
    shape (batch 2), with init_state, against autograd through the plain
    chunked scan; timed."""
    from repro_torch.kernels import ssd_scan as ssd
    b, S, H, P, G, N, Q = ssd_path_shape()
    b = TRAIN_BATCH

    def normal(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale
    x, Bm, Cm = normal(b, S, H, P), normal(b, S, G, N), normal(b, S, G, N)
    dt = torch.rand((b, S, H), generator=gen, device="cuda") * 0.1 + 0.01
    A = -(torch.rand((H,), generator=gen, device="cuda") + 0.5)
    st = normal(b, H, P, N)
    cots = (normal(b, S, H, P), normal(b, H, P, N))
    inputs = (x, dt, A, Bm, Cm, st)
    got, kernel_bwd = _grads_of(
        lambda *t: ssd.ssd_scan(*t[:5], chunk_size=Q, init_state=t[5]),
        inputs, cots)
    want, plain_bwd = _grads_of(
        lambda *t: ssd.ssd_chunked_ref(*t[:5], Q, t[5]), inputs, cots)
    errs = _rel_errs(got, want)
    names = ("x", "dt", "A", "Bm", "Cm", "init_state")
    if not max(errs) <= SSD_BWD_REL_L2:
        raise RuntimeError(f"ssd backward: relative L2 errors "
                           f"{dict(zip(names, errs))}")
    times = _time_backwards(kernel_bwd, plain_bwd)
    _, _, nbytes, flops, _ = ssd_bound(b, S, H, P, G, N, Q, with_init=True)
    # the vjp of each product is two products: twice the forward's
    # operations, over inputs, cotangents and gradients of the forward's
    # bytes twice over
    t_bytes, t_ops = 2 * nbytes / HBM_BYTES_PER_S, 2 * flops / FP32_FLOP_PER_S
    return {"shape": [b, S, H, P, G, N, Q],
            "rel_l2": dict(zip(names, errs)), "limit": SSD_BWD_REL_L2,
            **times, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "timed": "the backward alone, fp32; median of 5 calls (plain "
                     "3); best of 2"}


def phase_train_kernels() -> dict:
    """Each backward the training phases run, against autograd through
    the plain version on the card: flash at h2o-danube-1.8b's training
    layout (its forward and lse first: the kernel never ran d = 80
    before) and at the reference test's layout, the RG-LRU scan, the SSD
    scan.  Returns the entries."""
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    c = get_config(DANUBE_ARCH)
    danube = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, c.num_heads,
              c.num_kv_heads, c.resolved_head_dim(), True, c.window)
    t0 = time.perf_counter()
    forward = flash_layout_check(gen, danube, "h2o-danube-1.8b training",
                                 lse=True)
    entries = {
        "flash_forward": forward,
        "flash": flash_backward_entry(gen, danube, "h2o-danube-1.8b "
                                      "training"),
        "flash_ref_test": flash_backward_entry(
            gen, FLASH_REF_TEST_LAYOUT, "tests/test_kernels.py flash vjp"),
        "rglru_scan": rglru_backward_entry(gen),
        "ssd_scan": ssd_backward_entry(gen)}
    torch.cuda.empty_cache()
    emit("train_kernels", seconds=time.perf_counter() - t0, **entries)
    return entries


def _first_layers(cfg, params, n: int):
    """The config and an fp32 copy of the tree cut to the first ``n``
    layers (groups of a one-kind pattern), at full width."""
    cfg_n = dataclasses.replace(cfg, num_layers=n, param_dtype="float32")
    tree = {k: v for k, v in params.items() if k != "blocks"}
    tree["blocks"] = _tree_map(lambda t: t[:n], params["blocks"])
    return cfg_n, _tree_map(lambda t: t.float(), tree)


def train_fp32_check(cfg, params, batch, kernel: str) -> dict:
    """The first TRAIN_FP32_LAYERS layers in fp32 on request 0: every
    leaf's gradient through the kernels against the same through the
    plain versions, relative L2."""
    from repro_torch.train.train_loop import value_and_grad
    cfg_n, tree = _first_layers(cfg, params, TRAIN_FP32_LAYERS)
    b0 = {k: v[:1] for k, v in batch.items()}
    (loss, _), got = value_and_grad(cfg_n, tree, b0)
    with plain_versions(kernel):
        (loss_p, _), want = value_and_grad(cfg_n, tree, b0)
    errs = {}
    for (path, g), w in zip(_paths(got), _leaves(want)):
        errs[path] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    worst = max(errs, key=errs.get)
    out = {"layers": TRAIN_FP32_LAYERS, "loss": float(loss),
           "loss_plain": float(loss_p), "worst_leaf": worst,
           "worst_rel_l2": errs[worst], "limit": TRAIN_FP32_GRAD_REL_L2,
           "leaves": len(errs)}
    if not errs[worst] <= TRAIN_FP32_GRAD_REL_L2:
        raise RuntimeError(f"fp32 gradients through {kernel} against its "
                           f"plain version: {out}")
    return out


def _paths(tree: dict, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def profile_train_step(step_fn, params, opt_state, batch) -> dict:
    """One more train step under ``torch.profiler``: device time by
    class, the idle share over the step, the trace held to the kernels
    the wrappers enqueued."""
    from repro_torch.serving import profile_split as ps
    counts, kernels = ps.wrapper_counts(), ps.kernel_counts()
    with ps.traced(torch.device("cuda")) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = ps._check_trace({
        "wall_seconds": wall, "loss": float(metrics["loss"]),
        "wrapper_launches": ps._since(counts, ps.wrapper_counts()),
        "wrapper_kernels": ps._since(kernels, ps.kernel_counts()),
        **ps.summarize_trace(ps._trace_events(prof), wall)})
    if out["device_seconds"] is None:
        raise RuntimeError("the profiled train step shows no device time")
    return out


def phase_train(phase: str, arch: str, want_params: int,
                want_bytes: int, kernel: str) -> float:
    """``arch`` at full width in bf16 with fp32 AdamW state: the fp32
    gradient check of its first layers, then TRAIN_STEPS steps of
    make_train_step on batch_for_config's batches (launch counts set to 0
    just before, read after each step), step 0's loss held to a no_grad
    train_forward of the same batch, and one more step profiled."""
    from repro_torch.data.pipeline import DataConfig, batch_for_config
    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step
    cfg, params, info = init_full_width(arch, want_params, want_bytes)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=SEED)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                batch_for_config(cfg, dc, s).items()}
               for s in range(TRAIN_STEPS + 1)]
    fp32 = train_fp32_check(cfg, params, batches[0], kernel)
    torch.cuda.empty_cache()
    with torch.no_grad():
        loss0, _ = tr.train_forward(params, batches[0], cfg)
    loss0 = float(loss0)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        warmup_steps=2, total_steps=100)))
    expected = _train_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(TRAIN_STEPS):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batches[s])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        steps.append({"step": s, "seconds": seconds,
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "lr": float(metrics["lr"]), "launches": launches})
        if launches != expected:
            raise RuntimeError(f"{phase}: step {s} launched {launches}, "
                               f"expected {expected}")
        if not (math.isfinite(steps[-1]["loss"])
                and math.isfinite(steps[-1]["grad_norm"])):
            raise RuntimeError(f"{phase}: step {s}: {steps[-1]}")
    peak = torch.cuda.max_memory_allocated()
    held = abs(steps[0]["loss"] - loss0) / abs(loss0)
    prof = profile_train_step(step_fn, params, opt_state,
                              batches[TRAIN_STEPS])
    if prof["wrapper_launches"] != expected:
        raise RuntimeError(f"{phase}: the profiled step launched "
                           f"{prof['wrapper_launches']}, expected {expected}")
    state_bytes = _nbytes({k: v for k, v in opt_state.items()
                           if k != "step"})
    del params, opt_state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    warm = [st["seconds"] for st in steps[1:]]
    emit(phase, **info, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         layers=cfg.num_layers, steps=steps,
         step_seconds_median_warm=statistics.median(warm),
         tokens_per_second=TRAIN_BATCH * TRAIN_SEQ / statistics.median(warm),
         launches_per_step=expected, peak_memory_bytes=peak,
         optimizer_state_bytes=state_bytes,
         loss0_no_grad=loss0, loss0_rel_diff=held,
         limit_loss0_rtol=TRAIN_LOSS_RTOL, fp32_gradients=fp32,
         profile=prof)
    if not held <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"{phase}: step 0's loss {steps[0]['loss']} "
                           f"against the no_grad forward's {loss0}")
    return statistics.median(warm)


def checkpoint_round_trip(cfg, params) -> dict:
    """One train step of ``params`` (so that AdamW's m and v are not
    zero), the parameters and optimizer state saved with
    ``train/checkpoint.py`` to a new temporary directory, restored, moved
    to the card and held to the state in memory leaf by leaf, to the bit
    and dtype for dtype.  The directory is removed."""
    from repro_torch.data.pipeline import DataConfig, batch_for_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=CLI_SEQ,
                    global_batch=CLI_BATCH)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in batch_for_config(cfg, dc, 0).items()}
    params, opt_state, _ = make_train_step(cfg, TrainConfig())(
        params, init_opt_state(params), batch)
    state = {"params": params, "opt": opt_state}
    moments = [float(t.abs().sum()) for t in
               _leaves(opt_state["m"]) + _leaves(opt_state["v"])]
    directory = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(directory, 1, state, metadata={"model": cfg.name})
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        t0 = time.perf_counter()
        step, restored, meta = ckpt.restore(directory, state)
        restored = _tree_map(lambda t: t.to("cuda"), restored)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory)
    want = dict(_paths(state))
    got = dict(_paths(restored))
    unequal = [path for path in sorted(want.keys() | got.keys())
               if path not in got or path not in want
               or got[path].dtype != want[path].dtype
               or not torch.equal(got[path], want[path])]
    out = {"parameters": sum(t.numel() for t in _leaves(params)),
           "state_bytes": _nbytes(state), "disk_bytes": disk,
           "save_seconds": save_s, "restore_seconds": restore_s,
           "leaves": len(_leaves(state)), "unequal_leaves": unequal,
           "step": step, "metadata": meta,
           "moments_nonzero": all(m > 0 for m in moments)}
    if unequal or step != 1 or not out["moments_nonzero"]:
        raise RuntimeError(f"checkpoint round trip: {out}")
    return out


def phase_train_cli() -> None:
    """smollm-135m at full width: the checkpoint round trip, then
    ``launch/train.py``'s ``main`` twice on one checkpoint directory
    (CLI_STEPS steps, then CLI_RESUME_STEPS, its lines captured, the
    launch counts set to 0 just before and read just after each run).
    The second run must resume at step CLI_STEPS, its first loss equal to
    a no-grad ``train_forward`` of the restored step-CLI_STEPS parameters
    on that step's batch within TRAIN_LOSS_RTOL.  Raises on any miss,
    after printing its line."""
    from repro_torch.data.pipeline import DataConfig, batch_for_config
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    cfg, params, info = init_full_width(CLI_ARCH, CLI_PARAMETERS,
                                        CLI_PARAMETER_BYTES)
    round_trip = checkpoint_round_trip(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    directory = tempfile.mkdtemp()
    argv = ["--arch", CLI_ARCH, "--full", "--batch", str(CLI_BATCH), "--seq",
            str(CLI_SEQ), "--ckpt-dir", directory, "--device", "cuda"]
    per_step = _train_launches(cfg)
    runs = []
    try:
        for steps in (CLI_STEPS, CLI_RESUME_STEPS):
            reset_launch_counts()
            printed = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                hist = launch.main(argv + ["--steps", str(steps)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            lines = printed.getvalue().splitlines()
            # the logged steps' clocks, each read after its step's sync
            step_s = ((hist[-1]["wall_s"] - hist[0]["wall_s"])
                      / (hist[-1]["step"] - hist[0]["step"]))
            runs.append({
                "seconds": wall, "steps_per_second": 1 / step_s,
                "tokens_per_second": CLI_BATCH * CLI_SEQ / step_s,
                "printed_steps": [int(ln.split()[1]) for ln in lines
                                  if ln.startswith("step ")],
                "losses": [h["loss"] for h in hist],
                "summary": lines[-1], "launches": launches, "steps": steps,
                "flash_launches_per_step":
                    launches["flash_attention"] / steps,
                "checkpoints": sorted(os.listdir(directory))})
        template = tr.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        _, tree, _ = ckpt.restore(directory, {"params": template},
                                  step=CLI_STEPS)
        del template
        restored = _tree_map(lambda t: t.to("cuda"), tree["params"])
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_for_config(
            cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=CLI_SEQ,
                            global_batch=CLI_BATCH), CLI_STEPS).items()}
        with torch.no_grad():
            loss, _ = tr.train_forward(restored, batch, cfg)
        loss = float(loss)
        del restored, batch, tree
    finally:
        shutil.rmtree(directory)
    gc.collect()
    torch.cuda.empty_cache()
    resumed = runs[1]["losses"][0]
    held = abs(resumed - loss) / abs(loss)

    def logged(steps):
        """The steps a run of ``steps`` logs: its first, then every 10th."""
        return [0] + list(range(9, steps, 10))
    emit("train_cli", **info, batch=CLI_BATCH, seq=CLI_SEQ,
         steps=[CLI_STEPS, CLI_RESUME_STEPS], checkpoint=round_trip,
         runs=runs, launches_per_step=per_step, resumed_loss=resumed,
         restored_no_grad_loss=loss, resumed_rel_diff=held,
         limit_loss_rtol=TRAIN_LOSS_RTOL,
         seconds=time.perf_counter() - t_phase)
    misses = [what for what, ok in (
        ("first run's steps", runs[0]["printed_steps"] == logged(CLI_STEPS)),
        ("resumed at step 100", runs[1]["printed_steps"]
         == [CLI_STEPS + s for s in logged(CLI_RESUME_STEPS)]),
        # a checkpoint every 100 steps: the resumed run writes none
        ("checkpoints", all(r["checkpoints"] == ["LATEST", "step_00000100"]
                            for r in runs)),
        ("launches", all(r["launches"]
                         == {k: r["steps"] * v for k, v in per_step.items()}
                         for r in runs)),
        ("finite losses", all(math.isfinite(x) for r in runs
                              for x in r["losses"])),
        ("one device", all(r["summary"].endswith(
            "on mesh {'data': 1, 'model': 1}") for r in runs)),
        ("resumed loss", held <= TRAIN_LOSS_RTOL)) if not ok]
    if misses:
        raise RuntimeError(f"train_cli: missed {misses}")


#: each step's record in this process (``record_step``), read and cleared
#: by the launcher's ``rank_report`` (``train_dp_report``,
#: ``tp_train_report``)
STEPS_SEEN = []


def record_step(step, params, opt_state, metrics) -> None:
    """``launch/train.py``'s ``on_step`` (called in each rank, or in this
    process on one device, after each step): the step's loss, gradient
    norm and learning rate (reading them waits for the step) and the
    clock then."""
    STEPS_SEEN.append({
        **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")},
        "step": step, "clock": time.perf_counter()})


def record_step_leaves(step, params, opt_state, metrics) -> None:
    """``record_step``, with each parameter leaf's checksum after the
    step (``tree_checksum``), by its ``keystr`` path."""
    record_step(step, params, opt_state, metrics)
    STEPS_SEEN[-1]["checksums"] = {_keystr(path): tree_checksum({"t": t})
                                   for path, t in _paths(params)}


def _steps_seen() -> list:
    seen = list(STEPS_SEEN)
    STEPS_SEEN.clear()
    return seen


def _step_seconds(steps: list) -> float:
    """Seconds a step from the recorded steps' clocks, the first step
    (warm-up) left out."""
    return ((steps[-1]["clock"] - steps[0]["clock"])
            / (steps[-1]["step"] - steps[0]["step"]))


def train_dp_report(rank, loop, params, opt_state) -> dict:
    """What ``train_dp`` reads of a rank (``launch.train.main``'s
    ``rank_report``, called in each rank after its last step, or in this
    process on one device): each step's record (``record_step``), the
    parameters' checksum, the optimizer state's bytes and the leaves it
    holds whole (a master of the parameter's shape), the kernel launches,
    the peak memory, and the bytes and seconds of the step's hops."""
    state = {k: opt_state[k] for k in ("master", "m", "v")}
    shapes = dict(_paths(params))
    whole = [path for path, t in _paths(state["master"])
             if t.shape == shapes[path].shape]
    return {"rank": rank, "steps": _steps_seen(),
            "checksum": tree_checksum(params),
            "state_bytes": _nbytes(state), "whole_leaves": whole,
            "whole_bytes": 3 * sum(4 * shapes[p].numel() for p in whole),
            "launches": launch_counts(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "hops": {k: dataclasses.asdict(v)
                     for k, v in loop.hop_stats.items()}}


def _logged(steps: int) -> list:
    """The steps the launcher logs in a run of ``steps``: its first, then
    every 10th."""
    return [0] + list(range(9, steps, 10))


def phase_train_dp() -> None:
    """smollm-135m at full width through ``launch/train.py``: DP_STEPS
    steps on one device, then the same over DP_RANKS data ranks on this
    card (``--data-parallel``: the launcher starts the gloo ranks; ZeRO-1
    state, the gradient summed in fp32, the parameters gathered).  First
    flash is held to its plain version at the ranks' shape, forward and
    backward.  Checks: the printed steps and summary, the 2-rank run's
    loss and gradient norm at step 0 and its loss at step DP_STEPS - 1
    (every step read through ``record_step``) against the one-device
    run's, every rank's parameters bit-equal, each rank's optimizer state
    at half the one-device state's plus the leaves held whole, the flash
    launches of each rank.  Raises on any miss, after printing its line.
    One card time-shares its SMs between the ranks, and gloo moves every
    hop through pinned host memory: no speed-up is expected or
    claimed."""
    from repro_torch.launch import train as launch
    t_phase = time.perf_counter()
    cfg, params, info = init_full_width(CLI_ARCH, CLI_PARAMETERS,
                                        CLI_PARAMETER_BYTES)
    del params
    rows = CLI_BATCH // DP_RANKS
    shape = (rows, CLI_SEQ, CLI_SEQ, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim(), True, 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = {"forward": flash_layout_check(gen, shape, "smollm_rank",
                                           lse=True),
             "backward": flash_backward_entry(gen, shape, "smollm_rank")}
    gc.collect()
    torch.cuda.empty_cache()
    per_step = _train_launches(cfg)
    runs = {}
    for name, extra in (("one_device", []),
                        ("data_parallel", ["--data-parallel",
                                           str(DP_RANKS)])):
        argv = ["--arch", CLI_ARCH, "--full", "--steps", str(DP_STEPS),
                "--batch", str(CLI_BATCH), "--seq", str(CLI_SEQ),
                "--device", "cuda"] + extra
        reset_launch_counts()
        STEPS_SEEN.clear()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            _, reports = launch.main(argv, rank_report=train_dp_report,
                                     on_step=record_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        steps = reports[0]["steps"]
        step_s = _step_seconds(steps)
        for r in reports:
            for hop in r["hops"].values():
                seconds = hop["host_copy_seconds"] + hop["transfer_seconds"]
                hop["bytes_per_step"] = hop["bytes"] / DP_STEPS
                hop["gb_per_s"] = (_gb_per_s(hop["bytes"], seconds)
                                   if seconds else None)
        runs[name] = {
            "seconds": wall, "step_seconds": step_s,
            "tokens_per_second": CLI_BATCH * CLI_SEQ / step_s,
            "printed_steps": [int(ln.split()[1]) for ln in lines
                              if ln.startswith("step ")],
            "summary": lines[-1],
            "history": [{k: h[k] for k in ("step", "loss", "grad_norm",
                                          "lr")} for h in steps],
            "ranks": reports}
        gc.collect()
        torch.cuda.empty_cache()
    one, dp = runs["one_device"], runs["data_parallel"]

    def rel(key, i):
        a, b = dp["history"][i][key], one["history"][i][key]
        return abs(a - b) / abs(b)
    last = f"loss_{DP_STEPS - 1}"
    diffs = {"loss_0": rel("loss", 0), "grad_norm_0": rel("grad_norm", 0),
             last: rel("loss", -1)}
    limits = {"loss_0": DP_LOSS0_RTOL, "grad_norm_0": DP_GNORM0_RTOL,
              last: DP_LOSS_LAST_RTOL}
    one_state = one["ranks"][0]["state_bytes"]
    expected = {k: DP_STEPS * v for k, v in per_step.items()}
    emit("train_dp", **info, ranks=DP_RANKS, batch=CLI_BATCH, seq=CLI_SEQ,
         steps=DP_STEPS, flash=flash, launches_per_step=per_step,
         runs=runs, rel_diffs=diffs, limits=limits,
         one_device_state_bytes=one_state,
         seconds=time.perf_counter() - t_phase)
    misses = [what for what, ok in (
        ("printed steps", one["printed_steps"] == _logged(DP_STEPS)
         and dp["printed_steps"] == _logged(DP_STEPS)),
        ("recorded steps", all(
            [h["step"] for h in run["history"]] == list(range(DP_STEPS))
            for run in runs.values())),
        ("summaries", one["summary"].endswith(
            "on mesh {'data': 1, 'model': 1}") and dp["summary"].endswith(
            f"on mesh {{'data': {DP_RANKS}, 'model': 1}}")),
        ("ranks", [r["rank"] for r in dp["ranks"]] == list(range(DP_RANKS))),
        ("loss and gradient norm", all(diffs[k] <= limits[k]
                                       for k in limits)),
        ("finite", all(math.isfinite(h[k]) for run in runs.values()
                       for h in run["history"] for k in ("loss",
                                                         "grad_norm"))),
        ("parameters bit-equal", len({r["checksum"] for r in dp["ranks"]})
         == 1),
        ("one-device state", one_state == DP_ONE_DEVICE_STATE_BYTES),
        ("ZeRO-1 state", all(
            DP_RANKS * (r["state_bytes"] - r["whole_bytes"])
            + r["whole_bytes"] == one_state for r in dp["ranks"])),
        ("launches", one["ranks"][0]["launches"] == expected and all(
            r["launches"] == expected for r in dp["ranks"])),
        ("gradient sum", all(r["hops"]["grad_sum"]["hops"] == DP_STEPS
                             for r in dp["ranks"]))) if not ok]
    if misses:
        raise RuntimeError(f"train_dp: missed {misses}")


def _keystr(path: str) -> str:
    """A ``_paths`` path (``blocks/b0/wq``) as ``keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def tp_train_sums(cfg, B: int, S: int, M: int, chunk: int = 512) -> list:
    """The bytes of a rank's tensor in each sum over the model axis that
    one train step of ``B`` x ``S`` tokens makes under dense tensor
    parallelism over ``M`` ranks, where the heads, ``d_ff`` and the
    vocabulary are cut (``models/transformer.py``, ``lm_loss``): the
    forward's embedding rows (the parameters' dtype), each layer's fp32
    attention and MLP partials, and for each chunk of the loss its row
    maxima (gathered) and its stacked sums of exponentials and target
    logits (fp32); the backward recomputes each layer (its attention sum
    again: the recompute stops before the MLP's, the last saved tensor
    coming before it) and each chunk of the loss (both again), and sums
    the gradients of the attention's and the MLP's normed inputs and of
    each chunk's hidden state (the parameters' dtype), and of ``wk``,
    ``wv`` (and their biases) where the kv heads stay whole; then the
    global norm's sums of squares of the cut leaves (fp32)."""
    isz = 2 if cfg.param_dtype == "bfloat16" else 4
    act, L, d = B * S * cfg.d_model, cfg.num_layers, cfg.d_model
    chunks = [min(chunk, S)] * (S // min(chunk, S))
    chunks += [S % min(chunk, S)] if S % min(chunk, S) else []
    loss = [n for c in chunks for n in (4 * B * c, 8 * B * c)]
    hd = cfg.resolved_head_dim()
    kv = []
    if cfg.num_kv_heads % M and cfg.num_heads % M == 0:
        kv = [d * cfg.num_kv_heads * hd * isz] * 2
        kv += [cfg.num_kv_heads * hd * 4] * 2 if cfg.qkv_bias else []
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_loop
    ctx = shd.make_ctx(Mesh((1, M), ("data", "model")))
    n_cut = sum(train_loop.cut_over_model(train_loop.model_specs(cfg, ctx),
                                          ctx))
    forward = [isz * act] + [4 * act, 4 * act] * L + loss
    recompute = [4 * act] * L + loss
    backward = ([isz * act, isz * act] * L + kv * L
                + [isz * B * c * d for c in chunks])
    return forward + recompute + backward + [4 * n_cut]


def tp_train_gathers(cfg, D: int, M: int) -> list:
    """The bytes of a rank's block in each ring hop of the parameter
    gather over the data axis that one train step over a (``D``, ``M``)
    mesh makes (``train_loop.gather_blocks``): one entry a leaf that
    ZeRO-1's spec cuts over the data axis, its block under the whole
    spec (``zero1_specs``, both axes) in the parameter's dtype; each is
    sent ``D`` - 1 times."""
    from repro_torch.convert import tree_leaves
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tr
    from repro_torch.train import train_loop
    ctx = shd.make_ctx(Mesh((D, M), ("data", "model")))
    whole = tr.init_params(cfg, torch.Generator(), "meta")
    specs = train_loop.zero1_specs(whole, cfg, ctx)["master"]

    def one(path, t, spec):
        if train_loop._data_dim(spec, ctx.data_axes) is None:
            return 0
        return (math.prod(shd.local_shape(tuple(t.shape), spec, ctx.mesh))
                * t.element_size())
    return [n for n in tree_leaves(shd.tree_map_with_path(one, whole, specs))
            if n]


def tp_train_report(rank, loop, params, opt_state) -> dict:
    """What ``tp_train`` reads of a rank (``launch.train.main``'s
    ``rank_report``; in this process on one device): each step's record
    with the checksums of its leaves (``record_step_leaves``), each
    leaf's shape and bytes beside ``sharding.local_shapes``', the state's
    bytes and each master's shape, the kernel launches, the peak memory
    and the hops of the sums over the model axis and of the data axis's
    sum and gather."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tr
    cfg, mesh = loop.model_cfg, loop.ctx.mesh
    whole = {_keystr(p): tuple(t.shape) for p, t in _paths(
        tr.init_params(cfg, torch.Generator(), "meta"))}
    local = shd.local_shapes(cfg, mesh) if mesh is not None else whole
    leaves = {}
    for path, t in _paths(params):
        key = _keystr(path)
        leaves[key] = {"shape": list(t.shape),
                       "bytes": t.numel() * t.element_size(),
                       "local_shape": list(local[key]),
                       "whole": local[key] == whole[key]}
    return {"rank": rank, "steps": _steps_seen(), "leaves": leaves,
            "state_bytes": _nbytes({k: opt_state[k]
                                    for k in ("master", "m", "v")}),
            "state_shapes": {_keystr(p): list(t.shape)
                             for p, t in _paths(opt_state["master"])},
            "launches": launch_counts(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            **{k: dataclasses.asdict(v) for k, v in loop.hop_stats.items()}}


def tp_train_state_shapes(cfg, D: int, M: int) -> dict:
    """{``keystr`` path: shape} of a rank's master (and m, v) on a (``D``,
    ``M``) mesh: ``local_shape`` of each whole leaf under ZeRO-1's whole
    spec (``zero1_specs``, the model axis and the data axes)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tr
    from repro_torch.train import train_loop
    ctx = shd.make_ctx(Mesh((D, M), ("data", "model")))
    whole = tr.init_params(cfg, torch.Generator(), "meta")
    specs = train_loop.zero1_specs(whole, cfg, ctx)["master"]
    shapes = shd.tree_map_with_path(
        lambda path, t, spec: shd.local_shape(tuple(t.shape), spec,
                                              ctx.mesh), whole, specs)
    return {_keystr(p): list(t) for p, t in _paths(shapes)}


def tp_train_fp32(loop, dev) -> dict:
    """``tp_train``'s fp32 step, in a rank of the launcher's world after
    its bf16 steps: the one-device tree of the same layers in fp32, drawn
    from SEED as the one-device loop draws it, and its gradients on one
    device; then this rank's ``param_specs`` blocks of it, the gradients
    of the loss on them under dense tensor parallelism, the whole norm
    (``optimizer.global_norm`` over the model axis, as the step takes
    it), and each leaf's gradient against its block of the one-device
    gradient: the squared error and the block's squared norm, summed over
    the model axis for a cut leaf (the gathered leaf's relative L2,
    without gathering it).  Over a data axis too, the rank takes its rows
    of the batch and its gradients and metrics are summed over the data
    axis with its share (``sum_over_data``, as the step does) before the
    norm: every data rank then holds the same summed blocks.  Returns
    host values."""
    from repro_torch.convert import tree_leaves
    from repro_torch.data.pipeline import DataConfig, batch_for_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint, optimizer, train_loop

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    marks = {"start": time.perf_counter()}
    ctx, mesh = loop.ctx, loop.ctx.mesh
    cfg = dataclasses.replace(loop.model_cfg, param_dtype="float32")
    params = tr.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_config(
        cfg, DataConfig(cfg.vocab_size, TP_TRAIN_SEQ, TP_TRAIN_BATCH),
        0).items()}
    (loss1, _), grads = train_loop.value_and_grad(cfg, params, batch)
    one = {"loss": float(loss1),
           "grad_norm": float(optimizer.global_norm(grads))}
    specs = train_loop.model_specs(cfg, ctx)
    own = checkpoint.reshard(params, shd.named(mesh, specs), dev)
    del params
    sync()
    marks["one_device"] = time.perf_counter()
    stats = coll.HopStats()
    with coll.counting(stats, stats):
        if train_loop.data_parallel(ctx):
            rows, share = train_loop._rows(batch, ctx)
            (_, metrics), got = train_loop.value_and_grad(cfg, own, rows,
                                                          ctx)
            got, metrics = train_loop.sum_over_data(got, metrics, share, ctx)
            loss = metrics["loss"]
        else:
            (loss, _), got = train_loop.value_and_grad(cfg, own, batch, ctx)
        norm = optimizer.global_norm(
            got, cut=train_loop.cut_over_model(specs, ctx),
            model_sum=lambda t: coll.psum(t, ctx.model_axis, mesh=mesh))
    sync()
    marks["step"] = time.perf_counter()

    def pair(path, g, w, spec):
        return (path, g, shd.local_shard(w, spec, mesh),
                any("model" in (e if isinstance(e, tuple) else (e,))
                    for e in spec))
    pairs = tree_leaves(shd.tree_map_with_path(pair, got, grads, specs),
                        lambda x: isinstance(x, tuple))
    sq = torch.stack([torch.stack([(g.float() - w.float()).square().sum(),
                                   w.float().square().sum()])
                      for _, g, w, _ in pairs])
    summed = coll.psum(sq, "model", mesh=mesh)
    rel = {}
    for (path, _, _, c), mine, total in zip(pairs, sq, summed):
        e, r = (total if c else mine).tolist()
        rel[path] = math.sqrt(e / max(r, 1e-30))
    whole = {path: tree_checksum({"t": g})
             for path, g, _, c in pairs if not c}
    marks["checks"] = time.perf_counter()
    return {"one_device": one, "loss": float(loss), "grad_norm": float(norm),
            "rel_l2": rel, "whole_grad_checksums": whole,
            "blocks_bytes": _nbytes(own),
            "model_sum": dataclasses.asdict(stats),
            "seconds": _spans(marks)}


def tp_train_rank_report(rank, loop, params, opt_state) -> dict:
    """``tp_train_report`` of a rank of ``--model-parallel`` (with
    ``--data-parallel``, if given), then its fp32 step
    (``tp_train_fp32``), in the world that trained it."""
    report = tp_train_report(rank, loop, params, opt_state)
    report["fp32"] = tp_train_fp32(loop, _leaves(params)[0].device)
    return report


def phase_tp_train() -> None:
    """h2o-danube-1.8b at full width, its first TP_TRAIN_LAYERS layers,
    trained over each (D, M) mesh of TP_TRAIN_MESHES of gloo ranks on
    this card: dense tensor parallelism over the model axis, and over a
    data axis too each rank's rows, the gradients summed over it and the
    AdamW state cut by ZeRO-1.  First flash is held to its plain version
    at each mesh's rank shape, forward with its lse and backward.  Then
    ``launch/train.py`` (its ``--full`` config cut to those layers)
    trains the bf16 model TP_TRAIN_STEPS steps on one device and with
    ``--data-parallel D --model-parallel M`` (every step recorded
    through ``record_step_leaves``): each step's loss and gradient norm
    against one device's within TP_TRAIN_BF16_RTOL, and bit-equal across
    the ranks with every leaf held whole; the ranks that share a model
    index bit-equal on every leaf; the printed lines; each rank's leaves
    of ``sharding.local_shapes``' shapes and its state of
    ``tp_train_state_shapes``'; the flash launches; the sums over the
    model axis against ``tp_train_sums`` at a rank's rows, the data
    axis's sums one a step and its gathers against ``tp_train_gathers``.
    Then, in the same world, one fp32 step (``tp_train_fp32``): the
    ranks' loss and gradient norm against one device's within
    TP_TRAIN_FP32_RTOL, each leaf's gradient within
    TP_TRAIN_FP32_GRAD_REL, the whole leaves' gradients bit-equal across
    the ranks.  Raises on any miss, after printing its line.  One card
    time-shares its SMs between the ranks, and gloo moves every hop
    through pinned host memory: no speed-up is expected or claimed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch

    mode = tool_output(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"]).splitlines()[0].strip()
    if mode != "Default":
        raise RuntimeError(f"compute mode {mode!r}: {TP_TRAIN_RANKS} ranks "
                           f"cannot share the card (needs 'Default')")
    marks = {"start": time.perf_counter()}
    B, S = TP_TRAIN_BATCH, TP_TRAIN_SEQ
    full = get_config(DANUBE_ARCH)
    cfg = dataclasses.replace(full, num_layers=TP_TRAIN_LAYERS)
    hd = cfg.resolved_head_dim()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = {}
    for D, M in TP_TRAIN_MESHES:
        shape = (B // D, S, S, cfg.num_heads // M, cfg.num_kv_heads // M, hd,
                 True, cfg.window)
        layout = "danube_tp_rank" if D == 1 else f"danube_{D}x{M}_rank"
        flash[f"{D}x{M}"] = {
            "forward": flash_layout_check(gen, shape, layout, lse=True),
            "backward": flash_backward_entry(gen, shape, layout)}
        gc.collect()
        torch.cuda.empty_cache()
    marks["flash"] = time.perf_counter()

    # what each mesh's ranks must hold and move, from the code, before
    # the runs
    per_step = _train_launches(cfg)
    expected = {k: TP_TRAIN_STEPS * v for k, v in per_step.items()}
    want = {}
    for D, M in TP_TRAIN_MESHES:
        sums = tp_train_sums(cfg, B // D, S, M)
        gathers = tp_train_gathers(cfg, D, M)
        state = tp_train_state_shapes(cfg, D, M)
        want[f"{D}x{M}"] = {
            "model_sum": {"hops": TP_TRAIN_STEPS * len(sums) * (M - 1),
                          "bytes": TP_TRAIN_STEPS * sum(sums) * (M - 1)},
            "grad_sum_hops": TP_TRAIN_STEPS if D > 1 else 0,
            "param_gather": {
                "hops": TP_TRAIN_STEPS * len(gathers) * (D - 1),
                "bytes": TP_TRAIN_STEPS * sum(gathers) * (D - 1)},
            "state_shapes": state,
            "state_bytes": 3 * 4 * sum(math.prod(v) for v in state.values())}

    # the bf16 steps through the launcher (its --full config cut to the
    # first layers), one device then each mesh's ranks, each rank then
    # taking the fp32 step
    argv = ["--arch", DANUBE_ARCH, "--full", "--batch", str(B), "--seq",
            str(S), "--steps", str(TP_TRAIN_STEPS), "--device", "cuda"]
    runs = {}
    for name, extra, report in [("one_device", [], tp_train_report)] + [
            (f"{D}x{M}", ["--data-parallel", str(D), "--model-parallel",
                          str(M)], tp_train_rank_report)
            for D, M in TP_TRAIN_MESHES]:
        reset_launch_counts()
        STEPS_SEEN.clear()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (contextlib.redirect_stdout(printed),
              mock.patch.object(launch, "get_config", lambda arch: cfg)):
            _, reports = launch.main(argv + extra, rank_report=report,
                                     on_step=record_step_leaves)
        torch.cuda.synchronize()
        lines = printed.getvalue().splitlines()
        for r in reports:
            for key in ("model_sum", "grad_sum", "param_gather"):
                hop = r[key]
                seconds = hop["host_copy_seconds"] + hop["transfer_seconds"]
                hop["gb_per_s"] = (_gb_per_s(hop["bytes"], seconds)
                                   if seconds else None)
        runs[name] = {
            "seconds": time.perf_counter() - t0,
            "step_seconds": [_step_seconds(r["steps"]) for r in reports],
            "printed_steps": [int(ln.split()[1]) for ln in lines
                              if ln.startswith("step ")],
            "summary": lines[-1], "ranks": reports}
        gc.collect()
        torch.cuda.empty_cache()
        marks[name] = time.perf_counter()
    one = runs["one_device"]
    one_steps = one["ranks"][0]["steps"]
    steps = list(range(TP_TRAIN_STEPS))
    fields = {}
    misses = [what for what, ok in (
        ("one device's printed steps",
         one["printed_steps"] == _logged(TP_TRAIN_STEPS)),
        ("one device's summary",
         one["summary"].endswith("on mesh {'data': 1, 'model': 1}")),
        ("one device's launches", one["ranks"][0]["launches"] == expected),
        ("one device's recorded steps",
         [s["step"] for s in one_steps] == steps)) if not ok]
    for D, M in TP_TRAIN_MESHES:
        name = f"{D}x{M}"
        tp, w = runs[name], want[name]
        first = tp["ranks"][0]
        whole = [k for k, v in first["leaves"].items() if v["whole"]]
        bf16 = [{key: abs(mine[key] - base[key]) / abs(base[key])
                 for key in ("loss", "grad_norm")}
                for mine, base in zip(first["steps"], one_steps)]
        ranks32 = [r["fp32"] for r in tp["ranks"]]
        fp32 = {"rel": [{key: abs(r[key] - r["one_device"][key])
                         / abs(r["one_device"][key])
                         for key in ("loss", "grad_norm")} for r in ranks32],
                "worst_leaf": [max(r["rel_l2"].items(), key=lambda kv: kv[1])
                               for r in ranks32],
                "ranks": [{k: v for k, v in r.items() if k != "rel_l2"}
                          for r in ranks32]}

        def seen(r, keys):
            return [{"loss": s["loss"], "grad_norm": s["grad_norm"],
                     "checksums": {k: s["checksums"][k] for k in keys}}
                    for s in r["steps"]]
        fields[name] = {
            "mesh": [D, M], "flash": flash[name], "fp32_step": fp32,
            "bf16_rel_diffs": bf16,
            "bf16_history": [{k: s[k] for k in ("step", "loss", "grad_norm",
                                                "lr")} for s in first["steps"]],
            "leaf_bytes_a_rank": {k: [v["bytes"], v["local_shape"]]
                                  for k, v in first["leaves"].items()},
            "blocks_bytes": [sum(v["bytes"] for v in r["leaves"].values())
                             for r in tp["ranks"]],
            "state_bytes": [r["state_bytes"] for r in tp["ranks"]],
            "expected_state_bytes": w["state_bytes"],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in tp["ranks"]],
            "hops": [{k: r[k] for k in ("model_sum", "grad_sum",
                                        "param_gather")}
                     for r in tp["ranks"]],
            "expected_hops": {k: w[k] for k in ("model_sum", "grad_sum_hops",
                                                "param_gather")},
            "run": {k: v for k, v in tp.items() if k != "ranks"}}
        misses += [f"{name}: {what}" for what, ok in (
            ("printed steps", tp["printed_steps"] == _logged(TP_TRAIN_STEPS)),
            ("summary", tp["summary"].endswith(
                f"on mesh {{'data': {D}, 'model': {M}}}")),
            ("ranks", [r["rank"] for r in tp["ranks"]] == list(range(D * M))),
            ("recorded steps", all([s["step"] for s in r["steps"]] == steps
                                   for r in tp["ranks"])),
            ("fp32 loss and gradient norm", all(
                v <= TP_TRAIN_FP32_RTOL for d in fp32["rel"]
                for v in d.values())),
            ("fp32 gradients", all(v <= TP_TRAIN_FP32_GRAD_REL
                                   for r in ranks32
                                   for v in r["rel_l2"].values())),
            ("fp32 whole gradients bit-equal", all(
                r["whole_grad_checksums"] == ranks32[0]["whole_grad_checksums"]
                for r in ranks32) and ranks32[0]["whole_grad_checksums"]),
            ("bf16 loss and gradient norm", all(
                v <= TP_TRAIN_BF16_RTOL for d in bf16 for v in d.values())),
            ("finite", all(math.isfinite(s[k]) for r in tp["ranks"]
                           for s in r["steps"] for k in ("loss", "grad_norm"))),
            ("whole leaves bit-equal on every rank after each step", whole and
             all(seen(r, whole) == seen(first, whole) for r in tp["ranks"])),
            ("ranks of a model index bit-equal after each step", all(
                seen(r, r["leaves"]) == seen(tp["ranks"][i % M], r["leaves"])
                for i, r in enumerate(tp["ranks"]))),
            ("local shapes", all(v["shape"] == v["local_shape"]
                                 for r in tp["ranks"]
                                 for v in r["leaves"].values())),
            ("ZeRO-1 state", all(
                r["state_shapes"] == w["state_shapes"]
                and r["state_bytes"] == w["state_bytes"]
                for r in tp["ranks"])),
            ("launches", all(r["launches"] == expected for r in tp["ranks"])),
            ("sums over the model axis", all(
                {k: r["model_sum"][k] for k in ("hops", "bytes")}
                == w["model_sum"] for r in tp["ranks"])),
            ("sums over the data axis", all(
                r["grad_sum"]["hops"] == w["grad_sum_hops"]
                for r in tp["ranks"])),
            ("gathers over the data axis", all(
                {k: r["param_gather"][k] for k in ("hops", "bytes")}
                == w["param_gather"] for r in tp["ranks"]))) if not ok]
    emit("tp_train", config=cfg.name,
         layers=f"the first {TP_TRAIN_LAYERS} of {full.num_layers}",
         ranks=TP_TRAIN_RANKS, batch=B, seq=S, steps=TP_TRAIN_STEPS,
         backend="gloo", compute_mode=mode, launches_per_step=per_step,
         limits={"fp32_rtol": TP_TRAIN_FP32_RTOL,
                 "fp32_grad_rel_l2": TP_TRAIN_FP32_GRAD_REL,
                 "bf16_rtol": TP_TRAIN_BF16_RTOL},
         one_device={
             "bytes": sum(v["bytes"]
                          for v in one["ranks"][0]["leaves"].values()),
             "history": [{k: s[k] for k in ("step", "loss", "grad_norm",
                                            "lr")} for s in one_steps],
             **{k: v for k, v in one.items() if k != "ranks"}},
         meshes=fields, misses=misses,
         spans=_spans(marks), seconds=time.perf_counter() - marks["start"])
    if misses:
        raise RuntimeError(f"tp_train: missed {misses}")


def phase_replay(params, cfg) -> None:
    """The paper's scheduler end to end: the port's fleet simulator
    records the golden workload's decision trace, every plan is
    re-derived from it, and the first REPLAY_RECORDS dispatch records run
    through a fresh full-width engine (cold cache, int8 wire) on the
    serve's weights.  At full width the engine's grid is the simulator's
    (50 iterations, stride 5): each record keeps its own key."""
    import tempfile
    from repro_torch.core.cost_model import CostParams
    from repro_torch.core.transport import LOCAL_LINK, wire_nbytes
    from repro_torch.kernels import int8_quant
    from repro_torch.serving.engine import DiffusionSplitEngine
    from repro_torch.serving.fleet_sim import SimConfig, run_fleet_sim
    from repro_torch.serving.replay import (read_trace,
                                            replay_through_engine,
                                            scaled_group_key,
                                            verify_decisions)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        sim = run_fleet_sim(SimConfig(trace_out=path, **REPLAY_CELL))
        trace = read_trace(path)
    decisions = verify_decisions(trace)
    if (decisions.n_plans, decisions.n_replans, len(decisions.mismatches),
            sim.n_arrivals) != (REPLAY_PLANS, 0, 0, REPLAY_PLANS):
        raise RuntimeError(f"decision trace: {decisions.to_json()}, "
                           f"{sim.n_arrivals} arrivals")
    sim_n_total = int(trace.header["planner"]["params"]["n_total"])
    records = trace.dispatches()[:REPLAY_RECORDS]
    keys = [scaled_group_key(r, sim_n_total, cfg.n_total_iterations,
                             cfg.split_stride) for r in records]
    if keys != [(r["n_final"], r["batch"]) for r in records]:
        raise RuntimeError(f"engine keys {keys} are not the records' own")

    cost = CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                      n_step=cfg.split_stride, t_lim=5.0, k_decode=1.0)
    engine = DiffusionSplitEngine(params, cfg, cost, link=LOCAL_LINK,
                                  wire="int8", device="cuda")
    reset_launch_counts()
    int8_quant.launch_count = 0
    t0 = time.perf_counter()
    report = replay_through_engine(trace, engine=engine,
                                   max_records=REPLAY_RECORDS)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    int8_launches = int8_quant.launch_count
    others = launch_counts()

    latent = (cfg.latent_channels, cfg.latent_size, cfg.latent_size)
    context = (2, cfg.text_len, cfg.text_width)
    faults = []
    if report.executed != len(records):
        faults.append(f"executed {report.executed} of {len(records)}")
    if report.executable_bound != 11:
        faults.append(f"executable bound {report.executable_bound}")
    if report.measured_executables != report.modeled_executables:
        faults.append("executables: measured "
                      f"{report.measured_executables}, modeled "
                      f"{report.modeled_executables}")
    if report.measured_executables != len(set(keys)):
        faults.append(f"{report.measured_executables} executables for "
                      f"{len(set(keys))} keys")
    if report.measured_hit_rate != report.modeled_hit_rate:
        faults.append(f"hit rate: measured {report.measured_hit_rate}, "
                      f"modeled {report.modeled_hit_rate}")
    shipped = 0
    for g in report.groups:
        shapes = {"latent": latent}
        if g.n_scaled < cfg.n_total_iterations:
            shapes["context"] = context
        want = wire_nbytes(shapes, "int8")
        if not g.measured_bytes == g.modeled_bytes == want:
            faults.append(f"group {(g.n_scaled, g.batch)}: measured "
                          f"{g.measured_bytes} B, modeled "
                          f"{g.modeled_bytes} B, closed form {want} B")
        shipped += want * g.batch * g.executions
    if report.bytes_shipped != shipped or report.bytes_overhead != 0.0:
        faults.append(f"{report.bytes_shipped} B shipped, {shipped} B "
                      f"closed form")
    if report.requests != sum(r["batch"] for r in records):
        faults.append(f"{report.requests} requests served")
    if int8_launches != report.executed or any(others.values()):
        faults.append(f"int8 launched {int8_launches} times for "
                      f"{report.executed} dispatches; others {others}")
    if not all(math.isfinite(g.measured_s) and g.measured_s > 0
               for g in report.groups):
        faults.append("a group has no measured seconds")
    if faults:
        raise RuntimeError("replay: " + "; ".join(faults))
    del engine
    emit("replay", workload=REPLAY_CELL, arrivals=sim.n_arrivals,
         trace_records=len(trace.records),
         decisions={"plans": decisions.n_plans,
                    "replans": decisions.n_replans,
                    "mismatches": len(decisions.mismatches)},
         dispatches=report.n_dispatches, executed=report.executed,
         skipped=report.skipped,
         executables={"modeled": report.modeled_executables,
                      "measured": report.measured_executables,
                      "bound": report.executable_bound},
         hit_rate={"modeled": report.modeled_hit_rate,
                   "measured": report.measured_hit_rate},
         gpu_seconds=report.gpu_seconds,
         compile_seconds=report.compile_seconds,
         bytes_shipped=report.bytes_shipped, requests=report.requests,
         calibration_ratio=report.calibration_ratio,
         max_rel_dev=report.max_rel_dev,
         groups=[{"n_scaled": g.n_scaled, "batch": g.batch,
                  "executions": g.executions, "measured_s": g.measured_s,
                  "modeled_s": g.modeled_s,
                  "payload_bytes": g.measured_bytes}
                 for g in report.groups],
         int8_launches=int8_launches, replay_seconds=replay_s,
         seconds=time.perf_counter() - t_phase)


def phase_regnet() -> None:
    """RegNet-Y-128GF at full width on the card: the forward of one
    384 x 384 image, and at each split point of paper Table 1 the cloud's
    half, the activation through the host (the shipped bytes) and the
    device's half, held to the forward; then each segment and the forward
    timed at batch 1 and 8.  Its convolutions are cuDNN's (fp32, TF32
    off): no hand kernel is on this path."""
    from repro_torch.configs import regnet_y_128gf
    from repro_torch.convert import tree_map
    from repro_torch.models import regnet
    cfg = regnet_y_128gf.CONFIG
    t_phase = time.perf_counter()
    reset_launch_counts()
    params = regnet.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    leaves = []
    tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if (n_params, n_bytes) != (REGNET_PARAMETERS, REGNET_PARAMETER_BYTES):
        raise RuntimeError(f"RegNet: {n_params} parameters in {n_bytes} B")
    table = regnet.split_activations(cfg)
    if {name: b for name, _, b in table} != REGNET_TABLE1_BYTES:
        raise RuntimeError(f"split_activations {table}")

    torch.cuda.reset_peak_memory_stats()
    size = cfg.image_size
    images = torch.randn((max(REGNET_BATCHES), 3, size, size),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED), device="cuda")
    logits = regnet.forward(params, cfg, images[:1])
    if (tuple(logits.shape) != (1, cfg.num_classes)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"logits {tuple(logits.shape)}, finite "
                           f"{bool(torch.isfinite(logits).all())}")
    scale = float(logits.abs().max())
    limit = REGNET_SPLIT_RTOL * scale
    splits = []
    for name, shape, nbytes in table:
        act = regnet.run_from(params, cfg, images[:1], "input", name)
        shipped = act.cpu()
        if (tuple(shipped.shape) != shape
                or shipped.numel() * shipped.element_size() != nbytes):
            raise RuntimeError(f"{name}: activation {tuple(shipped.shape)}")
        out = regnet.run_from(params, cfg, shipped.to("cuda"), name,
                              "logits")
        err = float((out - logits).abs().max())
        if not err <= limit:
            raise RuntimeError(f"split at {name}: logits off by {err} > "
                               f"{limit}")
        splits.append({"point": name, "shape": list(shape),
                       "bytes": nbytes, "max_abs_err": err})

    order = ("input",) + regnet.SPLIT_POINTS + ("logits",)
    timings = []
    for B in REGNET_BATCHES:
        x = images[:B]
        segments = {}
        for start, stop in zip(order, order[1:]):
            nxt = regnet.run_from(params, cfg, x, start, stop)
            segments[stop] = time_ms(
                lambda x=x, start=start, stop=stop:
                regnet.run_from(params, cfg, x, start, stop),
                inner=1, samples=5)
            x = nxt
        if B > 1:
            # image 0 alone and in the batch: the same logits
            err = float((x[:1] - logits).abs().max())
            if not err <= limit:
                raise RuntimeError(f"batch {B}: image 0's logits off by "
                                   f"{err} > {limit}")
        fwd_ms = time_ms(lambda B=B: regnet.forward(params, cfg, images[:B]),
                         inner=1, samples=5)
        timings.append({
            "batch": B, "forward_ms": fwd_ms, "segments_ms": segments,
            "tflop_per_s": REGNET_FLOPS_PER_IMAGE * B / fwd_ms / 1e9,
            "fp32_peak_share": (REGNET_FLOPS_PER_IMAGE * B / (fwd_ms / 1e3)
                                / FP32_FLOP_PER_S)})
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"hand kernels launched on RegNet's path: "
                           f"{launches}")
    del params
    emit("regnet", config=cfg.name, parameters=n_params,
         parameter_bytes=n_bytes, init_seconds=init_s,
         image_size=size, logit_scale=scale, split_rtol=REGNET_SPLIT_RTOL,
         splits=splits, timings=timings,
         flops_per_image=REGNET_FLOPS_PER_IMAGE, peak_memory_bytes=peak,
         seconds=time.perf_counter() - t_phase)


def phase_calibrate(measured: dict, smi: str) -> None:
    """The port's dry run over every (arch, shape cell): host arithmetic
    on meta tensors, one record each, OK or the reference's SKIP.  Then
    each step of CALIBRATION_STEPS counted at its shape: its FLOPs and
    bytes, their times on the H100, the rate the roofline gives there
    (``r_cloud_est["h100"]``), the rate measured above (no step runs
    again), their ratio ``calibration_ratio`` and model FLOPs over peak
    over the measured seconds.  The capacity artifact is written from
    the records with their rates scaled by their ratios, and read back
    through ``CloudCapacity.from_json``."""
    from repro_torch.configs import ShapeCell
    from repro_torch.core.capacity import CloudCapacity
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS,
                                               r_cloud_estimates)
    t0 = time.perf_counter()
    records = dryrun.sweep()
    sweep_s = time.perf_counter() - t0
    skips = [f"{r['arch']}/{r['cell']}" for r in records
             if "SKIP" in r["status"]]
    failed = [r for r in records
              if r["status"] != "OK" and "SKIP" not in r["status"]]
    if (len(records), len(skips), failed) != (DRYRUN_RECORDS, DRYRUN_SKIPS,
                                              []):
        raise RuntimeError(f"calibrate: the dry run gave {len(records)} "
                           f"records, {len(skips)} SKIPs, failures "
                           f"{failed}")
    steps, calibrated = [], []
    for key, arch, (kind, seq, batch), kw in CALIBRATION_STEPS:
        seconds = measured[key]
        cell = ShapeCell(f"{arch}_{kind}_{batch}x{seq}", seq, batch, kind)
        rec = dryrun.analyze_cell(arch, cell, **kw)
        flops, byts = rec["flops_per_device"], rec["hlo_bytes_per_device"]
        est = r_cloud_estimates(flops, byts)["h100"]
        ratio = (1.0 / seconds) / est
        steps.append({
            "step": key, "arch": arch, "cell": cell.name, **kw,
            "flops": flops, "bytes": byts,
            "t_compute_s": flops / PEAK_FLOPS,
            "t_memory_s": byts / HBM_BW, "dominant": rec["dominant"],
            "r_cloud_est_h100": est, "seconds_measured": seconds,
            "r_cloud_measured": 1.0 / seconds, "calibration_ratio": ratio,
            "model_flops": rec["model_flops_per_device"],
            "model_flops_share_of_peak": rec["model_flops_per_device"]
            / PEAK_FLOPS / seconds,
            "components": rec["components"]})
        calibrated.append(dict(
            rec, step_time_measured_s=seconds, r_cloud_measured=1.0 / seconds,
            calibration_hw="h100", calibration_ratio=ratio,
            r_cloud_est={k: v * ratio for k, v in rec["r_cloud_est"].items()}))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "capacity.json")
        n_classes = dryrun.write_capacity(calibrated, path)
        with open(path) as f:
            capacity = CloudCapacity.from_json(json.load(f))
    h100 = capacity["h100"].r_cloud
    emit("calibrate", card=smi, dryrun_records=len(records),
         dryrun_seconds=sweep_s, skips=skips,
         dominant={f"{r['arch']}/{r['cell']}": r["dominant"]
                   for r in records if r["status"] == "OK"},
         steps=steps, limit_calibration_ratio=CALIBRATION_RATIO_MAX,
         capacity_classes=n_classes,
         capacity_rates={c.name: c.r_cloud for c in capacity.classes},
         capacity_h100_rate=h100)
    for s in steps:
        if not (math.isfinite(s["calibration_ratio"])
                and 0 < s["calibration_ratio"] <= CALIBRATION_RATIO_MAX):
            raise RuntimeError(f"calibrate: {s['step']}: calibration ratio "
                               f"{s['calibration_ratio']} outside (0, "
                               f"{CALIBRATION_RATIO_MAX}]")
    if n_classes != 4 or not (math.isfinite(h100) and h100 > 0):
        raise RuntimeError(f"calibrate: the capacity read back holds "
                           f"{n_classes} classes, h100 at {h100}")


#: the keys of a kernel in the kernels line: this run's measurements, its
#: launches on the main path and its bound; the phase lines carry the rest
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")


def kernels_line(*entries) -> list:
    """Each kernel's entry cut to KERNEL_LINE_KEYS; raises if one lacks a
    key or was launched no time on the main path."""
    line = []
    for e in entries:
        missing = [k for k in KERNEL_LINE_KEYS if k not in e]
        if missing or not e["launches"]:
            raise RuntimeError(f"{e.get('name')}: missing {missing} or "
                               f"launched {e.get('launches')} times")
        line.append({k: e[k] for k in KERNEL_LINE_KEYS})
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    import repro_torch  # noqa: F401  (sets the TF32 flags)

    with torch.inference_mode():
        smi = phase_env()
        phase_build()
        kernel_entry = phase_kernels()
        served = phase_serve(kernel_entry)
        phase_device(*served)
        phase_replay(served[0], served[1])
        del served
        torch.cuda.empty_cache()
        lm_entries = phase_lm_kernels()
        cloud, device, prompts = phase_lm_serve(lm_entries)
        phase_lm_profile(cloud, device, prompts)
        phase_model_decode("lm_decode", cloud.cfg, cloud.params, prompts)
        torch.cuda.empty_cache()
        phase_tp_recurrentgemma(cloud.cfg, cloud.params)
        del cloud, device
        gc.collect()                 # RecurrentGemma's 15 GB of weights
        torch.cuda.ipc_collect()     # once the ranks released them
        torch.cuda.empty_cache()
        ssd_entry = phase_ssd_kernels()
        mamba = phase_mamba_serve(ssd_entry)
        phase_model_decode("mamba_decode", *mamba)
        torch.cuda.empty_cache()
        phase_tp_mamba(*mamba[:2])
        del mamba
        gc.collect()                 # Mamba-2's 1.7 GB of weights
        torch.cuda.ipc_collect()     # once the ranks released them
        torch.cuda.empty_cache()
        decode_entry = phase_decode_kernels()
        measured = {}
        qwen2 = phase_decode_serve(decode_entry,
                                   lm_entries["flash_attention"], measured)
        phase_decode_profile(*qwen2)
        qwen2 = qwen2[:2]            # its config and weights, cache freed
        torch.cuda.empty_cache()
        phase_pipeline_qwen2(*qwen2)
        phase_tp_qwen2(*qwen2)
        del qwen2
        gc.collect()                 # Qwen2-7B's 15 GB of weights
        torch.cuda.ipc_collect()     # once the ranks released them
        torch.cuda.empty_cache()
        olmoe = phase_moe_serve()
        phase_moe_decode(*olmoe)
        torch.cuda.empty_cache()
        phase_moe_sharded(*olmoe[:2])
        del olmoe
        gc.collect()                 # OLMoE-1B-7B's 13.8 GB of weights
        torch.cuda.ipc_collect()     # once the ranks released them
        torch.cuda.empty_cache()
        encdec_entries = phase_encdec_kernels()
        encdec = phase_encdec_serve(encdec_entries)
        phase_encdec_decode(*encdec, encdec_entries)
        torch.cuda.empty_cache()
        phase_tp_seamless(*encdec[:2])
        del encdec
        gc.collect()                 # seamless-m4t-medium's 1.8 GB
        torch.cuda.ipc_collect()     # once the ranks released them
        torch.cuda.empty_cache()
        phase_frontend_serve()
        gc.collect()                 # internvl2-1b's 1.3 GB
        torch.cuda.empty_cache()
        phase_swa_ring_decode()
        phase_regnet()
    # training saves tensors for backward, which inference tensors cannot
    # be: these phases build everything outside inference mode
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_kernels()
    measured["train_danube"] = phase_train(
        "train_danube", DANUBE_ARCH, DANUBE_PARAMETERS,
        DANUBE_PARAMETER_BYTES, "flash_attention")
    measured["train_mamba"] = phase_train(
        "train_mamba", TRAIN_SSD_ARCH, SSD_PARAMETERS, SSD_PARAMETER_BYTES,
        "ssd_scan")
    phase_train_cli()
    phase_train_dp()
    phase_tp_train()
    phase_calibrate(measured, smi)
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels_line(
        kernel_entry, lm_entries["flash_attention"], lm_entries["rglru_scan"],
        ssd_entry, decode_entry)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
