#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed S]

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once; ``ptxas -v`` of the flash-attention,
wave-timer, XOR, fused-reduce, segment-sum, histogram, sketch and dispatch
libraries is printed, the last six must not spill, the flash library's
SASS must hold HGMMA,
and the SASS of the histogram's and the sketch's mask instances must add
with native shared integer atomics and hold no compare-and-swap loop),
holds each kernel against its plain PyTorch version at the shapes its
path gives it and times both (the histogram and the sketch in both
instances: the mask on the validity mask, bitwise, and the float one on
the same 0/1 weights, bitwise, and on random weights within rtol 1e-4,
each timed as device time from a burst behind a spin and with CUDA
events around one call, and every pair on one hot id, bitwise; the fused
reduce's sums and counts at every chunk of a real plan, and its sums on
normals unchanged by padding appended to or put in front of chunk 0's
stream; the sorted segment-sum at chunk 0's rows in rank order, equal to
the fused reduce bit for bit on normals and unchanged by padding, timed
beside ``index_add_`` and ``torch.segment_reduce``; the XOR kernel's
encode instance beside the three passes it
replaced, and its flat instance beside ``torch.bitwise_xor``), then
drives six paths of ``MapReduceJob`` (``scheduler="os4m"``,
``pipeline_chunks=4``) on full-size batches and checks every output
against a numpy oracle:

* the main path: exact statistics (the histogram's mask instance on the
  validity mask), three batches, pipelined == sequential;
* the reuse path: ``reuse=ReusePolicy()`` over the same three batches
  (batch 0 plans, the others replay the cached plan), then the plan's
  JSON snapshot loaded into a fresh job replays batch 0;
* the sketch path: ``stats="sketch"`` (4 x 1024 count-min cells a slot)
  at n = 2^17 clusters on batch 0, without and with ``stream_prefix=0.25``
  (three runs, with the allocator's retries), and with the prefix on the
  first half of batch 0's streams and on a copy of it whose tail overflows
  the wave that its prefix committed, so that the escape hatch re-executes
  phase B;
* the measured path: the sharded backend (one program and one CUDA stream
  per slot, 32 streams on the one card) on batches 0-2 at the main path's
  size, untimed (== oracle, == the main path's output and plan), then with
  ``estimate_speeds=True, measure_timings=True`` (per-slot wave clocks from
  the %globaltimer stamp kernels): three batches, then three more with slot
  0 slowed 2x, whose speed estimate and planned load must fall; then the
  stamp kernels at its shapes, ``read_ticks`` beside an empty kernel's
  time a launch under the same burst timer (the launch floor, its bound);
* the elastic path (stacked unless named): a fused and a
  ``checkpoint_waves=True`` job replay the main path's plan of batch 0 in
  turns (== each other and the oracle, bit for bit; the walk's fence
  priced in phase-B ms); batch 0 with slot 5 killed before wave 2 (waves
  0-1 checkpointed, the residue re-planned onto 31 slots and replayed in
  2 waves, == oracle, slot 5 given no load; kernel 2 launched once a
  walked and once a replayed wave; peak memory); batch 1 replanned for
  the dead slot (reason ``slot_dead``); ``resize(24)`` re-projecting the
  snapshot, batch 1's pairs re-sliced into 24 shards replaying it (==
  oracle), ``resize(32)`` back; then on the sharded backend (32 streams)
  the same kill (== the stacked run, bit for bit) and
  ``resize(24, devices=...)`` with one batch;
* the multi-job path: ``MultiJobCoordinator`` on the 32-slot mesh with
  two tenants at full width, II (batches 0-1, weight 1) and PUMA SelfJoin
  (Zipf 0.40 over 150,000 keys, 13 values a pair, two batches from seeds
  seed+1000 and seed+1001, weight 2), each under ``ReusePolicy()``: solo
  runs, then ``run_queue`` in WSPT and in FIFO order and
  ``run_interleaved``, every result == its solo run == its oracle, bit for
  bit, the tenants' caches never colliding; the completions, the
  measured and planned sum w*C and the coschedule overlap are printed;
* the coded path: Coded MapReduce's r = 2 XOR multicast shuffle on the
  paper's 8 nodes (m = 8, one Reduce slot each; n =
  recommended_num_clusters(8) = 88) over slots 0-7 of batch 0, the first
  K = 2^20 pairs of each: uncoded (oracle, bitwise), coded (== uncoded,
  bitwise), coded with a sequential phase B (== coded), uncoded and coded
  with an int8 wire (== each other; within 1e-4 of a float64 oracle of the
  dequantized pairs) and coded with an fp8 wire (exact for {0, 1, 2}:
  == uncoded), and the coded run once more on ``backend="sharded"`` (8
  slot programs and streams; == the stacked coded run and the oracle,
  equal wire and replication bytes, kernels 1, 2 and 7 launched once a
  slot where the stacked run launches them once, phase B printed beside
  the stacked one). Cut from m = 32 and K = 2^21 because the coded spills hold
  m^3 * sum(cap2) rows of W + 2 words: about 300 GB at m = 32, and at m = 8
  and K = 2^21 two 15.9 GB spills and a peak near 75 GB.

Then it frees the card and adds the serving side:

* kernel phase 9: the flash-attention kernel at the serve path's longest
  prefill (B = 8 lanes, Hq = 32, Hkv = 8, T = S = the longest prompt, D =
  128, bf16; tolerance 3e-2) and at sixteen more shapes of its two
  instances (wgmma: ragged T < S, T > S whose rows that see no key give
  exact 0, GQA groups 1, 4 and 8, D = 64, non-causal, and grok-1's 48
  query and 8 KV heads at the MoE engine's longest admission, at a ragged
  T and at the MoE placement prefills' B = 8; simt: f32 with T <
  S, at D = 20 and with T > S, tolerance 2e-5, and bf16 at D = 256), timed
  beside its plain version, its simt instance and
  ``scaled_dot_product_attention`` (device time from a burst behind a spin,
  and CUDA events around one call); and at the family paths' shapes, each
  timed beside ``scaled_dot_product_attention``: MLA's prefill (8, 128, 128,
  512, 512, 192) causal on the simt instance, whisper's encoder (8, 8, 8,
  1500, 1500, 64) and cross-attention (8, 8, 8, 32, 1500, 64) non-causal and
  qwen2-vl's (8, 28, 4, 512, 512, 128) causal on the wgmma instance;
* kernel phase 8: the dispatch-rank kernel at T = 2^20 tokens and E = 64,
  160 and 1,024 Zipf-skewed destinations with 2% padding, ranks and counts
  equal to the plain version exactly (its own entry point: no engine path
  runs it);
* the serve path: ``Engine`` on Llama-3-8B at full width and depth (16.1
  GB of bf16 weights from ``torch.Generator`` seed ``--seed``,
  ``attn_impl="pallas"``), 8 lanes, ``max_len`` 1024, 16 requests with
  prompts of 128-512 tokens and decode budgets clip(zipf(1.5) * 4, 4, 64):
  every request served within its budget, the lane plan equal to the host
  scheduler's, the flash kernel's wgmma instance launched once a layer in
  every prefill;
  then 20 decode steps under the profiler, and a 2-layer full-width
  float32 twin run with "pallas" (the simt instance) and with "naive"
  attention, whose token streams must agree (a stream that differs is
  reported with its top-2
  logit margin, and fails the run if that margin is above 1e-3);
* the launcher: ``python -m repro_torch.launch.serve --arch smollm-360m``
  at its defaults (``--attn-impl pallas``), as a subprocess; its prefills
  must launch the flash kernel;
* the MoE path (the serve path's model freed first): grok-1-314b
  (hf:xai-org/grok-1) at full width (d_model 6144, 48 heads, 8 KV heads,
  8 experts top-2 of d_ff 32768, vocab 131072, bf16), depth cut from 64
  to 4 layers (42.6 GB of weights from seed ``--seed``), its experts over
  4 expert slots stacked on the card (2 a slot): a prefill of 8 prompts of
  512 tokens drawn Zipf(1.3) over the vocabulary under the default
  placement, the OS4M expert balancer's re-plan of every layer with the
  expert weights moved to match, and the same prefill again (logits
  bit-equal, the same expert counts, no overflow in either at a
  dropless capacity; per-slot loads and balance ratios printed before and
  after); then ``Engine`` serving 8 requests of 128-512 prompt tokens on 4
  lanes with ``attn_impl="pallas"`` (every prefill layer through the flash
  kernel's wgmma instance), 20 decode steps under the profiler, and a
  2-layer float32 twin at full width served on the card and on the CPU
  with the same weights, whose token streams must be equal. Only the flash
  kernel runs on this path;
* the whisper path: whisper-base (openai/whisper base) at full width and
  depth (6 encoder and 6 decoder layers, d_model 512, 8 heads, 1500
  frames, vocab 51865, bf16), ``Engine`` on 8 lanes with max_len 448
  serving 16 requests of 4-32 prompt tokens with (lanes, 1500, 512) normal
  frames as ``extra_embed``: kernel 9's wgmma instance in every encoder
  layer (non-causal, 1500 x 1500), decoder layer and cross-attention
  (prompt x 1500, non-causal) of every prefill; 20 decode steps under the
  profiler; a float32 twin (2 + 2 layers) served on the card and the CPU
  with equal token streams;
* the VLM path: qwen2-vl-7b (hf:Qwen/Qwen2-VL-7B-Instruct) at full width
  and depth (28 layers, 15.2 GB of bf16 weights), 256 patch embeddings and
  M-RoPE sections (16, 24, 24): a prefill of 8 x (256 patches + 256 text
  tokens) and 16 decode steps at n_patches + p + i held against the
  train-mode forward of the whole stream (relative L2 within 5e-2; the
  float32 twin's argmax tokens equal), then ``Engine`` with the patches as
  ``extra_embed`` on 8 lanes, 16 requests (the reference's semantics:
  decoding continues at the prompt's length), kernel 9's wgmma instance at
  a GQA group of 7; 20 decode steps under the profiler; the twin on the
  card and the CPU;
* the MLA path: deepseek-v2-236b (hf:deepseek-ai/DeepSeek-V2) at full
  width (d_model 5120, 128 heads, MLA 512 / 1536 / 128 + 64 / 128, 160
  experts top-6 of d_ff 1536 with 2 shared, a first dense layer of d_ff
  12288, vocab 102400, bf16), depth cut from 60 to 5 layers (1 dense + 4
  MoE), its experts over 4 expert slots (40 a slot): a prefill of 8 Zipf
  prompts of 512 tokens at the config's capacity factor (its overflow
  recorded), then at the factor that lets an expert keep every token under
  the default placement, the balancer's re-plan with the weights moved and
  the OS4M placement (logits bit-equal, overflow 0, slot balance printed);
  MLA's compressed cache beside the GQA cache it replaces; ``Engine`` on 4
  lanes, 8 requests (absorbed decode), kernel 9's simt instance at D = 192
  in every prefill layer; 20 decode steps under the profiler; a 2-layer
  float32 twin on the card and the CPU with equal token streams.

Last, the training path (``repro_torch.train``), which launches none of
the nine kernels (kernel 9 has no backward; training attends with the
blocked path and its own backward):

* dense: smollm-360m (hf:HuggingFaceTB/SmolLM) at full width and depth
  (32 layers, d_model 960, 15 / 5 heads, d_ff 2560, vocab 49152), bf16
  weights, float32 AdamW moments, remat, 20 steps of 8 x 1024 tokens of
  the synthetic corpus packed by the OS4M scheduler, a checkpoint at step
  10 (keep 1, in a temporary directory): every loss finite, step 20's
  below step 1's, the step time (steps 2-9), tokens/s and peak memory;
  steps 11-20 run under deterministic algorithms, and a fresh ``Trainer``
  resumed from step 10 repeats them with losses bit-equal (within 1e-3
  with the ops named if any has no deterministic CUDA path), the
  checkpoint's bf16 weights bit-equal, and a step that raises once at
  step 15 is restored from step 10 and retried with the reference's step
  counting (its steps 11-14 repeat the first run's likewise); the resumed
  trainer then runs steps 21-30 under the profiler without deterministic
  algorithms (idle share);
* the launcher: ``python -m repro_torch.launch.train --arch smollm-360m
  --full --steps 20 --batch 8 --seq 1024`` as a subprocess (the
  reference's log lines, a final checkpoint), then ``--resume``;
* MoE: deepseek-v2-236b at full width, depth cut from 60 to 2 layers (1
  dense + 1 MoE, 5.36 G parameters), experts over 4 slots (40 a slot),
  bf16 weights and bf16 moments (the reference's knob for this config),
  whether two backward passes give the same gradient bits (without and
  with deterministic algorithms), then 30 steps of 4 x 512 Zipf(1.3)
  tokens at the config's capacity factor (overflow recorded) with the
  balancer re-planning every 10 steps: at each re-plan a probe batch,
  without grad at a capacity that keeps every token, gives logits
  bit-equal before and after the weight move; balance ratios, per-slot
  loads, re-plan and weight-move ms, step time, peak memory, idle share
  (steps 21-29 under the profiler);
* float32 twins trained on the card and on the CPU from the same weights
  and batches (TF32 off): smollm-360m at full width and 2 layers, 5
  steps of 2 x 128, and deepseek-v2's smoke twin at 4 expert slots, 10
  steps with a re-plan every 5: losses and grad norms within 1e-4
  relative, final parameters within TWIN_PARAM_ATOL, placements equal (a
  differing one is reported with the router's top-k margin and fails the
  run above 1e-4); each step's gradients are logged on both sides to show
  where the parameters differ most, and two card runs of the dense twin
  with a known fault (TF32 matmuls, bf16 compute) must differ from the CPU
  by more than TWIN_PARAM_ATOL.

Then the state-based families, the model entry points (``forward`` in
prefill, decode and train modes) and the ``Trainer``, as the reference
drives them (its serving engine refuses them):

* the zamba2 path: zamba2-2.7b (arXiv:2411.15242) at full width (d_model
  2560, 80 SSM heads of 64, state 64; a shared attention + MLP block of 32
  heads of 80 after every 6 layers, one set of weights), its depth cut
  from 54 Mamba2 layers (9 groups, 2.42 G parameters) to 24 (4 groups) so
  that the script stays inside its time, attn_impl="pallas":
  a prefill of 8 prompts of 1000 tokens (off the 128-token SSD chunk), 24
  greedy decode steps from the returned state held against the train-mode
  forward of the 1024-token stream, and in float32 compute on the same
  weights (relative L2 within 1e-3; the bf16 decode within twice the bf16
  forward's distance from the float32 one), the state's bytes, 20 more
  decode steps and one Mamba2 layer at 8 x 1024 under the profiler, 3
  ``Trainer`` steps of 8 x 1024 os4m-packed tokens (blocked attention,
  remat, float32 moments, lr 3e-5; finite losses, the last below the
  first, step ms, tokens/s, peak GB); kernel 9's simt instance once a
  group in every prefill and full forward (bf16 and float32); a float32
  twin (2 groups) on the card and the CPU: prefill and teacher-forced
  decode logits within 2e-3 of each other and of the full forward, then 2
  training steps (step 1's loss and gradient bounded);
* the xlstm path: xlstm-1.3b (arXiv:2405.04517) at full width (d_model
  2048, 4 heads), its depth cut from 6 groups of 7 mLSTM + 1 sLSTM (2.02 G
  parameters) to 3, the same measures (lr 3e-4), the mLSTM's and the
  sLSTM's layer (its eager time loop) under the profiler, no kernel; its
  twin is 1 group of 7 mLSTM + 1 sLSTM.

Last, the user-facing entry points (the card freed first):

* the on-device LPT (``scheduler.lpt_assign_torch``) at 160 experts on 16
  slots (deepseek-v2's expert count; Zipf(1.3) routing of 2^20 tokens),
  the main path's 352 II cluster loads on 32 slots with slot 0 at speed
  0.5 and slot 5 dead, and 4,096 operations on 64 slots: the card's
  assignment and slot loads equal to the CPU's, no host sync under
  ``torch.cuda.set_sync_debug_mode("error")``, the dead slot given no load,
  the makespan within float32 of the host ``schedule_lpt``'s; timed with
  CUDA events beside the host LPT;
* the plan checker (``repro_torch.analysis.plan_checks``) on the card's
  plans: the reuse path's snapshot through ``validate_snapshot`` and
  ``validate_roundtrip``, the elastic path's replay plan and its
  ``slot_dead`` re-plan through ``validate_wave_plan`` and
  ``validate_schedule`` (each run where its path made the plan): zero
  findings;
* the examples phase: ``python -m repro_torch.examples.<name>`` for the
  five examples as subprocesses on the card at the reference's sizes
  (``train_lm --steps 300``, its full run), each exiting 0 within 600 s,
  while ``inverted_index``, ``quickstart`` §1-§2c and ``moe_balance``'s
  placement and reuse sections run with ``--device cpu`` (one thread
  each); their plans, balance ratios, network bytes, top-cluster loads,
  counts, reuse flags and reasons must equal the card's exactly.
  Checked: the examples' own asserts, os4m's balance ratio <= hash's
  (``inverted_index``, ``serve_lm``), every ``serve_lm`` request given
  exactly its budget, ``train_lm``'s 300 losses finite and falling,
  ``moe_balance``'s balance <= its baseline at each re-plan, kernels 1
  and 2 launched by the MapReduce examples on the card and no kernel by
  the CPU runs. Each example's wall time, ``train_lm``'s tokens/s and
  peak memory and ``serve_lm``'s tokens/s are printed, and the examples'
  own launches of kernels 1 and 2 on a line of their own (they run in
  other processes, so they are not in the kernels line).

Each path runs with every kernel's launch count set to 0 just before it
and read just after. Any failed check raises, so the exit code is
non-zero.

CUDA maps streams onto ``CUDA_DEVICE_MAX_CONNECTIONS`` hardware queues (8
by default), so the measured path's 32 slot streams would share queues.
The script sets it to 32 unless the environment sets it, before the first
CUDA call, and prints the value it ran with.

The MapReduce paths' configuration is the PUMA InvertedIndex deployment the reference's
simulator calibrates (``src/repro/core/simulator.py``): keys Zipf(0.97)
over 120,000 distinct keys, 48-byte pairs (a 4-byte key and V = 11
float32 values), the paper's cluster of 8 nodes x 4 Reduce slots (m = 32),
n = recommended_num_clusters(32) = 352 operation clusters (paper §5.4), and
K = 2^21 pairs per slot (67.1 M pairs, 3.2 GB of pairs on the device).
Values are integers in {0, 1, 2} and about 2% of pairs are invalid, so
every sum is exact in float32 and the oracle comparison is bitwise.

Output: one line per phase, a JSON line ``{"kernels": [...]}`` with each
kernel's launches on the paths, its error against the plain version and
its times, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. All numbers also go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# CUDA reads it when it creates the context: set before torch touches
# the device.
os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "32")
# cuBLAS's workspace for deterministic algorithms (the training path's
# resume check runs under them); read when the first handle is made.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent

M = 32                  # Reduce slots: 8 nodes x 4 slots
K = 2 ** 21             # pairs per slot
V = 11                  # float32 values per pair (44 B + 4 B key = 48 B)
NUM_KEYS = 120_000      # distinct keys
ZIPF_S = 0.97           # key skew of InvertedIndex
# The multi-job path's second tenant: PUMA SelfJoin as the reference's
# simulator calibrates it (Zipf 0.40 over 150,000 keys, 56 B pairs: a
# 4-byte key and 13 float32 values), two batches from fresh seeds.
SJ_KEYS, SJ_ZIPF_S, SJ_V, SJ_SEED = 150_000, 0.40, 13, 1000
KILL_SLOT, KILL_WAVE = 5, 2   # the elastic path's mid-batch kill
RESIZED_M = 24                # the elastic path's warm resize (32 -> 24 -> 32)
INVALID = 0.02          # share of invalid pairs
WIDE_BINS = 2 ** 17     # histogram width beyond one CTA's shared memory
SKETCH_N = 2 ** 17      # clusters of the sketch path
SKETCH_WIDTH, SKETCH_DEPTH = 1024, 4
CODED_M, CODED_K = 8, 2 ** 20   # the coded path: 8 nodes, the first 2^20 pairs a slot
# Multipliers of the sketch's second kernel case: all >= 2^31, so the
# uint32 wraparound of the hash is exercised on every row.
HIGH_MULTIPLIERS = (0x9E3779B1, 0xFFFFFFFF, 0x80000001, 0xC2B2AE35)

# Kernels whose source file is named otherwise.
SOURCE_OF = {"read_ticks": "wave_timer", "stamp_through": "wave_timer",
             "dispatch_ranks": "moe_dispatch"}

DISPATCH_T, DISPATCH_E = 2 ** 20, 64   # kernel 8: tokens, destinations
SERVE_LANES, SERVE_MAX_LEN, SERVE_REQUESTS = 8, 1024, 16   # the serve path
# The MoE path: grok-1-314b cut to 4 layers (42.6 GB of bf16 weights), 4
# expert slots stacked on the card (2 experts a slot), a prefill of 8 Zipf
# prompts of 512 tokens, 8 requests served on 4 lanes, and a 2-layer
# float32 twin (TWIN_REQUESTS of Zipf prompts).
MOE_LAYERS, MOE_EP_SLOTS, MOE_PROMPTS, MOE_PROMPT_LEN = 4, 4, 8, 512
MOE_REQUESTS, MOE_LANES = 8, 4
# The whisper path: whisper-base at full width and depth on 8 lanes with
# max_len 448 (Whisper's decoder context), 16 requests of 4-32 prompt tokens.
WHISPER_LANES, WHISPER_MAX_LEN, WHISPER_REQUESTS, WHISPER_PROMPTS = 8, 448, 16, (4, 33)
# The VLM path: qwen2-vl-7b at full width and depth; the model-level check
# prefills 8 x (256 patches + 256 text tokens) and decodes 16 steps, held
# against the train-mode forward of the whole stream within VLM_BF16_TOL
# (relative L2 of the logits), and on the float32 twin within VLM_F32_TOL
# (max |diff| of the logits); then 16 requests on 8 lanes.
VLM_BATCH, VLM_TEXT, VLM_DECODE, VLM_BF16_TOL, VLM_F32_TOL = 8, 256, 16, 5e-2, 1e-3
# The MLA path: deepseek-v2-236b cut to 5 layers (1 dense + 4 MoE), 4 expert
# slots (40 experts a slot), a prefill of 8 Zipf prompts of 512 tokens, 8
# requests on 4 lanes.
MLA_LAYERS, MLA_EP_SLOTS, MLA_PROMPTS, MLA_PROMPT_LEN = 5, 4, 8, 512
MLA_REQUESTS, MLA_LANES = 8, 4
# The float32 twins of the MoE and family paths (2 layers, full width), card
# vs CPU:
# lanes, requests of 16-32 prompt tokens, new tokens a request.
TWIN_LANES, TWIN_REQUESTS, TWIN_NEW = 2, 4, 6

# The training path: smollm-360m at full width and depth, 20 steps of 8 x
# 1024 packed tokens, a checkpoint at step 10 (resume and failure checks);
# deepseek-v2-236b at full width cut to 2 layers (1 dense + 1 MoE), 4 expert
# slots, 30 steps of 4 x 512 Zipf(1.3) tokens, a re-plan every 10 steps,
# steps 21-29 under the profiler. The float32 twins' final parameters, card
# vs CPU, within TWIN_PARAM_ATOL: the geometric middle between the sound
# dense twin's largest reading on the H100 (7.23e-5 to 7.73e-5) and the
# smallest of a card run with a known fault (TF32 matmuls 3.46e-3, bf16
# compute 4.22e-3), which the script runs as controls. The sound runs'
# largest differences sit on embedding elements whose gradient, times the
# clip scale (0.03-0.1), is at most a few times AdamW's eps at the one step
# that reaches them, where card and CPU sum it 25-100% apart (and in 364-380
# of 570 M element-steps to opposite signs, each below 6.3e-8 in magnitude).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY, TRAIN_LR = 20, 8, 1024, 10, 1e-3
MOE_TRAIN_LAYERS, MOE_TRAIN_SLOTS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 4, 4, 512
MOE_TRAIN_STEPS, MOE_REPLAN, MOE_PROFILE_FROM, MOE_PROFILE_TO = 30, 10, 20, 29
TWIN_PARAM_ATOL = 5e-4
# The state-based paths (zamba2-2.7b, xlstm-1.3b, full width, STATE_GROUPS deep): a
# prefill of STATE_BATCH prompts of STATE_PROMPT tokens (1000 = 7 x 128 +
# 104: off zamba2's 128-token SSD chunk and xlstm's 512-token mLSTM chunk),
# STATE_DECODE greedy decode steps from the returned state, held against
# the train-mode forward of the whole stream (1024 tokens: on both chunks).
# In bf16 both drift from exact arithmetic with depth (random weights
# amplify rounding: xlstm-1.3b's bf16 forward is almost uncorrelated with
# its float32 one), so the check is made twice: the same weights computing
# in float32, teacher-forced on that stream, decode == the full forward
# within STATE_F32_REL_TOL (relative L2); and the bf16 decode no further
# from that float32 forward than twice the bf16 full forward is. Then 20
# more decode steps under the profiler and STATE_TRAIN_STEPS Trainer steps
# of STATE_TRAIN_BATCH x STATE_TRAIN_SEQ os4m-packed tokens. Their float32
# twins (zamba2: 2 groups of 6 Mamba2 layers and the shared block; xlstm:
# 1 group of 7 mLSTM and 1 sLSTM) on the card and the CPU: prefill logits
# and teacher-forced decode logits card vs CPU and against the full
# forward within STATE_F32_TOL (max |diff|), then STATE_TWIN_STEPS training
# steps of 2 x 64: step 1's loss within 1e-5 relative and its gradient
# within STATE_GRAD_REL_TOL (relative L2), card vs CPU. Later steps and the
# parameters are recorded, not bounded: AdamW's first steps move every
# element by about lr in its gradient's sign, so an element whose gradient
# is near zero and of opposite signs on the two sides moves 2 lr apart,
# and the exponential gates of these twins carry the difference on.
STATE_BATCH, STATE_PROMPT, STATE_DECODE = 8, 1000, 24
STATE_TRAIN_STEPS, STATE_TRAIN_BATCH, STATE_TRAIN_SEQ = 3, 8, 1024
# Peak learning rates (warmup 2 steps): AdamW's first steps are sign-like,
# moving every weight by about lr, and zamba2's 54 layers of width 2560-10240
# took lr 1e-4 badly (this script on the H100: loss 10.90 at step 1, 12.36
# at step 3); xlstm's gradients are clipped from norms of several hundred.
STATE_TRAIN_LR = {"zamba2": 3e-5, "xlstm": 3e-4}
STATE_F32_REL_TOL, STATE_F32_TOL, STATE_GRAD_REL_TOL = 1e-3, 2e-3, 5e-3
STATE_TWIN_PROMPT, STATE_TWIN_DECODE, STATE_TWIN_STEPS = 48, 8, 2
# Depth of the state paths, in groups (zamba2: 6 Mamba2 layers + the shared
# block; xlstm: 7 mLSTM + 1 sLSTM), cut from 9 and 6 at full width so that
# the whole script, with the examples phase after it, stays well inside its
# 1,200 s (at full depth it took 1,059.8 s on the H100).
STATE_GROUPS = {"zamba2-2.7b": 4, "xlstm-1.3b": 3}

# The paths that serve a model (each launches kernel 9 and no other kernel).
ATTENTION_PATHS = ("serve", "moe", "whisper", "vlm", "mla", "zamba")

# The examples phase: each example as a subprocess on the card (train_lm at
# its documented full run), and the host-plan sections once more on the CPU,
# whose printed plans must equal the card's (the keys of each report compared).
EXAMPLES_ON_CARD = {"inverted_index": [], "quickstart": [], "serve_lm": [],
                    "moe_balance": [], "train_lm": ["--steps", "300"]}
EXAMPLES_ON_CPU = {"inverted_index": [],
                   "quickstart": ["--sections", "schedulers,wordcount,pipelined,reuse"],
                   "moe_balance": ["--sections", "placement,reuse"]}
EXAMPLE_HOST_KEYS = {"inverted_index": ("pairs", "clusters", "runs"),
                     "quickstart": ("schedulers", "wordcount", "pipelined", "reuse"),
                     "moe_balance": ("placement", "reuse")}
EXAMPLE_TIMEOUT_S = 600
LPT_SEED = 15                 # the LPT phase's expert and operation loads
LPT_DEAD_SLOT = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet, 700 W)
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor-core rate, dense
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
INT32_OPS_PER_S = 33.5e12   # int32 lanes: 64 an SM against float32's 128


def check(cond: bool, what: str) -> None:
    """Raise (non-zero exit) when a smoke check fails."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, launches: int = 100, reps: int = 5, spin_cycles: int = 100_000_000) -> tuple:
    """Device time of one ``fn()`` and the host's time to issue it, in ms.

    A launch whose wrapper takes longer on the host than its kernel on the
    card leaves the card idle between launches, so timing back-to-back
    calls measures the host. Here a device-side spin holds the stream while
    the host enqueues a burst of ``launches`` calls, which then run back to
    back: CUDA events around the burst give the device time a call. The
    spin (about 50 ms) must outlast the enqueue, which is checked. Returns
    ``(device ms a call, host ms a call)`` (medians over ``reps``)."""
    fn()
    torch.cuda.synchronize()
    dev_times, host_times = [], []
    for _ in range(reps):
        spin_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin_start.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        check(spin_start.elapsed_time(start) > host_ms,
              f"the spin outlasts the enqueue of {launches} launches ({host_ms:.2f} ms)")
        dev_times.append(start.elapsed_time(end) / launches)
        host_times.append(host_ms / launches)
    return float(np.median(dev_times)), float(np.median(host_times))


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """Least time on the card: max(bytes / memory rate, ops / their rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Workload:
    """A PUMA key population (InvertedIndex unless told otherwise): Zipf
    ranks -> int32 key hashes, ``v`` float32 values a pair."""

    def __init__(self, num_clusters: int, device, num_keys: int = NUM_KEYS,
                 zipf_s: float = ZIPF_S, v: int = V):
        ranks = np.arange(1, num_keys + 1, dtype=np.float64)
        p = ranks ** -zipf_s
        self.cdf = torch.as_tensor(np.cumsum(p / p.sum()), device=device)
        self.num_keys, self.v = num_keys, v
        # Multiplicative hash of the key index: spreads keys over int32,
        # negatives included.
        self.hashes_np = (np.arange(num_keys, dtype=np.uint32)
                          * np.uint32(2654435761)).view(np.int32)
        self.hashes = torch.as_tensor(self.hashes_np, device=device)
        self.cluster_np = self.clusters_of_keys(num_clusters)
        self.num_clusters = num_clusters
        self.device = device

    def clusters_of_keys(self, num_clusters: int) -> np.ndarray:
        """The oracle's cluster of every key: |hash| % n with int32
        wraparound and a floor-mod, as the engine defines it."""
        return np.mod(np.abs(self.hashes_np), num_clusters)

    def batch(self, seed: int, extra_n=()):
        """One batch drawn with numpy from ``seed``: device tensors + oracle.

        Returns ``((keys, values, valid) on the device, key index on the
        host, (oracle values, oracle counts))``; with ``extra_n`` also a
        dict ``{n: oracle}`` for those cluster counts.
        """
        rng = np.random.default_rng(seed)
        u = torch.as_tensor(rng.random((M, K)), device=self.device)
        kidx = torch.searchsorted(self.cdf, u).clamp_(max=self.num_keys - 1)
        del u
        valid_np = rng.random((M, K)) >= INVALID
        values_np = rng.integers(0, 3, size=(M, K, self.v), dtype=np.int8)
        keys = self.hashes[kidx]
        kidx_np = kidx.to(torch.int32).cpu().numpy()
        del kidx
        values = torch.as_tensor(values_np, device=self.device).to(torch.float32)
        valid = torch.as_tensor(valid_np, device=self.device)
        kidx_valid = kidx_np[valid_np]
        vals = values_np[valid_np]

        main = oracle_of(self.cluster_np[kidx_valid], vals, self.num_clusters)
        if not extra_n:
            return (keys, values, valid), kidx_np, main
        extra = {n: oracle_of(self.clusters_of_keys(n)[kidx_valid], vals, n)
                 for n in extra_n}
        return (keys, values, valid), kidx_np, main, extra


def oracle_of(cid, vals, n):
    """Exact (float64) per-cluster value sums and pair counts of the valid
    pairs, from their cluster ids ``cid`` and values ``vals`` (numpy)."""
    counts = np.bincount(cid, minlength=n).astype(np.float64)
    values = np.stack(
        [np.bincount(cid, weights=vals[:, c], minlength=n) for c in range(vals.shape[1])],
        axis=1)
    return values, counts


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str) -> dict:
    """Per kernel (mangled name) what ``ptxas -v`` reported: registers,
    stack frame, spill stores and loads, in bytes."""
    kernels, name = {}, None
    for line in report.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?",
                          line)
        if found:
            name = found.group(1)
            kernels.setdefault(name, {})
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            kernels[name].update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                                 spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            kernels[name]["registers"] = int(used.group(1))
    return kernels


def sass_functions(build, name: str) -> dict:
    """Each kernel function's SASS in library ``name`` (cuobjdump), by its
    mangled name."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(name)[name])],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    parts = re.split(r"\n\s*Function : ", sass)[1:]
    return {part.split("\n", 1)[0].strip(): part for part in parts}


def atomics_of(sass: str) -> dict:
    """Count of each atomic instruction kind (shared ATOMS.*, generic or
    global ATOM.* and RED.*) in a function's SASS."""
    counts = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def ptxas_phase(build) -> dict:
    """What ``ptxas -v`` said of the eight libraries whose kernels were
    redesigned for Hopper (flash attention's instances, the wave timer's,
    the XOR word kernel's encode and flat instances, the fused reduce's and
    the sorted segment-sum's two launches each, the histogram's and the
    sketch's mask and float instances, the dispatch ranks' single pass),
    one line a kernel. The XOR, fused, segment-sum, histogram, sketch and
    dispatch kernels must not spill. The wgmma instance must not spill, must enter with the 168
    registers a thread that its setmaxnreg split needs (384 x 168 = 128 x 40
    + 256 x 232), and its SASS must hold HGMMA (cuobjdump). The histogram's
    and the sketch's SASS: the count of each kind of atomic a kernel holds;
    the mask instances (template arguments <uint8, uint32>, ``Ihj``) must
    add with native integer shared atomics and hold no compare-and-swap."""
    out = {}
    for name in ("flash_attention", "wave_timer", "xor_words", "fused_shuffle_reduce",
                 "segment_reduce", "histogram", "sketch_hist", "moe_dispatch"):
        kernels = ptxas_kernels(build.ptxas_report(name))
        check(bool(kernels), f"ptxas reported on {name}.cu")
        for kernel, info in kernels.items():
            print(f"ptxas {name}.cu: {kernel[:72]}: {info}", flush=True)
        out[name] = kernels
    for name in ("xor_words", "fused_shuffle_reduce", "segment_reduce", "histogram",
                 "sketch_hist", "moe_dispatch"):
        check(all(v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0
                  for v in out[name].values()), f"{name}.cu's kernels do not spill")
    wgmma = {k: v for k, v in out["flash_attention"].items() if "flash_fwd_wgmma" in k}
    check(len(wgmma) == 2, "ptxas reported both wgmma instances (D = 64, 128)")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0 for v in wgmma.values()),
          "the wgmma instance does not spill")
    check(all(v["registers"] * 384 >= 128 * 40 + 256 * 232 for v in wgmma.values()),
          "the wgmma instance enters with the registers its setmaxnreg split needs")
    # MLA's prefill (bf16, D = 192) runs the simt instance compiled for any
    # D (template argument 0), whose dynamic shared memory is the q tile,
    # a key and a value tile in float32 and the probabilities.
    generic = {k: v for k, v in out["flash_attention"].items()
               if "flash_fwd" in k and "wgmma" not in k and "Li0E" in k}
    check(len(generic) == 2, "ptxas reported the simt instance of any D (f32, bf16)")
    smem_192 = (64 * 193 + 32 * 193 + 32 * 192 + 64 * 33) * 4
    out["simt_any_d"] = {"kernels": generic, "dynamic_smem_bytes_d192": smem_192}
    print(f"flash simt instance of any D: {generic}; at D = 192 (MLA's prefill) "
          f"{smem_192} bytes of dynamic shared memory a CTA", flush=True)
    sass = "".join(sass_functions(build, "flash_attention").values())
    out["hgmma_in_sass"] = sass.count("HGMMA")
    check(out["hgmma_in_sass"] > 0, "the flash library's SASS holds HGMMA")
    print(f"SASS of flash_attention.cu: {out['hgmma_in_sass']} HGMMA instructions", flush=True)
    out["atomics"] = {}
    for name in ("histogram", "sketch_hist"):
        functions = sass_functions(build, name)
        check(len(functions) == 2, f"{name}.cu holds two kernel instances")
        for fn, text in functions.items():
            instance = "mask" if "Ihj" in fn else "float"
            counts = atomics_of(text)
            out["atomics"][f"{name}/{instance}"] = counts
            print(f"SASS of {name}.cu, {instance} instance: atomics {counts}", flush=True)
            if instance == "mask":
                shared = sum(c for op, c in counts.items() if op.startswith("ATOMS.")
                             and ("ADD" in op or "INC" in op))
                check(shared > 0 and not any("CAS" in op for op in counts),
                      f"{name}.cu's mask instance adds with native shared integer atomics "
                      f"and holds no compare-and-swap loop")
    return out


# Tolerance of the float instances on real-valued weights: their float
# atomics add a cell's up to 2^21 terms in another order than the plain
# version's index_add_, which moves a float32 sum by a few units of its
# 1e-7 relative precision times the square root of the term count.
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-3


def random_weights(shape, seed: int) -> torch.Tensor:
    """Uniform [0, 1) float32 weights on the card from a seeded generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda")


def instance_times(fn, plain, library, nbytes_mask, nbytes_float, ops) -> dict:
    """Times of both instances of a counting kernel (``fn(weights)``) and its
    plain version and library call, with each instance's bound."""
    res = {}
    for kind, nbytes in (("mask", nbytes_mask), ("float", nbytes_float)):
        call = fn[kind]
        dev_ms, host_ms = device_ms(call, launches=50)
        b, by = bound_ms(nbytes, ops, INT32_OPS_PER_S if kind == "mask" else F32_OPS_PER_S)
        prefix = "" if kind == "mask" else "float_"
        res.update({f"{prefix}ms": dev_ms, f"{prefix}host_ms": host_ms,
                    f"{prefix}event_ms": cuda_ms(call), f"{prefix}bound_ms": b,
                    f"{prefix}bound_by": by, f"{prefix}library_ms": cuda_ms(library[kind])})
    res["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
    return res


def histogram_phase(hist_ops, histogram_ref, ids, valid, num_bins, dev):
    """Both instances of the histogram kernel against the plain version at one
    shape: the mask instance on the validity mask and the float instance on
    the same 0/1 weights, bitwise; the float instance on random weights,
    within FLOAT_RTOL. Times of each under ``device_ms`` (the path's number)
    and ``cuda_ms``, with its bound (5 B or 8 B a pair). Returns a dict."""
    want = histogram_ref(ids, valid, num_bins)
    got = hist_ops.histogram(ids, valid, num_bins)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"histogram mask instance == plain at {num_bins} bins")
    w01 = valid.to(torch.float32)
    check(torch.equal(hist_ops.histogram(ids, w01, num_bins), want),
          f"histogram float instance on 0/1 weights == plain at {num_bins} bins")
    del got, w01
    wr = random_weights(ids.shape, num_bins)
    want_r = histogram_ref(ids, wr, num_bins)
    got_r = hist_ops.histogram(ids, wr, num_bins)
    check(torch.allclose(got_r, want_r, rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
          f"histogram float instance on random weights within rtol {FLOAT_RTOL} at {num_bins}")
    rel = float(((got_r - want_r).abs() / want_r.abs().clamp_min(1.0)).max())
    del got_r, want_r
    m, k = ids.shape
    # bincount takes no negative ids: out-of-range and invalid pairs go to a
    # dump bin (the mask's yardstick counts; the float one weighs).
    in_range = (ids >= 0) & (ids < num_bins)
    flat = torch.where(in_range, ids.long() + torch.arange(m, device=dev)[:, None] * num_bins,
                       m * num_bins).reshape(-1)
    flat_mask = torch.where(valid.reshape(-1), flat, m * num_bins)
    wf = wr.reshape(-1)
    res = {"bins": num_bins, "max_abs_err": err, "float_max_rel_err": rel}
    res.update(instance_times(
        {"mask": lambda: hist_ops.histogram(ids, valid, num_bins),
         "float": lambda: hist_ops.histogram(ids, wr, num_bins)},
        lambda: histogram_ref(ids, valid, num_bins),
        {"mask": lambda: torch.bincount(flat_mask, minlength=m * num_bins + 1),
         "float": lambda: torch.bincount(flat, weights=wf, minlength=m * num_bins + 1)},
        m * k * 5 + m * num_bins * 4, m * k * 8 + m * num_bins * 4, m * k))
    return res


def hot_bin_phase(hist_ops, histogram_ref, sk_ops, sketch_ref, multipliers, dev) -> None:
    """Every pair of 4 slots of 2^20 in one bin (one address takes every
    add): both instances of both kernels equal their plain versions."""
    ids = torch.full((4, 2 ** 20), 7, dtype=torch.int32, device=dev)
    for w in (torch.ones(ids.shape, dtype=torch.bool, device=dev),
              torch.ones(ids.shape, dtype=torch.float32, device=dev)):
        got = hist_ops.histogram(ids, w, 352)
        check(torch.equal(got, histogram_ref(ids, w, 352)) and float(got[0, 7]) == 2 ** 20,
              f"histogram ({w.dtype}) of one hot bin == plain")
        check(torch.equal(sk_ops.sketch_hist(ids, w, multipliers, SKETCH_WIDTH),
                          sketch_ref(ids, w, multipliers, SKETCH_WIDTH)),
              f"sketch ({w.dtype}) of one hot id == plain")
    print("kernels histogram and sketch_hist, every pair of (4, 2^20) on one id: both "
          "instances bitwise ok", flush=True)


def sketch_phase(sk_ops, sketch_ref, sketch_cells, ids, valid, multipliers):
    """Both instances of the sketch kernel against the plain version at one
    case, as :func:`histogram_phase`. Returns a dict.

    The library yardstick is one ``torch.bincount`` over the precomputed
    flat ``(slot, row, bin)`` cell of every pair: it excludes the hashing.
    """
    want = sketch_ref(ids, valid, multipliers, SKETCH_WIDTH)
    got = sk_ops.sketch_hist(ids, valid, multipliers, SKETCH_WIDTH)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want),
          f"sketch mask instance == plain at {len(multipliers)} x {SKETCH_WIDTH}")
    check(torch.equal(sk_ops.sketch_hist(ids, valid.to(torch.float32), multipliers,
                                         SKETCH_WIDTH), want),
          f"sketch float instance on 0/1 weights == plain at {len(multipliers)} x {SKETCH_WIDTH}")
    del got
    wr = random_weights(ids.shape, len(multipliers))
    want_r = sketch_ref(ids, wr, multipliers, SKETCH_WIDTH)
    got_r = sk_ops.sketch_hist(ids, wr, multipliers, SKETCH_WIDTH)
    check(torch.allclose(got_r, want_r, rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
          f"sketch float instance on random weights within rtol {FLOAT_RTOL}")
    rel = float(((got_r - want_r).abs() / want_r.abs().clamp_min(1.0)).max())
    del got_r, want_r
    m, k = ids.shape
    depth = len(multipliers)
    size = m * depth * SKETCH_WIDTH
    cells = sketch_cells(ids, multipliers, SKETCH_WIDTH)
    cells_mask = torch.where(valid[:, None, :], cells, size).reshape(-1)
    cells = cells.reshape(-1)
    wf = wr[:, None, :].expand(m, depth, k).reshape(-1)
    lib = torch.bincount(cells_mask, minlength=size + 1)[:size].float()
    check(torch.equal(lib.view(m, depth, SKETCH_WIDTH), want), "bincount yardstick == plain")
    del lib
    res = {"multipliers": [int(a) for a in multipliers], "max_abs_err": err,
           "float_max_rel_err": rel}
    res.update(instance_times(
        {"mask": lambda: sk_ops.sketch_hist(ids, valid, multipliers, SKETCH_WIDTH),
         "float": lambda: sk_ops.sketch_hist(ids, wr, multipliers, SKETCH_WIDTH)},
        lambda: sketch_ref(ids, valid, multipliers, SKETCH_WIDTH),
        {"mask": lambda: torch.bincount(cells_mask, minlength=size + 1),
         "float": lambda: torch.bincount(cells, weights=wf, minlength=size)},
        m * k * 5 + size * 4, m * k * 8 + size * 4, m * k * depth))
    return res


def segment_phase(seg_ops, seg_ref, fused, values, gather_idx, seg_ids, num_segments):
    """The sorted segment-sum at one chunk's shape: checks + times. Returns a dict.

    The chunk's received rows are put in rank order (the fused kernel's
    gather, done once here), with the dump id ``num_segments`` as padding.
    The kernel is held against the plain version bitwise (the values are
    integers). On standard normals at the same shapes, drawn as the
    unsorted table: the kernel on the rank-ordered rows equals the fused
    kernel (``fused``) on the table and its gather bit for bit (both add a
    segment's rows in one tile order), is within 1e-5 * sum of |values| of
    the exact float64 sums, and keeps every bit with 1,000 padding rows
    appended and with 7 padding rows (id -1) in front. Library yardsticks,
    timed on the integer rows: one ``index_add_`` and one
    ``torch.segment_reduce`` (lengths computed outside the timed call); the
    row's library time is the faster of the two.
    """
    m, n, v = values.shape
    dev = values.device
    rows_sorted = torch.gather(values, 1, gather_idx.long()[..., None].expand(m, n, v))
    got = seg_ops.segment_reduce_sorted(rows_sorted, seg_ids, num_segments)
    want = seg_ref(rows_sorted, seg_ids, num_segments)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "segment_reduce kernel == plain on integer values")
    err = float((got - want).abs().max())
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    rows = int(ok.sum())
    flat = torch.where(ok, seg_ids.long(), num_segments)
    flat = (flat + torch.arange(m, device=dev)[:, None] * (num_segments + 1)).reshape(-1)
    vals_flat = rows_sorted.reshape(-1, v)
    # torch.segment_reduce's lengths: the leading negative ids, each
    # segment, the trailing padding.
    bounds = torch.searchsorted(seg_ids, torch.arange(num_segments + 1, device=dev,
                                                      dtype=torch.int32).expand(m, -1)
                              .contiguous())
    lengths = torch.cat([bounds[:, :1], bounds.diff(dim=1),
                         n - bounds[:, -1:]], dim=1)

    def index_add():
        acc = torch.zeros(m * (num_segments + 1), v, device=dev)
        return acc.index_add_(0, flat, vals_flat)

    def segment_reduce():
        return torch.segment_reduce(rows_sorted, "sum", lengths=lengths, axis=1)

    lib = index_add().view(m, num_segments + 1, v)[:, :num_segments]
    check(torch.equal(lib, want), "index_add_ yardstick == plain")
    lib = segment_reduce()[:, 1:num_segments + 1]
    check(torch.equal(lib, want), "torch.segment_reduce yardstick == plain")
    del lib, got, want
    b, by = bound_ms(rows * (4 + 4 * v) + m * num_segments * v * 4, rows * v)
    res = {
        "shape": [m, n, v], "segments": num_segments, "valid_rows": rows,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: seg_ops.segment_reduce_sorted(rows_sorted, seg_ids,
                                                            num_segments), reps=5, warmup=1),
        "plain_ms": cuda_ms(lambda: seg_ref(rows_sorted, seg_ids, num_segments),
                            reps=5, warmup=1),
        "index_add_ms": cuda_ms(index_add, reps=5, warmup=1),
        "segment_reduce_ms": cuda_ms(segment_reduce, reps=5, warmup=1),
        "bound_ms": b, "bound_by": by,
    }
    res["library_ms"] = min(res["index_add_ms"], res["segment_reduce_ms"])
    del rows_sorted, vals_flat, flat

    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(values.shape, generator=gen, device=dev)
    normals = torch.gather(table, 1, gather_idx.long()[..., None].expand(m, n, v))
    got_n = seg_ops.segment_reduce_sorted(normals, seg_ids, num_segments)
    check(torch.equal(got_n, fused(table, gather_idx, seg_ids, num_segments)[0]),
          "segment_reduce kernel on rank-ordered normals == fused kernel on the table and "
          "its gather, bit for bit")
    del table
    for lead, extra in ((0, 1000), (7, 0)):
        again = seg_ops.segment_reduce_sorted(
            torch.cat([torch.ones((m, lead, v), device=dev), normals,
                       torch.ones((m, extra, v), device=dev)], dim=1),
            torch.cat([torch.full((m, lead), -1, dtype=torch.int32, device=dev), seg_ids,
                       torch.full((m, extra), num_segments, dtype=torch.int32, device=dev)],
                      dim=1), num_segments)
        check(torch.equal(again, got_n), f"segment_reduce kernel on normals: {lead} padding "
              f"rows in front and {extra} behind leave every bit of the sums")
        del again
    dst = torch.where(ok, seg_ids.long(), num_segments)
    dst = (dst + torch.arange(m, device=dev)[:, None] * (num_segments + 1))[ok]
    picked = normals[ok].double()
    del normals
    exact = torch.zeros(m * (num_segments + 1), v, dtype=torch.float64, device=dev)
    exact.index_add_(0, dst, picked)
    scale = torch.zeros_like(exact).index_add_(0, dst, picked.abs())
    del picked
    shape = (m, num_segments + 1, v)
    exact = exact.view(shape)[:, :num_segments]
    scale = scale.view(shape)[:, :num_segments]
    diff = (got_n.double() - exact).abs()
    check(bool((diff <= 1e-5 * scale).all()),
          "segment_reduce kernel on normals within 1e-5 * sum|x| of the exact sums")
    res.update(float_rel_err=float((diff / scale.clamp_min(1e-30)).max()),
               equals_fused_bitwise=True, pad_shift_invariant="checked")
    return res


def xor_phase(cs_ops, encode_ref, xor_ref, m, cap2, w_row, dev):
    """The XOR kernel's two instances at the coded path's chunk-0 shape, on
    random int32 words (XOR does the same work on any data).

    Encode: ``encode_packets`` on an ``(m, m, m, cap2, w_row)`` slab,
    bitwise against its plain version; timed beside the plain version, the
    three passes it replaces (the ``.contiguous()`` swap copy, the flat
    instance, ``masked_fill_``) and the library yardstick,
    ``torch.bitwise_xor`` of the slab and its strided swap followed by
    ``masked_fill_`` (no single PyTorch call computes the masked swap-XOR).
    Its bound: 8 B a packet word (read once, written once), 4 B a zero
    word. Flat: ``xor_words`` on two ``(m^3 cap2, w_row)`` slabs, bitwise
    against its plain version, which is the library call
    (``torch.bitwise_xor``); a second XOR restores the slab. Returns a dict.
    """
    rows = m ** 3 * cap2
    words = rows * w_row
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randint(-2 ** 31, 2 ** 31, (rows, w_row), generator=gen, device=dev,
                      dtype=torch.int32)
    slab = a.view(m, m, m, cap2, w_row)
    got = cs_ops.encode_packets(slab)
    want = encode_ref(slab)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "xor_words encode instance == plain, bitwise")
    err = float((got.long() - want.long()).abs().max())
    del got, want
    ids = torch.arange(m, device=dev)
    snd, dst_a, dst_b = ids[:, None, None], ids[None, :, None], ids[None, None, :]
    pair_ok = (dst_a != dst_b) & (dst_a != snd) & (dst_b != snd)
    no_pair = ~pair_ok[..., None, None]
    packet_share = float(pair_ok.float().mean())

    def three_pass():
        swapped = slab.transpose(1, 2).contiguous()
        x = cs_ops.xor_words(a, swapped.view(rows, w_row)).view_as(slab)
        return x.masked_fill_(no_pair, 0)

    def library():
        return torch.bitwise_xor(slab, slab.transpose(1, 2)).masked_fill_(no_pair, 0)

    check(torch.equal(three_pass(), cs_ops.encode_packets(slab)), "three passes == encode")
    b_ms, by = bound_ms((8 * packet_share + 4 * (1 - packet_share)) * words,
                        packet_share * words, INT32_OPS_PER_S)
    res = {
        "shape": [m, m, m, cap2, w_row], "cap2": cap2, "packet_share": packet_share,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: cs_ops.encode_packets(slab), reps=5, warmup=1),
        "plain_ms": cuda_ms(lambda: encode_ref(slab), reps=5, warmup=1),
        "three_pass_ms": cuda_ms(three_pass, reps=5, warmup=1),
        "library_ms": cuda_ms(library, reps=5, warmup=1),
        "bound_ms": b_ms, "bound_by": by,
    }
    b = torch.randint(-2 ** 31, 2 ** 31, (rows, w_row), generator=gen, device=dev,
                      dtype=torch.int32)
    got = cs_ops.xor_words(a, b)
    want = xor_ref(a, b)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "xor_words flat instance == plain, bitwise")
    check(torch.equal(cs_ops.xor_words(got, b), a), "xor_words decode restores the slab")
    flat_err = float((got.long() - want.long()).abs().max())
    del got, want
    fb_ms, fby = bound_ms(3 * 4 * words, words, INT32_OPS_PER_S)
    flat = {"shape": [rows, w_row], "max_abs_err": flat_err}
    # In turns (flat, library, library, flat): two versions compared within
    # one call, in both orders.
    times = {"ms": [], "library_ms": []}
    calls = {"ms": lambda: cs_ops.xor_words(a, b), "library_ms": lambda: torch.bitwise_xor(a, b)}
    for key in ("ms", "library_ms", "library_ms", "ms"):
        times[key].append(cuda_ms(calls[key], reps=5, warmup=1))
    flat.update({k: float(np.mean(v)) for k, v in times.items()})
    flat.update(plain_ms=cuda_ms(lambda: xor_ref(a, b), reps=5, warmup=1),
                bound_ms=fb_ms, bound_by=fby)
    res["flat"] = flat
    del a, b, slab
    return res


class FusedProbe:
    """Stands in for ``fused_shuffle_reduce`` during one engine run.

    Every call launches the kernel as the engine would, then holds its sums
    and counts against the plain version on the same inputs (bitwise: the
    values are integers, the counts exact), its sums against an exact
    float64 sum on standard normals at the same shapes (|error| <= 1e-5 *
    sum of |values| of the segment), and times the kernel, the plain
    version and the library yardstick: one ``index_add_`` that computes the
    same sums from the unsorted rows plus one ``torch.bincount`` of the
    segment ids for the counts. On the first call (chunk 0, the largest)
    the same stream on normals is fed again with padding appended, and
    shifted by padding rows in front: the sums must keep every bit.
    ``on_first`` is called with the first launch's inputs.
    """

    def __init__(self, real, ref, on_first=None):
        self.real = real
        self.ref = ref
        self.on_first = on_first
        self.chunks = []

    def __call__(self, values, gather_idx, seg_ids, num_segments):
        if not self.chunks and self.on_first is not None:
            self.on_first(values, gather_idx, seg_ids, num_segments)
        out, counts = self.real(values, gather_idx, seg_ids, num_segments)
        want, want_counts = self.ref(values, gather_idx, seg_ids, num_segments)
        torch.cuda.synchronize()
        check(torch.equal(out, want), "fused kernel == plain on integer values")
        check(torch.equal(counts, want_counts), "fused kernel's counts == plain, exactly")
        err = max(float((out - want).abs().max()), float((counts - want_counts).abs().max()))
        del want, want_counts

        m, n, v = values.shape
        ok = (seg_ids >= 0) & (seg_ids < num_segments)
        rows = int(ok.sum())
        # The library yardstick: with the segment of every unsorted row,
        # one index_add_ computes the same sums with no gather, and one
        # bincount of the sorted ids the counts.
        seg_of_row = torch.full((m, n), num_segments, dtype=torch.long,
                                device=values.device)
        seg_of_row.scatter_(1, gather_idx.long(), seg_ids.long().clamp(0, num_segments))
        seg_of_row += torch.arange(m, device=values.device)[:, None] * (num_segments + 1)
        seg_flat = seg_of_row.reshape(-1)
        vals_flat = values.reshape(-1, v)
        flat = torch.where(ok, seg_ids.long(), num_segments)
        flat = (flat + torch.arange(m, device=values.device)[:, None]
                * (num_segments + 1)).reshape(-1)

        def library():
            acc = torch.zeros(m * (num_segments + 1), v, device=values.device)
            return (acc.index_add_(0, seg_flat, vals_flat),
                    torch.bincount(flat, minlength=m * (num_segments + 1)))

        lib, lib_counts = library()
        check(torch.equal(lib.view(m, num_segments + 1, v)[:, :num_segments], out)
              and torch.equal(lib_counts.view(m, num_segments + 1)[:, :num_segments].float(),
                              counts), "index_add_ + bincount yardstick == kernel")
        del lib, lib_counts, seg_of_row

        float_err, invariant = self._float_check(values, gather_idx, seg_ids, num_segments,
                                                 ok)
        nbytes = rows * (4 + 4 * v) + m * num_segments * (v + 1) * 4
        ops = rows * v
        b, by = bound_ms(nbytes, ops)
        self.chunks.append({
            "shape": [m, n, v], "segments": num_segments, "valid_rows": rows,
            "bytes": nbytes, "ops": ops,
            "max_abs_err": err, "float_rel_err": float_err, "pad_shift_invariant": invariant,
            "ms": cuda_ms(lambda: self.real(values, gather_idx, seg_ids, num_segments),
                          reps=5, warmup=1),
            "plain_ms": cuda_ms(lambda: self.ref(values, gather_idx, seg_ids, num_segments),
                                reps=5, warmup=1),
            "library_ms": cuda_ms(library, reps=5, warmup=1),
            "bound_ms": b, "bound_by": by,
        })
        return out, counts

    def _float_check(self, values, gather_idx, seg_ids, num_segments, ok):
        """Kernel on standard normals vs the exact (float64) segment sums;
        on chunk 0 also the same stream with 1,000 padding rows appended and
        with 7 padding rows (id -1) in front, whose sums must be identical.
        Returns ``(largest relative error, "checked" or None)``."""
        m, n, v = values.shape
        dev = values.device
        gen = torch.Generator(device=dev).manual_seed(len(self.chunks))
        normals = torch.randn(values.shape, generator=gen, device=dev)
        got = self.real(normals, gather_idx, seg_ids, num_segments)[0]
        invariant = None
        if not self.chunks:
            for lead, extra in ((0, 1000), (7, 0)):
                again = self.real(
                    torch.cat([normals, torch.ones((m, lead + extra, v), device=dev)], dim=1),
                    torch.cat([torch.full((m, lead), n, dtype=torch.int32, device=dev),
                               gather_idx,
                               torch.zeros((m, extra), dtype=torch.int32, device=dev)], dim=1),
                    torch.cat([torch.full((m, lead), -1, dtype=torch.int32, device=dev),
                               seg_ids, torch.full((m, extra), num_segments,
                                                   dtype=torch.int32, device=dev)], dim=1),
                    num_segments)[0]
                check(torch.equal(again, got), f"fused kernel on normals: {lead} padding rows"
                      f" in front and {extra} behind leave every bit of the sums")
                del again
            invariant = "checked"
        got = got.double()
        slot = torch.arange(m, device=dev)[:, None].expand(m, n)[ok]
        src = gather_idx[ok].long() + slot * n
        dst = seg_ids[ok].long() + slot * num_segments
        picked = normals.reshape(-1, v)[src].double()
        del normals
        exact = torch.zeros(m * num_segments, v, dtype=torch.float64, device=dev)
        exact.index_add_(0, dst, picked)
        scale = torch.zeros_like(exact).index_add_(0, dst, picked.abs())
        diff = (got.reshape(-1, v) - exact).abs()
        check(bool((diff <= 1e-5 * scale).all()),
              "fused kernel on normals within 1e-5 * sum|x| of the exact sums")
        return float((diff / scale.clamp_min(1e-30)).max()), invariant


class PlanSpy:
    """Counts the host planner's calls of one job (``job._plan``) and keeps
    the plans it returned."""

    def __init__(self, job):
        self.plans = []
        self._plan = job._plan
        job._plan = self

    @property
    def calls(self) -> int:
        return len(self.plans)

    def __call__(self, *args, **kwargs):
        self.plans.append(self._plan(*args, **kwargs))
        return self.plans[-1]


def tail_burst(work, batch, kidx_np, oracle, plan1, n, prefix):
    """A batch whose tail overflows the wave that its prefix committed.

    ``plan1`` is the prefix plan of ``batch``: it committed wave 1 (its
    chunk 0) and that wave's send capacity. Take the destination whose
    wave-1 groups hold the most pairs, and the hottest key of a wave-1
    cluster sent there. Past the prefix, pairs of clusters outside wave 1
    that go to other slots are rewritten to that key: on each slot just
    enough of them to carry its (slot, destination) group of wave 1 one
    pair past the committed capacity. The prefix is untouched, so the
    engine commits the same wave 1, and every slot overflows it by one
    pair: a trending key that the prefix never saw. Returns the new batch,
    its oracle at ``n`` clusters and a description.
    """
    keys, values, valid = batch
    dev = keys.device
    m, k = keys.shape
    cl_np = work.clusters_of_keys(n)
    wave1 = np.zeros(n, bool)
    wave1[plan1.waves.chunk_members(0)] = True
    cap = int(plan1.chunk_caps[0])
    cl = torch.as_tensor(cl_np, device=dev)[torch.as_tensor(kidx_np, device=dev).long()]
    assign = torch.as_tensor(plan1.schedule.assignment, device=dev)[cl]
    in_wave1 = torch.as_tensor(wave1, device=dev)[cl]
    slot = torch.arange(m, device=dev)[:, None].expand(m, k)
    groups = torch.bincount((slot * m + assign)[valid & in_wave1], minlength=m * m)
    groups = groups.view(m, m)                      # wave-1 pairs by (slot, destination)
    dest = int(groups.sum(dim=0).argmax())
    key = int(np.flatnonzero(wave1[cl_np] & (plan1.schedule.assignment[cl_np] == dest))[0])
    own = groups[:, dest]
    need = (cap + 1 - own).clamp_min(0)
    tail = torch.arange(k, device=dev) >= int(np.ceil(prefix * k))
    eligible = valid & ~in_wave1 & (assign != dest) & tail
    from_end = eligible.flip(1).cumsum(1).flip(1)   # eligible pairs at or after t
    pick = eligible & (from_end <= need[:, None])
    check(bool((pick.sum(dim=1) == need).all()), "tail burst: enough tail pairs to rewrite")
    new_keys = torch.where(pick, work.hashes[key], keys)
    moved_cl = cl[pick].cpu().numpy()
    moved_vals = values[pick].double().cpu().numpy()
    del cl, assign, in_wave1, slot, eligible, from_end, pick
    vals, counts = oracle[0].copy(), oracle[1].copy()
    np.subtract.at(vals, moved_cl, moved_vals)
    np.subtract.at(counts, moved_cl, 1.0)
    vals[cl_np[key]] += moved_vals.sum(axis=0)
    counts[cl_np[key]] += len(moved_cl)
    info = {"key_rank": key + 1, "cluster": int(cl_np[key]), "dest": dest,
            "wave1_cap": cap, "rewritten_pairs": int(len(moved_cl))}
    return (new_keys, values, valid), (vals, counts), info


def reset_launches(counters) -> None:
    """Set every kernel's launch count to 0 (just before a path runs).

    ``counters`` maps a kernel's name to ``(module, attribute)`` of its
    wrapper's count."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
        for split in ("launches_by_design", "launches_by_instance"):
            by = getattr(mod, split, None)
            if by is not None:
                for key in by:
                    by[key] = 0


def read_launches(counters) -> dict:
    """Every kernel's launch count (just after a path ran)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def check_oracle(res, oracle, what: str) -> None:
    """Zero overflow and values and counts equal to the oracle, bit for bit."""
    check(res.overflow == 0, f"{what}: no overflow")
    check(np.array_equal(res.values, oracle[0]), f"{what}: values == numpy oracle")
    check(np.array_equal(res.counts, oracle[1]), f"{what}: counts == numpy oracle")


def coded_path(work, batch0, kidx0, counters, MapReduceConfig, MapReduceJob, n):
    """The coded shuffle and the quantized wire at m = 8, K = 2^20 (see the
    module docstring). Every check raises. Returns ``(record, launches)``
    with the path's kernel counts (set to 0 just before it)."""
    batch = tuple(t[:CODED_M, :CODED_K].contiguous() for t in batch0)
    valid_np = batch[2].cpu().numpy()
    vals = batch[1].cpu().numpy()[valid_np]
    cid = work.clusters_of_keys(n)[kidx0[:CODED_M, :CODED_K][valid_np]]
    oracle = oracle_of(cid, vals, n)
    # The int8 wire as the engine defines it, in float32: one scale from
    # the largest valid magnitude, round half to even, dequantize.
    scale = np.float32(max(float(np.abs(vals).max()), 1e-12)) / np.float32(127.0)
    q = np.clip(np.round(vals / scale), -127, 127).astype(np.float32)
    oracle_int8 = oracle_of(cid, q * scale, n)
    del vals, q, cid, valid_np
    xor_mod = counters["xor_words"][0]
    fused_mod = counters["fused_shuffle_reduce"][0]
    hist_mod = counters["histogram"][0]
    reset_launches(counters)
    runs = {}

    def run(label, backend="stacked", **cfg):
        job = MapReduceJob(lambda b: b, MapReduceConfig(
            num_slots=CODED_M, num_clusters=n, **cfg), backend=backend)
        # One program a slot on the sharded backend: every kernel launches
        # once a slot where the stacked run launches it once.
        slots = CODED_M if backend == "sharded" else 1
        x0, f0, h0 = xor_mod.launches, fused_mod.launches, hist_mod.launches
        by0 = dict(xor_mod.launches_by_design)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        chunks = job.last_plan.waves.num_chunks if job.cfg.pipelined else 1
        coded = job.cfg.shuffle_replication == 2
        check(job.last_plan.waves.replication == job.cfg.shuffle_replication,
              f"coded path {label}: the plan carries r")
        by_design = {k: xor_mod.launches_by_design[k] - by0[k] for k in by0}
        per = chunks * slots
        check(xor_mod.launches - x0 == (2 * per if coded else 0)
              and by_design == ({"encode": per, "flat": per} if coded
                                else {"encode": 0, "flat": 0}),
              f"coded path {label}: xor_words launched once a chunk (and slot) to encode and"
              f" once to decode, on a coded run only (got {by_design})")
        check(fused_mod.launches - f0 == per,
              f"coded path {label}: the fused kernel launched once a chunk (and slot)")
        check(hist_mod.launches - h0 == slots,
              f"coded path {label}: the histogram launched once (a slot) in phase A")
        check(res.overflow == 0, f"coded path {label}: no overflow")
        info = {"wall_ms": wall_ms, **job.last_phase_ms, "chunks": chunks, "backend": backend,
                "fused_launches": fused_mod.launches - f0,
                "histogram_launches": hist_mod.launches - h0,
                "chunk_caps": list(job.last_plan.chunk_caps),
                "shuffle_bytes": res.shuffle_bytes, "shuffle_rows": res.shuffle_rows,
                "shuffle_pairs": res.shuffle_pairs,
                "replication_bytes": res.replication_bytes,
                "quantize_exact": res.quantize_exact,
                "xor_launches": xor_mod.launches - x0, "xor_launches_by_design": by_design,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        runs[label] = info
        print(f"coded path {label}: shuffle {res.shuffle_bytes} B in {res.shuffle_rows} rows "
              f"({res.shuffle_pairs} non-local pairs), replication {res.replication_bytes} B, "
              f"quantize_exact {res.quantize_exact}, xor_words launches "
              f"{info['xor_launches']} {by_design} | phase A {info['phase_a']:.1f} ms | plan "
              f"{info['plan']:.1f} ms | phase B {info['phase_b']:.1f} ms | run "
              f"{wall_ms:.1f} ms | peak {info['peak_gb']:.1f} GB", flush=True)
        del job
        torch.cuda.empty_cache()
        return res

    uncoded = run("uncoded")
    check_oracle(uncoded, oracle, "coded path uncoded")
    coded = run("coded", shuffle_replication=2)
    check(np.array_equal(coded.values, uncoded.values)
          and np.array_equal(coded.counts, uncoded.counts), "coded == uncoded, bit for bit")
    sharded = run("coded sharded", backend="sharded", shuffle_replication=2)
    check_oracle(sharded, oracle, "coded path sharded")
    check(np.array_equal(sharded.values, coded.values)
          and np.array_equal(sharded.counts, coded.counts),
          "sharded coded == stacked coded, bit for bit")
    check(sharded.shuffle_bytes == coded.shuffle_bytes
          and sharded.replication_bytes == coded.replication_bytes
          and sharded.shuffle_rows == coded.shuffle_rows,
          "sharded coded: wire and replication bytes == the stacked run's")
    print(f"coded path: phase B sharded {runs['coded sharded']['phase_b']:.1f} ms over "
          f"{CODED_M} slot streams vs stacked {runs['coded']['phase_b']:.1f} ms", flush=True)
    seq = run("coded sequential", shuffle_replication=2, pipelined=False)
    check(np.array_equal(seq.values, coded.values)
          and np.array_equal(seq.counts, coded.counts), "coded sequential == coded pipelined")
    check(coded.shuffle_pairs == uncoded.shuffle_pairs, "coded path: same non-local pairs")
    u8 = run("uncoded int8", quantize_shuffle="int8")
    c8 = run("coded int8", shuffle_replication=2, quantize_shuffle="int8")
    check(np.array_equal(u8.values, c8.values) and np.array_equal(u8.counts, c8.counts),
          "coded int8 == uncoded int8, bit for bit")
    check(u8.quantize_exact is False and c8.quantize_exact is False,
          "int8 wire: 1 -> 64 * 2/127 is inexact, and the jobs say so")
    check(np.array_equal(u8.counts, oracle[1]), "int8 counts == oracle")
    rel = float(np.max(np.abs(u8.values - oracle_int8[0])
                       / np.maximum(np.abs(oracle_int8[0]), 1e-30)))
    check(rel <= 1e-4, f"int8 values within 1e-4 of the dequantized oracle (got {rel:.2e})")
    f8 = run("coded fp8", shuffle_replication=2, quantize_shuffle="fp8")
    check(f8.quantize_exact is True, "fp8 wire: {0, 1, 2} are exact in e4m3")
    check(np.array_equal(f8.values, uncoded.values) and np.array_equal(f8.counts, uncoded.counts),
          "coded fp8 == uncoded exact, bit for bit")
    launches = read_launches(counters)
    ratio = uncoded.shuffle_bytes / coded.shuffle_bytes
    theory = 2 * (CODED_M - 1) / (CODED_M - 2)
    print(f"coded path: wire bytes uncoded / coded = {ratio:.4f} (full groups: "
          f"{theory:.4f}); int8 {u8.shuffle_bytes} B uncoded, {c8.shuffle_bytes} B coded; "
          f"int8 values within {rel:.2e} of the dequantized oracle; launches {launches}",
          flush=True)
    del batch, uncoded, coded, sharded, seq, u8, c8, f8
    torch.cuda.empty_cache()
    by_design = {k: sum(r["xor_launches_by_design"][k] for r in runs.values())
                 for k in ("encode", "flat")}
    return {"m": CODED_M, "k": CODED_K, "n": n, "runs": runs, "wire_ratio": ratio,
            "wire_ratio_theory": theory, "int8_rel_err": rel,
            "launches_by_design": by_design}, launches


def measured_path(batches, main_runs, main_plan0, pipelined0, counters, n, MapReduceConfig,
                  MapReduceJob, ReusePolicy, wt_ops, dev):
    """The sharded backend and its measured executor at the main path's size
    (see the module docstring). Every check raises. Returns ``(record,
    launches)`` with the path's kernel counts (set to 0 just before it)."""
    hist_mod, fused_mod = counters["histogram"][0], counters["fused_shuffle_reduce"][0]
    torch.cuda.empty_cache()
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    # The first stamp of the process calibrates its tick unit (read_ticks
    # bracketing host sleeps); a measured run would do it at its first batch.
    t0 = time.perf_counter()
    cal = wt_ops.tick_calibration(dev)
    cal_ms = (time.perf_counter() - t0) * 1e3
    check(abs(cal.seconds_per_tick / 1e-9 - 1.0) <= 0.05,
          f"tick_calibration within 5% of 1e-9 s/tick (got {cal.seconds_per_tick:.4e})")
    print(f"measured path: tick_calibration {cal.seconds_per_tick:.6e} s/tick in {cal_ms:.1f} ms",
          flush=True)

    def one(job, batch, oracle, what):
        h0, f0 = hist_mod.launches, fused_mod.launches
        hm0 = hist_mod.launches_by_instance["mask"]
        s0 = wt_ops.stamp_through_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        chunks = job.last_plan.waves.num_chunks
        check(hist_mod.launches - h0 == M
              and hist_mod.launches_by_instance["mask"] - hm0 == M,
              f"{what}: phase A launched the histogram's mask instance once a slot")
        check(fused_mod.launches - f0 == M * chunks,
              f"{what}: phase B launched the fused kernel once a slot and chunk")
        stamps = wt_ops.stamp_through_launches - s0
        check(stamps == (M * (chunks + 1) if job._measure_timings else 0),
              f"{what}: stamp_through launched at every wave boundary of every slot, and only"
              f" when measured (got {stamps})")
        check_oracle(res, oracle, what)
        return res, {"wall_ms": wall_ms, **job.last_phase_ms, "chunks": chunks,
                     "stamp_launches": stamps}

    untimed = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n),
                           backend="sharded")
    check(all(d == dev for d in untimed.devices)
          and len({s.cuda_stream for s in untimed.streams}) == M,
          "the sharded job puts its slots on the card, one stream each")
    runs = []
    for b, (batch, oracle) in enumerate(batches):
        res, info = one(untimed, batch, oracle, f"measured path: untimed sharded batch {b}")
        if b == 0:
            check(np.array_equal(res.values, pipelined0[0])
                  and np.array_equal(res.counts, pipelined0[1]),
                  "sharded batch 0 == the stacked main path's, bit for bit")
            plan = untimed.last_plan
            check(np.array_equal(plan.schedule.assignment, main_plan0.schedule.assignment)
                  and np.array_equal(plan.waves.rank_of_cluster, main_plan0.waves.rank_of_cluster)
                  and np.array_equal(plan.waves.chunk_of_cluster,
                                     main_plan0.waves.chunk_of_cluster)
                  and tuple(plan.chunk_caps) == tuple(main_plan0.chunk_caps),
                  "sharded batch 0 plans as the stacked main path")
        stacked = main_runs[b]
        runs.append({"seed": stacked["seed"], "stacked": {
            k: stacked[k] for k in ("wall_ms", "phase_a", "plan", "phase_b")}, "sharded": info})
        print(f"measured path batch {stacked['seed']}: oracle ok | phase A / plan / phase B ms: "
              f"stacked {stacked['phase_a']:.1f} / {stacked['plan']:.1f} / "
              f"{stacked['phase_b']:.1f}, sharded {info['phase_a']:.1f} / {info['plan']:.1f} / "
              f"{info['phase_b']:.1f}", flush=True)
    del untimed
    torch.cuda.empty_cache()

    job = MapReduceJob(lambda b: b, MapReduceConfig(
        num_slots=M, num_clusters=n, estimate_speeds=True, measure_timings=True),
        backend="sharded")
    check(job._measure_timings, "measure_timings=True resolves to measured clocks")
    steps = []
    for step in range(6):
        b = step % len(batches)
        if step == len(batches):
            job.set_slot_slowdown(0, 2.0)
        batch, oracle = batches[b]
        what = f"measured path: measured step {step} (batch {b})"
        res, info = one(job, batch, oracle, what)
        t = job.last_wave_timings
        check(t.valid and t.seconds.shape == (M, info["chunks"]) and bool((t.seconds > 0).all()),
              f"{what}: valid all-positive ({M}, {info['chunks']}) wave timings")
        speeds = job.speed_estimator.speeds()
        load = np.bincount(res.schedule.assignment, weights=res.key_distribution, minlength=M)
        per_slot = t.slot_seconds()
        info.update(
            slowdown0=float(job._slot_slowdown[0]),
            wave_s={"min": float(t.seconds.min()), "median": float(np.median(t.seconds)),
                    "max": float(t.seconds.max())},
            slot_s={"min": float(per_slot.min()), "median": float(np.median(per_slot)),
                    "max": float(per_slot.max())},
            speed0=float(speeds[0]), speed_min=float(speeds.min()), speed_max=float(speeds.max()),
            load0_share=float(load[0] / load.sum()),
            phase_b_ratio=info["phase_b"] / runs[b]["sharded"]["phase_b"])
        steps.append(info)
        print(f"{what}: oracle ok | phase A {info['phase_a']:.1f} ms | plan {info['plan']:.1f} "
              f"ms | phase B {info['phase_b']:.1f} ms (measured / untimed "
              f"{info['phase_b_ratio']:.3f}) | wave s min/median/max "
              f"{info['wave_s']['min']:.6f} / {info['wave_s']['median']:.6f} / "
              f"{info['wave_s']['max']:.6f} | speed[0] {info['speed0']:.4f} (range "
              f"{info['speed_min']:.4f}-{info['speed_max']:.4f}) | slot 0 planned load share "
              f"{info['load0_share']:.5f}", flush=True)
    before, after = steps[len(batches) - 1], steps[-1]
    check(after["speed0"] < 0.75, f"slot 0 slowed 2x reads below 0.75 (got {after['speed0']:.4f})")
    check(after["load0_share"] < before["load0_share"], "slot 0's planned load fell")
    del job
    torch.cuda.empty_cache()

    # The stamps' overhead: an untimed and a measured job that replay one
    # plan (a reuse policy that never replans for drift or speed, with room
    # against overflow), in turns (untimed, measured, measured, untimed) on
    # every batch, twice.
    policy = ReusePolicy(max_drift=1.0, max_speed_drift=float("inf"), capacity_slack=1.0)
    pair = {"untimed": MapReduceJob(lambda b: b, MapReduceConfig(
                num_slots=M, num_clusters=n, reuse=policy), backend="sharded"),
            "measured": MapReduceJob(lambda b: b, MapReduceConfig(
                num_slots=M, num_clusters=n, reuse=policy, estimate_speeds=True,
                measure_timings=True), backend="sharded")}
    for label, job in pair.items():
        one(job, batches[0][0], batches[0][1], f"measured path: overhead pair, {label} warm-up")
    overhead = []
    for _ in range(2):
        for b, (batch, oracle) in enumerate(batches):
            phase_b = {"untimed": [], "measured": []}
            for label in ("untimed", "measured", "measured", "untimed"):
                res, info = one(pair[label], batch, oracle,
                                f"measured path: overhead pair, {label} batch {b}")
                check(res.reused, "the overhead pair replays its plan")
                phase_b[label].append(info["phase_b"])
            overhead.append({"batch": b, **phase_b,
                             "ratio": float(np.mean(phase_b["measured"])
                                            / np.mean(phase_b["untimed"]))})
    plans = [job.last_plan for job in pair.values()]
    check(np.array_equal(plans[0].schedule.assignment, plans[1].schedule.assignment)
          and tuple(plans[0].chunk_caps) == tuple(plans[1].chunk_caps),
          "the overhead pair ran one plan")
    ratios = [o["ratio"] for o in overhead]
    print(f"measured path: measured / untimed phase B on one replayed plan, in turns: ratios "
          + ", ".join(f"{r:.3f}" for r in ratios) + f" (median {np.median(ratios):.3f}); "
          f"phase B ms untimed {np.median([t for o in overhead for t in o['untimed']]):.1f}, "
          f"measured {np.median([t for o in overhead for t in o['measured']]):.1f} (medians)",
          flush=True)
    del pair
    launches = read_launches(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"measured path launches: {launches} | peak device memory {peak_gb:.1f} GB", flush=True)
    prof_batch = batches[0][0]
    torch.cuda.empty_cache()
    prof_job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n),
                            backend="sharded")
    prof_job.run(prof_batch)
    profile = profile_run("profile sharded batch 0", lambda: prof_job.run(prof_batch), prof_job)
    del prof_job
    torch.cuda.empty_cache()
    return {"calibration_s_per_tick": cal.seconds_per_tick, "calibration_ms": cal_ms,
            "connections": os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS"),
            "untimed": runs, "measured": steps, "overhead": overhead, "peak_gb": peak_gb,
            "profile": profile}, launches


class TimedCalls:
    """Wraps one method of a job (``job.<name>``): each call's host time in
    ms, after a device synchronise at both ends when ``sync``."""

    def __init__(self, job, name: str, sync: bool):
        self.ms = []
        self._fn = getattr(job, name)
        self._sync = sync
        setattr(job, name, self)

    def __call__(self, *args, **kwargs):
        if self._sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if self._sync:
            torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def reslice(batch, m: int):
    """The same pairs re-sliced into ``m`` shards: every slot's stream laid
    end to end, padded with invalid pairs to a multiple of ``m``."""
    keys, values, valid = batch
    total = keys.numel()
    k = -(-total // m)
    pad = m * k - total
    v = values.shape[-1]
    return (torch.cat([keys.reshape(-1), keys.new_zeros(pad)]).view(m, k),
            torch.cat([values.reshape(-1, v), values.new_zeros((pad, v))]).view(m, k, v),
            torch.cat([valid.reshape(-1), valid.new_zeros(pad)]).view(m, k))


def run_timed(job, batch, counters) -> tuple:
    """``job.run(batch)`` from a synchronised start: ``(result, info)`` with
    the wall time, the phases and kernels 1 and 2's launches in the run."""
    hist_mod, fused_mod = counters["histogram"][0], counters["fused_shuffle_reduce"][0]
    h0, f0 = hist_mod.launches, fused_mod.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = job.run(batch)
    wall_ms = (time.perf_counter() - t0) * 1e3
    return res, {"wall_ms": wall_ms, **job.last_phase_ms,
                 "histogram_launches": hist_mod.launches - h0,
                 "fused_launches": fused_mod.launches - f0}


def same_bits(res, want) -> bool:
    """A result's values and counts equal bit for bit to another result's,
    or to a ``(values, counts)`` pair."""
    values, counts = (want.values, want.counts) if hasattr(want, "values") else want
    return np.array_equal(res.values, values) and np.array_equal(res.counts, counts)


def elastic_path(batches, main_runs, main_plan0, main_peak_gb, pipelined0, counters, n, smi,
                 MapReduceConfig, MapReduceJob, ReusePolicy, dev):
    """The elastic mesh at the main path's size (see the module docstring).
    Every check raises. Returns ``(record, launches)`` with the path's
    kernel counts (set to 0 just before it)."""
    (batch0, oracle0), (batch1, oracle1) = batches[0], batches[1]
    chunks = main_plan0.waves.num_chunks
    torch.cuda.empty_cache()
    reset_launches(counters)

    # 1. The fence's price: a fused and a checkpointed job replay the main
    # path's plan of batch 0 (loaded as a snapshot) in turns.
    policy = ReusePolicy(max_drift=1.0, max_speed_drift=float("inf"))
    pair = {label: MapReduceJob(lambda b: b, MapReduceConfig(
                num_slots=M, num_clusters=n, reuse=policy, checkpoint_waves=ckpt))
            for label, ckpt in (("fused", False), ("checkpointed", True))}
    for job in pair.values():
        job.load_snapshot(main_plan0.to_json())
    turns = {"fused": [], "checkpointed": []}
    for _ in range(2):
        for label in ("fused", "checkpointed", "checkpointed", "fused"):
            res, info = run_timed(pair[label], batch0, counters)
            what = f"elastic path: {label} replay of the main plan on batch 0"
            check(res.reused and info["histogram_launches"] == 1
                  and info["fused_launches"] == chunks,
                  f"{what}: replayed, kernel 1 once, kernel 2 once a wave")
            check(same_bits(res, pipelined0), f"{what}: == the main path's fused run, "
                  "bit for bit")
            check_oracle(res, oracle0, what)
            turns[label].append(info["phase_b"])
    ck = pair["checkpointed"]
    check(ck.last_checkpoint_wave == chunks and ck.last_replayed_waves == 0
          and ck.last_replay_plan is None and ck.mesh_events == [],
          "elastic path: the uninterrupted walk checkpointed every wave and replayed none")
    fence = float(np.median(turns["checkpointed"]) / np.median(turns["fused"]))
    print(f"elastic path: checkpointed == fused == oracle on the main plan, bit for bit | phase "
          f"B ms in turns: fused {', '.join(f'{t:.1f}' for t in turns['fused'])}; checkpointed "
          f"{', '.join(f'{t:.1f}' for t in turns['checkpointed'])} (median ratio {fence:.3f}) | "
          f"{smi}", flush=True)
    del pair, ck
    torch.cuda.empty_cache()

    # 2. A kill before wave 2 of batch 0: the residue replays on 31 slots.
    job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n,
                                                    checkpoint_waves=True, reuse=ReusePolicy()))
    events = []
    job.on_mesh_change = events.append
    replays = TimedCalls(job, "_execute", sync=True)
    plans = TimedCalls(job, "_plan", sync=False)
    job.set_slot_failure(KILL_SLOT, at_wave=KILL_WAVE)
    torch.cuda.reset_peak_memory_stats()
    killed, kinfo = run_timed(job, batch0, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    what = f"elastic path: batch 0 with slot {KILL_SLOT} killed before wave {KILL_WAVE}"
    check_oracle(killed, oracle0, what)
    check(same_bits(killed, pipelined0), f"{what}: == the main path's run, bit for bit")
    rplan = job.last_replay_plan
    check(job.last_checkpoint_wave == KILL_WAVE and job.last_replayed_waves == chunks - KILL_WAVE,
          f"{what}: waves 0-{KILL_WAVE - 1} checkpointed, {chunks - KILL_WAVE} replayed (got "
          f"{job.last_checkpoint_wave}, {job.last_replayed_waves})")
    check(rplan is not None and rplan.schedule.slot_loads[KILL_SLOT] == 0.0
          and not bool((rplan.schedule.assignment == KILL_SLOT).any()),
          f"{what}: the replay plan gives slot {KILL_SLOT} no load")
    check(kinfo["fused_launches"] == KILL_WAVE + job.last_replayed_waves and len(replays.ms) == 1,
          f"{what}: kernel 2 launched once a walked wave and once a replayed wave")
    check([e["event"] for e in events] == ["slot_dead"] and bool(job.dead_slots[KILL_SLOT]),
          f"{what}: one slot_dead event")
    killed_rec = {**kinfo, "replay_ms": replays.ms[0], "replan_ms": plans.ms[-1],
                  "replayed_waves": job.last_replayed_waves, "peak_gb": peak_gb}
    whole = main_runs[0]
    print(f"{what}: oracle ok, == main path, replay plan gives slot {KILL_SLOT} no load | run "
          f"{kinfo['wall_ms']:.1f} ms (phase A {kinfo['phase_a']:.1f}, plan {kinfo['plan']:.1f}, "
          f"phase B {kinfo['phase_b']:.1f}, of which the residue's re-plan "
          f"{killed_rec['replan_ms']:.1f} and replay {replays.ms[0]:.1f}) against a whole batch's "
          f"{whole['wall_ms']:.1f} ms (phase B {whole['phase_b']:.1f}) | kernel 2 launches "
          f"{kinfo['fused_launches']} ({KILL_WAVE} walked + {job.last_replayed_waves} replayed) | "
          f"peak {peak_gb:.1f} GB (main path {main_peak_gb:.1f} GB) | {smi}", flush=True)

    # 3. Batch 1 plans around the dead slot.
    res1, info1 = run_timed(job, batch1, counters)
    what = "elastic path: batch 1 after the kill"
    check(res1.plan_reason == "slot_dead" and not res1.reused
          and res1.schedule.slot_loads[KILL_SLOT] == 0.0,
          f"{what}: replanned for the dead slot (reason {res1.plan_reason!r}), slot "
          f"{KILL_SLOT} has no load")
    check(job.last_replayed_waves == 0
          and info1["fused_launches"] == job.last_plan.waves.num_chunks, f"{what}: a clean walk")
    check_oracle(res1, oracle1, what)
    print(f"{what}: {res1.plan_reason}, slot {KILL_SLOT} load 0, oracle ok | run "
          f"{info1['wall_ms']:.1f} ms (phase B {info1['phase_b']:.1f})", flush=True)
    checked = [plan_findings(f"the elastic path's replay plan (slot {KILL_SLOT} killed before "
                             f"wave {KILL_WAVE})", rplan, n, whole=False),
               plan_findings("the elastic path's slot_dead re-plan of batch 1", job.last_plan,
                             n, whole=False)]

    # 4. Warm resize 32 -> 24 -> 32: the snapshot is re-projected, and batch
    # 1's pairs re-sliced into 24 shards replay it.
    t0 = time.perf_counter()
    job.resize(RESIZED_M)
    resize_ms = (time.perf_counter() - t0) * 1e3
    snap = job.schedule_cache.snapshot
    check(job.schedule_cache.reprojections == 1 and snap.schedule.num_slots == RESIZED_M
          and snap.schedule.slot_loads[KILL_SLOT] == 0.0,
          f"elastic path: resize({RESIZED_M}) re-projected the snapshot, slot {KILL_SLOT} "
          "still dead")
    small = reslice(batch1, RESIZED_M)
    res24, info24 = run_timed(job, small, counters)
    what = f"elastic path: batch 1 re-sliced into {RESIZED_M} shards"
    check(res24.reused and info24["histogram_launches"] == 1
          and info24["fused_launches"] == snap.waves.num_chunks,
          f"{what}: replays the re-projected plan (reason {res24.plan_reason!r})")
    check_oracle(res24, oracle1, what)
    del small
    t0 = time.perf_counter()
    job.resize(M)
    resize_back_ms = (time.perf_counter() - t0) * 1e3
    check(job.schedule_cache.reprojections == 2
          and job.schedule_cache.snapshot.schedule.num_slots == M,
          f"elastic path: resize({M}) re-projected the snapshot back")
    res32, info32 = run_timed(job, batch1, counters)
    check_oracle(res32, oracle1, "elastic path: batch 1 back at 32 slots")
    check([e["event"] for e in events] == ["slot_dead", "resize", "resize"],
          "elastic path: mesh events slot_dead, resize, resize")
    print(f"{what}: reused, oracle ok | resize({RESIZED_M}) {resize_ms:.1f} ms (re-bin + one "
          f"host plan), run at {RESIZED_M} {info24['wall_ms']:.1f} ms (phase B "
          f"{info24['phase_b']:.1f}) | resize({M}) {resize_back_ms:.1f} ms, batch 1 at {M}: "
          f"{res32.plan_reason}, reused={res32.reused}, oracle ok, run {info32['wall_ms']:.1f} ms "
          f"| events {[e['event'] for e in events]}", flush=True)
    cache_stats = job.schedule_cache.stats()
    del job, res1, res24, res32
    torch.cuda.empty_cache()

    # 5. The sharded backend (32 streams): the same kill, then resize with
    # the 24 slots' devices.
    sjob = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n,
                                                     checkpoint_waves=True), backend="sharded")
    sjob.set_slot_failure(KILL_SLOT, at_wave=KILL_WAVE)
    sk, sinfo = run_timed(sjob, batch0, counters)
    what = "elastic path: sharded batch 0 with the same kill"
    check(same_bits(sk, killed) and sk.overflow == 0, f"{what}: == the stacked killed run, bit for "
          "bit")
    check(np.array_equal(sjob.last_replay_plan.schedule.assignment, rplan.schedule.assignment),
          f"{what}: the stacked run's replay plan")
    check(sinfo["histogram_launches"] == M
          and sinfo["fused_launches"] == M * (KILL_WAVE + sjob.last_replayed_waves),
          f"{what}: kernel 1 once a slot, kernel 2 once a slot and walked or replayed wave")
    sjob.resize(RESIZED_M, devices=[dev] * RESIZED_M)
    check(len(sjob.devices) == RESIZED_M and None not in sjob.streams
          and len({st.cuda_stream for st in sjob.streams}) == RESIZED_M,
          f"elastic path: sharded resize({RESIZED_M}) placed {RESIZED_M} slot streams")
    small = reslice(batch1, RESIZED_M)
    s24, s24info = run_timed(sjob, small, counters)
    check_oracle(s24, oracle1, f"elastic path: sharded batch 1 at {RESIZED_M} slots")
    check(s24info["histogram_launches"] == RESIZED_M,
          f"elastic path: sharded batch at {RESIZED_M} slots: kernel 1 once a slot")
    print(f"{what}: == stacked, bit for bit | run {sinfo['wall_ms']:.1f} ms (phase B "
          f"{sinfo['phase_b']:.1f}) | resize({RESIZED_M}, devices) then batch 1: oracle ok, run "
          f"{s24info['wall_ms']:.1f} ms", flush=True)
    del sjob, small, sk, s24, killed
    torch.cuda.empty_cache()
    launches = read_launches(counters)
    print(f"elastic path launches: histogram {launches['histogram']}, fused_shuffle_reduce "
          f"{launches['fused_shuffle_reduce']} | peak device memory (killed batch) {peak_gb:.1f} "
          f"GB (main path {main_peak_gb:.1f} GB) | {smi}", flush=True)
    return {"fence": {"phase_b_turns": turns, "ratio": fence}, "killed": killed_rec,
            "after_kill": info1,
            "resize": {"to_ms": resize_ms, "back_ms": resize_back_ms, "run_24": info24,
                       "run_32": info32, "cache": cache_stats},
            "sharded": {"killed": sinfo, "run_24": s24info}, "peak_gb": peak_gb,
            "plan_checks": checked}, launches


def multi_job_path(batches, counters, n, smi, seed, MapReduceConfig, MapReduceJob,
                   ReusePolicy, MultiJobCoordinator, dev):
    """Two tenants on one 32-slot mesh (see the module docstring): solo runs,
    ``run_queue`` in WSPT and FIFO order and ``run_interleaved``, every
    result equal to its solo run and its oracle bit for bit. Every check
    raises. Returns ``(record, launches)`` with the path's kernel counts
    (set to 0 just before it)."""
    t0 = time.perf_counter()
    sj = Workload(n, dev, num_keys=SJ_KEYS, zipf_s=SJ_ZIPF_S, v=SJ_V)
    sj_batches = []
    for b in range(2):
        batch, _, oracle = sj.batch(seed + SJ_SEED + b)
        sj_batches.append((batch, oracle))
    del sj
    data_s = time.perf_counter() - t0
    for _, oracle in sj_batches:
        check(float(oracle[0].max()) < 2 ** 24, "SelfJoin oracle below 2^24 (exact in f32)")
    hot = float(sj_batches[0][1][1].max() / sj_batches[0][1][1].sum())
    print(f"multi-job path: SelfJoin batches {seed + SJ_SEED}, {seed + SJ_SEED + 1} in "
          f"{data_s:.1f} s (m={M}, K={K}, V={SJ_V}, n={n}; hottest cluster {hot:.4f} of the "
          "pairs)", flush=True)
    tenants = {"II": (1.0, batches[:2]), "SJ": (2.0, sj_batches)}
    torch.cuda.empty_cache()
    reset_launches(counters)

    def make():
        return MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n,
                                                         reuse=ReusePolicy()))

    solo, solo_runs = {}, {}
    for name, (_, bs) in tenants.items():
        job = make()
        solo[name], solo_runs[name] = [], []
        for b, (batch, oracle) in enumerate(bs):
            res, info = run_timed(job, batch, counters)
            check_oracle(res, oracle, f"multi-job path: {name} alone, batch {b}")
            check(info["histogram_launches"] == 1 and info["fused_launches"] > 0,
                  f"multi-job path: {name} alone, batch {b}: kernels 1 and 2 launched")
            solo[name].append((res.values, res.counts))
            solo_runs[name].append(info)
        del job
    for name, runs in solo_runs.items():
        print(f"multi-job path: {name} alone: runs " + ", ".join(
            f"{r['wall_ms']:.1f} ms (plan {r['plan']:.1f}, phase B {r['phase_b']:.1f})"
            for r in runs), flush=True)

    def coordinator():
        co = MultiJobCoordinator(num_slots=M)
        for name, (weight, bs) in tenants.items():
            co.add_job(name, make(), weight=weight)
            co[name].observe_batch_seconds(
                float(np.mean([r["wall_ms"] for r in solo_runs[name]])) / 1e3)
            for batch, _ in bs:
                co.submit(name, batch)
        return co

    def same_as_solo(co, what):
        for name, (_, bs) in tenants.items():
            results = co[name].results
            check(len(results) == len(bs), f"{what}: {name} ran {len(bs)} batches")
            for b, (res, want, (_, oracle)) in enumerate(zip(results, solo[name], bs)):
                check(same_bits(res, want),
                      f"{what}: {name} batch {b} == its solo run, bit for bit")
                check_oracle(res, oracle, f"{what}: {name} batch {b}")
        stats = co.tenants.stats()
        check(stats["collisions"] == 0 and co.tenants.keys() == list(tenants)
              and co["II"].job.schedule_cache is not co["SJ"].job.schedule_cache,
              f"{what}: one cache a tenant, no collision")
        return stats

    queues = {}
    for order in ("wspt", "fifo"):
        co = coordinator()
        planned = {o: co.planned_weighted_completion(o) for o in ("wspt", "fifo")}
        out = co.run_queue(order)
        stats = same_as_solo(co, f"multi-job path: run_queue({order!r})")
        queues[order] = {"order": out["order"], "completions": out["completions"],
                         "weighted_completion": out["weighted_completion"],
                         "planned": planned, "coschedule_overlap": out["coschedule_overlap"],
                         "cache": {k: stats[k] for k in ("tenants", "collisions", "batches",
                                                         "replans", "reuses")}}
        print(f"multi-job path: run_queue({order!r}): order {out['order']}, completions "
              + ", ".join(f"{k} {v:.3f} s" for k, v in out["completions"].items())
              + f" | measured sum w*C {out['weighted_completion']:.4f} s; planned wspt "
              f"{planned['wspt']:.4f}, fifo {planned['fifo']:.4f} | coschedule overlap "
              f"{out['coschedule_overlap']:.3f} | every result == solo == oracle | {smi}",
              flush=True)
        del co
    check(queues["wspt"]["planned"]["wspt"] <= queues["wspt"]["planned"]["fifo"] + 1e-9,
          "multi-job path: WSPT's planned sum w*C is no more than FIFO's")
    co = coordinator()
    t0 = time.perf_counter()
    seq = co.run_interleaved()
    interleaved_s = time.perf_counter() - t0
    check([name for name, _ in seq] == ["II", "SJ", "II", "SJ"],
          "multi-job path: run_interleaved alternates the tenants")
    same_as_solo(co, "multi-job path: run_interleaved")
    del co, seq
    launches = read_launches(counters)
    print(f"multi-job path: run_interleaved {interleaved_s:.3f} s, every result == solo == oracle "
          f"| launches histogram {launches['histogram']}, fused_shuffle_reduce "
          f"{launches['fused_shuffle_reduce']}", flush=True)
    del sj_batches, tenants
    torch.cuda.empty_cache()
    return {"sj": {"keys": SJ_KEYS, "zipf_s": SJ_ZIPF_S, "v": SJ_V, "data_s": data_s},
            "solo": solo_runs, "queues": queues, "interleaved_s": interleaved_s}, launches


def wave_timer_phase(wt_ops, wt_ref, copy_split, launch_floor, ids_shape, dev) -> dict:
    """Kernels 5-6 at the measured path's shapes. ``stamp_through`` copies one
    slot's received cluster ids of chunk 0 (``ids_shape`` int32) bitwise,
    through the bulk-copy ring, and an unaligned byte view through the byte
    path; it is timed against its plain version and ``Tensor.copy_``, as
    device time from a burst queued behind a spin and with CUDA events
    around one call; ``read_ticks``
    is timed over back-to-back launches, and so is an empty kernel
    (``launch_floor``, the same burst and launch count): its time a launch
    is ``read_ticks``' bound (``bound_by`` "launch"; the 9 bytes it moves,
    ``bytes_bound_ms``). Stamp intervals are held against
    CUDA event times over >= 10 ms spins (within 5%), and back-to-back stamps
    give the timer's smallest step. Returns ``{"read_ticks": ..., "stamp_through":
    ..., "timer": ...}``."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-2 ** 31, 2 ** 31, ids_shape, generator=gen, device=dev, dtype=torch.int32)
    got, _ = wt_ops.stamp_through(x)
    want, _ = wt_ref.stamp_through_ref(x)
    torch.cuda.synchronize()
    check(torch.equal(got, x) and torch.equal(got, want), "stamp_through copies bit for bit")
    split = copy_split(x.data_ptr(), got.data_ptr(), x.numel() * x.element_size())
    check(split[1] > 0, "the measured path's copy goes through the bulk-copy ring")
    odd = x.view(-1).view(torch.uint8)[1:]            # unaligned bytes: the byte path
    got_odd, _ = wt_ops.stamp_through(odd)
    torch.cuda.synchronize()
    check(torch.equal(got_odd, odd), "stamp_through copies unaligned bytes bit for bit")
    copy_err = float((got.long() - want.long()).abs().max())
    del got, want, got_odd
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    b_ms, by = bound_ms(2 * nbytes + 8, 0)
    ms, host_ms = device_ms(lambda: wt_ops.stamp_through(x))
    plain_ms, plain_host_ms = device_ms(lambda: wt_ref.stamp_through_ref(x))
    stamp = {"shape": list(ids_shape), "bytes": 2 * nbytes + 8, "max_abs_err": copy_err,
             "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
             "library_ms": device_ms(lambda: out.copy_(x))[0],
             "event_ms": cuda_ms(lambda: wt_ops.stamp_through(x), reps=50, warmup=5),
             "library_event_ms": cuda_ms(lambda: out.copy_(x), reps=50, warmup=5),
             "head_body": list(split),
             "bound_ms": b_ms, "bound_by": by}
    del out

    # read_ticks: device time a launch (a queued burst), the host's time to
    # issue one, and the plain version's (host) time.
    anchor = torch.ones(1, device=dev)
    ms, host_ms = device_ms(lambda: wt_ops.read_ticks(anchor), launches=200)
    floor_ms, floor_host_ms = device_ms(lambda: launch_floor(dev), launches=200)
    t0 = time.perf_counter()
    for _ in range(1000):
        wt_ref.read_ticks_plain()
    b_ms, by = bound_ms(8 + 1, 0)
    read = {"ms": ms, "host_ms": host_ms, "plain_ms": (time.perf_counter() - t0) * 1e3 / 1000,
            "library_ms": None, "bound_ms": floor_ms, "bound_by": "launch",
            "floor_host_ms": floor_host_ms, "bytes_bound_ms": b_ms, "bytes_bound_by": by}

    # Stamp intervals against CUDA events over device-side spins.
    cal = wt_ops.tick_calibration(dev)
    errs = []
    for cycles in (20_000_000, 40_000_000, 80_000_000):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        a = wt_ops.read_ticks(anchor)
        torch.cuda._sleep(cycles)
        b = wt_ops.read_ticks(anchor)
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end)
        ticks = wt_ops.combine_ticks(np.stack([wt_ops.ticks_numpy(a), wt_ops.ticks_numpy(b)]))
        stamp_ms = float(ticks[1] - ticks[0]) * cal.seconds_per_tick * 1e3
        errs.append({"event_ms": event_ms, "stamp_ms": stamp_ms,
                     "rel_err": abs(stamp_ms - event_ms) / event_ms})
        check(event_ms >= 10.0, f"spin of {cycles} cycles lasts >= 10 ms (got {event_ms:.2f})")
        check(errs[-1]["rel_err"] <= 0.05,
              f"stamp interval within 5% of CUDA events ({stamp_ms:.4f} vs {event_ms:.4f} ms)")
    read["max_abs_err"] = max(abs(e["stamp_ms"] - e["event_ms"]) for e in errs)

    # The timer's update step: back-to-back stamps, queued behind a spin so
    # that they run as fast as the card launches them.
    torch.cuda._sleep(200_000_000)
    stamps = [wt_ops.read_ticks(anchor) for _ in range(4000)]
    torch.cuda.synchronize()
    values = wt_ops.combine_ticks(np.stack([wt_ops.ticks_numpy(t) for t in stamps]))
    steps = np.diff(values)
    nonzero = steps[steps > 0]
    check(bool((steps >= 0).all()) and nonzero.size > 0, "back-to-back stamps never go back")
    timer = {"seconds_per_tick": cal.seconds_per_tick, "intervals": errs,
             "min_step_ns": float(nonzero.min() * cal.seconds_per_tick * 1e9),
             "step_gcd_ticks": int(np.gcd.reduce(nonzero)),
             "zero_steps": int((steps == 0).sum()), "steps": int(steps.size),
             "median_step_ns": float(np.median(steps) * cal.seconds_per_tick * 1e9)}
    return {"read_ticks": read, "stamp_through": stamp, "timer": timer}


def profile_run(label, fn, job=None) -> dict:
    """One ``fn()`` under the profiler, tracing the device alone: its wall
    time, the device's busy time (the union of kernel and copy intervals)
    and the top device operations, read from the raw trace events (a
    training step issues tens of thousands of kernels, whose parsed trace
    takes longer to build than the steps take to run)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == on_device]
    by_name = {}
    for name, _, ns in raw:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + ns / 1e6, count + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    spans = [(start, start + ns) for _, start, ns in raw]
    device_ms, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        device_ms += max(0.0, hi - max(lo, end)) / 1e6
        end = max(end, hi)
    if device_ms > 0:
        print(f"{label}: run {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
              f"({device_ms / wall_ms:.3f} of the run)", flush=True)
        for name, ms, count in top[:8]:
            print(f"  {ms:9.3f} ms  {count:4d}x  {name[:90]}", flush=True)
    else:
        print(f"{label}: the profiler saw no device time; busy share not measured",
              flush=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_ops": len(raw),
            "phases": None if job is None else job.last_phase_ms, "top": top[:12]}


def flash_phase(fa_ops, flash_ref, fa_cuda, admit, dev) -> dict:
    """Kernel 9 against its plain version, at the serve path's prefill shape
    (B = 8 lanes, Hq = 32, Hkv = 8, T = S = the longest prompt, D = 128,
    bf16) and at more shapes of both instances. ``admit[path]`` is the
    (shortest, longest) prompt of the path's engine (:func:`admission_lens`).
    The wgmma instance (bf16, D = 64 or 128): ragged T < S, T > S (rows
    that see no key give exact 0), GQA groups 1, 4 and 8, D = 64,
    non-causal, and grok-1's head layout on the MoE path (Hq = 48, Hkv = 8:
    a GQA group of 6) at its engine's longest admission (B = 1), at a
    ragged T and at its placement prefills (B = 8, T = S = 512). The simt
    instance: f32 with T < S, f32 at the smollm twin's D = 20, f32 with
    T > S, bf16 at D = 256. The family paths' shapes, each on the instance
    its path runs: MLA's placement prefill (D = 192, simt), whisper's
    encoder (T = S = 1500) and cross-attention (T = the longest prompt,
    S = 1500), both non-causal at D = 64, and qwen2-vl's GQA group of 7
    (wgmma), each timed beside SDPA (device time from a burst behind a
    spin) under ``res["family"]``; and the engines' shortest and longest
    admissions of each family: qwen2-vl at B = 8 lanes, T = S = 256
    patches + the prompt; MLA at B = 4 lanes, D = 192 (simt); whisper's
    causal decoder self-attention (T = S = the prompt) and its
    cross-attention at the shortest prompt (T < 32 against S = 1500); and
    zamba2's shared block at D = 80 (simt): its prefill (B = 8, T = S =
    STATE_PROMPT) and full forward (T = S = STATE_PROMPT + STATE_DECODE),
    both timed beside SDPA, its float32 check's prefill, its warm-up
    prefill (T = 64) and its f32 twin's prefill. Each
    case checks that it went through the instance ``fa_ops.design`` names.

    Tolerance: 3e-2 in bf16, 2e-5 in f32 (the reference's own kernel tests;
    the two sum in other orders). At the serve shape the kernel and
    ``scaled_dot_product_attention`` (GQA, causal) are timed both as device
    time from a burst queued behind a spin (``device_ms``: the wrapper's
    host cost cannot pass for the kernel's) and with CUDA events around one
    call (``cuda_ms``); the plain version with CUDA events; and the simt
    instance on the same bf16 inputs (called directly, not counted), for
    the time the wgmma instance replaces. Bound: causal flops 4 B Hq D (T S
    - T (T - 1) / 2) at the bf16 tensor rate, against q, k, v and o once at
    the memory rate.
    """
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products of the plain version run in full float32")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    (_, serve_len), (_, moe_len) = admit["serve"], admit["moe"]
    (vlm_min, vlm_max), (mla_min, mla_max) = admit["vlm"], admit["mla"]
    wh_min, wh_max = admit["whisper"]
    cases = {"serve": (8, 32, 8, serve_len, serve_len, 128, bf16, True),
             "bf16_t1_s300": (2, 8, 2, 1, 300, 128, bf16, True),
             "bf16_t65_s300": (2, 8, 2, 65, 300, 128, bf16, True),
             "bf16_t130_s300": (2, 8, 2, 130, 300, 128, bf16, True),
             "bf16_t_gt_s": (2, 4, 2, 130, 60, 128, bf16, True),
             "bf16_gqa1": (1, 4, 4, 257, 257, 128, bf16, True),
             "bf16_gqa8": (1, 8, 1, 200, 200, 128, bf16, True),
             "bf16_d64": (2, 8, 2, 256, 256, 64, bf16, True),
             "bf16_d64_t_gt_s": (2, 8, 2, 70, 30, 64, bf16, True),
             "bf16_noncausal": (2, 4, 2, 130, 700, 128, bf16, False),
             "moe_engine": (1, 48, 8, moe_len, moe_len, 128, bf16, True),
             "moe_ragged": (1, 48, 8, 201, 201, 128, bf16, True),
             "moe_prefill": (MOE_PROMPTS, 48, 8, MOE_PROMPT_LEN, MOE_PROMPT_LEN, 128, bf16,
                             True),
             "f32_t_lt_s": (2, 8, 2, 100, 300, 128, f32, True),
             "f32_d20": (2, 3, 1, 50, 50, 20, f32, True),
             "f32_t_gt_s": (2, 4, 2, 70, 30, 64, f32, True),
             "bf16_d256": (1, 2, 2, 130, 130, 256, bf16, True),
             "mla_prefill": (MLA_PROMPTS, 128, 128, MLA_PROMPT_LEN, MLA_PROMPT_LEN, 192, bf16,
                             True),
             "whisper_encoder": (WHISPER_LANES, 8, 8, 1500, 1500, 64, bf16, False),
             "whisper_cross": (WHISPER_LANES, 8, 8, wh_max, 1500, 64, bf16, False),
             "vlm_prefill": (VLM_BATCH, 28, 4, 2 * VLM_TEXT, 2 * VLM_TEXT, 128, bf16, True),
             "vlm_engine": (SERVE_LANES, 28, 4, vlm_max, vlm_max, 128, bf16, True),
             "vlm_engine_short": (SERVE_LANES, 28, 4, vlm_min, vlm_min, 128, bf16, True),
             "mla_engine": (MLA_LANES, 128, 128, mla_max, mla_max, 192, bf16, True),
             "mla_engine_short": (MLA_LANES, 128, 128, mla_min, mla_min, 192, bf16, True),
             "whisper_decoder": (WHISPER_LANES, 8, 8, wh_max, wh_max, 64, bf16, True),
             "whisper_decoder_short": (WHISPER_LANES, 8, 8, wh_min, wh_min, 64, bf16, True),
             "whisper_cross_short": (WHISPER_LANES, 8, 8, wh_min, 1500, 64, bf16, False),
             "zamba_prefill": (STATE_BATCH, 32, 32, STATE_PROMPT, STATE_PROMPT, 80, bf16, True),
             "zamba_full": (STATE_BATCH, 32, 32, STATE_PROMPT + STATE_DECODE,
                            STATE_PROMPT + STATE_DECODE, 80, bf16, True),
             "zamba_f32_prefill": (STATE_BATCH, 32, 32, STATE_PROMPT, STATE_PROMPT, 80, f32,
                                   True),
             "zamba_warmup": (STATE_BATCH, 32, 32, 64, 64, 80, bf16, True),
             "zamba_twin": (2, 32, 32, STATE_TWIN_PROMPT, STATE_TWIN_PROMPT, 80, f32, True)}
    # The shapes the family paths give the kernel and the instance each path
    # runs; ``timed`` are timed beside SDPA.
    family_design = {"mla_prefill": "simt", "whisper_encoder": "wgmma",
                     "whisper_cross": "wgmma", "vlm_prefill": "wgmma", "vlm_engine": "wgmma",
                     "vlm_engine_short": "wgmma", "mla_engine": "simt",
                     "mla_engine_short": "simt", "whisper_decoder": "wgmma",
                     "whisper_decoder_short": "wgmma", "whisper_cross_short": "wgmma",
                     "zamba_prefill": "simt", "zamba_full": "simt",
                     "zamba_f32_prefill": "simt", "zamba_warmup": "simt",
                     "zamba_twin": "simt"}
    timed = ("serve", "mla_prefill", "whisper_encoder", "whisper_cross", "vlm_prefill",
             "zamba_prefill", "zamba_full")
    res = {"cases": {}, "family": {}}
    for name, (b, hq, hkv, t, s, d, dtype, causal) in cases.items():
        q = torch.randn(b, hq, t, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
        design = fa_ops.design(dtype, d)
        before = dict(fa_ops.launches_by_design)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = flash_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(fa_ops.launches_by_design[design] == before[design] + 1
              and sum(fa_ops.launches_by_design.values()) == sum(before.values()) + 1,
              f"flash case {name} went through the {design} instance")
        err = float((got.float() - want.float()).abs().max())
        tol = 3e-2 if dtype == bf16 else 2e-5
        check(err <= tol and got.dtype == dtype,
              f"flash kernel ({design}) == plain within {tol} at {name} "
              f"{(b, hq, hkv, t, s, d, causal)}: {err:.3g}")
        if name.startswith("moe"):
            check(design == "wgmma", f"flash case {name} is a case of the wgmma instance")
        if name in family_design:
            check(design == family_design[name],
                  f"flash case {name} is a case of the {family_design[name]} instance")
        if t > s and causal:
            check(bool(torch.all(got[:, :, :t - s] == 0)), "rows that see no key give exact 0")
        res["cases"][name] = {"shape": [b, hq, hkv, t, s, d], "dtype": str(dtype),
                              "causal": causal, "design": design, "max_abs_err": err,
                              "tol": tol}
        if name not in timed:
            continue
        flops = 4 * b * hq * d * attention_pairs(t, s, causal)
        nbytes = (2 * b * hq * t * d + 2 * b * hkv * s * d) * 2
        bound, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)

        def kernel():
            return fa_ops.flash_attention(q, k, v, causal=causal)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        if name != "serve":
            check(float((library().float() - want.float()).abs().max()) <= 3e-2,
                  f"scaled_dot_product_attention yardstick == plain within 3e-2 at {name}")
            ms, host_ms = device_ms(kernel, launches=10 if design == "simt" else 50)
            library_ms, _ = device_ms(library, launches=50)
            res["family"][name] = dict(
                res["cases"][name], flops=flops, bytes=nbytes, bound_ms=bound, bound_by=by,
                ms=ms, host_ms=host_ms, library_ms=library_ms, tflops=flops / ms / 1e9,
                plain_ms=cuda_ms(lambda: flash_ref(q, k, v, causal=causal), reps=3,
                                 warmup=1))
            continue

        def simt():
            fa_cuda(q, k, v, torch.empty_like(q), True, d ** -0.5, "simt")

        check(float((library().float() - want.float()).abs().max()) <= 3e-2,
              "scaled_dot_product_attention yardstick == plain within 3e-2")
        ms, host_ms = device_ms(kernel, launches=50)
        library_ms, library_host_ms = device_ms(library, launches=50)
        res.update(
            shape=[b, hq, hkv, t, s, d], dtype="bfloat16", design=design, max_abs_err=err,
            flops=flops, bytes=nbytes, bound_ms=bound, bound_by=by, ms=ms, host_ms=host_ms,
            event_ms=cuda_ms(kernel), library_ms=library_ms, library_host_ms=library_host_ms,
            library_event_ms=cuda_ms(library),
            plain_ms=cuda_ms(lambda: flash_ref(q, k, v, causal=True), reps=5, warmup=1),
            simt_ms=cuda_ms(simt, reps=5, warmup=1), tflops=flops / ms / 1e9)
    return res


def attention_pairs(t: int, s: int, causal: bool) -> float:
    """(query, key) pairs a query row sees, summed over the T rows: all T S
    without a mask, else row i (at key position S - T + i) sees
    min(S, S - T + i + 1) keys, none when that is below 1."""
    if not causal:
        return float(t * s)
    seen = np.clip(np.arange(s - t + 1, s + 1), 0, s)
    return float(seen.sum())


def dispatch_phase(md_ops, dispatch_ref, dev, t=DISPATCH_T, e=DISPATCH_E) -> dict:
    """Kernel 8 against its plain version, exactly, at T tokens and E
    destinations: Zipf(1.3)-skewed destinations with 2% padding (-1).

    Timed as device time from a burst queued behind a spin (its wrapper
    takes longer on the host than its kernel on the card); the plain
    version with CUDA events. No single PyTorch call computes stable ranks,
    so there is no library time. Bound: dest read and rank written once,
    counts written once, at the memory rate.
    """
    rng = np.random.default_rng(8)
    dest_np = ((rng.zipf(1.3, t) - 1) % e).astype(np.int32)
    dest_np[rng.random(t) < 0.02] = -1
    dest = torch.as_tensor(dest_np, device=dev)
    rank, counts = md_ops.dispatch_ranks(dest, e)
    want_rank, want_counts = dispatch_ref(dest, e)
    torch.cuda.synchronize()
    check(torch.equal(rank, want_rank) and torch.equal(counts, want_counts),
          f"dispatch kernel == plain, exactly, at T={t}, E={e}")
    check(int(counts.sum()) == int((dest_np >= 0).sum()), "counts sum to the valid tokens")
    err = float((rank.long() - want_rank.long()).abs().max())
    del want_rank, want_counts
    ms, host_ms = device_ms(lambda: md_ops.dispatch_ranks(dest, e), launches=100)
    b, by = bound_ms(8 * t + 4 * e, 0)
    return {"tokens": t, "dests": e, "max_abs_err": err, "hot_share":
            float(counts.max()) / t, "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: dispatch_ref(dest, e), reps=5, warmup=1),
            "library_ms": None, "bound_ms": b, "bound_by": by}


def serve_requests(vocab: int, seed: int, count: int = SERVE_REQUESTS, plen=(128, 513)):
    """The serve path's requests, drawn with numpy from ``seed``: prompts of
    ``plen`` tokens (default 128-512), decode budgets clip(zipf(1.5) * 4, 4,
    64)."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        plen_i = int(rng.integers(*plen))
        budget = int(np.clip(rng.zipf(1.5) * 4, 4, 64))
        out.append(Request(rid=i, prompt=rng.integers(3, vocab, plen_i).astype(np.int32),
                           max_new=budget))
    return out


def admission_lens(arch: str, seed: int, count: int, plen=(128, 513)) -> tuple:
    """(shortest, longest) prompt of the ``count`` requests a path's engine
    admits (:func:`serve_requests` at the arch's vocabulary)."""
    from repro_torch.configs import get_config

    lens = [r.prompt.shape[0] for r in serve_requests(get_config(arch).vocab, seed, count, plen)]
    return min(lens), max(lens)


def top2_margin(model, cfg, tokens, dev) -> float:
    """Top-2 logit margin of the next token after ``tokens`` (one sequence,
    no cache)."""
    from repro_torch.models.model import forward

    with torch.inference_mode():
        ids = torch.as_tensor(np.asarray(tokens, np.int64)[None, :], device=dev)
        logits = forward(model, cfg, tokens=ids).logits[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def serve_path(counters, fa_ops, args, dev) -> tuple:
    """The serving engine on Llama-3-8B at full width and depth, bf16 weights
    from ``torch.Generator`` seed ``args.seed``, attn_impl="pallas": 16
    requests on 8 lanes; then 20 decode steps under the profiler; then a
    2-layer float32 twin with "pallas" and with "naive" attention, whose
    token streams must agree. The bf16 prefills must all go through the
    flash kernel's wgmma instance, the twin's through its simt instance.
    Returns ``(record, launches)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import scheduler as sched_lib
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = dataclasses.replace(get_config("llama3-8b"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    rec = {"config": "llama3-8b", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "weights_gb": weight_gb, "init_s": time.perf_counter() - t0}
    print(f"serve path: llama3-8b, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{weight_gb:.2f} GB of bf16 weights in {rec['init_s']:.1f} s", flush=True)
    ecfg = EngineConfig(lanes=SERVE_LANES, max_len=SERVE_MAX_LEN, scheduler="os4m")
    eng = Engine(cfg, model, ecfg, device=dev)
    reqs = serve_requests(cfg.vocab, args.seed)
    budgets = {r.rid: r.max_new for r in reqs}
    want_lanes = sched_lib.schedule_bss(
        np.asarray([r.load for r in reqs], np.float64), SERVE_LANES).assignment
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    tokens = sum(len(r.output) for r in done)
    check(sorted(r.rid for r in done) == list(range(len(reqs))), "serve: every request served")
    check(all(1 <= len(r.output) <= budgets[r.rid] for r in done),
          "serve: every output within its decode budget")
    check([r.lane for r in reqs] == [int(a) for a in want_lanes],
          "serve: the lane plan == the host scheduler's plan for the same loads")
    check(launches["flash_attention"] == cfg.n_layers * len(reqs),
          f"serve: the flash kernel ran in every prefill layer ({cfg.n_layers} x {len(reqs)})")
    by_design = dict(fa_ops.launches_by_design)
    check(by_design == {"wgmma": cfg.n_layers * len(reqs), "simt": 0},
          f"serve: every bf16 prefill went through the wgmma instance ({by_design})")
    steps = np.asarray(eng.step_seconds[1:]) * 1e3
    prefill = np.asarray(eng.prefill_seconds) * 1e3
    rec.update(
        requests=len(reqs), lanes=SERVE_LANES, max_len=SERVE_MAX_LEN,
        prompt_lens=[int(r.prompt.shape[0]) for r in reqs], budgets=list(budgets.values()),
        out_lens=[len(r.output) for r in sorted(done, key=lambda r: r.rid)],
        lanes_of=[r.lane for r in reqs], wall_s=wall, tokens=tokens,
        tokens_per_s=tokens / wall, prefill_ms=prefill.tolist(),
        prefill_ms_median=float(np.median(prefill)),
        decode_steps=len(eng.step_seconds), first_step_ms=eng.step_seconds[0] * 1e3,
        decode_ms_median=float(np.median(steps)), decode_ms_p90=float(np.percentile(steps, 90)),
        balance_ratio=eng.last_balance_ratio, finish_ratio=eng.last_finish_ratio,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serve path: {len(done)} requests, {tokens} tokens in {wall:.2f} s "
          f"({rec['tokens_per_s']:.1f} tok/s) | prefill median {rec['prefill_ms_median']:.1f} ms "
          f"an admission ({len(prefill)}) | decode {rec['decode_steps']} steps, median "
          f"{rec['decode_ms_median']:.2f} ms, p90 {rec['decode_ms_p90']:.2f} ms (first "
          f"{rec['first_step_ms']:.1f} ms) | lane balance {rec['balance_ratio']:.4f}, finish "
          f"{rec['finish_ratio']:.4f} | peak {rec['peak_gb']:.1f} GB | launches {launches}",
          flush=True)

    # Where a decode step's time goes: 20 lock-step steps at the lanes'
    # depths of a prompt of median length, under the profiler.
    rec["profile_20_decode_steps"] = decode_profile("serve", eng, int(np.median(rec["prompt_lens"])))
    del eng, model, done
    torch.cuda.empty_cache()

    # The 2-layer float32 twin: flash kernel against materialised scores.
    twin = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    model = init_model(twin, seed=args.seed, device=dev)
    streams = {}
    for impl in ("pallas", "naive"):
        eng = Engine(dataclasses.replace(twin, attn_impl=impl), model, ecfg, device=dev)
        reset_launches(counters)
        streams[impl] = {r.rid: r.output for r in eng.run(serve_requests(twin.vocab, args.seed))}
        if impl == "pallas":
            twin_design = dict(fa_ops.launches_by_design)
            check(twin_design == {"wgmma": 0, "simt": twin.n_layers * len(reqs)},
                  f"f32 twin: every prefill went through the simt instance ({twin_design})")
    diverged = []
    for rid, a in streams["pallas"].items():
        b = streams["naive"][rid]
        if a != b:
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            prompt = serve_requests(twin.vocab, args.seed)[rid].prompt
            margin = top2_margin(model, twin, list(prompt) + a[:j], dev)
            diverged.append({"rid": rid, "step": j, "top2_margin": margin})
    for d in diverged:
        check(d["top2_margin"] <= 1e-3, f"f32 twin: request {d['rid']} diverges at step "
              f"{d['step']} with a top-2 margin of {d['top2_margin']:.3g} (a real disagreement)")
    rec["f32_twin"] = {"n_layers": 2, "streams_equal": not diverged, "diverged": diverged,
                       "tokens": sum(len(o) for o in streams["pallas"].values()),
                       "launches_by_design": twin_design}
    rec["launches_by_design"] = by_design
    print(f"f32 twin (2 layers, full width): pallas vs naive token streams "
          f"{'equal' if not diverged else 'differ: ' + str(diverged)}", flush=True)
    del model, eng
    torch.cuda.empty_cache()
    return rec, launches


def launcher_run(timeout: int = 600) -> dict:
    """``python -m repro_torch.launch.serve --arch smollm-360m`` at its
    defaults, as a subprocess on the card."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "smollm-360m"], capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"the launcher exits 0 (rc {out.returncode}: {out.stderr[-2000:]})")
    line = out.stdout.strip().splitlines()[-1]
    check(line.startswith("scheduler=os4m: 24 requests"), f"the launcher served 24 requests: {line}")
    found = re.search(r"attn_impl=pallas, flash kernel launches (\d+)$", line)
    flash = int(found.group(1)) if found else 0
    check(flash > 0, f"the launcher's prefills launched the flash kernel: {line}")
    print(f"launcher (python -m repro_torch.launch.serve --arch smollm-360m, {wall:.1f} s): "
          f"{line}", flush=True)
    return {"wall_s": wall, "line": line, "flash_launches": flash}


def moe_prompts(vocab: int, seed: int) -> np.ndarray:
    """The MoE path's prefill batch: MOE_PROMPTS prompts of MOE_PROMPT_LEN
    tokens drawn Zipf(1.3) over the vocabulary (hot tokens crowd a few
    experts, as the corpus of ``examples/moe_balance.py``)."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, (MOE_PROMPTS, MOE_PROMPT_LEN)) % vocab).astype(np.int64)


def slot_loads(counts: np.ndarray, placements: np.ndarray, slots: int) -> np.ndarray:
    """Per-slot routed load of every MoE layer: ``(L, slots)``."""
    return np.stack([np.bincount(p[0], weights=c, minlength=slots)
                     for c, p in zip(counts, placements)])


def moe_path(counters, fa_ops, args, dev, smi) -> tuple:
    """grok-1-314b at full width, depth cut to MOE_LAYERS, bf16 weights from
    seed ``args.seed``, MOE_EP_SLOTS expert slots stacked on the card:
    a Zipf prefill under the default placement, the OS4M expert balancer's
    re-plan with the weights moved, the same prefill again (logits
    bit-equal: moving experts is a relabeling; no overflow in either),
    then ``Engine`` serving
    MOE_REQUESTS requests on MOE_LANES lanes with attn_impl="pallas", 20
    decode steps under the profiler, and a 2-layer float32 twin served on
    the card and on the CPU with the same weights (equal token streams).
    Returns ``(record, launches)`` over the whole path (counts set to 0 just
    before it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import balancer as bal_lib
    from repro_torch.models.model import default_placements, forward, init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS, attn_impl="pallas")
    moe = cfg.moe
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev, ep_slots=MOE_EP_SLOTS)
    torch.cuda.synchronize()
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    rec = {"config": "grok-1-314b", "reduced": {"n_layers": [full.n_layers, MOE_LAYERS]},
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
           "experts": moe.num_experts, "top_k": moe.top_k, "d_ff": moe.d_ff,
           "vocab": cfg.vocab, "ep_slots": MOE_EP_SLOTS, "weights_gb": weight_gb,
           "init_s": time.perf_counter() - t0}
    print(f"moe path: grok-1-314b, {MOE_LAYERS} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {moe.num_experts} experts top-{moe.top_k}, d_ff {moe.d_ff}, "
          f"{MOE_EP_SLOTS} expert slots: {weight_gb:.2f} GB of bf16 weights in "
          f"{rec['init_s']:.1f} s", flush=True)

    # ---- 1-2: a Zipf prefill under the default placement, the balancer's
    # re-plan with the weights moved, and the same prefill again. The
    # capacity is dropless (every send bucket holds its slot's tokens), so
    # no placement drops a token.
    tokens = torch.as_tensor(moe_prompts(cfg.vocab, args.seed), device=dev)
    n_src = MOE_PROMPTS * (MOE_PROMPT_LEN // MOE_EP_SLOTS)
    capacity = n_src * moe.top_k

    def prefill(placements):
        times, out = [], None
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = forward(model, cfg, tokens=tokens, mode="prefill",
                              placements=placements, moe_capacity=capacity)
                out.logits.float().sum().item()
                times.append((time.perf_counter() - t) * 1e3)
        return out, times

    base_place = default_placements(cfg, MOE_EP_SLOTS, device=dev)
    before, before_ms = prefill(None)
    counts = before.stats["expert_counts"].cpu().numpy()
    check(int(before.stats["overflow"]) == 0, "moe path: no overflow under the default placement")
    check(np.all(counts.sum(axis=1) == MOE_PROMPTS * MOE_PROMPT_LEN * moe.top_k),
          "moe path: every token routed to top-k experts in every layer")
    balancer = bal_lib.ExpertBalancer(moe.num_experts, MOE_EP_SLOTS, MOE_LAYERS, interval=1,
                                      ema=0.0)
    balancer.observe(counts)
    t = time.perf_counter()
    placements, perms, reports = balancer.replan()
    plan_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for layer, perm in zip(model.layers, perms):
        bal_lib.permute_expert_weights(layer.moe, perm)
    torch.cuda.synchronize()
    permute_ms = (time.perf_counter() - t) * 1e3
    after, after_ms = prefill(torch.as_tensor(placements, device=dev))
    check(int(after.stats["overflow"]) == 0, "moe path: no overflow under the OS4M placement")
    check(torch.equal(after.stats["expert_counts"], before.stats["expert_counts"]),
          "moe path: the re-placed experts see the same routing")
    diff = float((after.logits.float() - before.logits.float()).abs().max())
    scale = float(before.logits.float().abs().max())
    check(bool(torch.isfinite(before.logits).all())
          and torch.equal(after.logits, before.logits),
          f"moe path: logits after the re-plan bit-equal to the default placement's (a "
          f"relabeling; |diff| {diff:.4g}, max|logit| {scale:.4g})")
    same_top = float((after.logits[:, -1].argmax(-1) == before.logits[:, -1].argmax(-1))
                     .float().mean())
    load_before = slot_loads(counts, base_place.cpu().numpy(), MOE_EP_SLOTS)
    load_after = slot_loads(counts, placements, MOE_EP_SLOTS)
    ratio = lambda loads: (loads.max(axis=1) / loads.mean(axis=1)).tolist()   # noqa: E731
    rec["balance"] = {
        "expert_counts": counts.tolist(), "slot_loads_before": load_before.tolist(),
        "slot_loads_after": load_after.tolist(), "balance_before": ratio(load_before),
        "balance_after": ratio(load_after), "reports": [dataclasses.asdict(r) for r in reports],
        "perms": [p.tolist() for p in perms], "replan_ms": plan_ms, "permute_ms": permute_ms,
        "prefill_ms_before": before_ms, "prefill_ms_after": after_ms,
        "logit_max_abs_diff": diff, "logit_max_abs": scale, "last_token_argmax_equal": same_top,
        "capacity": capacity, "tokens": MOE_PROMPTS * MOE_PROMPT_LEN}
    for i in range(MOE_LAYERS):
        print(f"moe path layer {i}: expert counts {counts[i].astype(int).tolist()} | slot loads "
              f"{load_before[i].astype(int).tolist()} -> {load_after[i].astype(int).tolist()} | "
              f"balance ratio {ratio(load_before)[i]:.4f} -> {ratio(load_after)[i]:.4f} "
              f"(report {reports[i].baseline_ratio:.4f} -> {reports[i].balance_ratio:.4f}, "
              f"{reports[i].moved_experts} experts moved)", flush=True)
    print(f"moe path: prefill {MOE_PROMPTS} x {MOE_PROMPT_LEN} tokens, dropless capacity "
          f"{capacity}: {np.median(before_ms):.1f} ms (default placement), "
          f"{np.median(after_ms):.1f} ms (OS4M placement) | re-plan {plan_ms:.2f} ms, weight "
          f"move {permute_ms:.1f} ms | logits |diff| {diff:.4g} of max {scale:.4g}, last-token "
          f"argmax equal {same_top:.3f} | overflow 0 and 0", flush=True)
    del before, after
    # Back to the weights' default order, which the engine's default
    # placement reads.
    for layer, perm in zip(model.layers, perms):
        bal_lib.permute_expert_weights(layer.moe, np.arange(moe.num_experts), prev_perm=perm)

    # ---- 3: the engine on MOE_LANES lanes, as the serve path holds Llama-3-8B.
    eng = Engine(cfg, model, EngineConfig(lanes=MOE_LANES, max_len=SERVE_MAX_LEN,
                                          scheduler="os4m"), device=dev)
    reqs = serve_requests(cfg.vocab, args.seed, MOE_REQUESTS)
    rec["serve"] = family_serve("moe serve", eng, reqs, None, fa_ops, smi)
    check(rec["serve"]["flash_launches_by_design"] == {"wgmma": MOE_LAYERS * len(reqs),
                                                       "simt": 0},
          f"moe serve: every prefill layer went through kernel 9's wgmma instance "
          f"({rec['serve']['flash_launches_by_design']})")
    prof = decode_profile("moe", eng, int(np.median(rec["serve"]["prompt_lens"])))
    rec["serve"]["profile_20_decode_steps"] = prof
    rec["serve"]["idle_share"] = prof["idle_share"]
    del eng, model
    torch.cuda.empty_cache()

    # ---- 4: the 2-layer float32 twin, on the card and on the CPU with the
    # same weights (drawn on the card, copied to the host).
    twin = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    gpu_model = init_model(twin, seed=args.seed, device=dev, ep_slots=MOE_EP_SLOTS)
    rec["f32_twin"] = twin_streams(
        "moe", twin, gpu_model, twin_requests(twin.vocab, args.seed, zipf=True),
        EngineConfig(lanes=MOE_LANES, max_len=64, scheduler="os4m", eos=-1),
        ep_slots=MOE_EP_SLOTS)
    launches = read_launches(counters)
    rec["launches"] = launches
    # Over the whole path: the prefills of steps 1-2 and the engine's
    # (wgmma), the twin's on the card (simt).
    rec["launches_by_design"] = dict(fa_ops.launches_by_design)
    del gpu_model
    torch.cuda.empty_cache()
    return rec, launches


def family_serve(label, eng, reqs, extra, fa_ops, smi) -> dict:
    """``eng.run(reqs, extra_embed=extra)`` on the card, timed, with its
    checks: every request served within its budget, the lane plan the host
    scheduler's; returns the record (flash launches by instance included)."""
    from repro_torch.core import scheduler as sched_lib

    budgets = {r.rid: r.max_new for r in reqs}
    want_lanes = sched_lib.schedule_bss(
        np.asarray([r.load for r in reqs], np.float64), eng.ecfg.lanes).assignment
    flash0 = dict(fa_ops.launches_by_design)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs, extra_embed=extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = sorted(done, key=lambda r: r.rid)
    check([r.rid for r in served] == list(range(len(reqs))), f"{label}: every request served")
    check(all(1 <= len(r.output) <= budgets[r.rid] for r in served),
          f"{label}: every output within its decode budget")
    check([r.lane for r in reqs] == [int(a) for a in want_lanes],
          f"{label}: the lane plan == the host scheduler's plan for the same loads")
    design = {k: fa_ops.launches_by_design[k] - flash0[k] for k in flash0}
    tokens = sum(len(r.output) for r in served)
    steps = np.asarray(eng.step_seconds[1:]) * 1e3
    prefill = np.asarray(eng.prefill_seconds) * 1e3
    rec = {"requests": len(reqs), "lanes": eng.ecfg.lanes, "max_len": eng.ecfg.max_len,
           "prompt_lens": [int(r.prompt.shape[0]) for r in reqs],
           "out_lens": [len(r.output) for r in served], "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "prefill_ms": prefill.tolist(),
           "prefill_ms_median": float(np.median(prefill)),
           "decode_steps": len(eng.step_seconds), "decode_ms_median": float(np.median(steps)),
           "decode_ms_p90": float(np.percentile(steps, 90)),
           "balance_ratio": eng.last_balance_ratio, "finish_ratio": eng.last_finish_ratio,
           "flash_launches_by_design": design,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label}: {len(served)} requests, {tokens} tokens in {wall:.2f} s "
          f"({rec['tokens_per_s']:.1f} tok/s) | prefill median {rec['prefill_ms_median']:.1f} ms "
          f"an admission | decode {rec['decode_steps']} steps, median "
          f"{rec['decode_ms_median']:.2f} ms, p90 {rec['decode_ms_p90']:.2f} ms | flash kernel "
          f"{design} | peak {rec['peak_gb']:.1f} GB | {smi}", flush=True)
    return rec


def decode_profile(label, eng, depth) -> dict:
    """20 lock-step decode steps of every lane of ``eng`` at ``depth`` under
    the profiler (after one untimed step), on a zeroed float32 cache; the
    record's ``idle_share`` is 1 - device busy / wall."""
    from repro_torch.models.model import init_cache

    model, lanes, dev = eng.params, eng.ecfg.lanes, eng.device
    cache = init_cache(eng.cfg, lanes, eng.ecfg.max_len, dtype=torch.float32, device=dev)
    pos = np.full(lanes, depth, np.int64)
    cur = torch.full((lanes, 1), 7, dtype=torch.int32, device=dev)

    def steps20():
        nonlocal cache
        with torch.inference_mode():
            for i in range(20):
                cache, nxt = eng._decode(model, cache, cur, torch.as_tensor(pos + i, device=dev))
                nxt.cpu()

    with torch.inference_mode():
        eng._decode(model, cache, cur, torch.as_tensor(pos, device=dev))
        prof = profile_run(f"{label} profile 20 decode steps", steps20)
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] > 0 else None
    print(f"{label}: device idle share over 20 decode steps {prof['idle_share']}", flush=True)
    return prof


def twin_streams(label, twin, gpu_model, requests, ecfg, extra=None, ep_slots=1) -> dict:
    """A float32 twin served by ``Engine`` on the card and on the CPU with the
    same weights (drawn on the card, copied to the host) and inputs: the
    token streams must be equal."""
    from repro_torch.models.model import DecoderModel
    from repro_torch.serve.engine import Engine

    cpu_model = DecoderModel(twin, device="cpu", ep_slots=ep_slots)
    with torch.no_grad():
        for dst, src in zip(cpu_model.parameters(), gpu_model.parameters()):
            dst.copy_(src)
    streams, seconds = {}, {}
    for where, mdl in (("cuda", gpu_model), ("cpu", cpu_model)):
        t = time.perf_counter()
        eng = Engine(twin, mdl, ecfg, device=mdl.device)
        x = None if extra is None else extra.to(mdl.device)
        streams[where] = {r.rid: r.output for r in eng.run(requests(), extra_embed=x)}
        seconds[where] = time.perf_counter() - t
    equal = streams["cuda"] == streams["cpu"]
    print(f"{label} f32 twin ({twin.n_layers} layers, full width, {len(streams['cuda'])} "
          f"requests): card vs CPU token streams {'equal' if equal else 'differ'} (card "
          f"{seconds['cuda']:.1f} s, CPU {seconds['cpu']:.1f} s)", flush=True)
    check(equal, f"{label} f32 twin: card and CPU token streams equal ({streams})")
    del cpu_model
    return {"n_layers": twin.n_layers, "requests": len(streams["cuda"]), "streams_equal": equal,
            "tokens": sum(len(o) for o in streams["cuda"].values()), "seconds": seconds,
            "streams": {str(k): v for k, v in streams["cuda"].items()}}


def twin_requests(vocab: int, seed: int, zipf: bool = False):
    """The twins' TWIN_REQUESTS requests: prompts of 16-32 tokens, uniform
    over the vocabulary or (``zipf``) Zipf(1.3) as the MoE paths' prefills,
    TWIN_NEW new tokens."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed + 1)
    if zipf:
        def draw(n):
            return rng.zipf(1.3, n) % vocab
    else:
        def draw(n):
            return rng.integers(3, vocab, n)
    prompts = [draw(int(rng.integers(16, 33))).astype(np.int32) for _ in range(TWIN_REQUESTS)]
    return lambda: [Request(rid=i, prompt=p, max_new=TWIN_NEW) for i, p in enumerate(prompts)]


def weights_gb(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def whisper_path(counters, fa_ops, args, dev, smi) -> tuple:
    """whisper-base at full width and depth (openai/whisper base: 6 encoder
    and 6 decoder layers, d_model 512, 8 heads, 1500 frames, vocab 51865),
    bf16 weights from seed ``args.seed``, attn_impl="pallas": ``Engine`` on
    WHISPER_LANES lanes with max_len 448 serving WHISPER_REQUESTS requests
    with (lanes, 1500, 512) normal frames from the seed; every prefill runs
    kernel 9 in each encoder layer (non-causal, 1500 x 1500), each decoder
    layer and each cross-attention (T = prompt, S = 1500, non-causal), all
    on the wgmma instance; 20 decode steps under the profiler; a float32
    twin (2 encoder + 2 decoder layers) served on the card and the CPU.
    Returns ``(record, launches)`` over the whole path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = dataclasses.replace(get_config("whisper-base"), attn_impl="pallas")
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    frames = torch.randn(WHISPER_LANES, cfg.enc_len, cfg.d_model, generator=gen,
                         device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    rec = {"config": "whisper-base", "source": "openai/whisper base (arXiv:2212.04356)",
           "n_enc_layers": cfg.n_enc_layers, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "enc_len": cfg.enc_len, "vocab": cfg.vocab,
           "weights_gb": weights_gb(model), "init_s": time.perf_counter() - t0}
    print(f"whisper path: whisper-base, {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.enc_len} frames: {rec['weights_gb']:.3f} GB of bf16 weights",
          flush=True)
    ecfg = EngineConfig(lanes=WHISPER_LANES, max_len=WHISPER_MAX_LEN, scheduler="os4m")
    eng = Engine(cfg, model, ecfg, device=dev)
    reqs = serve_requests(cfg.vocab, args.seed, WHISPER_REQUESTS, plen=WHISPER_PROMPTS)
    rec["serve"] = family_serve("whisper serve", eng, reqs, frames, fa_ops, smi)
    per_admission = cfg.n_enc_layers + 2 * cfg.n_layers
    check(rec["serve"]["flash_launches_by_design"]
          == {"wgmma": per_admission * len(reqs), "simt": 0},
          f"whisper serve: kernel 9's wgmma instance ran in every encoder, decoder and cross "
          f"layer of every prefill ({per_admission} x {len(reqs)})")
    rec["serve"]["profile_20_decode_steps"] = decode_profile(
        "whisper", eng, int(np.median(rec["serve"]["prompt_lens"])))
    del eng, model, frames
    torch.cuda.empty_cache()

    twin = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    gpu_model = init_model(twin, seed=args.seed, device=dev)
    twin_frames = torch.randn(TWIN_LANES, cfg.enc_len, cfg.d_model, generator=gen, device=dev)
    rec["f32_twin"] = twin_streams(
        "whisper", twin, gpu_model, twin_requests(twin.vocab, args.seed),
        EngineConfig(lanes=TWIN_LANES, max_len=64, scheduler="os4m", eos=-1), twin_frames)
    launches = read_launches(counters)
    rec["launches"] = launches
    rec["launches_by_design"] = dict(fa_ops.launches_by_design)
    del gpu_model
    torch.cuda.empty_cache()
    return rec, launches


def vlm_path(counters, fa_ops, args, dev, smi) -> tuple:
    """qwen2-vl-7b at full width and depth (hf:Qwen/Qwen2-VL-7B-Instruct: 28
    layers, d_model 3584, 28 heads over 4 KV heads, M-RoPE sections (16, 24,
    24), 256 patches on a 16 x 16 grid), bf16 weights from seed
    ``args.seed``, attn_impl="pallas". Model level: a prefill of VLM_BATCH x
    (256 patches + VLM_TEXT tokens) with a float32 cache, then VLM_DECODE
    greedy decode steps at n_patches + p + i, whose logits (and the
    prefill's last) are held against the train-mode forward of the whole
    stream within VLM_BF16_TOL; the same on the float32 twin within
    VLM_F32_TOL and with equal argmax tokens. Then ``Engine`` with the patches as ``extra_embed`` on 8
    lanes, 16 requests (the reference's semantics: decoding continues at
    the prompt's length), kernel 9's wgmma instance at a GQA group of 7 in
    every prefill layer; 20 decode steps under the profiler; the float32
    twin served on the card and the CPU. Returns ``(record, launches)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_cache, init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = dataclasses.replace(get_config("qwen2-vl-7b"), attn_impl="pallas")
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    rec = {"config": "qwen2-vl-7b", "source": "hf:Qwen/Qwen2-VL-7B-Instruct",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv": cfg.n_kv, "n_patches": cfg.n_patches,
           "mrope_sections": list(cfg.mrope_sections), "vocab": cfg.vocab,
           "weights_gb": weights_gb(model), "init_s": time.perf_counter() - t0}
    print(f"vlm path: qwen2-vl-7b, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv} heads, {cfg.n_patches} patches: "
          f"{rec['weights_gb']:.2f} GB of bf16 weights in {rec['init_s']:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)

    def patches(batch, dtype):
        # Embedding-sized rows: normals times d^-0.5, as the token table's.
        x = torch.randn(batch, cfg.n_patches, cfg.d_model, generator=gen, device=dev)
        return (x * cfg.d_model ** -0.5).to(dtype)

    def decode_vs_full(mdl, c, extra, text):
        """Prefill, VLM_DECODE greedy steps at n_patches + p + i, and the
        train-mode forward of the whole stream: (step logits, full logits
        at the same positions, prefill ms, decode ms)."""
        b, p = text.shape
        with torch.inference_mode():
            cache = init_cache(c, b, c.n_patches + p + VLM_DECODE, dtype=torch.float32,
                               device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = forward(mdl, c, tokens=text, extra_embed=extra, mode="prefill", cache=cache)
            nxt = out.logits[:, -1].argmax(-1)
            nxt.cpu()
            pre_ms = (time.perf_counter() - t) * 1e3
            steps, toks, dec_ms = [out.logits[:, -1].float()], [], []
            cache = out.cache
            for i in range(VLM_DECODE):
                toks.append(nxt)
                t = time.perf_counter()
                out = forward(mdl, c, tokens=nxt[:, None], mode="decode", cache=cache,
                              cache_pos=c.n_patches + p + i)
                nxt = out.logits[:, -1].argmax(-1)
                nxt.cpu()
                dec_ms.append((time.perf_counter() - t) * 1e3)
                steps.append(out.logits[:, -1].float())
            stream = torch.cat([text, torch.stack(toks, dim=1)], dim=1)
            full = forward(mdl, c, tokens=stream, extra_embed=extra).logits.float()
            return torch.stack(steps, dim=1), full[:, c.n_patches + p - 1:], pre_ms, dec_ms

    rng = np.random.default_rng(args.seed + 3)
    text = torch.as_tensor(rng.integers(3, cfg.vocab, (VLM_BATCH, VLM_TEXT)), device=dev)
    steps, full, pre_ms, dec_ms = decode_vs_full(model, cfg, patches(VLM_BATCH, torch.bfloat16),
                                                 text)
    rel = float(torch.linalg.vector_norm(steps - full) / torch.linalg.vector_norm(full))
    top1 = float((steps.argmax(-1) == full.argmax(-1)).float().mean())
    check(bool(torch.isfinite(steps).all()) and rel <= VLM_BF16_TOL,
          f"vlm: prefill + decode at n_patches + p + i == the full forward within "
          f"{VLM_BF16_TOL} (relative L2 {rel:.4g})")
    rec["model_level"] = {"batch": VLM_BATCH, "text": VLM_TEXT, "decode_steps": VLM_DECODE,
                          "rel_l2": rel, "tol": VLM_BF16_TOL, "top1_agree": top1,
                          "logit_max_abs": float(full.abs().max()),
                          "max_abs_diff": float((steps - full).abs().max()),
                          "prefill_ms": pre_ms, "decode_ms": dec_ms,
                          "decode_ms_median": float(np.median(dec_ms[1:]))}
    print(f"vlm model level: prefill {VLM_BATCH} x ({cfg.n_patches} + {VLM_TEXT}) {pre_ms:.1f} "
          f"ms, {VLM_DECODE} decode steps median {rec['model_level']['decode_ms_median']:.2f} "
          f"ms | vs the full forward: relative L2 {rel:.4g} (tol {VLM_BF16_TOL}), max |diff| "
          f"{rec['model_level']['max_abs_diff']:.4g} of max |logit| "
          f"{rec['model_level']['logit_max_abs']:.4g}, top-1 agree {top1:.3f}", flush=True)
    del steps, full

    ecfg = EngineConfig(lanes=SERVE_LANES, max_len=SERVE_MAX_LEN, scheduler="os4m")
    eng = Engine(cfg, model, ecfg, device=dev)
    reqs = serve_requests(cfg.vocab, args.seed, SERVE_REQUESTS)
    rec["serve"] = family_serve("vlm serve", eng, reqs, patches(SERVE_LANES, torch.bfloat16),
                                fa_ops, smi)
    check(rec["serve"]["flash_launches_by_design"] == {"wgmma": cfg.n_layers * len(reqs),
                                                       "simt": 0},
          f"vlm serve: kernel 9's wgmma instance ran in every prefill layer "
          f"({cfg.n_layers} x {len(reqs)})")
    rec["serve"]["profile_20_decode_steps"] = decode_profile(
        "vlm", eng, int(np.median(rec["serve"]["prompt_lens"])))
    del eng, model
    torch.cuda.empty_cache()

    twin = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    gpu_model = init_model(twin, seed=args.seed, device=dev)
    steps, full, _, _ = decode_vs_full(gpu_model, twin, patches(TWIN_LANES, torch.float32),
                                       text[:TWIN_LANES, :32])
    agree = bool(torch.equal(steps.argmax(-1), full.argmax(-1)))
    f32_diff = float((steps - full).abs().max())
    check(agree, "vlm f32 twin: decode argmax tokens == the full forward's")
    check(f32_diff <= VLM_F32_TOL,
          f"vlm f32 twin: decode logits == the full forward's within {VLM_F32_TOL} "
          f"(max |diff| {f32_diff:.3g})")
    rec["model_level"].update(f32_twin_argmax_equal=agree, f32_twin_max_abs_diff=f32_diff,
                              f32_tol=VLM_F32_TOL)
    print(f"vlm f32 twin: decode at n_patches + p + i vs the full forward: argmax equal, max "
          f"|diff| {f32_diff:.3g} (tol {VLM_F32_TOL})", flush=True)
    del steps, full
    rec["f32_twin"] = twin_streams(
        "vlm", twin, gpu_model, twin_requests(twin.vocab, args.seed),
        EngineConfig(lanes=TWIN_LANES, max_len=cfg.n_patches + 64, scheduler="os4m", eos=-1),
        patches(TWIN_LANES, torch.float32))
    launches = read_launches(counters)
    rec["launches"] = launches
    rec["launches_by_design"] = dict(fa_ops.launches_by_design)
    del gpu_model
    torch.cuda.empty_cache()
    return rec, launches


def mla_path(counters, fa_ops, args, dev, smi) -> tuple:
    """deepseek-v2-236b (hf:deepseek-ai/DeepSeek-V2) at full width (d_model
    5120, 128 heads, MLA kv_lora 512 / q_lora 1536 / qk 128 + 64 / v 128, 160
    experts top-6 of d_ff 1536 with 2 shared, first layer dense of d_ff
    12288, vocab 102400), depth cut to MLA_LAYERS, bf16 weights from seed
    ``args.seed``, experts over MLA_EP_SLOTS stacked slots. A prefill of 8
    Zipf(1.3) prompts of 512 tokens at the config's capacity factor
    (overflow recorded), then the placement pair at a capacity factor that
    lets every expert keep every token: the default placement, the OS4M
    balancer's re-plan (BSS with cardinality 40) with the weights moved,
    the OS4M placement (logits ``torch.equal``, overflow 0 in both). Then
    ``Engine`` on MLA_LANES lanes (MLA's compressed cache, absorbed decode),
    kernel 9's simt instance at D = 192 in every prefill layer; 20 decode
    steps under the profiler; a 2-layer float32 twin on the card and the
    CPU. Returns ``(record, launches)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import balancer as bal_lib
    from repro_torch.models.model import default_placements, forward, init_cache, init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    full_cfg = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full_cfg, n_layers=MLA_LAYERS, attn_impl="pallas")
    moe, mla = cfg.moe, cfg.mla
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev, ep_slots=MLA_EP_SLOTS)
    torch.cuda.synchronize()
    n_moe = MLA_LAYERS - cfg.first_k_dense
    per_slot = moe.num_experts // MLA_EP_SLOTS
    rec = {"config": "deepseek-v2-236b", "source": "hf:deepseek-ai/DeepSeek-V2",
           "reduced": {"n_layers": [full_cfg.n_layers, MLA_LAYERS]}, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "mla": dataclasses.asdict(mla),
           "experts": moe.num_experts, "top_k": moe.top_k, "d_ff": moe.d_ff,
           "shared_experts": moe.shared_experts, "first_dense_ff": cfg.first_dense_ff,
           "vocab": cfg.vocab, "ep_slots": MLA_EP_SLOTS, "weights_gb": weights_gb(model),
           "init_s": time.perf_counter() - t0}
    print(f"mla path: deepseek-v2-236b, {MLA_LAYERS} of {full_cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA {mla.kv_lora}/{mla.q_lora}/"
          f"{mla.qk_nope}+{mla.qk_rope}/{mla.v_dim}, {moe.num_experts} experts top-{moe.top_k} "
          f"over {MLA_EP_SLOTS} slots: {rec['weights_gb']:.2f} GB of bf16 weights in "
          f"{rec['init_s']:.1f} s", flush=True)

    # ---- 1-2: Zipf prefills. The send buckets are dropless (each holds its
    # slot's every assignment). An expert keeps at most capacity_factor x
    # assignments / experts-a-slot rows; at n_local / top_k it keeps every
    # token (an expert gets at most one assignment a token).
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor((rng.zipf(1.3, (MLA_PROMPTS, MLA_PROMPT_LEN)) % cfg.vocab)
                             .astype(np.int64), device=dev)
    n_tok = MLA_PROMPTS * MLA_PROMPT_LEN
    capacity = MLA_PROMPTS * (MLA_PROMPT_LEN // MLA_EP_SLOTS) * moe.top_k
    dropless_cf = per_slot / moe.top_k

    def set_capacity_factor(cf):
        for layer in model.layers:
            layer.moe.args = dataclasses.replace(layer.moe.args, capacity_factor=cf)

    def prefill(placements, reps=3):
        times, out = [], None
        with torch.inference_mode():
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = forward(model, cfg, tokens=tokens, mode="prefill",
                              placements=placements, moe_capacity=capacity)
                out.logits.float().sum().item()
                times.append((time.perf_counter() - t) * 1e3)
        return out, times

    flash0 = dict(fa_ops.launches_by_design)
    at_config, config_ms = prefill(None, reps=1)
    overflow_config = int(at_config.stats["overflow"])
    del at_config
    set_capacity_factor(dropless_cf)
    base_place = default_placements(cfg, MLA_EP_SLOTS, device=dev)
    before, before_ms = prefill(None)
    counts = before.stats["expert_counts"].cpu().numpy()
    check(int(before.stats["overflow"]) == 0, "mla path: no overflow under the default placement")
    check(np.all(counts.sum(axis=1) == n_tok * moe.top_k),
          "mla path: every token routed to top-k experts in every MoE layer")
    balancer = bal_lib.ExpertBalancer(moe.num_experts, MLA_EP_SLOTS, n_moe, interval=1, ema=0.0)
    balancer.observe(counts)
    t = time.perf_counter()
    placements, perms, reports = balancer.replan()
    plan_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for layer, perm in zip(model.layers, perms):
        bal_lib.permute_expert_weights(layer.moe, perm)
    torch.cuda.synchronize()
    permute_ms = (time.perf_counter() - t) * 1e3
    after, after_ms = prefill(torch.as_tensor(placements, device=dev))
    check(int(after.stats["overflow"]) == 0, "mla path: no overflow under the OS4M placement")
    check(torch.equal(after.stats["expert_counts"], before.stats["expert_counts"]),
          "mla path: the re-placed experts see the same routing")
    check(bool(torch.isfinite(before.logits).all())
          and torch.equal(after.logits, before.logits),
          "mla path: logits after the re-plan bit-equal to the default placement's")
    prefill_design = {k: fa_ops.launches_by_design[k] - flash0[k] for k in flash0}
    check(prefill_design == {"wgmma": 0, "simt": 7 * MLA_LAYERS},
          f"mla path: every prefill layer ran kernel 9's simt instance at D = "
          f"{mla.qk_nope + mla.qk_rope} ({prefill_design})")
    load_before = slot_loads(counts, base_place.cpu().numpy(), MLA_EP_SLOTS)
    load_after = slot_loads(counts, placements, MLA_EP_SLOTS)
    ratio = lambda loads: (loads.max(axis=1) / loads.mean(axis=1)).tolist()   # noqa: E731
    rec["balance"] = {
        "expert_counts": counts.tolist(), "hottest_expert_share": (counts.max(1) / n_tok).tolist(),
        "slot_loads_before": load_before.tolist(), "slot_loads_after": load_after.tolist(),
        "balance_before": ratio(load_before), "balance_after": ratio(load_after),
        "reports": [dataclasses.asdict(r) for r in reports], "replan_ms": plan_ms,
        "permute_ms": permute_ms, "prefill_ms_config_cf": config_ms,
        "overflow_config_cf": overflow_config, "config_capacity_factor": moe.capacity_factor,
        "dropless_capacity_factor": dropless_cf, "prefill_ms_before": before_ms,
        "prefill_ms_after": after_ms, "capacity": capacity, "tokens": n_tok,
        "flash_launches_by_design": prefill_design}
    for i in range(n_moe):
        print(f"mla path MoE layer {i}: hottest expert {int(counts[i].max())} of {n_tok} | slot "
              f"loads {load_before[i].astype(int).tolist()} -> "
              f"{load_after[i].astype(int).tolist()} | balance ratio "
              f"{ratio(load_before)[i]:.4f} -> {ratio(load_after)[i]:.4f} "
              f"({reports[i].moved_experts} experts moved)", flush=True)
    print(f"mla path: prefill {MLA_PROMPTS} x {MLA_PROMPT_LEN} tokens, send capacity {capacity}: "
          f"capacity factor {moe.capacity_factor} (the config's) {config_ms[0]:.1f} ms with "
          f"overflow {overflow_config}; factor {dropless_cf:g} (every token kept) "
          f"{np.median(before_ms):.1f} ms (default placement), {np.median(after_ms):.1f} ms "
          f"(OS4M placement), overflow 0 and 0, logits bit-equal | re-plan {plan_ms:.2f} ms, "
          f"weight move {permute_ms:.1f} ms", flush=True)
    del before, after
    for layer, perm in zip(model.layers, perms):
        bal_lib.permute_expert_weights(layer.moe, np.arange(moe.num_experts), prev_perm=perm)
    set_capacity_factor(moe.capacity_factor)

    # ---- 3: the engine, MLA's compressed cache beside the GQA cache that
    # 128 heads of 128 + 128 would need at the same lanes and length.
    ecfg = EngineConfig(lanes=MLA_LANES, max_len=SERVE_MAX_LEN, scheduler="os4m")
    cache_bytes = sum(a.numel() * 4 for part in init_cache(
        cfg, MLA_LANES, SERVE_MAX_LEN, torch.float32, device="meta").values()
        for a in part["self"].values())
    gqa_bytes = MLA_LAYERS * MLA_LANES * SERVE_MAX_LEN * cfg.n_heads * (mla.qk_nope + mla.v_dim) * 4
    rec["cache"] = {"mla_bytes": cache_bytes, "gqa_bytes": gqa_bytes,
                    "ratio": gqa_bytes / cache_bytes, "dtype": "float32",
                    "lanes": MLA_LANES, "max_len": SERVE_MAX_LEN, "layers": MLA_LAYERS}
    print(f"mla cache (float32, {MLA_LAYERS} layers, {MLA_LANES} lanes x {SERVE_MAX_LEN}): "
          f"{cache_bytes / 1e6:.1f} MB (c_kv {mla.kv_lora} + k_pe {mla.qk_rope} a token) against "
          f"{gqa_bytes / 1e6:.1f} MB for {cfg.n_heads} heads of {mla.qk_nope} + {mla.v_dim} "
          f"({rec['cache']['ratio']:.1f}x)", flush=True)
    eng = Engine(cfg, model, ecfg, device=dev)
    reqs = serve_requests(cfg.vocab, args.seed, MLA_REQUESTS)
    rec["serve"] = family_serve("mla serve", eng, reqs, None, fa_ops, smi)
    check(rec["serve"]["flash_launches_by_design"] == {"wgmma": 0,
                                                       "simt": MLA_LAYERS * len(reqs)},
          f"mla serve: kernel 9's simt instance ran in every prefill layer "
          f"({MLA_LAYERS} x {len(reqs)})")
    rec["serve"]["profile_20_decode_steps"] = decode_profile(
        "mla", eng, int(np.median(rec["serve"]["prompt_lens"])))
    del eng, model
    torch.cuda.empty_cache()

    twin = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    gpu_model = init_model(twin, seed=args.seed, device=dev, ep_slots=MLA_EP_SLOTS)
    rec["f32_twin"] = twin_streams(
        "mla", twin, gpu_model, twin_requests(twin.vocab, args.seed),
        EngineConfig(lanes=MLA_LANES, max_len=64, scheduler="os4m", eos=-1),
        ep_slots=MLA_EP_SLOTS)
    launches = read_launches(counters)
    rec["launches"] = launches
    rec["launches_by_design"] = dict(fa_ops.launches_by_design)
    del gpu_model
    torch.cuda.empty_cache()
    return rec, launches


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------


def train_batches(cfg, seed: int, count: int, batch: int, seq: int, zipf_alpha: float = 1.2):
    """``count`` batches of the synthetic corpus (Zipf tokens in lognormal
    documents) packed into rows by the OS4M scheduler, as numpy."""
    from repro_torch.data.synthetic import CorpusConfig, token_batches

    it = token_batches(CorpusConfig(vocab=cfg.vocab, zipf_alpha=zipf_alpha), seed=seed,
                       batch=batch, seq_len=seq)
    return [next(it) for _ in range(count)]


def packing_stats(cfg, seed: int, batch: int, seq: int) -> dict:
    """PackingStats of the first batch's documents under os4m, lpt and hash."""
    from repro_torch.data import packing
    from repro_torch.data.synthetic import CorpusConfig, documents

    corpus = CorpusConfig(vocab=cfg.vocab)
    docs, total = [], 0
    while total < 1.3 * batch * seq:
        block = documents(corpus, seed, len(docs), 64)
        docs.extend(block)
        total += sum(d.shape[0] for d in block)
    return {name: dataclasses.asdict(packing.pack_documents(docs, batch, seq,
                                                            scheduler=name)[1])
            for name in ("os4m", "lpt", "hash")}


def run_steps(trainer, batches) -> list:
    """One ``trainer.run`` a batch; the wall time of each (ms, synchronized:
    the loop reads every metric back)."""
    times = []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.run(iter([b]), 1)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def link_copy(src: Path, dst: Path) -> None:
    """A checkpoint directory copied as hard links (it is never written in
    place: a save writes a new directory)."""
    shutil.copytree(src, dst, copy_function=os.link)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16).to(a.device))
    return torch.equal(a, b.to(a.device))


class NondeterminismLog:
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` while
    open; the names of the operations that warned they have no
    deterministic CUDA implementation."""

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self.records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        self._fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = self._fill
        self._catch.__exit__(*exc)
        self.ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                           for w in self.records
                           if "deterministic" in str(w.message)})
        return False


def dense_train_leg(args, dev, smi, tmp: Path) -> dict:
    """smollm-360m at full width and depth: TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ packed tokens with a checkpoint at step
    TRAIN_CKPT_EVERY (steps 1-10 timed, 11-20 under deterministic
    algorithms); a fresh trainer resumed from that checkpoint repeats steps
    11-20 (losses bit-equal under deterministic algorithms), the
    checkpoint's bf16 tensors bit-equal to the live ones, and the failure
    path (a step that raises once at step 15, restored from step 10 and
    retried). The resumed trainer then runs 10 more steps (21-30, on the
    batches of steps 11-20 again) under the profiler, without deterministic
    algorithms, as the timed steps run: the idle share."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    cfg = get_config("smollm-360m")
    shape = Shape("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=5, decay_steps=TRAIN_STEPS)
    tcfg = dict(ckpt_every=TRAIN_CKPT_EVERY, keep=1, log_every=1, seed=args.seed)
    batches = train_batches(cfg, args.seed, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {"config": "smollm-360m", "source": "hf:HuggingFaceTB/SmolLM", "reduced": {},
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
           "param_dtype": cfg.param_dtype, "moment_dtype": opt.moment_dtype,
           "packing": packing_stats(cfg, args.seed, TRAIN_BATCH, TRAIN_SEQ)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phase_s, last = {}, [t0]

    def mark(name):
        now = time.perf_counter()
        phase_s[name], last[0] = now - last[0], now

    ta = Trainer(cfg, shape, device=dev, opt_cfg=opt,
                 tcfg=TrainerConfig(ckpt_dir=str(tmp / "a"), **tcfg))
    rec["params"] = sum(p.numel() for p in ta.params.values())
    rec["init_s"] = time.perf_counter() - t0
    mark("init")
    first = run_steps(ta, batches[:TRAIN_CKPT_EVERY])
    mark("steps_1_10")
    check(ckpt_latest(tmp / "a") == TRAIN_CKPT_EVERY, "train: a checkpoint at step 10")
    name10 = f"step_{TRAIN_CKPT_EVERY:08d}"
    link_copy(tmp / "a" / name10, tmp / "b" / name10)
    link_copy(tmp / "a" / name10, tmp / "c" / name10)
    at10 = {name: p.detach().clone() for name, p in ta.params.items()}
    m10 = {name: m.clone() for name, m in ta.opt_state["m"].items()}
    ta.tcfg.ckpt_every = 10 ** 9                  # no save at step 20
    # Steps 11-20, the resumed run and the failure path under deterministic
    # algorithms (steps 1-10, timed, and the profiled steps 21-30 without).
    with NondeterminismLog() as nd:
        ta.run(iter(batches[TRAIN_CKPT_EVERY:]), TRAIN_STEPS - TRAIN_CKPT_EVERY)
        mark("steps_11_20")
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        hist_a = list(ta.history)
        losses = [m["loss"] for _, m in hist_a]
        check(all(np.isfinite(losses)), f"train: every loss finite ({losses})")
        check(losses[-1] < losses[0], f"train: the loss of step {TRAIN_STEPS} "
              f"({losses[-1]:.4f}) below step 1's ({losses[0]:.4f})")
        del ta
        torch.cuda.empty_cache()

        # ---- Resume: a fresh trainer from the step-10 checkpoint.
        tb = Trainer(cfg, shape, device=dev, opt_cfg=opt,
                     tcfg=TrainerConfig(ckpt_dir=str(tmp / "b"), **{**tcfg, "ckpt_every": 10 ** 9}))
        mark("resume_init")
        check(tb.try_resume() and tb.step == TRAIN_CKPT_EVERY, "train: resumed at step 10")
        mark("resume_load")
        bf16 = [n for n, p in tb.params.items() if p.dtype == torch.bfloat16]
        check(len(bf16) == len(tb.params) and all(bits_equal(tb.params[n], at10[n]) for n in bf16)
              and all(bits_equal(tb.opt_state["m"][n], m10[n]) for n in m10),
              "train: the checkpoint's bf16 weights and float32 moments came back bit-equal")
        del at10, m10
        tb.run(iter(batches[TRAIN_CKPT_EVERY:]), TRAIN_STEPS - TRAIN_CKPT_EVERY)
        mark("resume_steps_11_20")
        resumed = [m["loss"] for _, m in tb.history]

        # ---- Failure path: a step that raises once (at step 15).
        tc = Trainer(cfg, shape, device=dev, opt_cfg=opt,
                     tcfg=TrainerConfig(ckpt_dir=str(tmp / "c"), **{**tcfg, "ckpt_every": 10 ** 9}))
        check(tc.try_resume(), "train: the failure-path trainer resumed")
        step_fn, calls = tc.step_fn, []

        def flaky(*a):
            calls.append(tc.step)
            if len(calls) == 5:
                raise RuntimeError("simulated device loss at step 15")
            return step_fn(*a)

        tc.step_fn = flaky
        tc.run(iter(batches[TRAIN_CKPT_EVERY:TRAIN_CKPT_EVERY + 6]), 6)
        mark("failure_path")
        hist_c = list(tc.history)
        del tc
        torch.cuda.empty_cache()
    prof = profile_run("train dense: steps 21-30",
                       lambda: tb.run(iter(batches[TRAIN_CKPT_EVERY:]),
                                      TRAIN_STEPS - TRAIN_CKPT_EVERY))
    mark("steps_21_30_profiled")
    del tb
    torch.cuda.empty_cache()
    rec["nondeterministic_ops"] = nd.ops
    want = losses[TRAIN_CKPT_EVERY:]
    rec["resume_bit_equal"] = resumed == want
    rec["resume_max_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))

    def repeats(got, ref, what):
        # Bit-equal under deterministic algorithms; within 1e-3 relative if an
        # op has no deterministic CUDA path (named).
        if nd.ops:
            check(max(abs(a - b) / abs(b) for a, b in zip(got, ref)) < 1e-3,
                  f"train: {what} within 1e-3 relative of the first run's (ops without a "
                  f"deterministic CUDA path: {nd.ops})")
        else:
            check(got == ref, f"train: {what} bit-equal to the first run's ({got} vs {ref})")

    repeats(resumed, want, "resumed losses of steps 11-20")
    steps_c = [s for s, _ in hist_c]
    check(steps_c == [11, 12, 13, 14, 11, 12] and calls == [10, 11, 12, 13, 14, 10, 11],
          f"train: the failure path retried step 15 from step 10 ({steps_c}, {calls})")
    repeats([m["loss"] for _, m in hist_c[:4]], want[:4],
            "the failure-path trainer's losses of steps 11-14")
    check(hist_c[4][1]["lr"] == hist_a[TRAIN_CKPT_EVERY][1]["lr"]
          and np.isfinite(hist_c[4][1]["loss"]),
          "train: the retried step runs with step 11's learning rate (optimizer state rewound)")
    step_ms = first[1:TRAIN_CKPT_EVERY - 1]
    rec.update({
        "losses": losses, "resumed_losses": resumed,
        "grad_norms": [m["grad_norm"] for _, m in hist_a], "lrs": [m["lr"] for _, m in hist_a],
        "failure_steps": steps_c, "failure_losses": [m["loss"] for _, m in hist_c],
        "step_ms_first_10": first, "step_ms_median": float(np.median(step_ms)),
        "tokens_per_s": tokens / (np.median(step_ms) / 1e3),
        "profile_10_steps": {k: prof[k] for k in ("wall_ms", "device_ms", "top")},
        "idle_share": 1 - prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] else None,
        "profiled_step_ms": prof["wall_ms"] / (TRAIN_STEPS - TRAIN_CKPT_EVERY),
        "phase_s": phase_s, "wall_s": time.perf_counter() - t0})
    print(f"train dense ({smi}): smollm-360m {rec['params'] / 1e6:.1f} M params, bf16 weights, "
          f"f32 moments, remat, {TRAIN_BATCH} x {TRAIN_SEQ} os4m-packed tokens (packing "
          f"efficiency os4m {rec['packing']['os4m']['real_tokens'] / tokens:.4f}, hash "
          f"{rec['packing']['hash']['real_tokens'] / tokens:.4f}) | loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} | step {rec['step_ms_median']:.1f} ms median (steps 2-9), "
          f"{rec['tokens_per_s']:.0f} tokens/s, {rec['profiled_step_ms']:.1f} ms a step "
          f"under the profiler (steps 21-30) | peak {rec['peak_gb']:.2f} GB | idle "
          f"{rec['idle_share'] if rec['idle_share'] is None else round(rec['idle_share'], 4)}",
          flush=True)
    print(f"train dense: resume from step 10 -> losses of steps 11-20 "
          f"{'bit-equal' if rec['resume_bit_equal'] else 'max rel diff %.3g' % rec['resume_max_rel_diff']}"
          f" (deterministic algorithms; ops without a deterministic path: {nd.ops or 'none'}); "
          f"bf16 round trip bit-equal; failure at step 15 -> steps {steps_c} | phases (s) "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} }", flush=True)
    return rec


def ckpt_latest(path: Path):
    from repro_torch.train import checkpoint as ckpt_lib

    return ckpt_lib.latest_step(path)


def train_launcher_run(tmp: Path, timeout: int = 600) -> dict:
    """``python -m repro_torch.launch.train --arch smollm-360m --full --steps
    20 --batch 8 --seq 1024`` as a subprocess on the card, then ``--resume``
    for 2 more steps."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
            "--full", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir",
            str(tmp / "cli")]
    out = {}
    for name, extra in (("train", ["--steps", str(TRAIN_STEPS)]),
                        ("resume", ["--steps", "2", "--resume"])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, capture_output=True, text=True, timeout=timeout,
                              env=env, cwd=ROOT)
        lines = proc.stdout.strip().splitlines()
        out[name] = {"wall_s": time.perf_counter() - t0, "lines": lines}
        check(proc.returncode == 0,
              f"train launcher ({name}) exits 0 (rc {proc.returncode}: {proc.stderr[-2000:]})")
        out[name]["latest_checkpoint"] = ckpt_latest(tmp / "cli")
    lines = out["train"]["lines"]
    pattern = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{3})  lr (\S+)$")
    steps = [int(m.group(1)) for m in map(pattern.match, lines[:-1]) if m]
    check(steps == [10, 20] and len(lines) == 3
          and lines[-1] == f"done at step {TRAIN_STEPS}; checkpoints in {tmp / 'cli'}",
          f"train launcher: the reference's log lines ({lines})")
    check(out["train"]["latest_checkpoint"] == TRAIN_STEPS, "train launcher: a final checkpoint")
    check(out["resume"]["lines"][0] == f"resumed from step {TRAIN_STEPS}"
          and out["resume"]["lines"][-1].startswith(f"done at step {TRAIN_STEPS + 2}"),
          f"train launcher --resume: {out['resume']['lines']}")
    print(f"train launcher (python -m repro_torch.launch.train --arch smollm-360m --full "
          f"--steps {TRAIN_STEPS} --batch {TRAIN_BATCH} --seq {TRAIN_SEQ}, "
          f"{out['train']['wall_s']:.1f} s): {' | '.join(lines)} || --resume "
          f"({out['resume']['wall_s']:.1f} s): {' | '.join(out['resume']['lines'])}",
          flush=True)
    return out


def moe_loss(model, cfg, tokens, capacity):
    """The train step's loss (``launch.steps``): lm_loss + aux_loss."""
    from repro_torch.models.model import forward, lm_loss

    out = forward(model, cfg, tokens=tokens, mode="train", moe_capacity=capacity)
    return lm_loss(out.logits[:, :-1], tokens[:, 1:]) + out.stats["aux_loss"]


def grads_stable(model, cfg, tokens, capacity, deterministic: bool) -> list:
    """Two backward passes at the same weights and batch: the names of the
    parameters whose gradients differ in any bit."""
    names, params = zip(*model.named_parameters())
    runs = []
    for _ in range(2):
        if deterministic:
            with NondeterminismLog():
                grads = torch.autograd.grad(moe_loss(model, cfg, tokens, capacity), params)
        else:
            grads = torch.autograd.grad(moe_loss(model, cfg, tokens, capacity), params)
        runs.append(grads)
    differ = [n for n, a, b in zip(names, *runs) if not bits_equal(a, b)]
    del runs
    torch.cuda.empty_cache()
    return differ


def moe_train_leg(args, dev, smi) -> dict:
    """deepseek-v2-236b at full width, depth cut to MOE_TRAIN_LAYERS (1 dense
    + 1 MoE), experts over MOE_TRAIN_SLOTS slots, bf16 weights and moments:
    MOE_TRAIN_STEPS steps of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ Zipf(1.3) packed
    tokens with the balancer re-planning every MOE_REPLAN steps; at each
    re-plan a probe batch without grad at a capacity that keeps every token
    gives logits bit-equal before and after the weight move."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Shape
    from repro_torch.models.model import default_placements, forward, init_model, \
        moe_capacity_for_shape
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    moe = cfg.moe
    shape = Shape("chip", "train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev, ep_slots=MOE_TRAIN_SLOTS)
    n_params = sum(p.numel() for p in model.parameters())
    batches = train_batches(cfg, args.seed, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                            zipf_alpha=1.3)
    capacity = moe_capacity_for_shape(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_SLOTS)
    rec = {"config": "deepseek-v2-236b", "source": "hf:deepseek-ai/DeepSeek-V2",
           "reduced": {"n_layers": [full.n_layers, MOE_TRAIN_LAYERS]}, "params": n_params,
           "ep_slots": MOE_TRAIN_SLOTS, "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
           "capacity": capacity, "capacity_factor": moe.capacity_factor,
           "moment_dtype": "bfloat16", "init_s": time.perf_counter() - t0}

    # ---- Are the card's gradients bit-stable run to run?
    model.requires_grad_(True)
    probe_tok = torch.as_tensor(batches[0], device=dev)
    rec["grad_bits_differ"] = grads_stable(model, cfg, probe_tok, capacity, False)
    rec["grad_bits_differ_deterministic"] = grads_stable(model, cfg, probe_tok, capacity, True)
    print(f"train moe: gradients over two runs at the same weights: "
          f"{len(rec['grad_bits_differ'])} of {len(list(model.parameters()))} parameters differ "
          f"in some bit {rec['grad_bits_differ'] or ''}; under deterministic algorithms "
          f"{len(rec['grad_bits_differ_deterministic'])} "
          f"{rec['grad_bits_differ_deterministic'] or ''}", flush=True)

    opt = OptConfig(lr=TRAIN_LR, warmup_steps=5, decay_steps=MOE_TRAIN_STEPS,
                    moment_dtype="bfloat16")
    trainer = Trainer(cfg, shape, model=model, opt_cfg=opt,
                      tcfg=TrainerConfig(ckpt_every=10 ** 9, replan_interval=MOE_REPLAN,
                                         log_every=1, seed=args.seed))
    rng = np.random.default_rng(args.seed + 7)
    probe = torch.as_tensor((rng.zipf(1.3, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)) % cfg.vocab)
                            .astype(np.int64), device=dev)
    per_slot = moe.num_experts // MOE_TRAIN_SLOTS
    dropless = MOE_TRAIN_BATCH * (MOE_TRAIN_SEQ // MOE_TRAIN_SLOTS) * moe.top_k

    def probe_logits(placements):
        for layer in model.layers:
            layer.moe.args = dataclasses.replace(layer.moe.args,
                                                 capacity_factor=per_slot / moe.top_k)
        with torch.inference_mode():
            out = forward(model, cfg, tokens=probe, mode="train", placements=placements,
                          moe_capacity=dropless)
        for layer in model.layers:
            layer.moe.args = dataclasses.replace(layer.moe.args,
                                                 capacity_factor=moe.capacity_factor)
        check(int(out.stats["overflow"]) == 0, "train moe: the probe keeps every token")
        return out.logits

    replans = []
    apply, plan = trainer._apply_placements, trainer.balancer.replan

    def timed_plan():
        t = time.perf_counter()
        res = plan()
        replans.append({"replan_ms": (time.perf_counter() - t) * 1e3,
                        "counts": trainer.balancer.counts.copy()})
        return res

    def checked_apply(placements, perms):
        before_place = trainer.placements.clone()
        before = probe_logits(before_place)
        torch.cuda.synchronize()
        t = time.perf_counter()
        apply(placements, perms)
        torch.cuda.synchronize()
        move_ms = (time.perf_counter() - t) * 1e3
        after = probe_logits(trainer.placements)
        counts = replans[-1]["counts"]
        replans[-1].update({
            "step": trainer.step, "move_ms": move_ms,
            "moved": [int((np.asarray(p) != np.arange(moe.num_experts)).sum()) for p in perms],
            "bit_equal": bool(torch.isfinite(before).all()) and torch.equal(after, before),
            "slot_loads_before": slot_loads(counts, before_place.cpu().numpy(),
                                            MOE_TRAIN_SLOTS).tolist(),
            "slot_loads_after": slot_loads(counts, np.asarray(placements),
                                           MOE_TRAIN_SLOTS).tolist()})
        check(replans[-1]["bit_equal"], f"train moe: probe logits bit-equal across the weight "
              f"move at step {trainer.step}")

    trainer.balancer.replan = timed_plan
    trainer._apply_placements = checked_apply
    mark = time.perf_counter()
    step_ms = dict(enumerate(run_steps(trainer, batches[:MOE_PROFILE_FROM]), 1))
    rec["steps_1_20_s"] = time.perf_counter() - mark
    mark = time.perf_counter()
    prof = profile_run(f"train moe: steps {MOE_PROFILE_FROM + 1}-{MOE_PROFILE_TO}",
                       lambda: trainer.run(iter(batches[MOE_PROFILE_FROM:MOE_PROFILE_TO]),
                                           MOE_PROFILE_TO - MOE_PROFILE_FROM))
    rec["profiled_s"] = time.perf_counter() - mark
    step_ms.update(enumerate(run_steps(trainer, batches[MOE_PROFILE_TO:]), MOE_PROFILE_TO + 1))
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    hist = list(trainer.history)
    losses = [m["loss"] for _, m in hist]
    check(all(np.isfinite(losses)), f"train moe: every loss finite ({losses})")
    check(len(replans) == MOE_TRAIN_STEPS // MOE_REPLAN
          and all("bit_equal" in r for r in replans),
          f"train moe: {MOE_TRAIN_STEPS // MOE_REPLAN} re-plans applied and probed")
    plain = [t for i, t in step_ms.items() if i > 1 and i % MOE_REPLAN]   # no re-plan
    for r in replans:
        m = dict(hist)[r["step"]]
        r["balance_ratio"], r["baseline_ratio"] = m["balance_ratio"], m["baseline_ratio"]
        print(f"train moe re-plan at step {r['step']}: balance ratio {r['balance_ratio']:.4f} "
              f"(baseline {r['baseline_ratio']:.4f}) | slot loads "
              f"{np.round(r['slot_loads_before'][0]).astype(int).tolist()} -> "
              f"{np.round(r['slot_loads_after'][0]).astype(int).tolist()} | {r['moved']} experts "
              f"moved | re-plan {r['replan_ms']:.2f} ms, weight move {r['move_ms']:.1f} ms | "
              f"probe logits bit-equal", flush=True)
    rec.update({
        "losses": losses, "grad_norms": [m["grad_norm"] for _, m in hist],
        "overflow": [m["overflow"] for _, m in hist], "replans": replans,
        "step_ms": step_ms, "step_ms_median": float(np.median(plain)),
        "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (np.median(plain) / 1e3),
        "profile": {k: prof[k] for k in ("wall_ms", "device_ms", "top")},
        "idle_share": 1 - prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] else None,
        "wall_s": time.perf_counter() - t0})
    for r in replans:
        del r["counts"]
    print(f"train moe ({smi}): deepseek-v2-236b {MOE_TRAIN_LAYERS} of {full.n_layers} layers, "
          f"{n_params / 1e9:.2f} G params over {MOE_TRAIN_SLOTS} expert slots, bf16 moments | "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, overflow {int(sum(rec['overflow']))} "
          f"assignments over {MOE_TRAIN_STEPS} steps (capacity factor {moe.capacity_factor}) | "
          f"step {rec['step_ms_median']:.1f} ms median, {rec['tokens_per_s']:.0f} tokens/s | peak "
          f"{rec['peak_gb']:.2f} GB | idle "
          f"{rec['idle_share'] if rec['idle_share'] is None else round(rec['idle_share'], 4)}",
          flush=True)
    del trainer, model
    torch.cuda.empty_cache()
    return rec


def router_margin(model, cfg, tokens) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over the MoE layers, at ``model``'s weights."""
    from repro_torch.models.model import forward

    seen = []
    hooks = [layer.moe.register_forward_pre_hook(lambda mod, a: seen.append((mod, a[0])))
             for layer in model.layers]
    with torch.no_grad():
        forward(model, cfg, tokens=tokens, mode="train")
    for h in hooks:
        h.remove()
    k = cfg.moe.top_k
    margins = []
    for mod, x in seen:
        probs = torch.softmax(x.float().reshape(-1, x.shape[-1]) @ mod.router.float(), -1)
        top = torch.topk(probs, k + 1, dim=-1).values
        margins.append(float((top[:, k - 1] - top[:, k]).min()))
    return min(margins)


def grad_log(tr) -> dict:
    """Every step's gradient of each of ``tr``'s parameters (float32 copies
    on the parameter's device), from a hook on the parameter."""
    log = {name: [] for name in tr.params}
    for name, p in tr.params.items():
        p.register_hook(lambda g, _log=log[name]: _log.append(g.detach().float().clone()))
    return log


def twin_diagnosis(tg, tc, grads, k: int = 5) -> dict:
    """Where the card's final parameters differ most from the CPU's: the
    ``k`` worst elements with each step's gradient on both sides and the
    parameter's gradient RMS, and over every element and step, how many
    gradients differ in sign between card and CPU and the largest magnitude
    among them."""
    worst = []
    for name, p in tc.params.items():
        d = (tg.params[name].detach().cpu() - p.detach()).abs().flatten()
        top = torch.topk(d, min(k, d.numel()))
        worst += [(float(v), name, int(i)) for v, i in zip(top.values, top.indices)]
    rows = []
    for err, name, i in sorted(worst, reverse=True)[:k]:
        card = [float(g.flatten()[i]) for g in grads["cuda"][name]]
        cpu = [float(g.flatten()[i]) for g in grads["cpu"][name]]
        rows.append({"param": name, "index": i, "abs_err": err, "grad_card": card,
                     "grad_cpu": cpu, "sign_differs": [bool(np.sign(a) != np.sign(b))
                                                       for a, b in zip(card, cpu)],
                     "param_grad_rms": [float(g.square().mean().sqrt())
                                        for g in grads["cpu"][name]]})
    flips, flip_max, grad_sq, pairs = 0, 0.0, 0.0, 0
    for name, steps in grads["cpu"].items():
        for a, b in zip(grads["cuda"][name], steps):
            b = b.to(a.device)
            differ = torch.sign(a) != torch.sign(b)
            flips += int(differ.sum())
            if differ.any():
                flip_max = max(flip_max, float(torch.maximum(a.abs(), b.abs())[differ].max()))
            grad_sq += float(b.square().sum())
            pairs += b.numel()
    return {"worst": rows, "sign_flips": flips, "sign_flip_max_abs_grad": flip_max,
            "grad_rms": (grad_sq / pairs) ** 0.5, "element_steps": pairs}


def twin_train(label, cfg, batches, opt, tcfg_kw, ep_slots, dev, seed, controls=(),
               bound: str = "trajectory") -> dict:
    """A float32 twin trained on the card and on the CPU from the same
    weights (drawn on the CPU) and batches. ``bound="trajectory"``: losses
    and grad norms within 1e-4 relative at every step, final parameters
    within TWIN_PARAM_ATOL; ``"first_step"`` (the state-based twins): step
    1's loss within 1e-5 relative and its gradient within
    STATE_GRAD_REL_TOL (relative L2), the later steps and the parameters
    recorded. Placements equal at each re-plan (a differing one is reported
    with the router's top-k margin). Each step's gradients are logged on
    both sides for :func:`twin_diagnosis` and their relative L2 distance,
    card vs CPU. ``controls`` names card runs with a known fault ("tf32":
    TF32 matmuls; "bf16": bf16 compute over the float32 weights), each of
    whose final parameters must differ from the CPU's by more than
    TWIN_PARAM_ATOL (the check can see a fault of that size)."""
    import copy

    from repro_torch.models.config import Shape
    from repro_torch.models.model import init_model
    from repro_torch.train.loop import Trainer, TrainerConfig

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest", f"{label}: TF32 off")
    shape = Shape("twin", "train", batches[0].shape[1], batches[0].shape[0])
    cpu_model = init_model(cfg, seed=seed, device="cpu", ep_slots=ep_slots)
    start = copy.deepcopy(cpu_model) if controls else None
    out, placements, grads = {}, {}, {}
    for where, mdl in (("cuda", copy.deepcopy(cpu_model).to(dev)), ("cpu", cpu_model)):
        t = time.perf_counter()
        tr = Trainer(cfg, shape, model=mdl, opt_cfg=opt, tcfg=TrainerConfig(**tcfg_kw))
        grads[where] = grad_log(tr)
        applied = []
        if tr.balancer is not None:
            apply = tr._apply_placements

            def record(p, perms, _apply=apply, _applied=applied, _tr=tr):
                _apply(p, perms)
                _applied.append(_tr.placements.cpu().numpy().copy())

            tr._apply_placements = record
        tr.run(iter(batches), len(batches))
        out[where] = (tr, time.perf_counter() - t)
        placements[where] = applied
    (tg, sg), (tc, sc) = out["cuda"], out["cpu"]
    rel = lambda key: max(abs(a[1][key] - b[1][key]) / max(abs(b[1][key]), 1e-30)  # noqa: E731
                          for a, b in zip(tg.history, tc.history))

    def param_err(tr) -> float:
        return max(float((tr.params[n].detach().cpu() - p.detach()).abs().max())
                   for n, p in tc.params.items())

    err = param_err(tg)
    norms = [float(sum(g[i].double().square().sum() for g in grads["cpu"].values())) ** 0.5
             for i in range(len(batches))]
    check(max(abs(n - m["grad_norm"]) / m["grad_norm"] for n, (_, m) in zip(norms, tc.history))
          < 1e-5, f"{label}: the logged gradients are the step's (their norm is its grad norm)")
    rec = {"steps": len(batches), "loss_max_rel": rel("loss"), "grad_norm_max_rel": rel("grad_norm"),
           "param_max_abs_err": err, "seconds": {"cuda": sg, "cpu": sc},
           "losses": [m["loss"] for _, m in tg.history],
           "grad_norms": [m["grad_norm"] for _, m in tc.history],
           "diagnosis": twin_diagnosis(tg, tc, grads),
           "grad_rel_l2": [
               (sum(float((grads["cuda"][n][i].cpu() - g[i]).double().square().sum())
                    for n, g in grads["cpu"].items()) ** 0.5 / norms[i]) if norms[i] else 0.0
               for i in range(len(batches))]}
    del grads
    rec["controls"] = {}
    for kind in controls:
        prec = torch.get_float32_matmul_precision()
        if kind == "tf32":
            torch.set_float32_matmul_precision("high")
        try:
            fault = Trainer(cfg if kind == "tf32" else
                            dataclasses.replace(cfg, compute_dtype="bfloat16"), shape,
                            model=copy.deepcopy(start).to(dev), opt_cfg=opt,
                            tcfg=TrainerConfig(**tcfg_kw))
            fault.run(iter(batches), len(batches))
        finally:
            torch.set_float32_matmul_precision(prec)
        rec["controls"][kind] = {"param_max_abs_err": param_err(fault),
                                 "loss_max_rel": max(abs(a[1]["loss"] - b[1]["loss"]) / abs(b[1]["loss"])
                                                     for a, b in zip(fault.history, tc.history))}
        del fault
    equal = [bool(np.array_equal(a, b)) for a, b in zip(placements["cuda"], placements["cpu"])]
    rec["replans"], rec["placements_equal"] = len(equal), equal
    if not all(equal):
        rec["router_margin"] = router_margin(tc.model, cfg, torch.as_tensor(batches[-1]))
        check(rec["router_margin"] <= 1e-4, f"{label}: placements differ with a router top-k "
              f"margin of {rec['router_margin']:.3g} (above 1e-4)")
    diag = rec["diagnosis"]
    print(f"{label} f32 twin ({cfg.n_layers} layers, {len(batches)} steps of "
          f"{batches[0].shape[0]} x {batches[0].shape[1]}): card vs CPU loss max rel "
          f"{rec['loss_max_rel']:.2e}, grad norm max rel {rec['grad_norm_max_rel']:.2e}, final "
          f"params max abs {err:.2e}"
          + (f", placements equal at {len(equal)} re-plans" if equal else "")
          + f" (card {sg:.1f} s, CPU {sc:.1f} s) | gradients differing in sign "
          f"{diag['sign_flips']} of {diag['element_steps']} (largest |g| among them "
          f"{diag['sign_flip_max_abs_grad']:.3g}; gradient RMS {diag['grad_rms']:.3g})"
          + "".join(f" | control {k}: params max abs {c['param_max_abs_err']:.2e}, loss max rel "
                    f"{c['loss_max_rel']:.2e}" for k, c in rec["controls"].items()), flush=True)
    for r in diag["worst"]:
        print(f"  {r['param']}[{r['index']}]: |card - CPU| {r['abs_err']:.3g}; gradient card "
              f"{np.array2string(np.array(r['grad_card']), precision=3)} CPU "
              f"{np.array2string(np.array(r['grad_cpu']), precision=3)}; parameter RMS "
              f"{np.array2string(np.array(r['param_grad_rms']), precision=3)}", flush=True)
    print(f"  gradients card vs CPU, relative L2 by step: "
          f"{' '.join(f'{v:.3g}' for v in rec['grad_rel_l2'])}", flush=True)
    if bound == "first_step":
        first = abs(tg.history[0][1]["loss"] - tc.history[0][1]["loss"]) / tc.history[0][1]["loss"]
        check(first <= 1e-5 and rec["grad_rel_l2"][0] <= STATE_GRAD_REL_TOL,
              f"{label}: step 1's loss within 1e-5 relative ({first:.3g}) and gradient within "
              f"{STATE_GRAD_REL_TOL} ({rec['grad_rel_l2'][0]:.3g}), card vs CPU")
        check(all(np.isfinite(rec["losses"])), f"{label}: every loss finite")
        return rec
    check(rec["loss_max_rel"] <= 1e-4 and rec["grad_norm_max_rel"] <= 1e-4,
          f"{label}: card vs CPU losses and grad norms within 1e-4 relative ({rec})")
    check(err <= TWIN_PARAM_ATOL, f"{label}: final parameters within {TWIN_PARAM_ATOL} ({err:.3g})")
    for kind, c in rec["controls"].items():
        check(c["param_max_abs_err"] > TWIN_PARAM_ATOL,
              f"{label}: the {kind} control's parameters differ by more than {TWIN_PARAM_ATOL}")
    return rec


def train_path(counters, args, dev, smi) -> tuple:
    """The training path: the dense leg (smollm-360m, full width and depth),
    the launcher (``--full`` and ``--resume``), the MoE leg (deepseek-v2-236b
    at full width with the balancer in the loop) and the float32 twins, card
    against CPU. No kernel of the nine runs on it (kernel 9 has no backward;
    training attends with "blocked"). Returns ``(record, launches)``."""
    import tempfile

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.train.optim import OptConfig

    reset_launches(counters)
    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        rec["dense"] = dense_train_leg(args, dev, smi, Path(tmp))
        torch.cuda.empty_cache()
        rec["launcher"] = train_launcher_run(Path(tmp))
    rec["moe"] = moe_train_leg(args, dev, smi)
    twin = dataclasses.replace(get_config("smollm-360m"), n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=5)
    rec["dense_twin"] = twin_train(
        "train dense", twin, train_batches(twin, args.seed, 5, 2, 128), opt,
        dict(ckpt_every=10 ** 9), 1, dev, args.seed, controls=("tf32", "bf16"))
    ds = get_smoke("deepseek-v2-236b")
    rec["moe_twin"] = twin_train(
        "train moe", ds, train_batches(ds, args.seed, 10, 4, 32, zipf_alpha=1.3),
        OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=10),
        dict(ckpt_every=10 ** 9, replan_interval=5), MOE_TRAIN_SLOTS, dev, args.seed)
    check(rec["moe_twin"]["replans"] == 2, "train moe twin: two re-plans on each side")
    launches = read_launches(counters)
    rec["launches"] = launches
    check(all(v == 0 for v in launches.values()),
          f"the training path launched none of the nine kernels ({launches})")
    return rec, launches


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / tuple (a model's cache)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def state_decode_vs_full(model, cfg, tokens, prompt: int, steps: int, greedy: bool,
                         cache_dtype, extra_len: int = 0) -> dict:
    """A prefill of ``tokens[:, :prompt]`` and ``steps`` decode steps from
    the returned state (greedy, or teacher-forced with ``tokens``), then
    the train-mode forward of the whole stream: the step logits (the
    prefill's last and each step's), the full forward's at the same
    positions, prefill and decode ms (host clock ending in the token's copy
    to the host), the cache's bytes after the prefill, and the cache (room
    for ``extra_len`` more steps) with the stream."""
    from repro_torch.models.model import forward, init_cache

    dev = tokens.device
    b = tokens.shape[0]
    with torch.inference_mode():
        cache = init_cache(cfg, b, prompt + steps + extra_len, dtype=cache_dtype, device=dev)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        out = forward(model, cfg, tokens=tokens[:, :prompt], mode="prefill", cache=cache)
        nxt = out.logits[:, -1].argmax(-1) if greedy else tokens[:, prompt]
        nxt.cpu()
        pre_ms = (time.perf_counter() - t) * 1e3
        cache, state_bytes = out.cache, tree_bytes(out.cache)
        logits, toks, dec_ms = [out.logits[:, -1].float()], [], []
        for i in range(steps):
            toks.append(nxt)
            t = time.perf_counter()
            out = forward(model, cfg, tokens=nxt[:, None], mode="decode", cache=cache,
                          cache_pos=prompt + i)
            if greedy:
                nxt = out.logits[:, -1].argmax(-1)
            elif i + 1 < steps:
                nxt = tokens[:, prompt + i + 1]
            nxt.cpu()
            dec_ms.append((time.perf_counter() - t) * 1e3)
            logits.append(out.logits[:, -1].float())
        del out
        stream = torch.cat([tokens[:, :prompt], torch.stack(toks, dim=1)], dim=1)
        full = forward(model, cfg, tokens=stream).logits[:, prompt - 1:].float()
    return {"steps": torch.stack(logits, dim=1), "full": full, "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "state_bytes": state_bytes, "cache": cache, "stream": stream}


def state_twin(label, cfg, dev, seed) -> dict:
    """The float32 twin at full width and small depth, on the card and the
    CPU from the same weights (drawn on the CPU): a prefill of 2 x
    STATE_TWIN_PROMPT tokens and STATE_TWIN_DECODE teacher-forced decode
    steps, whose logits card vs CPU and against each side's full forward
    are within STATE_F32_TOL (with ``cfg``'s attention: zamba2's twin
    launches kernel 9); then :func:`twin_train` (STATE_TWIN_STEPS steps of
    2 x 64 with blocked attention, ``bound="first_step"``)."""
    import copy

    from repro_torch.models.model import init_model
    from repro_torch.train.optim import OptConfig

    check(not torch.backends.cuda.matmul.allow_tf32, f"{label} twin: TF32 off")
    cpu_model = init_model(cfg, seed=seed, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(seed + 17)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab, (2, STATE_TWIN_PROMPT + STATE_TWIN_DECODE)))
    res = {}
    for where, mdl in (("cuda", gpu_model), ("cpu", cpu_model)):
        t = time.perf_counter()
        res[where] = state_decode_vs_full(mdl, cfg, toks.to(mdl.device), STATE_TWIN_PROMPT,
                                          STATE_TWIN_DECODE, False, torch.float32)
        res[where]["seconds"] = time.perf_counter() - t
    g, c = res["cuda"], res["cpu"]
    diff = lambda a, b: float((a.cpu() - b.cpu()).abs().max())  # noqa: E731
    rec = {"n_layers": cfg.n_layers, "prompt": STATE_TWIN_PROMPT, "decode": STATE_TWIN_DECODE,
           "tol": STATE_F32_TOL, "prefill_card_vs_cpu": diff(g["steps"][:, 0], c["steps"][:, 0]),
           "decode_card_vs_cpu": diff(g["steps"], c["steps"]),
           "decode_vs_full_card": diff(g["steps"], g["full"]),
           "decode_vs_full_cpu": diff(c["steps"], c["full"]),
           "logit_max_abs": float(c["full"].abs().max()),
           "argmax_agree_card_cpu": float((g["steps"].argmax(-1).cpu()
                                           == c["steps"].argmax(-1)).float().mean()),
           "seconds": {k: v["seconds"] for k, v in res.items()}}
    print(f"{label} f32 twin ({cfg.n_layers} layers, full width): prefill logits card vs CPU "
          f"{rec['prefill_card_vs_cpu']:.3g}, {STATE_TWIN_DECODE} teacher-forced decode steps "
          f"card vs CPU {rec['decode_card_vs_cpu']:.3g}, decode vs the full forward card "
          f"{rec['decode_vs_full_card']:.3g} CPU {rec['decode_vs_full_cpu']:.3g} (max |logit| "
          f"{rec['logit_max_abs']:.3g}, tol {STATE_F32_TOL}; card {g['seconds']:.1f} s, CPU "
          f"{c['seconds']:.1f} s)", flush=True)
    for key in ("prefill_card_vs_cpu", "decode_card_vs_cpu", "decode_vs_full_card",
                "decode_vs_full_cpu"):
        check(rec[key] <= STATE_F32_TOL, f"{label} f32 twin: {key} within {STATE_F32_TOL} "
              f"({rec[key]:.3g})")
    del res, g, c, gpu_model, cpu_model
    torch.cuda.empty_cache()
    rec["train"] = twin_train(
        f"{label} train", dataclasses.replace(cfg, attn_impl="blocked"),
        train_batches(cfg, seed, STATE_TWIN_STEPS, 2, 64),
        OptConfig(lr=TRAIN_LR, warmup_steps=2, decay_steps=STATE_TWIN_STEPS),
        dict(ckpt_every=10 ** 9), 1, dev, seed, bound="first_step")
    return rec


def state_path(arch, counters, fa_ops, args, dev, smi) -> tuple:
    """A state-based arch at full width, its depth cut to STATE_GROUPS groups,
    bf16 weights from seed ``args.seed``: zamba2-2.7b (arXiv:2411.15242: 54
    Mamba2 layers in full, d_model
    2560, d_inner 5120 in 80 heads of 64, state 64; the shared attention +
    MLP block after every 6, 32 heads of 80, with attn_impl="pallas":
    kernel 9's simt instance once a group in every prefill and full
    forward) or xlstm-1.3b (arXiv:2405.04517: 48 layers in full, 6 groups of 7
    mLSTM + 1 sLSTM, d_model 2048, 4 heads, the mLSTM's head dim 1024; no
    kernel). Model level (:func:`state_decode_vs_full`): a prefill of
    STATE_BATCH x STATE_PROMPT, STATE_DECODE greedy decode steps against the
    full forward, and in float32 compute on the same weights (teacher-forced
    on that stream) within STATE_F32_REL_TOL, the bf16 decode within twice
    the bf16 forward's distance from the float32 one; the decode state's
    bytes; 20 more
    decode steps and one Mamba2 / sLSTM layer's forward at the training
    shape under the profiler (the SSD chunk loop, the sLSTM's time loop);
    then STATE_TRAIN_STEPS Trainer steps (attn_impl="blocked", remat, f32
    moments, os4m-packed batches): finite losses, the last below the first,
    step ms, tokens/s, peak GB; last the float32 twin
    (:func:`state_twin`). Returns ``(record, launches)``."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Shape
    from repro_torch.models.model import forward, init_model
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import OptConfig

    label = arch.split("-")[0]
    full = get_config(arch)
    per = full.attn_every or full.slstm_every
    groups = STATE_GROUPS[arch]
    cfg = dataclasses.replace(full, attn_impl="pallas", n_layers=groups * per)
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    rec = {"config": arch, "source": {"zamba2": "arXiv:2411.15242",
                                      "xlstm": "arXiv:2405.04517"}[label],
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "params": sum(p.numel() for p in model.parameters()),
           "weights_gb": weights_gb(model), "init_s": time.perf_counter() - t0,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                       "why": "the script's 1,200 s with the examples phase"}}
    print(f"{label} path ({smi}): {arch}, {cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}: {rec['params'] / 1e9:.3f} G params, {rec['weights_gb']:.2f} GB of "
          f"bf16 weights in {rec['init_s']:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed + 5)
    prompts = torch.as_tensor(rng.integers(3, cfg.vocab, (STATE_BATCH, STATE_PROMPT)),
                              device=dev)
    with torch.inference_mode():      # first calls (libraries, allocations) untimed
        forward(model, cfg, tokens=prompts[:, :64], mode="prefill")
    res = state_decode_vs_full(model, cfg, prompts, STATE_PROMPT, STATE_DECODE, True,
                               torch.bfloat16, extra_len=21)
    steps, full = res["steps"], res["full"]
    # The same weights computing in float32, teacher-forced on the bf16
    # greedy stream: decode from state == the full forward at full depth.
    res32 = state_decode_vs_full(model, dataclasses.replace(cfg, compute_dtype="float32"),
                                 res["stream"], STATE_PROMPT, STATE_DECODE, False,
                                 torch.float32)
    full32 = res32["full"]
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)  # noqa: E731
                             / torch.linalg.vector_norm(b))
    ml = {"batch": STATE_BATCH, "prompt": STATE_PROMPT, "decode_steps": STATE_DECODE,
          "rel_l2": rel(steps, full), "f32_rel_l2": rel(res32["steps"], full32),
          "f32_tol": STATE_F32_REL_TOL, "bf16_decode_vs_f32": rel(steps, full32),
          "bf16_full_vs_f32": rel(full, full32),
          "top1_agree": float((steps.argmax(-1) == full.argmax(-1)).float().mean()),
          "max_abs_diff": float((steps - full).abs().max()),
          "logit_max_abs": float(full.abs().max()), "prefill_ms": res["prefill_ms"],
          "decode_ms": res["decode_ms"], "decode_ms_median": float(np.median(res["decode_ms"][1:])),
          "f32_prefill_ms": res32["prefill_ms"], "state_bytes": res["state_bytes"],
          "state_bytes_per_lane": res["state_bytes"] / STATE_BATCH}
    rec["model_level"] = ml
    print(f"{label} model level: prefill {STATE_BATCH} x {STATE_PROMPT} {ml['prefill_ms']:.1f} "
          f"ms, {STATE_DECODE} greedy decode steps median {ml['decode_ms_median']:.2f} ms | "
          f"state after the prefill {ml['state_bytes'] / 2 ** 20:.1f} MiB "
          f"({ml['state_bytes_per_lane'] / 2 ** 20:.1f} MiB a lane) | vs the full forward of "
          f"{STATE_PROMPT + STATE_DECODE}: bf16 relative L2 {ml['rel_l2']:.4g} (top-1 agree "
          f"{ml['top1_agree']:.3f}); against the float32 forward: bf16 decode "
          f"{ml['bf16_decode_vs_f32']:.4g}, bf16 full forward {ml['bf16_full_vs_f32']:.4g}; "
          f"float32 decode vs float32 full {ml['f32_rel_l2']:.3g} (tol {STATE_F32_REL_TOL}) | "
          f"{smi}", flush=True)
    check(bool(torch.isfinite(steps).all()) and ml["f32_rel_l2"] <= STATE_F32_REL_TOL,
          f"{label}: float32 prefill + decode == the full forward within {STATE_F32_REL_TOL} "
          f"at full depth (relative L2 {ml['f32_rel_l2']:.4g})")
    check(ml["bf16_decode_vs_f32"] <= max(2 * ml["bf16_full_vs_f32"], STATE_F32_REL_TOL),
          f"{label}: bf16 decode no further from the float32 forward than twice the bf16 full "
          f"forward ({ml['bf16_decode_vs_f32']:.4g} vs {ml['bf16_full_vs_f32']:.4g})")

    cache, pos = res["cache"], STATE_PROMPT + STATE_DECODE
    cur = res["stream"][:, -1:]
    del res, res32, steps, full, full32

    def steps20():
        nonlocal cur
        with torch.inference_mode():
            for i in range(20):
                out = forward(model, cfg, tokens=cur, mode="decode", cache=cache,
                              cache_pos=pos + i)
                cur = out.logits[:, -1:].argmax(-1)
                cur.cpu()

    prof = profile_run(f"{label} profile 20 decode steps", steps20)
    prof["idle_share"] = 1 - prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] else None
    prof["ms_per_step"] = prof["wall_ms"] / 20
    rec["profile_20_decode_steps"] = prof
    print(f"{label}: 20 decode steps {prof['ms_per_step']:.2f} ms a step under the profiler, "
          f"device idle share {prof['idle_share']}", flush=True)
    del cache
    torch.cuda.empty_cache()

    # The recurrent loops at the training shape, one layer each, forward only.
    x = torch.randn(STATE_TRAIN_BATCH, STATE_TRAIN_SEQ, cfg.d_model, device=dev,
                    dtype=torch.bfloat16)
    layers = ({"mamba2": model.mamba[0][0]} if cfg.ssm is not None
              else {"mlstm": model.mlstm[0][0], "slstm": model.slstm[0]})
    rec["layer_profiles"] = {}
    for name, layer in layers.items():
        with torch.inference_mode():
            layer(x, "train")
            torch.cuda.synchronize()
            lp = profile_run(f"{label} one {name} layer forward {tuple(x.shape[:2])}",
                             lambda: (layer(x, "train"), torch.cuda.synchronize()))
        lp["idle_share"] = 1 - lp["device_ms"] / lp["wall_ms"] if lp["device_ms"] else None
        rec["layer_profiles"][name] = {k: lp[k] for k in ("wall_ms", "device_ms", "device_ops",
                                                          "idle_share", "top")}
        print(f"{label} {name} layer: {lp['device_ops']} device operations, run "
              f"{lp['wall_ms']:.1f} ms, idle share {lp['idle_share']}", flush=True)
    del x

    # Training at full width and depth.
    tcfg = dataclasses.replace(cfg, attn_impl="blocked")
    shape = Shape("chip", "train", STATE_TRAIN_SEQ, STATE_TRAIN_BATCH)
    batches = train_batches(cfg, args.seed, STATE_TRAIN_STEPS, STATE_TRAIN_BATCH,
                            STATE_TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(tcfg, shape, model=model,
                 opt_cfg=OptConfig(lr=STATE_TRAIN_LR[label], warmup_steps=2,
                                   decay_steps=STATE_TRAIN_STEPS),
                 tcfg=TrainerConfig(ckpt_every=10 ** 9, log_every=1, seed=args.seed))
    times = run_steps(tr, batches)
    losses = [m["loss"] for _, m in tr.history]
    check(all(np.isfinite(losses)), f"{label} train: every loss finite ({losses})")
    check(losses[-1] < losses[0], f"{label} train: the last loss ({losses[-1]:.4f}) below the "
          f"first ({losses[0]:.4f})")
    tokens = STATE_TRAIN_BATCH * STATE_TRAIN_SEQ
    step_ms = float(np.median(times[1:]))
    rec["train"] = {"batch": STATE_TRAIN_BATCH, "seq": STATE_TRAIN_SEQ, "lr": STATE_TRAIN_LR[label],
                    "remat": tcfg.remat, "moment_dtype": "float32", "losses": losses,
                    "grad_norms": [m["grad_norm"] for _, m in tr.history], "step_ms": times,
                    "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    rt = rec["train"]
    print(f"{label} train ({smi}): {STATE_TRAIN_STEPS} steps of {STATE_TRAIN_BATCH} x "
          f"{STATE_TRAIN_SEQ} os4m-packed tokens, bf16 weights, f32 moments, remat, lr "
          f"{STATE_TRAIN_LR[label]:g} | loss "
          f"{' '.join(f'{v:.4f}' for v in losses)} | step {step_ms:.1f} ms median (steps 2-"
          f"{STATE_TRAIN_STEPS}), {rt['tokens_per_s']:.0f} tokens/s | peak {rt['peak_gb']:.2f} GB",
          flush=True)
    del tr, model
    torch.cuda.empty_cache()

    twin = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               n_layers=2 * cfg.attn_every if cfg.ssm is not None
                               else cfg.slstm_every)
    twin_flash = dict(fa_ops.launches_by_design)
    rec["f32_twin"] = state_twin(label, twin, dev, args.seed)
    twin_flash = {k: fa_ops.launches_by_design[k] - twin_flash[k] for k in twin_flash}
    launches = read_launches(counters)
    rec["launches"] = launches
    rec["launches_by_design"] = dict(fa_ops.launches_by_design)
    if cfg.ssm is not None:
        # One launch a group in every prefill (the warm-up's, bf16's and
        # float32's) and full forward (bf16 and float32), and in the twin's
        # on the card; none in decode or training.
        want = 5 * groups + 2 * (twin.n_layers // twin.attn_every)
        check(rec["launches_by_design"] == {"wgmma": 0, "simt": want}
              and twin_flash["simt"] == 2 * (twin.n_layers // twin.attn_every),
              f"{label}: kernel 9's simt instance once a shared block in every prefill and "
              f"full forward ({want}; {rec['launches_by_design']})")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"{label}: no kernel but kernel 9 on this path ({launches})")
    return rec, launches



def lpt_phase(ii_loads: np.ndarray, dev, smi) -> dict:
    """``lpt_assign_torch`` on the card at three sizes: 160 experts on 16 slots
    (deepseek-v2's expert count; loads are the tokens a Zipf(1.3) router
    sends each expert out of 2^20), the main path's 352 II cluster loads on
    32 slots with slot 0 at speed 0.5 and slot 5 dead, and 4,096 operations
    (Zipf(1.3) loads clipped to 20,000) on 64 slots. Each: the card's
    assignment and slot loads equal to the same call on the CPU, no host
    sync (``set_sync_debug_mode("error")`` around the call), the dead slot
    given no load, the makespan equal within float32 to the host
    ``schedule_lpt``'s; timed with CUDA events beside the host LPT."""
    from repro_torch.core.scheduler import lpt_assign_torch, schedule_lpt
    from repro_torch.data.synthetic import zipf

    rng = np.random.default_rng(LPT_SEED)
    experts = np.bincount(zipf(rng, 1.3, 2 ** 20) % 160, minlength=160).astype(np.float32)
    ops = zipf(rng, 1.3, 4096).clip(1, 20_000).astype(np.float32)
    ii_speeds = np.ones(32, np.float32)
    ii_speeds[0], ii_speeds[LPT_DEAD_SLOT] = 0.5, 0.0
    cases = (("160 experts on 16 slots", experts, 16, None),
             (f"II's {ii_loads.size} clusters on 32 slots (slot 0 at speed 0.5, slot "
              f"{LPT_DEAD_SLOT} dead)", np.asarray(ii_loads, np.float32), 32, ii_speeds),
             ("4096 operations on 64 slots", ops, 64, None))
    out = []
    for label, loads, m, speeds in cases:
        check(float(loads.sum()) < 2 ** 24 * m, f"LPT {label}: slot sums exact in float32")
        want_a, want_l = lpt_assign_torch(loads, m, speeds=speeds, device="cpu")
        loads_d = torch.as_tensor(loads, device=dev)
        speeds_d = None if speeds is None else torch.as_tensor(speeds, device=dev)

        def on_card():
            return lpt_assign_torch(loads_d, m, speeds=speeds_d)

        on_card()                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_a, got_l = on_card()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(got_a.device == loads_d.device, f"LPT {label}: the result stays on the card")
        check(torch.equal(got_a.cpu(), want_a) and torch.equal(got_l.cpu(), want_l),
              f"LPT {label}: the card's assignment and slot loads == the CPU's")
        host = schedule_lpt(loads.astype(np.float64), m, speeds=speeds)
        sp = np.ones(m) if speeds is None else speeds.astype(np.float64)
        alive = sp > 0
        slot_loads = got_l.cpu().numpy().astype(np.float64)
        if speeds is not None:
            dead = np.nonzero(~alive)[0]
            check(not bool(np.isin(got_a.cpu().numpy(), dead).any())
                  and bool((slot_loads[dead] == 0).all()),
                  f"LPT {label}: the dead slot gets no load")
        makespan = float((slot_loads[alive] / sp[alive]).max())
        check(abs(makespan - host.makespan) <= 2.0 ** -23 * host.makespan,
              f"LPT {label}: makespan {makespan} within float32 of the host's {host.makespan}")
        ms = cuda_ms(on_card, reps=5, warmup=1)
        host_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            schedule_lpt(loads.astype(np.float64), m, speeds=speeds)
            host_times.append((time.perf_counter() - t0) * 1e3)
        rec = {"case": label, "n": int(loads.size), "slots": m, "ms": ms,
               "host_ms": float(np.median(host_times)), "makespan": makespan,
               "host_makespan": float(host.makespan),
               "same_assignment_as_host": bool(np.array_equal(got_a.cpu().numpy(),
                                                              host.assignment)),
               "balance_ratio": float(host.balance_ratio)}
        out.append(rec)
        print(f"LPT on the card, {label}: == CPU, no host sync, makespan {makespan:.0f} == host "
              f"schedule_lpt's (same assignment: {rec['same_assignment_as_host']}) | "
              f"lpt_assign_torch {ms:.3f} ms (CUDA events) | host schedule_lpt "
              f"{rec['host_ms']:.3f} ms | {smi}", flush=True)
    return {"cases": out}


def plan_findings(label: str, plan, n: int, whole: bool) -> dict:
    """The port's plan checker on a plan the card's run made: the whole
    snapshot and its JSON round trip (``whole``), else its schedule and wave
    plan. Zero findings, or the run fails."""
    from repro_torch.analysis import plan_checks

    if whole:
        findings = (plan_checks.validate_snapshot(plan, label)
                    + plan_checks.validate_roundtrip(plan, label))
        checks = ["validate_snapshot", "validate_roundtrip"]
    else:
        findings = (plan_checks.validate_wave_plan(plan.waves, n, label)
                    + plan_checks.validate_schedule(plan.schedule, label))
        checks = ["validate_wave_plan", "validate_schedule"]
    check(findings == [], f"plan checks on {label}: "
          + "; ".join(f.render() for f in findings))
    print(f"plan checks on {label}: {', '.join(checks)}: 0 findings", flush=True)
    return {"plan": label, "checks": checks, "findings": len(findings)}


def example_cmd(name: str, report: Path, args=(), cpu: bool = False) -> list:
    return ([sys.executable, "-m", f"repro_torch.examples.{name}", "--report", str(report)]
            + list(args) + (["--device", "cpu"] if cpu else []))


def examples_phase(smi) -> dict:
    """The five examples (``python -m repro_torch.examples.<name>``) as
    subprocesses on the card at the reference's sizes, ``train_lm`` at its
    full ``--steps 300``; meanwhile ``inverted_index``, ``quickstart`` §1-§2c
    and ``moe_balance``'s placement and reuse sections run once more with
    ``--device cpu``, and their plans, balance ratios, network bytes,
    top-cluster loads, counts, reuse flags and reasons must equal the card's
    exactly. Each run must exit 0 within its timeout; each example writes
    the numbers it printed, and its own kernel launches, to a JSON report."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        tmp = Path(tmp)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "TMPDIR": str(tmp)}
        cpu_runs = {name: example_cmd(name, tmp / f"{name}_cpu.json", args, cpu=True)
                    for name, args in EXAMPLES_ON_CPU.items()}
        t_cpu = time.perf_counter()
        # One thread each, so that they take little of the host from the card's runs.
        procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True, env={**env, "OMP_NUM_THREADS": "1"},
                                        cwd=ROOT)
                 for name, cmd in cpu_runs.items()}
        try:
            for name, args in EXAMPLES_ON_CARD.items():
                if name == "train_lm":
                    args = args + ["--ckpt-dir", str(tmp / "train_lm_ckpt")]
                report = tmp / f"{name}_card.json"
                t0 = time.perf_counter()
                proc = subprocess.run(example_cmd(name, report, args), capture_output=True,
                                      text=True, timeout=EXAMPLE_TIMEOUT_S, env=env, cwd=ROOT)
                wall = time.perf_counter() - t0
                check(proc.returncode == 0, f"example {name} on the card exits 0 (rc "
                      f"{proc.returncode}: {proc.stderr[-3000:]})")
                rec = json.loads(report.read_text())
                rec.update(wall_s=wall, stdout=proc.stdout.splitlines())
                out[name] = rec
                print(f"example {name} on the card: rc 0 in {wall:.1f} s | "
                      + " | ".join(proc.stdout.strip().splitlines()[-3:]), flush=True)
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
                check(proc.returncode == 0, f"example {name} --device cpu exits 0 (rc "
                      f"{proc.returncode}: {stderr[-3000:]})")
                rec = json.loads((tmp / f"{name}_cpu.json").read_text())
                rec["stdout"] = stdout.splitlines()
                out[f"{name}_cpu"] = rec
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cpu_wall = time.perf_counter() - t_cpu

    # Host plans over the same numpy inputs: the card's numbers == the CPU's.
    for name, keys in EXAMPLE_HOST_KEYS.items():
        card, cpu = out[name], out[f"{name}_cpu"]
        for key in keys:
            check(card[key] == cpu[key], f"example {name}: {key} on the card == on the CPU")
        print(f"example {name}: {', '.join(keys)} on the card == --device cpu, exactly",
              flush=True)
    ii, qs, sl, mb, tl = (out[k] for k in ("inverted_index", "quickstart", "serve_lm",
                                           "moe_balance", "train_lm"))
    check(ii["runs"]["os4m"]["balance_ratio"] <= ii["runs"]["hash"]["balance_ratio"],
          "inverted_index: os4m's balance ratio <= hash's")
    check(qs["pipelined"]["bit_identical"] and qs["reuse"]["stats"]["replans"] == 2,
          "quickstart: pipelined == sequential, two replans (its own asserts)")
    check(all(np.isfinite(qs["lm"]["losses"])), "quickstart: the tiny LM's losses are finite")
    check(sl["runs"]["os4m"]["balance_ratio"] <= sl["runs"]["hash"]["balance_ratio"],
          "serve_lm: os4m's lane balance ratio <= hash's")
    budgets = {str(i): b for i, b in enumerate(sl["budgets"])}
    check(all(run["generated"] == budgets for run in sl["runs"].values()),
          "serve_lm: every request gets exactly its budget (eos=-1)")
    losses = tl["losses"]
    check(len(losses) == 300 and all(np.isfinite(losses))
          and float(np.mean(losses[-10:])) < float(np.mean(losses[:10])),
          "train_lm: 300 finite losses, the last ten's mean below the first ten's")
    check(len(mb["trainer"]["replans"]) == 3
          and all(r["balance_ratio"] <= r["baseline_ratio"] for r in mb["trainer"]["replans"]),
          "moe_balance: balance <= its baseline at each re-plan")
    check(all(out[k]["launches"]["histogram"] > 0 and out[k]["launches"]["fused_shuffle_reduce"] > 0
              for k in ("inverted_index", "quickstart", "moe_balance")),
          "the MapReduce examples launched kernels 1 and 2 on the card")
    check(all(all(v == 0 for v in out[f"{k}_cpu"]["launches"].values()) for k in EXAMPLES_ON_CPU),
          "the --device cpu runs launched no kernel")
    launches = {k: {kern: out[k]["launches"][kern]
                    for kern in ("histogram", "fused_shuffle_reduce")} for k in EXAMPLES_ON_CARD}
    summary = {
        "wall_s": {k: out[k]["wall_s"] for k in EXAMPLES_ON_CARD}, "cpu_wall_s": cpu_wall,
        "train_lm_tokens_per_s": tl["tokens_per_s"], "train_lm_peak_gb": tl["peak_gb"],
        "train_lm_loss": [losses[0], losses[-1]],
        "serve_lm_tokens_per_s": {s: r["tokens_per_s"] for s, r in sl["runs"].items()},
        "launches": launches}
    print(f"examples on the card: wall s {summary['wall_s']} (the --device cpu runs beside "
          f"them: {cpu_wall:.1f} s) | train_lm: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{tl['tokens_per_s']:.0f} tokens/s (checkpoints included), peak "
          f"{tl['peak_gb']:.2f} GB | serve_lm tokens/s: "
          + ", ".join(f"{s} {v:.1f}" for s, v in summary["serve_lm_tokens_per_s"].items())
          + f" | {smi}", flush=True)
    print(f"examples' own launches of kernels 1 and 2 (subprocesses): {json.dumps(launches)}",
          flush=True)
    out["summary"] = summary
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the first batch (batches use seed, seed+1, "
                             "seed+2), of the serve path's weights and of its requests")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import clustering, scheduler as sched_lib
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.core.multi_job import MultiJobCoordinator
    from repro_torch.core.schedule_cache import ReusePolicy
    from repro_torch.core.stats_provider import CountMinParams
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded_shuffle import ops as cs_ops
    from repro_torch.kernels.coded_shuffle.ref import encode_packets_ref, xor_words_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
    from repro_torch.kernels.fused_shuffle_reduce.ref import (
        fused_gather_segment_reduce_ref,
    )
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_dispatch.ref import dispatch_ranks_ref
    from repro_torch.kernels.segment_reduce import ops as seg_ops
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_sorted_ref
    from repro_torch.kernels.sketch_hist import ops as sk_ops
    from repro_torch.kernels.sketch_hist.ref import sketch_cells, sketch_hist_ref
    from repro_torch.kernels.wave_timer import ops as wt_ops
    from repro_torch.kernels.wave_timer import ref as wt_ref
    from repro_torch.kernels.wave_timer.wave_timer import copy_split, launch_floor_cuda

    counters = {"histogram": (hist_ops, "launches"), "sketch_hist": (sk_ops, "launches"),
                "fused_shuffle_reduce": (fused_ops, "launches"),
                "segment_reduce": (seg_ops, "launches"), "xor_words": (cs_ops, "launches"),
                "read_ticks": (wt_ops, "read_ticks_launches"),
                "stamp_through": (wt_ops, "stamp_through_launches"),
                "flash_attention": (fa_ops, "launches"), "dispatch_ranks": (md_ops, "launches")}
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    connections = os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS")
    print(f"device: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"CUDA_DEVICE_MAX_CONNECTIONS={connections}", flush=True)
    record = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "cuda_device_max_connections": connections}

    # ---- Build every kernel (parallel nvcc).
    check({SOURCE_OF.get(k, k) for k in counters} == set(_build.SOURCES),
          "every kernel source is driven here")
    t0 = time.perf_counter()
    libs = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.1f} s -> {sorted(str(p) for p in libs.values())}",
          flush=True)
    record["ptxas"] = ptxas_phase(_build)

    n = clustering.recommended_num_clusters(M)
    work = Workload(n, dev)
    t0 = time.perf_counter()
    batch0, kidx0, oracle0, extra0 = work.batch(args.seed, extra_n=(SKETCH_N,))
    oracle0_wide = extra0[SKETCH_N]
    batches = [(batch0, oracle0)]
    for b in (1, 2):
        batch, _, oracle = work.batch(args.seed + b)
        batches.append((batch, oracle))
    record["data_s"] = time.perf_counter() - t0
    print(f"data: batches {args.seed}..{args.seed + 2} in {record['data_s']:.1f} s "
          f"(m={M}, K={K}, V={V}, n={n}; oracle of batch {args.seed} also at "
          f"n={SKETCH_N})", flush=True)
    for name, oracle in (("values", oracle0[0]), ("counts", oracle0[1])):
        check(float(oracle.max()) < 2 ** 24, f"oracle {name} below 2^24 (exact in f32)")
    hot = float(oracle0[1].max() / oracle0[1].sum())
    print(f"data: hottest cluster holds {hot:.4f} of the valid pairs", flush=True)

    # ---- Kernel phase 1: histogram, both instances, at n and at 2^17 bins
    # (a cluster of CTAs splits the bins).
    keys0, _, valid0 = batch0
    ids = torch.as_tensor(work.cluster_np, device=dev)[
        torch.as_tensor(kidx0, device=dev).long()].to(torch.int32)
    hist_main = histogram_phase(hist_ops, histogram_ref, ids, valid0, n, dev)
    wide_ids = torch.remainder(keys0, WIDE_BINS).to(torch.int32)
    wide_ids[:, ::1000] = -1                          # out-of-range ids dropped
    hist_wide = histogram_phase(hist_ops, histogram_ref, wide_ids, valid0, WIDE_BINS, dev)
    del wide_ids
    for h in (hist_main, hist_wide):
        print(f"kernel histogram ({M}, {K}) -> {h['bins']} bins: mask instance bitwise ok, "
              f"float instance bitwise on 0/1 weights, rel err {h['float_max_rel_err']:.2e} "
              f"on random ones | mask {h['ms']:.4f} ms (events {h['event_ms']:.4f}), bound "
              f"{h['bound_ms']:.4f} | float {h['float_ms']:.4f} ms (events "
              f"{h['float_event_ms']:.4f}), bound {h['float_bound_ms']:.4f} | plain "
              f"{h['plain_ms']:.4f} ms | bincount {h['library_ms']:.4f} ms, weighted "
              f"{h['float_library_ms']:.4f} ms", flush=True)

    # ---- Kernel phase 3: count-min sketch, both instances, with the engine's
    # multipliers on batch 0's cluster ids at n = 2^17 (what the sketch path
    # launches it on) and at n, and on the raw key hashes (spread over int32)
    # with multipliers >= 2^31.
    engine_mult = CountMinParams(SKETCH_WIDTH, SKETCH_DEPTH, seed=0).multipliers
    sketch_main = sketch_phase(sk_ops, sketch_hist_ref, sketch_cells, ids, valid0, engine_mult)
    del ids
    ids = torch.as_tensor(work.clusters_of_keys(SKETCH_N), device=dev)[
        torch.as_tensor(kidx0, device=dev).long()].to(torch.int32)
    sketch_path = sketch_phase(sk_ops, sketch_hist_ref, sketch_cells, ids, valid0, engine_mult)
    del ids
    sketch_high = sketch_phase(sk_ops, sketch_hist_ref, sketch_cells, keys0, valid0,
                               HIGH_MULTIPLIERS)
    torch.cuda.empty_cache()
    for label, sk in ((f"cluster ids at n={SKETCH_N}", sketch_path),
                      (f"cluster ids at n={n}", sketch_main),
                      ("key hashes, multipliers >= 2^31", sketch_high)):
        print(f"kernel sketch_hist ({M}, {K}) -> {SKETCH_DEPTH} x {SKETCH_WIDTH}, "
              f"{label}: mask bitwise ok, float rel err {sk['float_max_rel_err']:.2e} | mask "
              f"{sk['ms']:.4f} ms (events {sk['event_ms']:.4f}), bound {sk['bound_ms']:.4f} | "
              f"float {sk['float_ms']:.4f} ms (events {sk['float_event_ms']:.4f}), bound "
              f"{sk['float_bound_ms']:.4f} | plain {sk['plain_ms']:.4f} ms | bincount (no "
              f"hashing) {sk['library_ms']:.4f} ms, weighted {sk['float_library_ms']:.4f} ms",
              flush=True)
    hot_bin_phase(hist_ops, histogram_ref, sk_ops, sketch_hist_ref, engine_mult, dev)

    # ---- Kernel phases 2 and 4: the fused reduce at the chunk shapes of a
    # real plan (a probe run of batch 0 that checks and times every launch),
    # and the sorted segment-sum at chunk 0's shape on its rank-sorted rows.
    segment = {}
    fused_kernel = fused_ops.fused_shuffle_reduce

    def on_chunk0(values, gather_idx, seg_ids, num_segments):
        segment.update(segment_phase(seg_ops, segment_reduce_sorted_ref, fused_kernel, values,
                                     gather_idx, seg_ids, num_segments))

    probe = FusedProbe(fused_ops.fused_shuffle_reduce, fused_gather_segment_reduce_ref,
                       on_first=on_chunk0)
    fused_ops.fused_shuffle_reduce = probe
    try:
        MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n)).run(batch0)
    finally:
        fused_ops.fused_shuffle_reduce = probe.real
    check(len(probe.chunks) > 0 and bool(segment), "probe run reached the fused kernel")
    for c in probe.chunks:
        shifted = ", padded/shifted stream: same bits" if c["pad_shift_invariant"] else ""
        print(f"kernel fused_shuffle_reduce {tuple(c['shape'])} -> {c['segments']} "
              f"segments, {c['valid_rows']} valid rows: sums and counts bitwise ok, normals "
              f"rel err {c['float_rel_err']:.2e}{shifted} | kernel {c['ms']:.4f} ms | plain "
              f"{c['plain_ms']:.4f} ms | index_add_ + bincount {c['library_ms']:.4f} ms | "
              f"bound {c['bound_ms']:.4f} ms", flush=True)
    print(f"kernel segment_reduce {tuple(segment['shape'])} -> {segment['segments']} "
          f"segments, {segment['valid_rows']} valid rows (chunk 0, rank order): bitwise "
          f"ok, normals rel err {segment['float_rel_err']:.2e}, == fused kernel bit for bit, "
          f"padded/shifted stream: same bits | kernel {segment['ms']:.4f} ms | plain "
          f"{segment['plain_ms']:.4f} ms | index_add_ {segment['index_add_ms']:.4f} ms, "
          f"torch.segment_reduce {segment['segment_reduce_ms']:.4f} ms | bound "
          f"{segment['bound_ms']:.4f} ms", flush=True)
    record.update(histogram=[hist_main, hist_wide],
                  sketch=[sketch_path, sketch_main, sketch_high],
                  fused_chunks=probe.chunks, segment_reduce=segment)
    del probe
    torch.cuda.empty_cache()

    # ---- The main path: exact statistics on three batches.
    job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n))
    check(job.device.type == "cuda", "the job runs on the card by default")
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    pipelined0 = None
    for b, (batch, oracle) in enumerate(batches):
        seed = args.seed + b
        h0 = hist_ops.launches
        f0 = fused_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        chunks = job.last_plan.waves.num_chunks
        check(hist_ops.launches - h0 == 1, "phase A launched the histogram once")
        check(fused_ops.launches - f0 == chunks,
              "phase B launched the fused kernel once per chunk")
        check_oracle(res, oracle, f"main path batch {seed}")
        hash_ratio = sched_lib.schedule_hash(
            res.key_distribution, M, keys=np.arange(n)).balance_ratio
        run = {"seed": seed, "wall_ms": wall_ms, "chunks": chunks,
               "chunk_caps": list(job.last_plan.chunk_caps),
               **job.last_phase_ms, "balance_os4m": float(res.schedule.balance_ratio),
               "balance_hash": float(hash_ratio), "shuffle_bytes": res.shuffle_bytes}
        runs.append(run)
        print(f"main path batch {seed}: oracle ok, overflow 0 | phase A "
              f"{run['phase_a']:.1f} ms | plan {run['plan']:.1f} ms | phase B "
              f"{run['phase_b']:.1f} ms | run {wall_ms:.1f} ms | balance os4m "
              f"{run['balance_os4m']:.4f} vs hash {run['balance_hash']:.4f}", flush=True)
        if b == 0:
            pipelined0 = (res.values, res.counts)
            main_plan0 = job.last_plan
        del res
    launches = {"main": read_launches(counters)}
    by_instance = {"main": dict(hist_ops.launches_by_instance)}
    check(by_instance["main"] == {"mask": launches["main"]["histogram"], "float": 0},
          "the main path's phase A took the histogram's mask instance (no float cast)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path launches: {launches['main']} | peak device memory {peak_gb:.1f} GB",
          flush=True)
    ii_loads = np.asarray(main_plan0.local_hist, np.float64).sum(axis=0)   # the LPT phase's

    # ---- Sequential phase B on batch 0: bit-identical to the pipelined run.
    seq = MapReduceJob(lambda b: b, MapReduceConfig(
        num_slots=M, num_clusters=n, pipelined=False)).run(batch0)
    check(np.array_equal(seq.values, pipelined0[0])
          and np.array_equal(seq.counts, pipelined0[1]),
          "pipelined == sequential, bit for bit")
    print("sequential phase B on batch 0: bit-identical to pipelined", flush=True)
    del seq
    record.update(runs=runs, peak_gb=peak_gb)

    # ---- The reuse path: the same three batches under ReusePolicy().
    policy = ReusePolicy()
    job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n,
                                                    reuse=policy))
    spy = PlanSpy(job)
    reset_launches(counters)
    reuse_runs = []
    for b, (batch, oracle) in enumerate(batches):
        seed = args.seed + b
        calls0 = spy.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        planned = spy.calls - calls0
        if b == 0:
            check(res.plan_reason == "cold" and not res.reused, "reuse path: batch 0 plans")
        else:
            check(res.reused or res.plan_reason == "overflow",
                  f"reuse path: batch {seed} replays the plan (or replans for overflow)")
        check((planned == 0) == res.reused, "reuse path: the planner ran only on replans")
        check_oracle(res, oracle, f"reuse path batch {seed}")
        run = {"seed": seed, "wall_ms": wall_ms, "reused": res.reused,
               "plan_reason": res.plan_reason, "drift": res.drift, "planner_calls": planned,
               **job.last_phase_ms}
        reuse_runs.append(run)
        drift = "-" if res.drift is None else f"{res.drift:.5f}"
        print(f"reuse path batch {seed}: {res.plan_reason}, reused={res.reused}, drift "
              f"{drift}, planner calls {planned}, oracle ok | phase A "
              f"{run['phase_a']:.1f} ms | plan {run['plan']:.1f} ms | phase B "
              f"{run['phase_b']:.1f} ms | run {wall_ms:.1f} ms", flush=True)
        del res
    launches["reuse"] = read_launches(counters)
    cache_stats = job.schedule_cache.stats()
    print(f"reuse path launches: {launches['reuse']} | cache {cache_stats}", flush=True)
    reuse_plan_checks = plan_findings("the reuse path's snapshot", job.schedule_cache.snapshot,
                                      n, whole=True)

    # A snapshot of the live plan, through JSON, into a fresh job: batch 0
    # replays it with no planner call.
    snapshot = json.loads(json.dumps(job.schedule_cache.snapshot.to_json()))
    warm = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n,
                                                     reuse=policy))
    warm.load_snapshot(snapshot)
    warm_spy = PlanSpy(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = warm.run(batch0)
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(res.reused and warm_spy.calls == 0, "a loaded snapshot replays batch 0")
    check_oracle(res, oracle0, "snapshot replay of batch 0")
    check(np.array_equal(res.values, pipelined0[0]), "snapshot replay == main path, bitwise")
    phases = warm.last_phase_ms
    print(f"snapshot replay of batch {args.seed}: reused, drift {res.drift:.5f}, oracle ok "
          f"| phase A {phases['phase_a']:.1f} ms | plan {phases['plan']:.1f} ms | phase B "
          f"{phases['phase_b']:.1f} ms | run {warm_ms:.1f} ms", flush=True)
    record["reuse"] = {"runs": reuse_runs, "cache": cache_stats,
                       "snapshot_replay": {"wall_ms": warm_ms, "drift": res.drift,
                                           **phases},
                       "plan_checks": reuse_plan_checks}
    del res, job, warm
    torch.cuda.empty_cache()

    # ---- The measured path: the sharded backend on the same three batches,
    # untimed and with measured wave clocks.
    record["measured_path"], launches["measured"] = measured_path(
        batches, runs, main_plan0, pipelined0, counters, n, MapReduceConfig, MapReduceJob,
        ReusePolicy, wt_ops, dev)

    # ---- The elastic path (checkpointed walk, a mid-batch kill, warm
    # resizes, both backends) and the multi-job path (II and SelfJoin on
    # one mesh), on the main path's batches.
    record["elastic_path"], launches["elastic"] = elastic_path(
        batches, runs, main_plan0, record["peak_gb"], pipelined0, counters, n, smi, MapReduceConfig,
        MapReduceJob, ReusePolicy, dev)
    record["multi_job_path"], launches["multi_job"] = multi_job_path(
        batches, counters, n, smi, args.seed, MapReduceConfig, MapReduceJob, ReusePolicy,
        MultiJobCoordinator, dev)
    del batches, batch, oracle
    torch.cuda.empty_cache()

    # ---- The sketch path: count-min statistics at n = 2^17 on batch 0,
    # without and with streaming-prefix planning (that one three times, with
    # the allocator's retries), then the prefix path on a batch whose tail
    # overflows the committed wave 1, which takes the escape hatch.
    def sketch_run(batch, prefix, path, oracle, fallbacks, what):
        job = MapReduceJob(lambda b: b, MapReduceConfig(
            num_slots=M, num_clusters=SKETCH_N, stats="sketch", sketch_width=SKETCH_WIDTH,
            sketch_depth=SKETCH_DEPTH, stream_prefix=prefix))
        spy = PlanSpy(job)
        executed = []                                 # chunk caps of each phase B
        execute = job._execute

        def spy_execute(intermediate, planned, caps=None):
            executed.append(list(caps[1] if caps else planned.chunk_caps))
            return execute(intermediate, planned, caps)

        job._execute = spy_execute
        reset_launches(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        res = job.run(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = read_launches(counters)
        if path is not None:
            launches[path] = got
        chunks = job.last_plan.waves.num_chunks
        check(got["sketch_hist"] == (1 if prefix is None else 2),
              f"{what}: phase A launched the sketch kernel {1 if prefix is None else 2}x")
        check(sk_ops.launches_by_instance == {"mask": got["sketch_hist"], "float": 0},
              f"{what}: phase A took the sketch's mask instance (no float cast)")
        if path is not None:
            by_instance[path] = dict(sk_ops.launches_by_instance)
        check(got["histogram"] == 0, f"{what}: no exact histogram")
        check(job.capacity_fallbacks == fallbacks, f"{what}: {fallbacks} capacity fallbacks")
        check(got["fused_shuffle_reduce"] == chunks * (1 + fallbacks),
              f"{what}: phase B ran {1 + fallbacks}x")
        check_oracle(res, oracle, what)
        run = {"stream_prefix": prefix, "wall_ms": wall_ms,
               "chunk_caps": list(job.last_plan.chunk_caps),
               "caps_estimated": job.last_plan.caps_estimated,
               "capacity_fallbacks": job.capacity_fallbacks,
               "executed_caps": executed,
               "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **job.last_phase_ms}
        hatch = f", executed caps {executed}" if fallbacks else ""
        print(f"{what}, n={SKETCH_N}: oracle ok, overflow 0, launches {got}, capacity "
              f"fallbacks {job.capacity_fallbacks}, caps {run['chunk_caps']}{hatch} | phase A "
              f"{run['phase_a']:.1f} ms | plan {run['plan']:.1f} ms | phase B "
              f"{run['phase_b']:.1f} ms | run {wall_ms:.1f} ms | peak "
              f"{run['peak_gb']:.1f} GB, allocator retries {run['alloc_retries']}", flush=True)
        plan1 = spy.plans[0]
        del res, job, spy
        torch.cuda.empty_cache()
        return run, plan1

    sketch_runs = [sketch_run(batch0, None, "sketch", oracle0_wide, 0, "sketch path")[0]]
    for r in range(3):
        run, _ = sketch_run(batch0, 0.25, "sketch_prefix" if r == 0 else None,
                            oracle0_wide, 0,
                            f"sketch path with stream_prefix=0.25 (run {r + 1} of 3)")
        sketch_runs.append(run)
    # The escape hatch runs on the first half of batch 0's streams (K/2
    # pairs a slot): a burst as large as wave 1's cap also enters the
    # distinct-bin bounds of the later waves, and the first phase B at those
    # caps would not fit beside a full batch.
    half = K // 2
    base = tuple(t[:, :half].contiguous() for t in batch0)
    kidx_half = np.ascontiguousarray(kidx0[:, :half])
    valid_half = base[2].cpu().numpy()
    base_oracle = oracle_of(work.clusters_of_keys(SKETCH_N)[kidx_half[valid_half]],
                            base[1].cpu().numpy()[valid_half], SKETCH_N)
    del valid_half
    run, plan1 = sketch_run(base, 0.25, None, base_oracle, 0,
                            f"sketch path with stream_prefix=0.25 at K/2={half}")
    sketch_runs.append(run)
    burst, burst_oracle, info = tail_burst(work, base, kidx_half, base_oracle, plan1,
                                           SKETCH_N, 0.25)
    print(f"tail burst: key of Zipf rank {info['key_rank']} (cluster {info['cluster']}, "
          f"wave 1, slot {info['dest']}) takes {info['rewritten_pairs']} tail pairs; the "
          f"committed wave-1 cap is {info['wave1_cap']}", flush=True)
    hatch_run, _ = sketch_run(burst, 0.25, "sketch_hatch", burst_oracle, 1,
                              f"sketch path with stream_prefix=0.25 at K/2={half} on the "
                              f"tail burst")
    reference_rows = M * M * half * len(hatch_run["chunk_caps"])
    hatch_run.update(burst=info, reference_spill_rows=reference_rows,
                     spill_rows=M * M * sum(hatch_run["executed_caps"][1]))
    print(f"escape hatch: spill of {hatch_run['spill_rows']} rows in the batch's caps, "
          f"against {reference_rows} rows in the escalated plan's caps", flush=True)
    del burst, base
    torch.cuda.empty_cache()
    pull = {"sketch_bytes": M * SKETCH_DEPTH * SKETCH_WIDTH * 4, "exact_bytes": M * SKETCH_N * 4}
    print(f"statistics pull at n={SKETCH_N}: sketch ({M}, {SKETCH_DEPTH * SKETCH_WIDTH}) f32 = "
          f"{pull['sketch_bytes'] / 1e6:.2f} MB vs exact ({M}, {SKETCH_N}) f32 = "
          f"{pull['exact_bytes'] / 1e6:.2f} MB", flush=True)
    record["sketch_path"] = {"runs": sketch_runs, "hatch": hatch_run, "pull": pull}

    # ---- The coded path (m = 8, K = 2^20 of batch 0), then kernel phase 7:
    # the XOR kernel's two instances at the coded path's chunk-0 shape.
    coded_n = clustering.recommended_num_clusters(CODED_M)
    record["coded_path"], launches["coded"] = coded_path(
        work, batch0, kidx0, counters, MapReduceConfig, MapReduceJob, coded_n)
    n_rep = -(-CODED_K // (CODED_M - 1))
    cap2 = min(n_rep, record["coded_path"]["runs"]["coded"]["chunk_caps"][0])
    xor = xor_phase(cs_ops, encode_packets_ref, xor_words_ref, CODED_M, cap2, V + 2, dev)
    fx = xor["flat"]
    print(f"kernel xor_words encode {tuple(xor['shape'])} (chunk 0; {xor['packet_share']:.4f} "
          f"of the words in packets): bitwise ok | kernel {xor['ms']:.4f} ms | plain "
          f"{xor['plain_ms']:.4f} ms | the three passes it replaced (swap copy, flat XOR, "
          f"masked_fill_) {xor['three_pass_ms']:.4f} ms | bitwise_xor on the strided swap + "
          f"masked_fill_ {xor['library_ms']:.4f} ms | bound {xor['bound_ms']:.4f} ms",
          flush=True)
    print(f"kernel xor_words flat {tuple(fx['shape'])}: bitwise ok | kernel {fx['ms']:.4f} ms | "
          f"bitwise_xor {fx['library_ms']:.4f} ms (kernel / bitwise_xor "
          f"{fx['ms'] / fx['library_ms']:.3f}) | plain {fx['plain_ms']:.4f} ms | bound "
          f"{fx['bound_ms']:.4f} ms ({fx['bound_ms'] / fx['ms']:.3f} of it)", flush=True)
    record["xor_words"] = xor
    torch.cuda.empty_cache()
    record["launches"] = launches

    # ---- Kernel phases 5 and 6: the wave timer at the measured path's
    # shapes (one slot's received ids of chunk 0).
    ids_shape = (1, M * int(main_plan0.chunk_caps[0]))
    timer = wave_timer_phase(wt_ops, wt_ref, copy_split, launch_floor_cuda, ids_shape, dev)
    st, rt, tm = timer["stamp_through"], timer["read_ticks"], timer["timer"]
    print(f"kernel stamp_through {ids_shape} int32 (chunk 0's received ids of one slot): "
          f"bitwise ok (ring: head, body {st['head_body']}; byte path ok) | device: kernel "
          f"{st['ms']:.4f} ms, plain (clone + host stamp) {st['plain_ms']:.4f} ms, "
          f"Tensor.copy_ {st['library_ms']:.4f} ms (kernel / copy_ "
          f"{st['ms'] / st['library_ms']:.3f}), bound {st['bound_ms']:.4f} ms "
          f"({st['bound_ms'] / st['ms']:.3f} of it) | host to issue: kernel "
          f"{st['host_ms']:.4f} ms, plain {st['plain_host_ms']:.4f} ms | one call between "
          f"events: kernel {st['event_ms']:.4f} ms, copy_ {st['library_event_ms']:.4f} ms",
          flush=True)
    print(f"kernel read_ticks: device {rt['ms'] * 1e3:.3f} us a launch, host to issue "
          f"{rt['host_ms'] * 1e3:.3f} us | an empty kernel (the launch floor, its bound) "
          f"{rt['bound_ms'] * 1e3:.3f} us a launch ({rt['bound_ms'] / rt['ms']:.3f} of "
          f"read_ticks' time) | plain (host perf_counter_ns) "
          f"{rt['plain_ms'] * 1e3:.3f} us | stamp vs CUDA event intervals: "
          + ", ".join(f"{e['stamp_ms']:.4f} / {e['event_ms']:.4f} ms" for e in tm["intervals"]),
          flush=True)
    print(f"%globaltimer: {tm['seconds_per_tick']:.6e} s/tick (calibrated); back-to-back stamps: "
          f"smallest non-zero step {tm['min_step_ns']:.1f} ns, gcd of steps "
          f"{tm['step_gcd_ticks']} ticks, median step {tm['median_step_ns']:.1f} ns, "
          f"{tm['zero_steps']} of {tm['steps']} steps zero", flush=True)
    record["wave_timer"] = timer
    print(f"CUDA_DEVICE_MAX_CONNECTIONS={os.environ.get('CUDA_DEVICE_MAX_CONNECTIONS')}",
          flush=True)

    # ---- Where the time goes: batch 0 on the main path once more, and the
    # coded path's coded run, under the profiler.
    prof_job = MapReduceJob(lambda b: b, MapReduceConfig(num_slots=M, num_clusters=n))
    record["profile"] = profile_run(f"profile batch {args.seed}", lambda: prof_job.run(batch0),
                                    prof_job)
    coded_batch = tuple(t[:CODED_M, :CODED_K].contiguous() for t in batch0)
    coded_job = MapReduceJob(lambda b: b, MapReduceConfig(
        num_slots=CODED_M, num_clusters=coded_n, shuffle_replication=2))
    record["coded_path"]["profile"] = profile_run(
        "profile coded run", lambda: coded_job.run(coded_batch), coded_job)
    del coded_batch, coded_job

    # ---- Free the card for the serve path (the paths above peaked near 58 GB).
    del batch0, keys0, valid0, prof_job, work
    torch.cuda.empty_cache()
    print(f"card freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated",
          flush=True)

    # ---- Kernel phase 9: flash attention at the serve path's prefill shape
    # (its longest prompt) and four more; kernel phase 8: dispatch ranks.
    n_patches = get_config("qwen2-vl-7b").n_patches
    admit = {"serve": admission_lens("llama3-8b", args.seed, SERVE_REQUESTS),
             "moe": admission_lens("grok-1-314b", args.seed, MOE_REQUESTS),
             "vlm": tuple(n_patches + p for p in admission_lens("qwen2-vl-7b", args.seed,
                                                                SERVE_REQUESTS)),
             "mla": admission_lens("deepseek-v2-236b", args.seed, MLA_REQUESTS),
             "whisper": admission_lens("whisper-base", args.seed, WHISPER_REQUESTS,
                                       WHISPER_PROMPTS)}
    flash = flash_phase(fa_ops, flash_attention_ref, flash_attention_cuda, admit, dev)
    print(f"kernel flash_attention {tuple(flash['shape'])} bf16 causal (the serve path's "
          f"longest prefill, {flash['design']} instance): err {flash['max_abs_err']:.3g} "
          "(others: " + ", ".join(f"{k} [{c['design']}] {c['max_abs_err']:.3g}"
                                  for k, c in flash["cases"].items() if k != "serve")
          + f") | device (burst): kernel {flash['ms']:.4f} ms ({flash['tflops']:.1f} TFLOP/s), "
          f"scaled_dot_product_attention {flash['library_ms']:.4f} ms | one call between "
          f"events: kernel {flash['event_ms']:.4f} ms, sdpa {flash['library_event_ms']:.4f} ms "
          f"| plain {flash['plain_ms']:.4f} ms | simt instance on the same bf16 inputs "
          f"{flash['simt_ms']:.4f} ms | bound {flash['bound_ms']:.4f} ms ({flash['bound_by']})",
          flush=True)
    for name, c in flash["family"].items():
        print(f"kernel flash_attention {name} {tuple(c['shape'])} bf16 causal={c['causal']} "
              f"({c['design']} instance): err {c['max_abs_err']:.3g} | device (burst): kernel "
              f"{c['ms']:.4f} ms ({c['tflops']:.1f} TFLOP/s), scaled_dot_product_attention "
              f"{c['library_ms']:.4f} ms | plain {c['plain_ms']:.4f} ms | bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    record["flash_attention"] = flash
    # At the path's E = 64, and at the largest MoE configuration's 160
    # experts and the wrapper's limit of 1,024 destinations.
    disp_cases = {e: dispatch_phase(md_ops, dispatch_ranks_ref, dev, e=e)
                  for e in (DISPATCH_E, 160, 1024)}
    for d in disp_cases.values():
        print(f"kernel dispatch_ranks T={d['tokens']} E={d['dests']} (Zipf 1.3, 2% "
              f"padding; hottest destination {d['hot_share']:.3f} of the tokens): exact | "
              f"device {d['ms']:.4f} ms a call (host to issue {d['host_ms']:.4f} ms) | "
              f"plain {d['plain_ms']:.4f} ms | bound {d['bound_ms']:.4f} ms", flush=True)
    disp = disp_cases[DISPATCH_E]
    record["dispatch_ranks"] = list(disp_cases.values())
    torch.cuda.empty_cache()

    # ---- The serve path: Llama-3-8B at full width and depth on 8 lanes.
    record["serve_path"], launches["serve"] = serve_path(counters, fa_ops, args, dev)
    record["launcher"] = launcher_run()
    # ---- The MoE path: grok-1-314b at full width, 4 layers, 4 expert slots.
    record["moe_path"], launches["moe"] = moe_path(counters, fa_ops, args, dev, smi)
    # ---- The attention families, each after the card is freed: whisper-base,
    # qwen2-vl-7b and deepseek-v2-236b's MLA.
    print(f"card freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated",
          flush=True)
    record["whisper_path"], launches["whisper"] = whisper_path(counters, fa_ops, args, dev, smi)
    record["vlm_path"], launches["vlm"] = vlm_path(counters, fa_ops, args, dev, smi)
    record["mla_path"], launches["mla"] = mla_path(counters, fa_ops, args, dev, smi)
    # ---- The training path: smollm-360m and deepseek-v2-236b at full width.
    record["train_path"], launches["train"] = train_path(counters, args, dev, smi)
    # ---- The state-based families at full width and depth: zamba2-2.7b
    # (kernel 9 in its shared block) and xlstm-1.3b (no kernel).
    record["zamba_path"], launches["zamba"] = state_path("zamba2-2.7b", counters, fa_ops, args,
                                                         dev, smi)
    record["xlstm_path"], launches["xlstm"] = state_path("xlstm-1.3b", counters, fa_ops, args,
                                                         dev, smi)
    # ---- Item 13's user-facing half, the card freed first: the on-device LPT,
    # then the five examples as subprocesses (their kernel launches are
    # their own: printed above the kernels line, not in it).
    torch.cuda.empty_cache()
    print(f"card freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated",
          flush=True)
    record["lpt"] = lpt_phase(ii_loads, dev, smi)
    record["examples"] = examples_phase(smi)

    # ---- Result lines. A kernel's launches are its counts over the paths
    # (each path read with the counts set to 0 just before it).
    def total_launches(name):
        return sum(path[name] for path in launches.values())

    chunks = record["fused_chunks"]
    fused_bound = bound_ms(sum(c["bytes"] for c in chunks), sum(c["ops"] for c in chunks))
    kernels = [
        # Both counting kernels: the numbers at the path's shape are the mask
        # instance's (the engine's), device time a call from a burst behind a
        # spin (event_ms: CUDA events around one call); the float instance's
        # are the float_* keys, on random weights; the library call is
        # bincount (weighted for the float instance). launches_by_instance
        # counts the main and sketch paths' launches.
        {"name": "histogram", "route": "cuda",
         "source": "src/repro_torch/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:58",
         "launches": total_launches("histogram"),
         "launches_by_instance": by_instance["main"],
         "max_abs_err": max(h["max_abs_err"] for h in (hist_main, hist_wide)),
         "ms": hist_main["ms"], "event_ms": hist_main["event_ms"],
         "plain_ms": hist_main["plain_ms"], "bound_ms": hist_main["bound_ms"],
         "bound_by": hist_main["bound_by"], "library_ms": hist_main["library_ms"],
         "float_ms": hist_main["float_ms"], "float_event_ms": hist_main["float_event_ms"],
         "float_bound_ms": hist_main["float_bound_ms"],
         "float_library_ms": hist_main["float_library_ms"],
         "float_max_rel_err": max(h["float_max_rel_err"] for h in (hist_main, hist_wide)),
         "wide_ms": hist_wide["ms"], "wide_float_ms": hist_wide["float_ms"],
         "wide_bound_ms": hist_wide["bound_ms"]},
        {"name": "sketch_hist", "route": "cuda",
         "source": "src/repro_torch/csrc/sketch_hist.cu",
         "replaces": "src/repro/kernels/sketch_hist/sketch_hist.py:69",
         "launches": total_launches("sketch_hist"),
         "launches_by_instance": {k: by_instance["sketch"][k] + by_instance["sketch_prefix"][k]
                                  for k in ("mask", "float")},
         "max_abs_err": max(sk["max_abs_err"]
                            for sk in (sketch_path, sketch_main, sketch_high)),
         "ms": sketch_path["ms"], "event_ms": sketch_path["event_ms"],
         "plain_ms": sketch_path["plain_ms"], "bound_ms": sketch_path["bound_ms"],
         "bound_by": sketch_path["bound_by"], "library_ms": sketch_path["library_ms"],
         "float_ms": sketch_path["float_ms"], "float_event_ms": sketch_path["float_event_ms"],
         "float_bound_ms": sketch_path["float_bound_ms"],
         "float_library_ms": sketch_path["float_library_ms"],
         "float_max_rel_err": max(sk["float_max_rel_err"]
                                  for sk in (sketch_path, sketch_main, sketch_high))},
        # One main-path run calls the fused kernel once per chunk (each call
        # two launches: segment starts, tiles): its times are the sums over
        # those calls. The library call is index_add_ for the sums plus
        # bincount for the counts.
        {"name": "fused_shuffle_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_shuffle_reduce.cu",
         "replaces": "src/repro/kernels/fused_shuffle_reduce/fused_shuffle_reduce.py:75",
         "launches": total_launches("fused_shuffle_reduce"),
         "max_abs_err": max(c["max_abs_err"] for c in chunks),
         "ms": sum(c["ms"] for c in chunks),
         "plain_ms": sum(c["plain_ms"] for c in chunks),
         "bound_ms": fused_bound[0], "bound_by": fused_bound[1],
         "library_ms": sum(c["library_ms"] for c in chunks)},
        # No engine path launches it, in the reference either: its numbers
        # are from chunk 0 of the main path's plan, in rank order. Its library
        # time is the faster of index_add_ and torch.segment_reduce.
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:68",
         "launches": total_launches("segment_reduce"), "on_engine_path": False,
         "max_abs_err": segment["max_abs_err"], "ms": segment["ms"],
         "plain_ms": segment["plain_ms"], "bound_ms": segment["bound_ms"],
         "bound_by": segment["bound_by"], "library_ms": segment["library_ms"],
         "index_add_ms": segment["index_add_ms"],
         "segment_reduce_ms": segment["segment_reduce_ms"],
         "equals_fused_bitwise": segment["equals_fused_bitwise"]},
        # The coded path launches it twice a chunk on each coded run: the
        # encode instance, then the flat one to decode. Its times are the
        # encode's at chunk 0's shape; its library time is bitwise_xor on
        # the strided swap plus masked_fill_ (no one call computes the
        # masked swap-XOR). The flat instance's own numbers (at chunk 0's
        # (m^3 cap2, W) words; its library call is bitwise_xor) are the
        # flat_* keys.
        {"name": "xor_words", "route": "cuda",
         "source": "src/repro_torch/csrc/xor_words.cu",
         "replaces": "src/repro/kernels/coded_shuffle/coded_shuffle.py:40",
         "launches": total_launches("xor_words"),
         "launches_by_design": record["coded_path"]["launches_by_design"],
         "max_abs_err": max(xor["max_abs_err"], fx["max_abs_err"]),
         "ms": xor["ms"], "plain_ms": xor["plain_ms"], "bound_ms": xor["bound_ms"],
         "bound_by": xor["bound_by"], "library_ms": xor["library_ms"],
         "three_pass_ms": xor["three_pass_ms"], "flat_ms": fx["ms"],
         "flat_plain_ms": fx["plain_ms"], "flat_library_ms": fx["library_ms"],
         "flat_bound_ms": fx["bound_ms"]},
        # The measured path launches it to calibrate the tick unit; its time
        # is one launch of a burst of back-to-back launches, and its bound an
        # empty kernel's time a launch in the same kind of burst (the 9 bytes
        # it moves: bytes_bound_ms). Its error is the largest |stamp interval
        # - CUDA event interval| in ms over the spins. No library call reads a
        # device clock.
        {"name": "read_ticks", "route": "cuda",
         "source": "src/repro_torch/csrc/wave_timer.cu",
         "replaces": "src/repro/kernels/wave_timer/wave_timer.py:123",
         "launches": total_launches("read_ticks"), "max_abs_err": rt["max_abs_err"],
         "ms": rt["ms"], "plain_ms": rt["plain_ms"], "bound_ms": rt["bound_ms"],
         "bound_by": rt["bound_by"], "library_ms": None,
         "bytes_bound_ms": rt["bytes_bound_ms"]},
        # Launched at every wave boundary of every slot of a measured batch
        # (M * (chunks + 1)); its times are at chunk 0's received ids of one
        # slot. The library call is Tensor.copy_ (the copy without the stamp).
        {"name": "stamp_through", "route": "cuda",
         "source": "src/repro_torch/csrc/wave_timer.cu",
         "replaces": "src/repro/kernels/wave_timer/wave_timer.py:167",
         "launches": total_launches("stamp_through"), "max_abs_err": st["max_abs_err"],
         "ms": st["ms"], "event_ms": st["event_ms"], "plain_ms": st["plain_ms"],
         "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
         "library_ms": st["library_ms"], "library_event_ms": st["library_event_ms"]},
        # Launched in every attention of every prefill of the serve, MoE and
        # family paths and in zamba2's shared block (launches_by_path), bf16
        # through the wgmma instance but MLA's D = 192 and zamba2's D = 80
        # through the simt one; its times are at the serve
        # path's longest prefill, device time a call from a burst behind a
        # spin, and family_cases holds the family paths' shapes; its error is
        # the largest over every case of its phase. The library call is
        # scaled_dot_product_attention (GQA, causal).
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:111",
         "launches": total_launches("flash_attention"),
         "launches_by_design": {
             k: sum(record[f"{p}_path"]["launches_by_design"][k] for p in ATTENTION_PATHS)
             for k in ("wgmma", "simt")},
         "launches_by_path": {p: launches[p]["flash_attention"] for p in ATTENTION_PATHS},
         "family_cases": {
             name: {key: c[key] for key in ("shape", "design", "causal", "max_abs_err", "ms",
                                            "plain_ms", "library_ms", "bound_ms", "bound_by")}
             for name, c in flash["family"].items()},
         "max_abs_err": max(c["max_abs_err"] for c in flash["cases"].values()),
         "ms": flash["ms"], "event_ms": flash["event_ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"], "library_event_ms": flash["library_event_ms"]},
        # No engine or model path launches it, in the reference either: its
        # numbers are from its own entry point at 2^20 tokens and 64
        # destinations (e160_*, e1024_*: 160 and 1,024). No single PyTorch
        # call computes stable ranks.
        {"name": "dispatch_ranks", "route": "cuda",
         "source": "src/repro_torch/csrc/moe_dispatch.cu",
         "replaces": "src/repro/kernels/moe_dispatch/moe_dispatch.py:75",
         "launches": total_launches("dispatch_ranks"), "on_engine_path": False,
         "max_abs_err": max(d["max_abs_err"] for d in disp_cases.values()),
         "ms": disp["ms"], "plain_ms": disp["plain_ms"],
         "bound_ms": disp["bound_ms"], "bound_by": disp["bound_by"], "library_ms": None,
         "e160_ms": disp_cases[160]["ms"], "e160_bound_ms": disp_cases[160]["bound_ms"],
         "e1024_ms": disp_cases[1024]["ms"],
         "e1024_bound_ms": disp_cases[1024]["bound_ms"]},
    ]
    check(launches["main"]["histogram"] > 0 and launches["main"]["fused_shuffle_reduce"] > 0
          and all(launches[p]["histogram"] > 0 and launches[p]["fused_shuffle_reduce"] > 0
                  for p in ("elastic", "multi_job"))
          and launches["sketch"]["sketch_hist"] > 0 and launches["coded"]["xor_words"] > 0
          and launches["measured"]["read_ticks"] > 0
          and launches["measured"]["stamp_through"] > 0
          and all(launches[p]["flash_attention"] > 0 for p in ATTENTION_PATHS),
          "every kernel of an engine path was launched on it")
    check(all(launches[p]["flash_attention"] == 0 for p in launches if p not in ATTENTION_PATHS),
          "only the serve, MoE and family paths launched the flash kernel")
    check(all(launches[p][k] == 0 for p in ATTENTION_PATHS for k in counters
              if k != "flash_attention"),
          "the serve, MoE and family paths launched only the flash kernel (kernel 8 stays "
          "off them)")
    check(all(launches[p]["xor_words"] == 0 for p in launches if p != "coded"),
          "no uncoded path launched xor_words")
    check(all(launches[p][k] == 0 for p in launches if p != "measured"
              for k in ("read_ticks", "stamp_through")),
          "only the measured path launched the wave timer")
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total: {record['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
