#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device,
nvcc and nvidia-smi. Phases, each of which raises on failure:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, started together) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the paths give it, then time it (device time from
   torch.profiler, per-call time from CUDA events) beside its bound, its
   plain version and a library call computing the same function:
   the sketch updates at SKETCH_UPDATE_CASES and PSPARSE_CASES, both
   kernels of each (the tensor-core one for bf16 A with d % 8 == 0 and T
   > 64, the FMA one otherwise), within rtol 1e-4, atol 1e-4 * max|plain| (the sums
   run in another order; the tensor-core sketch_update carries each
   projection as bf16 hi and lo parts) and two calls equal bit for bit,
   beside one torch.matmul of A^T against the (T, 3k) projections; the
   stacked launch of both (one launch over E experts' triples, the
   "expert_in" stacks) at STACKED_CASES (qwen3-moe's train step: E 128
   x 160 rows x d 2048, bf16, k 17; the reduced MoE step's f32 shape),
   the same check, beside one batched torch.bmm and beside E launches of
   the unstacked kernel; the
   count-sketch kernels at the LM train step's geometry
   (r 5, c 2^23, the flat dimension of tinyllama-1.1b, k 256 and 512), a
   small ragged case and an even r: ``csvec_insert`` within the same
   tolerance (atomic sums), with its plan's scratch and the kernels a
   profiled call launches (two a chunk), beside r ``index_add_`` calls over
   precomputed buckets and signed values, ``csvec_topk`` exact (indices
   and values) beside ``torch.topk`` of a precomputed |estimate|, and
   exact on the same tables with a NaN in a bucket of the seed sample,
   a NaN only outside them, a whole NaN row (as the int8 quantiser makes
   it) or an inf, each at r 5 (pruned), on its first 4 rows (even r) and
   on a flat table of its shape (NaN equal in place, the thresholds and
   counts against ``emulate_pruned``); ``csvec_quant`` in both forms (all
   four outputs; ``dhat_only``), exact in q and bit for bit in scale and
   dhat and within one ulp of the row's amax in resid, also with NaN,
   inf and -inf in its rows, beside ``fake_quantize_per_channel_affine``
   with the scale precomputed (the dhat half of the function); the flash
   attention forward (o, lse) and backward (dq, dk, dv) at FLASH_CASES
   (head_dim 16 to 256; at 256 recurrentgemma-2b's prefill, train step,
   window crossing and a ragged window)
   beside ``scaled_dot_product_attention`` and its gradient, each row
   with its TFLOP/s and its share of the bound (f32, and lse in both
   types, within rtol 1e-4, atol 1e-4 * max|plain|; bf16 o, dq, dk and
   dv within rtol and atol ``flash_attention.BF16_TOL`` times each query
   row's or key's own max|plain|, from readings of the tensor-core
   kernels, which round P and dS to bf16 before their products, against
   the f32 plain version; every head_dim runs in f32 too, over several
   64-row tiles), two backward calls on the same inputs equal bit for
   bit (no atomics), and the host's time to encode one TMA tensor map;
   ``mlstm_chunk`` at MLSTM_CASES (chunks longer than, equal to and a
   quarter of S at small widths, xlstm-1.3b's serving prefill B 8 x S
   2048 and refill B 1 x S 512 at Dk 512, Dv 1024), each with f32 and
   with bf16 inputs widened in the kernel: h, C and n within rtol 1e-4,
   atol 1e-4 * max|plain|, m within 1e-4 (the reference's tolerance for
   its Pallas kernel), no library call computing the function;
   ``ring_allreduce`` at W 2, 3, 4 and 8 x N 3, 129, 1000 and 2^20 on
   both wires (tests/test_ring.py's draw) and at the DP runs' buffers
   (phase 9's fused dense wire at W 4, N 1.109e9, fp32; its int8 sketch
   wire at W 2): y, every replica and every residual row equal to the
   plain version's bit for bit, with and without replicas, the int8
   ledger dequant(y) + sum_d res_d = sum_d x_d within 8 W ulps of the
   largest shard element, the kernels a profiled call launches (one on
   the fp32 wire, W + 1 on the int8); timed as the DP step calls it
   (device 0's replica) beside ``xs.sum(0)`` on the fp32 wire (no
   library call on the int8) and with every replica, each beside the
   bound of the bytes it writes; the int8 wire with a NaN or an inf in
   one worker's row at W 2 and 4, equal with NaN in place; then
   the bytes autograd keeps for one attention call at tinyllama-1.1b's
   context (B 4, S 2048) through the plain version and through the
   kernel, which must keep q, k, v, o and lse and nothing of size S x S;
3. serving: ``ServeEngine(monitor=True)`` on tinyllama-1.1b at full width
   with random weights (8 prompts of 128 tokens, 32 new tokens, then one
   refill of a 64-token prompt); tokens must equal the unmonitored
   engine's, sketches and logits must be finite; prefill is timed on both
   engines, alternating, median of three (PREFILL_SAMPLES). Then the same serve with psparse
   monitor projections (``monitor_proj_kind="psparse"``), tokens equal.
   The same on gemma3-27b at full width cut to one pattern period (6
   layers: 5 local with a 1024-token window, 1 global): 2 prompts of
   2048 tokens, 16 new tokens, a refill of 1100 tokens, max_context 2304,
   so the local layers' caches are rings and their attention skips tiles.
   The same on xlstm-1.3b at full width cut to one pattern period (8
   layers: 7 mLSTM, 1 sLSTM; XLSTM_SERVE_LAYERS): 8 prompts of 2048
   tokens (eight chunks), 32 new tokens, a 512-token refill, max_context
   2304, and the sLSTM loop's share of one more prefill. The same on
   recurrentgemma-2b at full width cut to 13 layers (RGEMMA_SERVE): 8
   prompts of 2048 tokens, 32 new tokens (the local layers' 2048-slot
   rings wrap), a 1,100-token refill, max_context 2304, and the RG-LRU
   scans' share of one more prefill. The same on qwen3-moe-30b-a3b at
   full width cut to 12 of its 48 layers (QWEN_SERVE_LAYERS; weights
   drawn in bf16, 15.3 GB): 8 prompts of 2048 tokens, 32 new tokens, a
   1,100-token refill, max_context 2304, and the share of routed choices
   that capacity dropped in one prefill and one decode step. The same on
   musicgen-large at full width and all 48 layers (MUSICGEN_SERVE: 8
   prompts of 1024 audio tokens, 32 new tokens, a 512-token refill,
   max_context 1536) and on internvl2-76b at full width cut to 8 layers
   (INTERNVL_SERVE_LAYERS; weights drawn in bf16; 8 prompts of 2048
   tokens, 16 new tokens, a 1,100-token refill, no patch embeddings, as
   the reference's engine);
4. the serving engine on reduced tinyllama in f32 on the card and on the
   CPU, from the same weights and monitor state: equal tokens, and logits
   and sketches within rtol 1e-4, atol 1e-4; then reduced xlstm with
   512-token prompts (two chunks): equal tokens, logits and sketches
   within rtol and atol 1e-3 * max|CPU| (XLSTM_DVC_TOL's reason);
5. training: MNIST_MLP (784 -> 512 x3 -> 10) for 100 steps in each of
   standard, monitor, sketched_fixed and sketched_adaptive, with Gaussian
   and with psparse projections; then the 16-layer monitoring pair
   (MONITOR_HEALTHY, MONITOR_PROBLEMATIC) for 120 steps, psparse, whose
   pathology flags are printed. Losses finite, the sketched variants
   learn (mean of the last 10 losses below the first 10's), monitor's
   parameters equal standard's;
6. a reduced MLP in f32: one sketched_fixed step (gradients, new tree)
   and the reconstruction of a node, on the card and on the CPU, with
   each projection kind (tree within 1e-4; gradients and reconstruction
   factors within 1e-3, as the k x k solves amplify rounding); then one
   LM train step (plain backprop, f32) of reduced tinyllama at S 80 (not
   a multiple of the attention kernels' 64-row tiles) and of reduced
   gemma3 at S 80 (past its 32-token window), card against CPU: loss and
   gradients within 1e-4 * max|CPU|;
7. LM training: tinyllama-1.1b at full width (f32 parameters, bf16
   compute), B=8 x S=128 synthetic batches, sketched backprop on both
   FFN matmuls of all 22 layers (k_max 17), AdamW with warmup-cosine,
   20 steps of (a) no compression, 10 each of (b) count-sketch with an
   fp32 table, (c) count-sketch with an int8 table and p2=2, all with
   Gaussian projections, then 3 steps with psparse projections. Losses
   finite, no skipped step, (a) learns (mean of the last 5 losses below
   the first 5's; (b) and (c) send 256 of 1.1e9 coordinates a step, so
   learning is not asked of them). After each run one more step under
   torch.profiler (device time by kernel, the attention kernels' share);
   after (b) and (c), one more step's gradients: v_new + update == v_pre
   exactly away from the sent coordinates (rtol 1e-6 at them), and the
   insert kernel against its plain version on that step's v_pre; then
   one step with a NaN in one ``w_down`` entry, which the NaN guard must
   skip (parameters, u, v, the sketch, AdamW's count unchanged, the skip
   counted) after the kernels ran on its NaN gradient. Then
   (a) for 3 steps at tinyllama's own context, B=4 x S=2048: losses
   finite, no skip, peak memory under 80 GB;
8. the LM launcher (``python -m repro_torch.launch.train --reduced
   --compress countsketch``'s ``main``) for 6 steps, checkpointing into
   a temporary directory that is removed afterwards;
9. data-parallel LM training: tinyllama-1.1b at full width, global B 8 x
   S 128, W workers in one process, 10 steps each of (a) the fused
   layout, fp32 sketch wire through the ring, dense gradients, W 4, and
   (b) the overlap layout, int8 sketch wire through the ring, the fp32
   count sketch with p2 2, W 2: losses finite, learning (last-5 mean
   below the first-5's), peak under 80 GB; after (b) one more step whose
   int8 ring inputs and output are held to the ledger; one step of each
   profiled;
10. reduced tinyllama, W 4, B 8 x S 16, 3 steps of each setting on the
   card and on the CPU from one state: losses, parameters and trees
   (on the int8 wire the tree plus the workers' ledgers) within TOL;
11. the DP launcher (``--reduced --dp 4 --dp-collective overlap
   --sketch-wire-dtype int8 --ring-wire --compress countsketch --cs-p2
   2``) for 4 steps, then resumed to 6 from its ``per_worker_v1``
   checkpoint;
12. the rest of the paper's experiments at their configs' full sizes
   (``phase_paper_experiments``): a faithful MNIST_MLP step on a NaN
   input (NaN loss, no exception: C5), MNIST_MLP corange with Gaussian
   and psparse-corange projections (no update kernel) and its batched
   forward against the sequential one, the sketched CIFAR conv stem
   with each projection kind and standard, the CIFAR hybrid, the PINN
   with the monitor on and off, and the MLP data-parallel step in both
   layouts (trees and losses bit for bit equal) and against the CPU;
13. xlstm training (``phase_xlstm_train``): ``mlstm_chunk_bwd`` at
   MLSTM_BWD_CASES (xlstm-1.3b's train shapes B 4 x S 512 in bf16 and
   f32 and B 1 x S 2048 with the model's forget gates, a small case
   where the denominator's exp(-m) branch wins, and a narrow bf16 case
   on the tensor cores with and without that branch) against its plain
   version on the same inputs widened exactly, each gradient within rtol
   1e-4, atol 1e-4 * max|plain| (bf16 outputs with their one rounding on
   top: ``mlstm_chunk.bwd_gap``), two calls equal bit for bit, each row
   with its path (the bf16 rows at xlstm's widths must take the tensor
   cores), timed beside its path's bound (the tensor cores' products at
   the bf16 rate, the FMA kernels' at the f32 rate) and its plain
   version, no library call; then xlstm-1.3b at full width cut to one
   7:1 period, 8 layers (XLSTM_TRAIN: f32 parameters, bf16 compute,
   AdamW without the global-norm clip (XLSTM_GRAD_CLIP), monitor
   sketches with the
   mlstm_c/mlstm_n carry nodes at k_max 9), B 4 x S
   512 for 10 steps with Gaussian projections on one repeated batch
   (profiled: the backward's device share; the sLSTM blocks' share of a
   step; learning: the mean of the last 3 losses XLSTM_LEARN_DROP below
   the first 3's) and 3 with psparse ones on fresh batches,
   then 1 step at B 1 x S 2048 (8 layers too): losses finite, no
   skip, peak under 80 GB, every sketch entry holding mass (but a carry
   node's psparse sketch whose matrix has no support row below B, which
   stays zero in the reference too); then reduced xlstm in f32 at B 2, one train step
   on the card and on the CPU from one state at each XLSTM_DVC_STEPS (S
   16 in one chunk, within TOL * max|CPU|; S 64 over four 16-token
   chunks, within 5e-3: the gradient's conditioning there): loss,
   gradients and tree;
14. recurrentgemma-2b training (``phase_rgemma_train``): full width and
   all 26 layers (RGEMMA_TRAIN: f32 parameters, bf16 compute, AdamW as
   launch/train.py builds it, clip at 1, sketched FFN backprop and the
   rglru_h carry node at k_max 17), B 4 x S 512 for 10 steps with
   Gaussian projections on one repeated batch (profiled: the flash
   kernels' device share, the idle share; the RG-LRU scan's device ms a
   layer forward and backward; learning: the mean of the last 3 losses
   RGEMMA_LEARN_DROP below the first 3's) and 3 psparse steps on fresh
   batches, then 2 steps at B 1 x S 4096 (past the 2048-token window):
   losses finite, no skip, peak under 80 GB, every sketch entry holding
   mass; then reduced recurrentgemma cut to 5 layers, one f32 step at B
   2 x S 64 on the card and on the CPU (loss, gradients, tree within
   TOL * max|CPU|);
15. qwen3-moe-30b-a3b training (``phase_qwen3_moe_train``): full width
   cut to 3 layers (QWEN_TRAIN: f32 parameters, bf16 compute, AdamW as
   launch/train.py builds it, "attn_o" sketched backprop on the
   attention out-projection and the "expert_in" stacks at k_max 17),
   B 4 x S 512 for 10 steps with Gaussian projections on one repeated
   batch (profiled: flash's device share, the idle share; one layer's
   expert FFN and one stacked update timed apart; learning: the mean of
   the last 3 losses QWEN_LEARN_DROP below the first 3's) and 3 psparse
   steps on fresh batches: losses finite, no skip, peak under 80 GB;
   then reduced qwen3-moe, one f32 step at B 2 x S 64 on the card and on
   the CPU (loss, gradients, tree within TOL * max|CPU|, each layer's
   routing selections equal);
16. musicgen-large training (``phase_musicgen_train``): full width and
   all 48 layers (MUSICGEN_TRAIN: f32 parameters, bf16 compute, AdamW
   as launch/train.py builds it, sketched FFN backprop at k_max 17), B 4
   x S 512 for 10 Gaussian steps on one repeated batch (profiled; the
   last-3 mean loss MUSICGEN_LEARN_DROP below the first 3's) and 3
   psparse steps: losses finite, no skip, peak under 80 GB;
17. reduced internvl2-76b, two f32 steps with stand-in patch embeddings
   spliced over its first 4 positions, on the card and on the CPU
   (``_lm_steps_vs_cpu``: losses, parameters and trees within TOL);
18. xlstm-1.3b and recurrentgemma-2b data-parallel
   (``phase_recurrent_dp``): W 2 workers, the fused layout on the fp32
   ring, global B 4 x S 512, 3 steps, at full width cut to
   RECURRENT_DP_LAYERS (8 and 13): losses finite, no skip, peak under
   80 GB, every carry entry holding mass from each worker's B/W rows,
   recurrentgemma's step profiled; then a reduced W 2 step of each, card
   against CPU;
19. the same two with the fp32 count sketch (5 x 2^23) on one device
   (``phase_recurrent_cs``), 3 steps at RECURRENT_CS_LAYERS (8 each:
   flat dimensions under 2**31), then the mass check on one more step;
   and two reduced compressed steps of each (fp32; the int8 table with
   p2), card against CPU (the count sketch's {u, v} too);
20. print ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Every run of a path (3, 4, 5, 6's LM step, 7–19) sets the kernels'
launch counts to 0 just before it and checks them just after: each
monitored token step or train step launches one update kernel per sketched node,
the projection kind's; each compressed LM step one insert and one top-k,
and one quant with the int8 table; each prefill, refill and train step
one flash forward an attention layer and each prefill and refill one
mlstm_chunk an mLSTM layer, each train step one flash backward a layer,
each xlstm train step one mlstm_chunk and one mlstm_chunk_bwd an mLSTM
layer and one update a "res" layer and two (mlstm_c, mlstm_n) an mLSTM
layer, each recurrentgemma train step one flash forward and one
backward a local layer and one update a node entry (ffn_in and ffn_h
every layer, rglru_h an RG-LRU layer), each MoE train step one flash
forward and backward and two updates a layer ("attn_o", and one stacked
launch for the layer's "expert_in" stack), a decode step none, a corange step none, a conv step one a stage. A DP
step counts these per worker (the overlap layout's increment sweep adds
a forward), one top-k, and one ring merge (fused) or two (overlap: the
sketch, then the gradient wire). The phases' wall seconds go to
``phase_s`` in the JSON, and the whole script's to ``total_s``.

Exits non-zero, printing no result, without a CUDA device or without the
repository's sources beside it. Measurements also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
TOL = 1e-4
# prefills timed an engine, alternating monitor on and off (three, for
# the script's time limit)
PREFILL_SAMPLES = 3

# (label, T, d, k, A dtype). sketch_update: the serving path's shapes at
# tinyllama's d=2048 and k=9 (prefill T=B*S0=1024, decode T=B=8, refill
# T=S0=64), a ragged case, the paper's largest k=33, and the trainer's
# nodes (MNIST_MLP: T=128, d=512, k=33; the 16-layer monitoring pair:
# T=128, d=1024, k=17; f32 A), the LM trainer's FFN nodes at B 8 x S 128
# (T=1024, d=2048 and 5632, k=17) and each DP worker's share of them
# (DP_RUNS: T=256 at W 4, T=512 at W 2), the FFN nodes at tinyllama's
# context (B 4 x S 2048: T=8192), a bf16 case ragged in T, d and k (the
# tensor-core kernel's edges), bf16 at d 50 (the FMA kernel) and bf16 at
# the largest k=64 (three 64-output warpgroups)
SKETCH_UPDATE_CASES = [
    ("prefill", 1024, 2048, 9, "bfloat16"),
    ("prefill", 1024, 2048, 9, "float32"),
    ("decode", 8, 2048, 9, "bfloat16"),
    ("decode", 8, 2048, 9, "float32"),
    ("refill", 64, 2048, 9, "bfloat16"),
    ("ragged", 37, 50, 9, "float32"),
    ("k33", 1024, 2048, 33, "bfloat16"),
    ("mnist_mlp", 128, 512, 33, "float32"),
    ("monitor16", 128, 1024, 17, "float32"),
    ("lm_ffn_in", 1024, 2048, 17, "bfloat16"),
    ("lm_ffn_h", 1024, 5632, 17, "bfloat16"),
    ("dp_w4_ffn_in", 256, 2048, 17, "bfloat16"),
    ("dp_w4_ffn_h", 256, 5632, 17, "bfloat16"),
    ("dp_w2_ffn_in", 512, 2048, 17, "bfloat16"),
    ("dp_w2_ffn_h", 512, 5632, 17, "bfloat16"),
    ("lm_ctx_ffn_in", 8192, 2048, 17, "bfloat16"),
    ("lm_ctx_ffn_h", 8192, 5632, 17, "bfloat16"),
    ("ragged_bf16", 1000, 1000, 17, "bfloat16"),
    ("ragged_bf16_d50", 300, 50, 17, "bfloat16"),
    ("k64", 1024, 2048, 64, "bfloat16"),
    ("conv1", 32768, 27, 33, "float32"),
    ("conv2", 32768, 72, 33, "float32"),
    ("pinn", 1024, 50, 17, "float32"),
    # xlstm-1.3b training at B 4 x S 512, k 9: "res" (T 2048), and the
    # carry nodes' 4 rows against the projections' first 4 (mlstm_c at
    # H Dk Dv = 2,097,152, mlstm_n at H Dk = 2048)
    ("xlstm_res", 2048, 2048, 9, "bfloat16"),
    ("xlstm_mlstm_c", 4, 2097152, 9, "float32"),
    ("xlstm_mlstm_n", 4, 2048, 9, "float32"),
]
# psparse_update at density 0.1: the trainer's nodes, the psparse serving
# prefill and decode step, a ragged case (m = clamp(round(0.1 T), k, T)
# support rows), the LM's FFN nodes, a bf16 case ragged in T, d and k,
# bf16 at k=64, the conv stem's two stages and xlstm training's nodes
# (PSPARSE_BINDING)
PSPARSE_CASES = [
    ("mnist_mlp", 128, 512, 33, "float32"),
    ("monitor16", 128, 1024, 17, "float32"),
    ("prefill", 1024, 2048, 9, "bfloat16"),
    ("decode", 8, 2048, 9, "bfloat16"),
    ("ragged", 37, 50, 9, "float32"),
    ("lm_ffn_in", 1024, 2048, 17, "bfloat16"),
    ("lm_ffn_h", 1024, 5632, 17, "bfloat16"),
    ("ragged_bf16", 1000, 1000, 17, "bfloat16"),
    ("k64", 1024, 2048, 64, "bfloat16"),
    ("conv1", 32768, 27, 33, "float32"),
    ("conv2", 32768, 72, 33, "float32"),
    ("xlstm_res", 2048, 2048, 9, "bfloat16"),
    ("xlstm_mlstm_c", 4, 2097152, 9, "float32"),
    ("xlstm_mlstm_n", 4, 2048, 9, "float32"),
]
# the binding (num_tokens) of the psparse cases whose A has fewer rows:
# the carry nodes' 4 rows against the tree's 2048 token rows, their hash
# coefficients drawn until every matrix has a support row below 4
PSPARSE_BINDING = {"xlstm_mlstm_c": 2048, "xlstm_mlstm_n": 2048}
DENSITY = 0.1
# the stacked launch (one launch for an "expert_in" stack of E triples):
# (label, E, rows, d, k, A dtype, binding T). qwen3-moe-30b-a3b's train
# step at B 4 x S 512 (capacity 160 slots an expert of 128, d 2048, k
# 17: the tensor-core kernel for sketch_update; psparse's FMA kernel over
# the live slots of the 2048-row binding) and the reduced MoE step that
# phase_moe_step_vs_cpu runs (E 4, capacity 80 at 128 tokens, d 64, k 9,
# f32: the FMA kernels)
STACKED_CASES = [
    ("moe_expert_in", 128, 160, 2048, 17, "bfloat16", 2048),
    ("moe_reduced_f32", 4, 80, 64, 9, "float32", 128),
]
# the CUDA sources, one nvcc each
KERNELS = ("sketch_update", "psparse_update", "csvec_insert", "csvec_topk",
           "csvec_quant", "flash_attention", "mlstm_chunk", "mlstm_chunk_bwd",
           "ring_allreduce")
# the count-sketch kernels: (label, r, c, n, ks). "train" is the LM train
# step's geometry: tinyllama-1.1b's flat dimension, the table that
# resolve_countsketch sizes for it (5 x 2^23), cs_k 256 and 2 x 256 p2
# candidates
CS_CASES = [
    ("train", 5, 2**23, None, (256, 512)),
    ("ragged", 5, 128, 1000, (64,)),
    ("even_r", 4, 128, 1000, (64,)),
]

# flash attention: (label, B, Hq, Hkv, S, D, window, dtype). tinyllama's
# train step (B 8 x S 128), each DP worker's share of it (B 2 at W 4, B 4
# at W 2; the backward's dk/dv split differs with B) and its own context
# (B 4 x S 2048), gemma3's
# local (window 1024) and global layers at B 2 x S 2048, granite-34b's
# MQA and stablelm-12b's head_dim 160 at S 512, the reduced configs'
# f32 head_dim 16 at a ragged S and past a 32-token window and their bf16
# twins at head_dim 64 (the tensor-core kernels take no head_dim 16), a
# bf16 head_dim 128 window over several tiles, and head_dim 64, 128 and
# 160 in f32 over several tiles, held at 1e-4; recurrentgemma-2b's local
# layers at head_dim 256 (10 query heads on one KV head, window 2048):
# its serving prefill (B 8 x S 2048, every pair inside the window), its
# train step (B 4 x S 512), a sequence past the window (B 1 x S 4096) and
# a ragged window (S 300, window 100); musicgen-large's serving prefill
# (B 8 x S 1024, MHA 32/32 at head_dim 64: one query head a KV head) and
# its whole context (B 1 x S 1536), and internvl2-76b's prefill (B 8 x S
# 2048, GQA 64/8 at head_dim 128)
FLASH_CASES = [
    ("train_s128", 8, 32, 4, 128, 64, None, "bfloat16"),
    ("dp_w4_s128", 2, 32, 4, 128, 64, None, "bfloat16"),
    ("dp_w2_s128", 4, 32, 4, 128, 64, None, "bfloat16"),
    ("tinyllama_ctx", 4, 32, 4, 2048, 64, None, "bfloat16"),
    ("gemma3_local", 2, 32, 16, 2048, 128, 1024, "bfloat16"),
    ("gemma3_global", 2, 32, 16, 2048, 128, None, "bfloat16"),
    ("granite_mqa", 2, 48, 1, 512, 128, None, "bfloat16"),
    ("stablelm_d160", 2, 32, 8, 512, 160, None, "bfloat16"),
    ("reduced_ragged", 2, 4, 2, 37, 16, None, "float32"),
    ("reduced_window", 2, 4, 2, 80, 16, 32, "float32"),
    ("bf16_ragged", 2, 4, 2, 37, 64, None, "bfloat16"),
    ("bf16_window", 2, 4, 2, 80, 64, 32, "bfloat16"),
    ("bf16_d128_window", 1, 8, 2, 300, 128, 100, "bfloat16"),
    ("f32_d64", 2, 8, 2, 300, 64, None, "float32"),
    ("f32_d128_window", 1, 8, 2, 300, 128, 100, "float32"),
    ("f32_d160", 1, 4, 2, 200, 160, None, "float32"),
    ("rgemma_prefill", 8, 10, 1, 2048, 256, 2048, "bfloat16"),
    ("rgemma_train", 4, 10, 1, 512, 256, 2048, "bfloat16"),
    ("rgemma_window", 1, 10, 1, 4096, 256, 2048, "bfloat16"),
    ("rgemma_ragged_window", 1, 10, 1, 300, 256, 100, "bfloat16"),
    ("musicgen_prefill", 8, 32, 32, 1024, 64, None, "bfloat16"),
    ("musicgen_ctx", 1, 32, 32, 1536, 64, None, "bfloat16"),
    ("internvl2_prefill", 8, 64, 8, 2048, 128, None, "bfloat16"),
]

# mlstm_chunk: (label, B, H, S, Dk, Dv, chunk), each with f32 inputs and
# with bf16 inputs widened in the kernel (the model's q, k and v). S below,
# at and four times the chunk at small widths, then xlstm-1.3b's serving
# prefill (B 8 x 2048 tokens, eight chunks) and its refill (1 x 512)
MLSTM_CASES = [
    ("s_lt_w", 2, 2, 40, 8, 16, 256),
    ("s_eq_w", 1, 3, 64, 16, 32, 64),
    ("s_4w", 2, 2, 128, 32, 32, 32),
    ("serve", 8, 4, 2048, 512, 1024, 256),
    ("refill", 1, 4, 512, 512, 1024, 256),
]
# mlstm_chunk_bwd: (label, B, H, S, Dk, Dv, chunk, dtype, li shift, forget
# gates). xlstm-1.3b's train shapes (B 4 x S 512, two chunks, in bf16 as
# the model runs and in f32; B 1 x S 2048, eight chunks) with the model's
# forget gates, and a small case where the denominator's exp(-m) branch
# wins on some rows, and a narrow tensor-core case (Dv 128, four 64-token
# chunks) with and without that branch. "model": lf = logsigmoid(b_h +
# N(0, 1)) with the model's forget biases b_h = linspace(3, 6) over the
# heads (models/ssm.py),
# a decay of e^-0.6 to e^-12.5 over a 256-token chunk, so the dC carried
# into an earlier chunk is large; "steep": logsigmoid(N(0, 1) + 2), e^-33
# a 256-token chunk, for short chunks only
MLSTM_BWD_CASES = [
    ("train_bf16", 4, 4, 512, 512, 1024, 256, "bfloat16", 0.0, "model"),
    ("train_f32", 4, 4, 512, 512, 1024, 256, "float32", 0.0, "model"),
    ("ctx_bf16", 1, 4, 2048, 512, 1024, 256, "bfloat16", 0.0, "model"),
    ("floor_branch", 1, 2, 64, 8, 16, 16, "float32", -8.0, "steep"),
    ("narrow_tc", 1, 2, 256, 512, 128, 64, "bfloat16", 0.0, "steep"),
    ("narrow_tc_floor", 1, 2, 256, 512, 128, 64, "bfloat16", -8.0, "steep"),
]
# the MLSTM_BWD_CASES rows that must take the tensor cores
MLSTM_BWD_TC = ("train_bf16", "ctx_bf16", "narrow_tc", "narrow_tc_floor")
# xlstm-1.3b trained at full width (f32 parameters, bf16 compute, AdamW
# with warmup-cosine, monitor sketches with the mlstm_c/mlstm_n carry
# nodes): B 4 x S 512 (two mLSTM chunks), STEPS with Gaussian
# projections and PSPARSE_STEPS with psparse ones, then CTX_STEPS at B 1
# x S 2048, the model's context (eight chunks); all cut in depth to one
# 7:1 period (LAYERS, CTX_LAYERS: 8) to keep the script inside its time
# limit (7.04 s a step at 48 layers on an H100, mostly the sLSTM
# loop). k_max 9
# is the reference's own xlstm tests' (tests/test_node_families.py): one
# copy of the 42 mlstm_c triples takes 3 x 42 x 2,097,152 x k_max x 4 B,
# 9.5 GB at 9 and 34.9 GB at the default 33, and the step holds two
XLSTM_TRAIN = dict(layers=8, batch=4, seq=512, steps=10, psparse_steps=3,
                   ctx_batch=1, ctx_seq=2048, ctx_steps=1, ctx_layers=8,
                   k_max=9)
# the Gaussian xlstm run trains on its first batch again and again and
# must end with its last-3 mean loss this fraction below its first-3
# mean. On fresh batches ten steps cannot show learning: at reduced size
# neither xlstm's nor tinyllama's loss falls in ten steps there (the
# batches' own spread is larger). On the repeated batch reduced xlstm
# falls 12%, and not at all with its mLSTM gradient's sign flipped
# (tools/xlstm_learn_witness.py, CPU)
XLSTM_LEARN_DROP = 0.02
# xlstm-1.3b's random init has a gradient norm of about 4.8e12 at B 4 x S
# 512 on the card (the backward kernel and the plain one agree within 2%,
# f32 alike), growing about twice a layer toward the input (PERF.md,
# Findings). Reduced xlstm's grad_norm equals the reference's on the CPU
# at S 16 to 512 (tests/test_torch_xlstm_train.py) and grows with S there;
# the reference itself does not run at full width. Clipped to a global
# norm of 1 (launch/train.py's default), the deep layers' gradients fall
# far under AdamW's eps (1e-8) and their steps vanish: on one repeated
# batch the loss moves 0.07% in 10 steps. The xlstm runs here turn the
# clip off (AdamWConfig's 0); the repeated batch then falls 11%
XLSTM_GRAD_CLIP = 0.0
# the card against the CPU on reduced xlstm's train step at B 2: (S,
# mLSTM chunk, tol). Its gradient is ill-conditioned at random init:
# every weight moved by one f32 rounding (1e-7 relative) moves a gradient
# leaf by 8.3e-6 to 2.1e-5 of its max at S 16 (8 perturbation seeds), and
# by 7.0e-5 to 1.38e-3 at S 64 (32 seeds, median 4.1e-4; 6.2e-5 to
# 1.67e-3 at chunk 16; tools/xlstm_chunk_spread.py --conditioning), where
# the card read 8.3e-4 at chunk 256. S 16 is one chunk, held at TOL; S 64
# at chunk 16 crosses three chunk boundaries, held at 3x the largest of
# its readings
XLSTM_DVC_STEPS = [(16, 256, TOL), (64, 16, 5e-3)]
# xlstm-1.3b served at full width: 2048-token prompts (eight chunks), 32
# new tokens, a 512-token refill (two chunks, one request); cut in depth
# to one 7:1 pattern period (8 layers; 16 before recurrentgemma-2b's
# phases came) to keep the script inside its time limit
XLSTM_SERVE = dict(batch=8, prompt_len=2048, new_tokens=32, refill_len=512,
                   max_context=2304)
XLSTM_SERVE_LAYERS = 8
# reduced models amplify rounding over long prompts: at 512 tokens the JAX
# reference's own logits move by 7.3e-4 of their max when only its mLSTM
# chunk changes, the port's CPU prefill reads 7.2e-4 against it, and one
# with q and k rounded to bf16 reads 0.75 (tools/xlstm_chunk_spread.py),
# so the card is held to the CPU there at 1e-3 of max
XLSTM_DVC_TOL = 1e-3

# recurrentgemma-2b served at full width: 8 prompts of 2048 tokens (the
# local layers' window: their 2048-slot rings fill at prefill and wrap
# while decoding), 32 new tokens, a 1,100-token refill; cut in depth to
# 13 of its 26 layers (four (rglru, rglru, local) periods and an rglru)
# for the time limit (its training keeps all 26)
RGEMMA_SERVE = dict(batch=8, prompt_len=2048, new_tokens=32,
                    refill_len=1100, max_context=2304)
RGEMMA_SERVE_LAYERS = 13
# and trained at full width and all 26 layers (f32 parameters, bf16
# compute, AdamW as launch/train.py builds it: lr 3e-4, the global-norm
# clip at 1; sketched FFN backprop and the rglru_h carry node at the LM
# runs' k_max 17): B 4 x S 512, STEPS Gaussian steps on one repeated
# batch, which must end with the last-3 mean loss LEARN_DROP below the
# first 3's, and PSPARSE_STEPS psparse ones on fresh batches; CTX_STEPS
# at B 1 x S 4096, where the local layers' window of 2048 cuts the
# attention
RGEMMA_TRAIN = dict(batch=4, seq=512, steps=10, psparse_steps=3,
                    ctx_batch=1, ctx_seq=4096, ctx_steps=2, k_max=17)
RGEMMA_LEARN_DROP = 0.02
# reduced recurrentgemma-2b cut to one period and the tail (5 layers),
# one f32 train step at B 2 x S 64 on the card and on the CPU
RGEMMA_DVC = dict(layers=5, batch=2, seq=64, k_max=9)

# qwen3-moe-30b-a3b served at full width (30.5 B parameters at all 48
# layers, 61.1 GB drawn in bf16): 8 prompts of 2048 tokens
# (capacity 1,280 slots an expert), 32 new tokens (capacity 4 at B 8),
# a 1,100-token refill (capacity 88), both monitors
QWEN_SERVE = dict(batch=8, prompt_len=2048, new_tokens=32,
                  refill_len=1100, max_context=2304)
# cut in depth to a quarter of its 48 layers (15.3 GB of bf16 weights)
# to keep the script inside its time limit (36 s for the phase at 48)
QWEN_SERVE_LAYERS = 12
# and trained at full width cut to 3 layers (2.49 B parameters: 39.9 GB
# of f32 parameters, gradients and AdamW moments; AdamW's functional
# update holds the old and the new parameters and moments at its end, so
# 4 layers (3.11 B) reached 72.4 GiB allocated beside 5.1 GiB of free
# fragments and ran out of memory on an H100; 48 layers would need 489
# GB), bf16 compute, AdamW as launch/train.py builds it (lr 3e-4, clip
# 1), "attn_o" sketched backprop and the "expert_in" stacks at k_max 17:
# B 4 x S 512 (capacity 160), STEPS Gaussian steps on one repeated
# batch, which must end with the last-3 mean loss LEARN_DROP below the
# first 3's, and PSPARSE_STEPS psparse ones on fresh batches
QWEN_TRAIN = dict(layers=3, batch=4, seq=512, steps=10, psparse_steps=3,
                  k_max=17)
QWEN_LEARN_DROP = 0.02
# reduced qwen3-moe (2 layers, E 4 top-2), one f32 train step at B 2 x S
# 64 on the card and on the CPU
QWEN_DVC = dict(batch=2, seq=64, k_max=9)

# musicgen-large served at full width and all 48 layers: 8 prompts of
# 1024 EnCodec tokens, 32 new tokens, a 512-token refill, a 1536-token
# context (MusicGen's 30 s of 50 Hz codes)
MUSICGEN_SERVE = dict(batch=8, prompt_len=1024, new_tokens=32,
                      refill_len=512, max_context=1536)
# and trained at full width and all 48 layers (2.42 B parameters: 38.8
# GB of f32 parameters, gradients and AdamW moments), bf16 compute, AdamW
# as launch/train.py builds it (lr 3e-4, clip 1), sketched FFN backprop
# at k_max 17: B 4 x S 512, STEPS Gaussian steps on one repeated batch,
# which must end with the last-3 mean loss LEARN_DROP below the first
# 3's, and PSPARSE_STEPS psparse ones on fresh batches
MUSICGEN_TRAIN = dict(batch=4, seq=512, steps=10, psparse_steps=3,
                      k_max=17)
MUSICGEN_LEARN_DROP = 0.02
# internvl2-76b served at full width cut to 8 of its 80 layers (1.71 GB
# of bf16 weights a layer and 4.2 GB of embeddings, drawn in bf16; one
# layer's training state is 13.7 GB, 80 layers' far past one card, which
# waits for ROADMAP A14): 8 prompts of 2048 tokens, 16 new tokens, a
# 1,100-token refill. The engine takes no patch embeddings, as the
# reference's
INTERNVL_SERVE = dict(batch=8, prompt_len=2048, new_tokens=16,
                      refill_len=1100, max_context=2304)
INTERNVL_SERVE_LAYERS = 8
# data-parallel training of the recurrent archs: W 2 workers in one
# process, the fused layout on the fp32 ring, global B 4 x S 512, STEPS
# steps, at full width cut in depth so that the f32 state, the W wire
# rows and one worker's activations fit the card (recurrentgemma 1.77e9
# coordinates at 13 layers), xlstm at one 7:1 period (8 layers) as its
# own training (each worker runs the sLSTM loop: 5.0 s a step at 16);
# k_max as each arch's own training run
RECURRENT_DP = dict(workers=2, batch=4, seq=512, steps=3)
RECURRENT_DP_LAYERS = {"xlstm-1.3b": 8, "recurrentgemma-2b": 13}
# and with the fp32 count sketch (5 x 2^23 counters) on one device, 3
# steps, at a depth whose flat dimension stays under 2**31 (the
# reference's int32 indices) and whose state, u, v_pre and the update
# fit: recurrentgemma 8 layers (1.35e9), xlstm one 7:1 period (8) as its
# other training runs
RECURRENT_CS = dict(batch=4, seq=512, steps=3,
                    compression=dict(mode="countsketch", cs_cols=2**23))
RECURRENT_CS_LAYERS = {"xlstm-1.3b": 8, "recurrentgemma-2b": 8}
# reduced steps on the card against the CPU (f32, Gaussian, k_max 9):
# internvl2 with patch embeddings, the recurrent archs W 2 fused and with
# the count sketch (c 512, k 64); xlstm at S 16, one mLSTM chunk, as
# XLSTM_DVC_STEPS holds it at TOL (its gradient's conditioning: at S 64
# the count sketch's momentum u, the gradient itself, read 1.03e-3 of
# its max against the CPU on an H100)
REDUCED_DVC = dict(batch=4, seq=64, k_max=9)
REDUCED_DVC_SEQ = {"xlstm-1.3b": 16}

# the LM trainer: tinyllama-1.1b at full width, as launch/train.py runs it
LM_BATCH, LM_SEQ, LM_STEPS, LM_PSPARSE_STEPS = 8, 128, 20, 3
# the compressed runs, which are not asked to learn (256 of 1.1e9
# coordinates a step), cut from 20 steps to keep the script inside its
# time limit
LM_CS_STEPS = 10
# and at its own context (arXiv:2401.02385 trains at 2048 tokens)
LM_CTX_BATCH, LM_CTX_SEQ, LM_CTX_STEPS = 4, 2048, 3
PEAK_LIMIT_BYTES = 80e9
LM_MODES = {"none": None,
            "countsketch_fp32": dict(mode="countsketch"),
            "countsketch_int8_p2": dict(mode="countsketch", cs_p2=2,
                                        wire_dtype="int8")}

# the trainer's path: MNIST_MLP as benchmarks/bench_mnist.py runs it, the
# 16-layer monitoring pair as examples/gradient_monitoring.py runs it
MNIST_STEPS = 100
MNIST_EPOCH = 10            # steps per adaptive-rank epoch
MONITOR_STEPS = 120
VARIANTS = ("standard", "monitor", "sketched_fixed", "sketched_adaptive")
PROJ_KINDS = ("gaussian", "psparse")
# the paper experiments' phase: MNIST_MLP corange, the sketched CIFAR
# conv stem, the CIFAR hybrid, the PINN and the MLP data-parallel step
COR_STEPS, COR_AB_STEPS = 100, 5
CONV_STEPS, HYBRID_STEPS, PINN_STEPS = 50, 100, 100
MLP_DP_WORKERS, MLP_DP_BATCH, MLP_DP_STEPS, MLP_DP_CPU_STEPS = 4, 128, 20, 3
CONV_CPU_STEPS = 3
# full size on the card against the CPU, 3 steps from one state: each
# parameter leaf and sketch within tol * its max|CPU| (losses at TOL).
# Adam's first steps move a weight by lr = 1e-3 whatever its gradient's
# size, so a weight whose gradient is near zero carries rounding whole
# into the step; a step of the wrong sign moves a leaf by 2e-3 / its max.
# The readings on an H100 (PERF.md, Findings): the conv stem (faithful pinv)
# 2.0e-5 (weights), 6.6e-7 (trees); MNIST_MLP's DP step (fast solve)
# 7.4e-4 (a near-zero gradient's weight; its trees 5.3e-5 downstream of
# it). Each tol stands a few times above its reading and under what one
# wrong-signed step moves a weight leaf: 2.5e-3 to 3.6e-3 for the convs
# (max|w| about 0.8 and 0.55), 8e-3 for MNIST_MLP's (about 0.25)
CONV_CPU_TOL, MLP_DP_FULL_TOL = 1e-4, 2e-3
# the conv stem and the hybrid train on the conv family's stand-in CIFAR
# batches (N(0, 1) image prototypes, noise 0.5), on which exact gradients
# clearly learn within the window; on the benchmark's weaker images
# (class_prototypes, unit noise) exact gradients take the hybrid only
# from ln 10 to about 2.0 in 100 steps (tools/hybrid_witness.py). Each
# run, the standard one as the witness, must end with its last-10 mean
# loss at most LEARN_FRAC * ln(d_out), half the chance loss. The hybrid
# trains at HYBRID_LR: at CIFAR_HYBRID's 1e-3 its sketched tail ends 100
# steps anywhere from 3e-6 to 2.1, in the reference as in the port, the
# same init giving other ends on other runs; at 1e-4 it ends at 1.4e-3
# to 3.0e-3 from every init tried (tools/hybrid_witness.py --data
# stand_in --lr 1e-4, keys 0-3 and 7), exact gradients at 1e-4
LEARN_FRAC = 0.5
HYBRID_LR = 1e-4
# the corange forward's batched and sequential forms on the card: the
# same products, grouped differently (one batched QR and pinv against L):
# losses within rtol 1e-5; parameters within atol 5e-5, the paper
# trainer's Adam-trajectory tolerance (tests/test_torch_paper_trainer.py):
# Adam's m / sqrt(v) carries a gradient's last-bit difference whole into
# a weight whose gradient is near zero
COR_AB_TOL, COR_AB_PARAM_ATOL = 1e-5, 5e-5
# device against CPU: the k x k solves and pinv of the reconstruction
# amplify f32 rounding by up to cond(Y^T Y); a QR column of the other
# sign moves A~ by O(1)
RECON_TOL = 1e-3
# the names of each redesigned kernel family's kernels, as the profiler
# shows them
INSERT_KERNELS = ("csvec_insert_bin_records", "csvec_insert_sum_bins")
RING_KERNELS = ("ring_fold_f32", "ring_amax0_int8", "ring_level_int8")
# mlstm_chunk_bwd's kernels, both paths (not the flash backward's)
MLSTM_BWD_KERNELS = (r"(?<!flash_)bwd_(gates|n|states|scores|dn|sweep|dqdk|dv|"
                     r"grads)_(kernel|tc)")
PROFILE_TRIES = 3       # profiles of a timing before a short count is taken
# calls a timing's device profile holds at most (its CUDA-event timing
# runs them all): torch.profiler's records of many calls cost the host
# more than the calls do
PROFILE_CALLS = 50
SPIN_CYCLES = 2_000_000  # about 1 ms of torch.cuda._sleep at 1.98 GHz


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _device_kernels(fn, calls: int) -> dict[str, tuple[int, float]] | None:
    """{kernel name: (records, device us)} that torch.profiler keeps over
    ``calls`` calls of ``fn``, or None if it lost a marker. The profiler
    can miss the kernels of a profile's first milliseconds and pass late
    records of an earlier profile on, so a 1 ms spin kernel and a
    synchronisation lead in, and the calls run between two more spin
    kernels: only the records between those two count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e for e in events if "spin_kernel" in e.name
             and e.time_range.elapsed_us() < 100]
    if len(marks) != 2:
        return None
    t0, t1 = marks[0].time_range.end, marks[1].time_range.start
    out: dict[str, tuple[int, float]] = {}
    for e in events:
        if t0 <= e.time_range.start and e.time_range.end <= t1:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def time_ms(fn, iters: int, warmup: int = 10) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``. Call ms is a mean over
    ``iters`` calls after ``warmup``, from CUDA events around the loop,
    so it includes the host's enqueue time where that is longer (small
    shapes). Device ms sums the kernels that torch.profiler records over
    min(iters, PROFILE_CALLS) calls, a mean a call, and is the call ms
    when it records none. ``time_ms.source`` then says which it is:
    "profile", "scaled" (below) or "call".

    Each kernel's records over those calls must number as many times its
    records in a profile of one call, or both profiles are taken again,
    up to PROFILE_TRIES times: a profile that lost records would
    understate device ms. If the counts never agree, each kernel counts
    as the mean of its kept records times the most records a one-call
    profile kept, and the shortfall is logged."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    calls = min(iters, PROFILE_CALLS)
    per_call: dict[str, int] = {}
    seen = None
    for _ in range(PROFILE_TRIES):
        one, many = _device_kernels(fn, 1), _device_kernels(fn, calls)
        if one is None or many is None:
            continue
        if not one and not many:
            time_ms.source = "call"
            return call_ms, call_ms
        for name, (n, _) in one.items():
            per_call[name] = max(per_call.get(name, 0), n)
        seen = many
        if {k: calls * n for k, n in per_call.items()} == {
                k: n for k, (n, _) in seen.items()}:
            time_ms.source = "profile"
            return sum(us for _, us in seen.values()) / 1e3 / calls, call_ms
    if not seen:
        log(f"time_ms: torch.profiler lost its markers in {PROFILE_TRIES} "
            f"profiles; device ms is the call ms")
        time_ms.source = "call"
        return call_ms, call_ms
    want = {k: per_call.get(k, max(1, round(n / calls))) for k, (n, _)
            in seen.items()}
    log(f"time_ms: torch.profiler kept {sum(n for n, _ in seen.values())} "
        f"kernel records where {calls} calls make "
        f"{calls * sum(want.values())}, in each of {PROFILE_TRIES} tries; "
        f"device ms from the mean of each kernel's kept records")
    time_ms.source = "scaled"
    return sum(us / n * want[k] for k, (n, us) in seen.items()) / 1e3, \
        call_ms


time_ms.source = None


def graph_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Device ms of one call of ``fn`` from a CUDA graph of ``iters``
    calls replayed ``replays`` times between two CUDA events: no host
    enqueue in the timing, for calls whose host time exceeds their
    device time (and where torch.profiler loses its records)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: int, flops: int, d: int, k: int, a_bytes: int):
    """(bound_ms, bound_by) of one sketch update moving ``nbytes`` (each
    input read once, each output written once) and doing ``flops`` of
    products. The products run at the bf16 tensor-core rate with each f32
    operand split into a bf16 high and low part, which keeps the sums
    within the 1e-4 tolerance: two bf16 products per product for bf16 A,
    three for f32 A. The epilogue's 10*d*k flops run at the f32 rate."""
    passes = 2 if a_bytes == 2 else 3
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = passes * flops / PEAK_BF16_FLOP_S + 10 * d * k / PEAK_F32_FLOP_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def measure(name: str, case: dict, kernel, plain, library, bound) -> dict:
    """Hold ``kernel()`` against ``plain()`` (rtol TOL, atol TOL *
    max|plain|) and against a second call of itself (bit for bit: the
    splits are summed in a fixed order), then time the kernel, the plain
    version and the library call."""
    import torch
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for g, h, w in zip(got, again, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale)
        err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, h):
            raise AssertionError(f"{name} {case}: two calls differ")
    ms, call_ms = time_ms(kernel, 200)
    ms_from = time_ms.source
    plain_ms, plain_call_ms = time_ms(plain, 200)
    lib_ms, lib_call_ms = time_ms(library, 200)
    bound_ms, bound_by = bound
    row = dict(case, max_abs_err=err, ms=ms, ms_from=ms_from,
               plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=lib_call_ms)
    log(f"{name} {case}: max_abs_err {err:.3e}  device us: kernel "
        f"{ms * 1e3:.2f} plain {plain_ms * 1e3:.2f} matmul "
        f"{lib_ms * 1e3:.2f} bound {bound_ms * 1e3:.3f} ({bound_by}); per "
        f"call us: kernel {call_ms * 1e3:.2f} plain {plain_call_ms * 1e3:.2f} "
        f"matmul {lib_call_ms * 1e3:.2f}")
    return row


def phase_kernels(dev) -> dict[str, list[dict]]:
    """Each kernel at each case against its plain version, then timed
    beside one torch.matmul of A^T against the (T, 3k) projections."""
    import torch
    from repro_torch.kernels.psparse_update import (
        psparse_dense, psparse_dim, psparse_hash_params, psparse_rows,
        psparse_update, psparse_update_ref,
    )
    from repro_torch.kernels.sketch_update import (
        sketch_update, sketch_update_ref,
    )
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = {"sketch_update": [], "psparse_update": []}
    for label, T, d, k, a_dtype in SKETCH_UPDATE_CASES:
        dtype = getattr(torch, a_dtype)
        a = rand(T, d).to(dtype)
        x, y, z = rand(d, k), rand(d, k), rand(d, k)
        ups, omg, phi, psi = rand(T, k), rand(T, k), rand(T, k), rand(k)
        args = (a, x, y, z, ups, omg, phi, psi)
        pcat = torch.cat([ups, omg, phi], dim=1).to(dtype)
        rows["sketch_update"].append(measure(
            "sketch_update", dict(case=label, T=T, d=d, k=k, a_dtype=a_dtype),
            lambda: sketch_update(*args, beta=0.9),
            lambda: sketch_update_ref(*args, 0.9),
            lambda: torch.matmul(a.t(), pcat),
            bound(T * d * a.element_size() + 3 * T * k * 4 + k * 4
                  + 6 * d * k * 4, 6 * T * d * k, d, k, a.element_size())))
    for label, T, d, k, a_dtype in PSPARSE_CASES:
        dtype = getattr(torch, a_dtype)
        n_tok = PSPARSE_BINDING.get(label, T)
        m = psparse_dim(n_tok, k, DENSITY)
        a = rand(T, d).to(dtype)
        x, y, z, psi = rand(d, k), rand(d, k), rand(d, k), rand(k)
        coeffs = psparse_hash_params(gen)
        while not all(bool((psparse_rows(c, m, n_tok) < T).any())
                      for c in coeffs):
            coeffs = psparse_hash_params(gen)
        dense = psparse_dense(coeffs, n_tok, k, m, dev)
        pcat = torch.cat([dense[n][:T] for n in ("upsilon", "omega", "phi")],
                         dim=1).to(dtype)
        support = [psparse_rows(c, m, n_tok) for c in coeffs]
        read = len(set().union(*(r[r < T].tolist() for r in support)))
        # the slots that add anything: all 3m, or a carry's live ones
        live = sum(int((r < T).sum()) for r in support)
        rows["psparse_update"].append(measure(
            "psparse_update",
            dict(case=label, T=T, d=d, k=k, m=m, num_tokens=n_tok,
                 rows_read=read, live_slots=live, a_dtype=a_dtype),
            lambda: psparse_update(a, x, y, z, coeffs, psi, beta=0.9, m=m,
                                   num_tokens=n_tok),
            lambda: psparse_update_ref(a, x, y, z, coeffs, psi, beta=0.9,
                                       m=m, num_tokens=n_tok),
            lambda: torch.matmul(a.t(), pcat),
            # the distinct support rows this call's coefficients select,
            # psi, the 12 coefficients, the sketches read and written; an
            # FMA a live slot, column and output
            bound(read * d * a.element_size() + k * 4 + 48 + 6 * d * k * 4,
                  2 * live * d * k, d, k, a.element_size())))
    for name, row in _stacked_rows(dev, gen).items():
        rows[name] += row
    return rows


def _stacked_rows(dev, gen) -> dict[str, list[dict]]:
    """The stacked launch at STACKED_CASES: each kernel's one launch over
    E triples against its plain version, timed beside one batched
    torch.bmm of A^T against [Upsilon|Omega|Phi] (psparse: against the
    implicit matrices' first rows, dense) and beside E launches of the
    unstacked kernel, one an expert (``e_launches_ms``)."""
    import torch
    from repro_torch.kernels.psparse_update import (
        psparse_dense, psparse_dim, psparse_hash_params, psparse_rows,
        psparse_update, psparse_update_ref,
    )
    from repro_torch.kernels.sketch_update import (
        sketch_update, sketch_update_ref,
    )

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"sketch_update": [], "psparse_update": []}
    for label, E, R, d, k, a_dtype, n_tok in STACKED_CASES:
        dtype = getattr(torch, a_dtype)
        a = rand(E, R, d).to(dtype)
        x, y, z, psi = rand(E, d, k), rand(E, d, k), rand(E, d, k), \
            rand(E, k)
        ups, omg, phi = rand(R, k), rand(R, k), rand(R, k)
        args = (a, x, y, z, ups, omg, phi)
        pcat = torch.cat([ups, omg, phi], dim=1).to(dtype).expand(E, -1, -1)
        case = dict(case=label, experts=E, T=R, d=d, k=k, a_dtype=a_dtype)
        row = measure(
            "sketch_update (stacked)", case,
            lambda: sketch_update(*args, psi, beta=0.9),
            lambda: sketch_update_ref(*args, psi, 0.9),
            lambda: torch.bmm(a.transpose(1, 2), pcat),
            bound(E * R * d * a.element_size() + 3 * R * k * 4 + E * k * 4
                  + 6 * E * d * k * 4, 6 * E * R * d * k, d, k,
                  a.element_size()))
        row["e_launches_ms"], row["e_launches_call_ms"] = time_ms(
            lambda: [sketch_update(a[e], x[e], y[e], z[e], ups, omg, phi,
                                   psi[e], beta=0.9) for e in range(E)], 20, 2)
        out["sketch_update"].append(row)

        m = psparse_dim(n_tok, k, DENSITY)
        coeffs = psparse_hash_params(gen)
        while not all(bool((psparse_rows(c, m, n_tok) < R).any())
                      for c in coeffs):
            coeffs = psparse_hash_params(gen)
        support = [psparse_rows(c, m, n_tok) for c in coeffs]
        read = len(set().union(*(r[r < R].tolist() for r in support)))
        live = sum(int((r < R).sum()) for r in support)
        dense = psparse_dense(coeffs, n_tok, k, m, dev)
        pdense = torch.cat([dense[n][:R] for n in ("upsilon", "omega",
                                                    "phi")],
                           dim=1).to(dtype).expand(E, -1, -1)
        kw = dict(beta=0.9, m=m, num_tokens=n_tok)
        row = measure(
            "psparse_update (stacked)",
            dict(case, m=m, num_tokens=n_tok, rows_read=read,
                 live_slots=live),
            lambda: psparse_update(a, x, y, z, coeffs, psi, **kw),
            lambda: psparse_update_ref(a, x, y, z, coeffs, psi, **kw),
            lambda: torch.bmm(a.transpose(1, 2), pdense),
            bound(E * read * d * a.element_size() + E * k * 4 + 48
                  + 6 * E * d * k * 4, 2 * E * live * d * k, d, k,
                  a.element_size()))
        row["e_launches_ms"], row["e_launches_call_ms"] = time_ms(
            lambda: [psparse_update(a[e], x[e], y[e], z[e], coeffs, psi[e],
                                    **kw) for e in range(E)], 20, 2)
        out["psparse_update"].append(row)
        log(f"stacked {label}: E launches {row['e_launches_ms'] * 1e3:.2f} "
            f"us (psparse); sketch_update "
            f"{out['sketch_update'][-1]['e_launches_ms'] * 1e3:.2f} us")
    return out


def _cs_rows_only(params, j: int):
    """Hash row ``j`` of (4, r) coefficients as a one-row family."""
    return tuple((row[j],) for row in params)


def _same(got, want) -> bool:
    """Equal, with NaN in the same places (``torch.equal`` holds a NaN
    unequal to itself); for numbers, a NaN equals a NaN."""
    import torch
    if not isinstance(want, torch.Tensor):
        return got == want or (got != got and want != want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


def _bits_equal(got, want) -> bool:
    """f32 equal bit for bit, with NaN in the same places."""
    import torch
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _poison(*tensors) -> None:
    """Leave freed blocks of these tensors' sizes full of 0x7f bytes, so
    that an element a kernel does not write cannot pass as a stale
    result of an earlier call."""
    import torch
    bufs = [torch.full_like(t.view(torch.uint8), 0x7f) for t in tensors]
    del bufs


def _topk_exact(what: str, table, params, n: int, k: int):
    """csvec_topk against csvec_topk_ref on the card: indices equal,
    values equal with NaN in the same places; on the pruned path
    ``prune_stats`` against ``emulate_pruned`` (the thresholds, the
    switches to the unpruned sweep, the coordinates that pass each row
    test). Returns (the stats, the emulation's) or (None, None)."""
    import torch
    from repro_torch.kernels.csvec_topk import (
        csvec_topk, csvec_topk_ref, emulate_pruned, prune_plan, prune_stats,
    )
    got = csvec_topk(table, params, n, k)
    want = csvec_topk_ref(table, params, n, k)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"csvec_topk {what}: indices differ from the "
                             f"plain version")
    if not _same(got[0], want[0]):
        raise AssertionError(f"csvec_topk {what}: values differ from the "
                             f"plain version")
    prune = prune_stats()
    if prune is None:
        return None, None
    _, mirror = emulate_pruned(table, params, n, k,
                               prune_plan(*table.shape, n, k))
    for key in ("tau0", "tau", "dense", "nonfinite", "refine_survivors",
                "survivors"):
        if not _same(prune[key], mirror[key]):
            raise AssertionError(
                f"csvec_topk {what}: {key} {prune[key]} where the plain "
                f"emulation has {mirror[key]}")
    return prune, mirror


# the top-k's non-finite tables: a NaN in a bucket of the seed sample's, a
# NaN only in a bucket no sample coordinate reaches (and some other one
# does), a whole NaN row as the int8 quantiser makes it from one NaN entry,
# an inf in a sample bucket
TOPK_NONFINITE = ("nan_in_sample", "nan_outside", "nan_row", "inf")
# a row amax whose quotient by 127 and product with fl(1/127) round apart
# (1 + 60 ulp, times 1024), planted in the quantiser's non-finite tables
QUANT_SPLIT_AMAX = 1024 + 60 * 2**-13


def _put_nonfinite(table, params, n: int, what: str):
    """``table`` (a copy) with one of TOPK_NONFINITE put into hash row 2
    (or the first row with such a bucket); the sample is the pruned
    path's (the same for even r)."""
    import torch
    from repro_torch.countsketch.csvec import (
        dequantize_table, hash_buckets, quantize_table,
    )
    from repro_torch.kernels.csvec_topk import SAMPLE
    r, c = table.shape
    sample = min(SAMPLE, n // 4)
    bk = hash_buckets(params, c, torch.arange(sample, device=table.device)
                      * (n // sample))
    t = table.clone()
    if what == "nan_in_sample":
        t[2, bk[2, 0]] = float("nan")
    elif what == "nan_outside":
        reach = hash_buckets(params, c, torch.arange(
            min(n, 1 << 22), device=table.device))
        for j in range(r):
            free = torch.ones(c, dtype=torch.bool, device=table.device)
            free[bk[j]] = False
            hit = torch.zeros_like(free)
            hit[reach[j]] = True
            left = torch.nonzero(free & hit)
            if left.numel():
                t[j, int(left[0])] = float("nan")
                break
        del reach
        if not bool(torch.isnan(t).any()):
            raise AssertionError("no bucket outside the sample is reached")
    elif what == "nan_row":
        t[2, 17] = float("nan")
        t = dequantize_table(*quantize_table(t))
    else:
        t[2, bk[2, 0]] = float("inf")
    return t


def _topk_nonfinite_rows(label: str, table, params, n: int,
                         k: int) -> list[dict]:
    """The top-k on ``table`` with each of TOPK_NONFINITE put in, at r
    (pruned for odd r) and, for odd r, on its first r - 1 rows (even r,
    unpruned) and on a flat table of its shape (the dense switch)."""
    import torch
    r = table.shape[0]
    bases = [(f"{label}_r{r}", table, params)]
    if r % 2:
        bases += [(f"{label}_r{r - 1}", table[:r - 1].contiguous(),
                   tuple(row[:r - 1] for row in params)),
                  (f"{label}_flat", torch.full_like(table, 3.0), params)]
    rows = []
    for base, t0, p in bases:
        for what in TOPK_NONFINITE:
            t = _put_nonfinite(t0, p, n, what)
            prune, _ = _topk_exact(f"{base}_{what}", t, p, n, k)
            if prune is not None:      # NaN and inf as text: strict JSON
                prune = {key: v if not isinstance(v, float)
                         or math.isfinite(v) else str(v)
                         for key, v in prune.items()}
            rows.append(dict(case=f"{base}_{what}", r=t.shape[0], n=n, k=k,
                             max_abs_err=0.0, prune=prune, nan_entries=int(
                                 torch.isnan(t).sum())))
            log(f"csvec_topk {rows[-1]}")
            del t
    return rows


def _quant_exact(what: str, table, dhat_only: bool) -> float:
    """csvec_quant against its plain version on the card: q exact, scale
    and dhat bit for bit with NaN in the same places, resid within one
    ulp of the row's amax where finite. Returns the largest resid gap."""
    import torch
    from repro_torch.kernels.csvec_quant import csvec_quant, csvec_quant_ref
    want = csvec_quant_ref(table)
    _poison(*want)
    got = csvec_quant(table, dhat_only=dhat_only)
    torch.cuda.synchronize()
    for g, w, name in zip(got[1:3], want[1:3], ("scale", "dhat")):
        if not _bits_equal(g, w):
            raise AssertionError(f"csvec_quant {what}: {name} differs from "
                                 f"the plain version")
    if dhat_only:
        if got[0] is not None or got[3] is not None:
            raise AssertionError(f"csvec_quant {what}: dhat_only gave q or "
                                 f"resid")
        return 0.0
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"csvec_quant {what}: q differs from the plain "
                             f"version")
    nan = torch.isnan(want[3])
    if not torch.equal(torch.isnan(got[3]), nan):
        raise AssertionError(f"csvec_quant {what}: resid NaN elsewhere")
    amax = table.abs().amax(1, keepdim=True)
    ulp = torch.nextafter(amax, torch.full_like(amax, float("inf"))) - amax
    fin = ~nan & torch.isfinite(ulp).expand_as(nan)
    gap = (got[3] - want[3]).abs()
    if bool((gap > ulp)[fin].any()):
        raise AssertionError(f"csvec_quant {what}: resid off by more than "
                             f"one ulp of the row amax")
    return float(gap[fin].max()) if bool(fin.any()) else 0.0


def _quant_nonfinite(table):
    """A copy of ``table`` with QUANT_SPLIT_AMAX as row 0's last entry (its
    amax), NaN in row 1 and as the last row's last entry, inf and -inf
    elsewhere."""
    r, c = table.shape
    t = table.clone()
    t[0, -1] = QUANT_SPLIT_AMAX
    t[1 % r, c // 2] = float("nan")
    t[1 % r, c // 2 + 1] = float("inf")
    t[r - 1, c - 1] = float("nan")
    t[r - 1, 0] = float("inf")
    t[3 % r, c // 3] = float("-inf")
    return t


def phase_cs_kernels(dev) -> dict[str, list[dict]]:
    """csvec_insert, csvec_topk and csvec_quant at each CS_CASES geometry
    against their plain versions, then timed beside the library yardstick
    and their bounds. The bounds count each input byte read once and each
    output written once at 3.35 TB/s, and the f32 operations at 67 TFLOP/s
    (insert: the r n signed adds; top-k: the r sign products, the median
    network's compare-exchanges and the absolute value of each estimate;
    quant: six a counter); the integer hash arithmetic is not counted, as
    the data sheet gives no integer ALU rate. For top-k the r n random
    gathers at 32 bytes a sector are reported beside (gather_bound_ms);
    on the pruned path (odd r) its threshold tau0 and the count of
    coordinates that pass the row test must equal the plain emulation's
    (``emulate_pruned``), and the row gives tau0's rank (the coordinates
    with |estimate| >= tau0), the pass rate and the gathers made."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.countsketch.csvec import (
        CSVec, dequantize_table, hash_buckets, hash_params, hash_signs,
        query, quantize_table,
    )
    from repro_torch.kernels.csvec_insert import (
        csvec_insert, csvec_insert_ref, insert_plan,
    )
    from repro_torch.kernels.csvec_quant import csvec_quant, csvec_quant_ref
    from repro_torch.kernels.csvec_topk import csvec_topk, csvec_topk_ref
    from repro_torch.models.transformer import num_params

    def chunks(n):
        for a in range(0, n, 1 << 24):
            yield a, min(a + (1 << 24), n)

    def bytes_or_ops(nbytes, flops):
        t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
        return (t_b * 1e3, "bytes") if t_b >= t_o else (t_o * 1e3,
                                                       "operations")

    rows = {"csvec_insert": [], "csvec_topk": [], "csvec_quant": []}
    for label, r, c, n, ks in CS_CASES:
        n = n or num_params(get_arch("tinyllama-1.1b"))
        params = hash_params(torch.Generator().manual_seed(r * 31 + c % 97), r)
        vec = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(
            7), device=dev)
        zeros = torch.zeros((r, c), device=dev)
        big = n > 10**6
        it, plain_it = (3, 1) if big else (200, 20)
        case = dict(case=label, r=r, c=c, n=n)

        # insert, and r index_add_ calls over precomputed buckets and
        # signed values, one row at a time
        plan = insert_plan(n, r, c)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = csvec_insert(zeros, params, vec)
        torch.cuda.synchronize()
        # the scratch and the output table a call adds to what it is given
        call_peak = torch.cuda.max_memory_allocated() - before
        table = csvec_insert_ref(zeros, params, vec)
        torch.cuda.synchronize()
        scale = float(table.abs().max())
        torch.testing.assert_close(got, table, rtol=TOL, atol=TOL * scale)
        seen = _device_kernels(lambda: csvec_insert(zeros, params, vec), 1)
        kernels = kernel_ms = None
        if seen is not None:      # launches and device ms of each kernel
            kernels = sum(k for name, (k, _) in seen.items()
                          if any(n in name for n in INSERT_KERNELS))
            kernel_ms = {k: sum(us for name, (_, us) in seen.items()
                                if k in name) / 1e3
                         for k in INSERT_KERNELS}
        if kernels is not None and kernels != plan.kernels:
            raise AssertionError(f"csvec_insert {label}: one call launched "
                                 f"{kernels} kernels, not {plan.kernels}")
        ms, call_ms = time_ms(lambda: csvec_insert(zeros, params, vec), it, 1)
        plain_ms, plain_call_ms = time_ms(
            lambda: csvec_insert_ref(zeros, params, vec), plain_it, 0)
        lib_ms = lib_call_ms = 0.0
        for j in range(r):
            pj = _cs_rows_only(params, j)
            bj = torch.empty(n, dtype=torch.int32, device=dev)
            svj = torch.empty(n, dtype=torch.float32, device=dev)
            for a, b in chunks(n):
                idx = torch.arange(a, b, device=dev)
                bj[a:b] = hash_buckets(pj, c, idx)[0]
                svj[a:b] = hash_signs(pj, idx)[0] * vec[a:b]
            row = torch.zeros(c, device=dev)
            m1, m2 = time_ms(lambda: row.index_add_(0, bj, svj), it, 1)
            lib_ms, lib_call_ms = lib_ms + m1, lib_call_ms + m2
            del bj, svj
        rows["csvec_insert"].append(dict(
            case, max_abs_err=float((got - table).abs().max()),
            err_of_allowance=float(((got - table).abs() / (
                TOL * (scale + table.abs()))).max()),
            scratch_bytes=plan.scratch_bytes, call_peak_bytes=call_peak,
            chunks=plan.chunks, bins=plan.nbins, kernels_per_call=kernels,
            kernel_ms=kernel_ms,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, call_ms=call_ms,
            plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms,
            **dict(zip(("bound_ms", "bound_by"),
                       bytes_or_ops(4 * n + 8 * r * c, 2 * r * n)))))
        log(f"csvec_insert {rows['csvec_insert'][-1]}")
        del got

        # top-k of the inserted table, and torch.topk of |estimate|
        mag = torch.empty(n, device=dev)
        cs = CSVec(table=table, params=params, dim=n)
        for a, b in chunks(n):
            mag[a:b] = query(cs, torch.arange(a, b, device=dev)).abs()
        for k in ks:
            prune, mirror = _topk_exact(f"{label} k={k}", table, params, n,
                                        k)
            if prune is not None:
                prune.update(
                    tau0_rank=int((mag >= prune["tau0"]).sum()),
                    tau_rank=int((mag >= prune["tau"]).sum()),
                    coarse_tests=mirror["coarse_tests"],
                    fine_tests=mirror["fine_tests"],
                    gathers=r * (prune["survivors"] + prune["sample"]
                                 + prune["refine_survivors"]))
            ms, call_ms = time_ms(lambda: csvec_topk(table, params, n, k),
                                  it, 1)
            plain_ms, plain_call_ms = time_ms(
                lambda: csvec_topk_ref(table, params, n, k), plain_it, 0)
            lib_ms, lib_call_ms = time_ms(lambda: torch.topk(mag, k), it, 1)
            flops = n * (r + 2 * (r * (r - 1) // 2) + 1 + (2 if r % 2 == 0
                                                            else 0))
            rows["csvec_topk"].append(dict(
                case, case_k=f"{label}_k{k}", k=k, max_abs_err=0.0, ms=ms,
                prune=prune,
                plain_ms=plain_ms, library_ms=lib_ms, call_ms=call_ms,
                plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms,
                gather_bound_ms=r * n * 32 / PEAK_BYTES_S * 1e3,
                **dict(zip(("bound_ms", "bound_by"),
                           bytes_or_ops(4 * r * c + 12 * k, flops)))))
            log(f"csvec_topk {rows['csvec_topk'][-1]}")
        del mag, vec
        # the same search on tables that hold a NaN or an inf
        rows["csvec_topk"] += _topk_nonfinite_rows(label, table, params, n,
                                                   ks[0])

        # quantisation of the inserted table, in both forms, beside
        # fake_quantize_per_channel_affine with the scale precomputed (the
        # dhat half of the function)
        scale = csvec_quant_ref(table)[1]
        zero_point = torch.zeros(r, dtype=torch.int32, device=dev)
        lib_ms, lib_call_ms = time_ms(
            lambda: torch.fake_quantize_per_channel_affine(
                table, scale, zero_point, 0, -127, 127), it * 10, 1)
        for dhat_only in (False, True):
            err = _quant_exact(label, table, dhat_only)
            ms, call_ms = time_ms(
                lambda: csvec_quant(table, dhat_only=dhat_only), it * 10, 1)
            # a table of a block a row: its device time from a graph (one
            # launch, no handoff, so it can be captured)
            graph = None if big else graph_ms(
                lambda: csvec_quant(table, dhat_only=dhat_only))
            plain_ms, plain_call_ms = time_ms(
                (lambda: dequantize_table(*quantize_table(table)))
                if dhat_only else (lambda: csvec_quant_ref(table)),
                plain_it * 10, 1)
            rows["csvec_quant"].append(dict(
                case, case=label + ("_dhat_only" if dhat_only else ""),
                dhat_only=dhat_only, max_abs_err=err, ms=ms, graph_ms=graph,
                plain_ms=plain_ms, library_ms=lib_ms, call_ms=call_ms,
                plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms,
                **dict(zip(("bound_ms", "bound_by"), bytes_or_ops(
                    (8 if dhat_only else 13) * r * c + 4 * r, 6 * r * c)))))
            log(f"csvec_quant {rows['csvec_quant'][-1]}")
        # and with NaN, inf and -inf in its rows
        bad = _quant_nonfinite(table)
        for dhat_only in (False, True):
            rows["csvec_quant"].append(dict(
                case, case=label + "_nonfinite" + (
                    "_dhat_only" if dhat_only else ""), dhat_only=dhat_only,
                max_abs_err=_quant_exact(f"{label} nonfinite", bad,
                                         dhat_only)))
            log(f"csvec_quant {rows['csvec_quant'][-1]}")
        del bad, scale, table, zeros
        torch.cuda.empty_cache()
    return rows


def flash_pairs(S: int, window: int | None) -> int:
    """Live (query, key) pairs of one causal head: sum_i min(i + 1, w)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(B, Hq, Hkv, S, D, window, elem: int, backward: bool):
    """(bound_ms, bound_by): 4 D operations a live pair forward, 10 D
    backward, at the bf16 tensor-core rate for bf16 and the f32 rate for
    f32; bytes of q, k, v, o, lse (and do, dq, dk, dv backward) once."""
    flops = (10 if backward else 4) * D * flash_pairs(S, window) * B * Hq
    q_bytes, kv_bytes = B * Hq * S * D * elem, B * Hkv * S * D * elem
    lse_bytes = B * Hq * S * 4
    nbytes = (4 * q_bytes + 4 * kv_bytes if backward
              else 2 * q_bytes + 2 * kv_bytes) + lse_bytes
    rate = PEAK_BF16_FLOP_S if elem == 2 else PEAK_F32_FLOP_S
    t_b, t_o = nbytes / PEAK_BYTES_S, flops / rate
    return (t_b * 1e3, "bytes") if t_b >= t_o else (t_o * 1e3, "operations")


def _sdpa(q, k, v, window):
    """The library yardstick: one scaled_dot_product_attention call (a
    boolean mask for a window, which takes SDPA off its flash backend)."""
    import torch
    import torch.nn.functional as F
    if window is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    S = q.shape[2]
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=(rel >= 0) & (rel < window), enable_gqa=True)


def _flash_check(what: str, got, want) -> dict:
    """Hold ``got`` against ``want``: f32 results (lse in both types)
    within TOL of max|want|, bf16 o, dq, dk and dv within
    ``flash_attention.BF16_TOL`` of each row's own scale
    (``flash_attention.bf16_gaps``). Returns the max abs error, the gap
    (max|got - want| over max|want| in f32, over the row's scale in bf16)
    and the largest share of its allowance that an element used (the
    readings BF16_TOL rests on)."""
    import torch
    from repro_torch.kernels.flash_attention import bf16_gaps
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        gap, used = bf16_gaps(got, want)
        if not used <= 1:
            raise AssertionError(f"{what}: an element used {used:.3g} of "
                                 f"its BF16_TOL allowance (row gap "
                                 f"{gap:.3g}, max abs error {err:.3g})")
        return dict(err=err, gap=gap, used=used)
    scale = float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    used = float((diff / (TOL * scale + TOL * want.float().abs())).max())
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL,
                               atol=TOL * scale,
                               msg=lambda m: f"{what}: {m}")
    return dict(err=err, gap=err / scale, used=used)


def phase_flash(dev) -> dict[str, list[dict]]:
    """The flash forward and backward at each FLASH_CASES shape against
    their plain versions (the backward's given the kernel's o and lse),
    then timed beside their bounds, the plain versions and SDPA (its
    gradient through torch.autograd.grad for the backward). Inputs lie
    as the model's do: (B, S, H, D) storage read as (B, H, S, D)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain,
    )
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {"flash_attention": [], "flash_attention_bwd": []}
    encode_us = _flash_encode_us(dev)
    for label, B, Hq, Hkv, S, D, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)

        def rand(H):
            return torch.randn((B, S, H, D), generator=gen, device=dev).to(
                dtype).transpose(1, 2)

        q, k, v, do = rand(Hq), rand(Hkv), rand(Hkv), rand(Hq)
        kw = dict(window=window)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        o_p, lse_p = flash_attention_plain(q, k, v, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        grads_p = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        what = f"flash {label}"
        checks = {"o": _flash_check(f"{what} o", o, o_p),
                  "lse": _flash_check(f"{what} lse", lse, lse_p)}
        for n, g, w in zip(("dq", "dk", "dv"), grads, grads_p):
            checks[n] = _flash_check(f"{what} {n}", g, w)
        # no atomics: a second backward gives the same bits
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"{what}: two backward calls differ")
        del again
        fwd_err = max(checks["o"]["err"], checks["lse"]["err"])
        bwd_err = max(checks[n]["err"] for n in ("dq", "dk", "dv"))
        gaps = {n: (c["gap"], c["used"]) for n, c in checks.items()}
        lib_err = float((_sdpa(q, k, v, window).float() - o_p.float())
                        .abs().max())
        del o_p, lse_p, grads, grads_p
        big = S >= 1024
        it, plain_it = (20, 3) if big else (200, 20)
        case = dict(case=label, B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, window=window,
                    dtype=dt, live_pairs_a_head=flash_pairs(S, window),
                    gap_to_plain=gaps, encode_us_a_map=encode_us)
        timed = {}
        timed["fwd"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                               it, 3)
        timed["fwd_plain"] = time_ms(
            lambda: flash_attention_plain(q, k, v, **kw), plain_it, 1)
        timed["fwd_lib"] = time_ms(lambda: _sdpa(q, k, v, window), it, 3)
        timed["bwd"] = time_ms(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), it, 3)
        timed["bwd_plain"] = time_ms(
            lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
            plain_it, 1)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = _sdpa(*leaves, window)
        timed["bwd_lib"] = time_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), it, 3)
        del out, leaves
        for name, pre, err, backward in (
                ("flash_attention", "fwd", fwd_err, False),
                ("flash_attention_bwd", "bwd", bwd_err, True)):
            bound_ms, bound_by = flash_bound(B, Hq, Hkv, S, D, window,
                                             q.element_size(), backward)
            (ms, call_ms), (plain_ms, plain_call_ms), (lib_ms, lib_call_ms) \
                = timed[pre], timed[f"{pre}_plain"], timed[f"{pre}_lib"]
            flops = ((10 if backward else 4) * D * flash_pairs(S, window)
                     * B * Hq)
            rows[name].append(dict(
                case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflop_s=flops / (ms * 1e-3) / 1e12,
                share_of_bound=bound_ms / ms,
                call_ms=call_ms, plain_call_ms=plain_call_ms,
                library_call_ms=lib_call_ms,
                **({} if backward else dict(library_max_abs_diff=lib_err))))
            log(f"{name} {json.dumps(rows[name][-1])}")
        torch.cuda.empty_cache()
    return rows


def _flash_encode_us(dev) -> float:
    """Host microseconds to encode one TMA tensor map, as the bf16 flash
    calls do three (forward) or four to eight (backward: four at head_dim
    64, where both passes share them) times: the mean of 2000 encodes of
    tinyllama-1.1b's q at B 4 x S 2048."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _bind, _strides
    q = torch.empty((4, 2048, 32, 64), dtype=torch.bfloat16,
                    device=dev).transpose(1, 2)
    lib = _build.load("flash_attention", _bind)
    us = lib.flash_attention_encode_us(q.data_ptr(), 4, 32, 2048, 64,
                                       _strides(q), 2000)
    if us < 0:
        raise AssertionError("cuTensorMapEncodeTiled refused q's map")
    log(f"flash: {us:.3f} us to encode a tensor map")
    return us


def phase_saved_bytes(dev, B=4, Hq=32, Hkv=4, S=2048, D=64) -> dict:
    """The bytes autograd keeps for one attention call, by default at
    tinyllama-1.1b's context (B 4, S 2048, 32/4 heads, D 64, bf16, the
    model's layout): through the plain version, differentiated by
    autograd, and through the kernels' Function, which must keep q, k, v,
    o and lse and nothing with two dimensions of S or more."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2).requires_grad_(True)
        for H in (Hq, Hkv, Hkv))

    def saved(fn):
        seen = {}

        def pack(t):
            seen[(t.data_ptr(), tuple(t.shape), t.dtype)] = (
                tuple(t.shape), t.numel() * t.element_size())
            # a saved output returned as-is would reference its own
            # grad_fn: a cycle through C++ that gc cannot free
            return t.detach()

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        del out
        torch.cuda.synchronize()
        return list(seen.values())

    plain = saved(lambda: flash_attention_plain(q, k, v)[0])
    kernel = saved(lambda: flash_attention(q, k, v))
    torch.cuda.empty_cache()
    want = sorted([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                   (B, Hq, S, D), (B, Hq, S)])
    if sorted(shape for shape, _ in kernel) != want or any(
            sum(n >= S for n in shape) > 1 for shape, _ in kernel):
        raise AssertionError(f"the flash Function saved {kernel}")
    out = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D,
               plain_bytes=sum(n for _, n in plain),
               plain_tensors=len(plain),
               plain_largest=max(plain, key=lambda x: x[1]),
               kernel_bytes=sum(n for _, n in kernel),
               kernel_shapes=[shape for shape, _ in kernel])
    log("saved bytes: " + json.dumps(out))
    return out


def mlstm_bound(B, H, S, Dk, Dv, W, elem: int,
                tensor_cores: bool) -> tuple[float, str, float]:
    """(bound_ms, bound_by, f32_bound_ms). Operations: W (W + 1) (Dk +
    Dv) + 4 W Dk Dv a chunk of a (b, h) (causal q k^T and s v, q C and
    the C update), each product counted once, at the bf16 rate on the
    tensor-core path and at the f32 rate (the FMA kernels' arithmetic;
    f32_bound_ms on both paths). The tensor-core kernels split s, C and
    w v into bf16 hi and lo, two products each: the design's own work,
    not in the bound. Bytes: q, k, v read once in their type, li and lf
    in f32, h, C, n, m written once in f32."""
    nc = S // W
    flops = B * H * nc * (W * (W + 1) * (Dk + Dv) + 4 * W * Dk * Dv)
    nbytes = (B * H * S * (2 * Dk + Dv) * elem + 2 * B * H * S * 4
              + 4 * B * H * (S * Dv + Dk * Dv + Dk + 1))
    t_b = nbytes / PEAK_BYTES_S
    t_f32 = max(t_b, flops / PEAK_F32_FLOP_S)
    t_o = flops / (PEAK_BF16_FLOP_S if tensor_cores else PEAK_F32_FLOP_S)
    return (t_b * 1e3, "bytes", t_f32 * 1e3) if t_b >= t_o else (
        t_o * 1e3, "operations", t_f32 * 1e3)


def phase_mlstm(dev) -> dict[str, list[dict]]:
    """mlstm_chunk at each MLSTM_CASES shape, f32 and bf16 inputs, against
    its plain version (h, C, n within TOL * max|plain|, m within TOL),
    then timed beside its bound and the plain version. No one PyTorch call
    computes the function: library_ms is None. Inputs lie as the model's
    do: v a (B, H, S, Dv) view of (B, S, H, Dv) storage. Each row names
    the path its call took (``uses_tensor_cores``)."""
    import torch
    from repro_torch.kernels.mlstm_chunk import (
        mlstm_chunk, mlstm_chunk_plain, uses_tensor_cores,
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, B, H, S, Dk, Dv, chunk in MLSTM_CASES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)

            def rand(*shape):
                return torch.randn(shape, generator=gen, device=dev)

            q, k = rand(B, H, S, Dk).to(dtype), rand(B, H, S, Dk).to(dtype)
            v = rand(B, S, H, Dv).to(dtype).transpose(1, 2)
            li = rand(B, H, S) * 0.5
            lf = torch.nn.functional.logsigmoid(rand(B, H, S) + 2.0)
            args = (q, k, v, li, lf)
            got = mlstm_chunk(*args, chunk=chunk)
            want = mlstm_chunk_plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for name, g, w in zip(("h", "C", "n", "m"), (got[0],) + got[1],
                                  (want[0],) + want[1]):
                scale = 1.0 if name == "m" else float(w.abs().max())
                torch.testing.assert_close(
                    g, w, rtol=TOL, atol=TOL * scale,
                    msg=lambda m, n=name: f"mlstm {label} {dt} {n}: {m}")
                abs_errs[name] = float((g - w).abs().max())
                errs[name] = abs_errs[name] / max(scale, 1e-30)
            del got, want
            big = S >= 512
            it, plain_it = (10, 3) if big else (200, 20)
            ms, call_ms = time_ms(lambda: mlstm_chunk(*args, chunk=chunk),
                                  it, 2)
            plain_ms, plain_call_ms = time_ms(
                lambda: mlstm_chunk_plain(*args, chunk=chunk), plain_it, 1)
            tc = uses_tensor_cores(q, k, v, chunk)
            bound_ms, bound_by, f32_bound_ms = mlstm_bound(
                B, H, S, Dk, Dv, min(chunk, S), q.element_size(), tc)
            # each kernel's device us a call (None: markers lost)
            split = _device_kernels(lambda: mlstm_chunk(*args, chunk=chunk),
                                    3) if big else None
            rows.append(dict(
                case=f"{label}_{'f32' if dt == 'float32' else 'bf16'}",
                B=B, H=H, S=S, Dk=Dk, Dv=Dv, W=min(chunk, S), dtype=dt,
                path="tensor_cores" if tc else "fma",
                rel_err=errs, abs_err=abs_errs,
                max_abs_err=max(abs_errs.values()), ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, f32_bound_ms=f32_bound_ms,
                call_ms=call_ms, plain_call_ms=plain_call_ms,
                us_by_kernel=split and {
                    (re.search(r"mlstm_[a-z]+_(kernel|tc)", n) or [n])[0]:
                    us / 3 for n, (_, us) in split.items()}))
            log(f"mlstm_chunk {json.dumps(rows[-1])}")
            del q, k, v, li, lf, args
            torch.cuda.empty_cache()
    return {"mlstm_chunk": rows}


def _wrappers() -> dict:
    from repro_torch.kernels.csvec_insert import csvec_insert
    from repro_torch.kernels.csvec_quant import csvec_quant
    from repro_torch.kernels.csvec_topk import csvec_topk
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd,
    )
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_bwd
    from repro_torch.kernels.psparse_update import psparse_update
    from repro_torch.kernels.ring_allreduce import ring_allreduce
    from repro_torch.kernels.sketch_update import sketch_update
    return {"sketch_update": sketch_update, "psparse_update": psparse_update,
            "csvec_insert": csvec_insert, "csvec_topk": csvec_topk,
            "csvec_quant": csvec_quant,
            "flash_attention": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "mlstm_chunk": mlstm_chunk, "mlstm_chunk_bwd": mlstm_chunk_bwd,
            "ring_allreduce": ring_allreduce}


def reset_counts() -> None:
    """Every kernel's launch counts to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["sketch_update"].kernel_launches = 0
    _wrappers()["psparse_update"].kernel_launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def check_counts(what: str, got: dict, want: dict) -> None:
    """``got`` must equal ``want``, the kernels ``want`` omits at 0."""
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")


def _finite_tree(tree) -> bool:
    import torch
    node = tree.nodes["res"]
    return all(bool(torch.isfinite(t).all()) for t in (node.x, node.y, node.z))


def phase_serve(dev, cfg, batch: int, prompt_len: int, new_tokens: int,
                refill_len: int, max_context: int,
                draw_in_dtype: bool = False) -> dict:
    """The serving path: monitored serving, counted, against monitor off;
    then the same with psparse monitor projections, counted too. The
    weights are cast to the compute type once, so every engine shares
    them; with ``draw_in_dtype`` they are drawn in it (qwen3-moe's 30.5 B
    parameters would take 122 GB in f32). An MoE arch also reports the
    share of its routed choices that capacity dropped in one prefill and
    one decode step (``moe_drops``)."""
    import gc
    import torch
    from repro_torch.kernels.psparse_update import psparse_update
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.models import rglru, ssm
    from repro_torch.models.transformer import (
        ATTN_KINDS, cast_params, init_params,
    )
    from repro_torch.serve import ServeEngine
    from repro_torch.telemetry import TelemetryLog, read_jsonl

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cast_params(init_params(gen, dataclasses.replace(
        cfg, param_dtype=cfg.dtype) if draw_in_dtype else cfg), cfg.dtype,
        dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    refill_prompt = torch.randint(0, cfg.vocab_size, (refill_len,),
                                  generator=gen, device=dev)

    def engine(monitor, tlog=None, proj_kind="gaussian"):
        return ServeEngine(cfg=cfg, params=params, max_context=max_context,
                           monitor=monitor, device=dev, telemetry_log=tlog,
                           monitor_proj_kind=proj_kind)

    # warm-up: library handles and the kernels' first load
    engine(True).generate(prompts, 2)
    engine(True, proj_kind="psparse").generate(prompts, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    OUT_DIR.mkdir(exist_ok=True)
    tpath = OUT_DIR / f"chip_smoke_serve_{cfg.name}.jsonl"
    with TelemetryLog(str(tpath)) as tlog:
        eng = engine(True, tlog)
        reset_counts()
        toks = eng.generate(prompts, new_tokens)
        t0 = time.perf_counter()
        eng.refill(1, refill_prompt)
        torch.cuda.synchronize()
        refill_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        kernel_launches = sketch_update.kernel_launches
        tlog.append(eng.telemetry_record())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # an update a layer each token step (prefill, decodes, refill); a
    # flash forward an attention layer and an mlstm_chunk an mLSTM layer
    # each prefill and refill, none a decode
    want = cfg.num_layers * (1 + (new_tokens - 1) + 1)
    kinds = cfg.layer_types
    flash = {"flash_attention": 2 * sum(k in ATTN_KINDS for k in kinds),
             "mlstm_chunk": 2 * kinds.count("mlstm")}
    check_counts(f"serve {cfg.name} (gaussian monitor)", launches,
                 {"sketch_update": want, **flash})
    mon = eng._slots["mon"]
    if not _finite_tree(mon.tree):
        raise AssertionError("non-finite monitor sketches")
    if not bool(torch.isfinite(eng.last_logits.float()).all()):
        raise AssertionError("non-finite decode logits")
    if tuple(toks.shape) != (batch, new_tokens):
        raise AssertionError(f"tokens of shape {tuple(toks.shape)}")

    off = engine(False)
    toks_off = off.generate(prompts, new_tokens)
    off.refill(1, refill_prompt)
    tok_off = off._slots["tok"].clone()
    if not torch.equal(toks, toks_off) or \
            not torch.equal(eng._slots["tok"], tok_off):
        raise AssertionError("monitor on/off changed the generated tokens")

    _, recs = read_jsonl(str(tpath))
    if len(recs) != 2 or len(recs[-1].nodes) != cfg.num_layers:
        raise AssertionError("telemetry did not round-trip through JSONL")

    # the psparse monitor: same prompts, its own kernel, same tokens
    ps_eng = engine(True, proj_kind="psparse")
    reset_counts()
    ps_toks = ps_eng.generate(prompts, new_tokens)
    ps_eng.refill(1, refill_prompt)
    torch.cuda.synchronize()
    ps_launches = read_counts()
    ps_kernel_launches = psparse_update.kernel_launches
    check_counts(f"serve {cfg.name} (psparse monitor)", ps_launches,
                 {"psparse_update": want, **flash})
    if not _finite_tree(ps_eng._slots["mon"].tree):
        raise AssertionError("non-finite psparse monitor sketches")
    if not torch.equal(ps_toks, toks_off) or \
            not torch.equal(ps_eng._slots["tok"], tok_off):
        raise AssertionError("the psparse monitor changed the tokens")
    ps_flags = ps_eng.telemetry_record().flags

    # prefill on the host's clock: one more warm-up of each engine, then
    # PREFILL_SAMPLES prefills each, alternating on and off; the median
    prefill = {True: [], False: []}
    for rep in range(PREFILL_SAMPLES + 1):
        for on, e in ((True, eng), (False, off)):
            torch.cuda.synchronize()
            before = e.spans["prefill"]
            e.start(prompts)
            if rep:
                prefill[on].append((e.spans["prefill"] - before) * 1e3)

    # the recurrences' share of one more prefill of the unmonitored
    # engine: each sLSTM layer's loop, or each RG-LRU layer's scan, timed
    # between two synchronisations
    shares = {}
    for kind, module, fn in (("slstm", ssm, "slstm_apply"),
                             ("rglru", rglru, "rglru_scan")):
        if kind not in kinds:
            continue
        inner, spent = getattr(module, fn), []

        def timed(*a, inner=inner, spent=spent, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = inner(*a, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)
            return res

        setattr(module, fn, timed)
        try:
            torch.cuda.synchronize()
            before = off.spans["prefill"]
            off.start(prompts)
            total = off.spans["prefill"] - before
        finally:
            setattr(module, fn, inner)
        shares[kind] = dict(layers=len(spent), ms=sum(spent) * 1e3,
                            ms_a_layer=sum(spent) * 1e3 / len(spent),
                            prefill_ms=total * 1e3, share=sum(spent) / total)

    drops = _moe_drops(off, prompts) if cfg.is_moe else None
    decode_steps = new_tokens - 1
    out = dict(
        arch=cfg.name, batch=batch, prompt_len=prompt_len,
        new_tokens=new_tokens, refill_len=refill_len,
        prefill_ms=statistics.median(prefill[True]),
        prefill_ms_monitor_off=statistics.median(prefill[False]),
        prefill_ms_samples=prefill[True],
        prefill_ms_samples_monitor_off=prefill[False],
        decode_tok_s=batch * decode_steps / eng.spans["decode"],
        decode_ms_per_step=eng.spans["decode"] * 1e3 / decode_steps,
        refill_ms=refill_ms, peak_mem_gib=peak_gib,
        decode_tok_s_monitor_off=batch * decode_steps / off.spans["decode"],
        decode_tok_s_psparse=batch * decode_steps / ps_eng.spans["decode"],
        launches=launches, kernel_launches=kernel_launches,
        psparse_launches=ps_launches,
        psparse_kernel_launches=ps_kernel_launches, flags=recs[-1].flags,
        psparse_flags=ps_flags, moe_drops=drops,
        slstm_prefill=shares.get("slstm"),
        rglru_scan_prefill=shares.get("rglru"),
        phase_s=time.perf_counter() - t_phase)
    log(f"serve {cfg.name}: " + json.dumps(out))
    del eng, off, ps_eng, params
    return out


def _moe_drops(eng, prompts) -> dict:
    """The share of routed (token, choice) assignments that capacity
    dropped, over the MoE layers of one more prefill and one decode step
    of ``eng``: each ``dispatch_meta`` call's dropped slots read back."""
    import torch
    from repro_torch.models import moe
    inner, seen = moe.dispatch_meta, []

    def counted(tope, E, C):
        res = inner(tope, E, C)
        seen.append((int((res[2] == E * C).sum()), tope.numel(), C))
        return res

    moe.dispatch_meta = counted
    out = {}
    try:
        for what, fn in (("prefill", lambda: eng.start(prompts)),
                         ("decode", eng.decode_step)):
            seen.clear()
            fn()
            torch.cuda.synchronize()
            dropped, total = (sum(v[i] for v in seen) for i in (0, 1))
            out[what] = dict(dropped=dropped, assignments=total,
                             share=dropped / total, capacity=seen[0][2],
                             layers=len(seen))
    finally:
        moe.dispatch_meta = inner
    return out


def train_run(dev, cfg, scfg, variant: str, steps: int, batches, *,
              eval_batch=None, epoch: int = 0) -> dict:
    """One counted, timed run of ``train``: launch counts from 0, per-step
    host time (each step ends in the loss's device sync), peak memory."""
    import torch
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.models.mlp import mlp_init
    from repro_torch.train.paper_trainer import accuracy, train

    stamps = []

    def batch_fn(s):
        stamps.append(time.perf_counter())
        return batches[s]

    eval_fn = None
    if eval_batch is not None:
        def eval_fn(params):
            return {"test_acc": accuracy(params, cfg, *eval_batch)}
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mlp_init(gen, cfg)          # one init for every variant
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = train(cfg, scfg, variant, steps=steps, batch_fn=batch_fn,
                eval_fn=eval_fn, steps_per_epoch=epoch or steps,
                adaptive=AdaptiveConfig(r0=scfg.rank, r_max=scfg.max_rank),
                params=params, device=dev)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    launches = read_counts()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    losses = [h["loss"] for h in res.history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name} {variant}: non-finite loss")
    return dict(res=res, launches=launches, losses=losses,
                ranks=[h["rank"] for h in res.history],
                step_ms=statistics.median(step_ms[1:]),
                peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20)


def _kernel_of(proj_kind: str) -> str:
    return "psparse_update" if proj_kind == "psparse" else "sketch_update"


def _expected_counts(variant: str, proj_kind: str, total: int) -> dict:
    want = {"sketch_update": 0, "psparse_update": 0}
    if variant != "standard":
        want[_kernel_of(proj_kind)] = total
    return want


def phase_train_mnist(dev) -> dict:
    """MNIST_MLP (784 -> 512 x3 -> 10, tanh, batch 128) in every ported
    variant with each projection kind, counted: 3 sketch updates a step
    for the sketch-keeping variants, all through the kernel of the
    projection kind. The sketched variants must learn, and the monitor
    variant must leave the parameters equal to standard's."""
    import torch
    from repro_torch.configs.paper import MNIST_MLP
    from repro_torch.data.synthetic import (
        class_prototypes, classification_batch,
    )
    from repro_torch.launch.paper import run_settings

    cfg = MNIST_MLP
    noise = run_settings("mnist_mlp", cfg.batch_size, "gaussian")[1]
    gen = torch.Generator(device=dev).manual_seed(100)
    protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
    test = classification_batch(gen, protos, 2048, noise)
    batches = [classification_batch(gen, protos, cfg.batch_size, noise)
               for _ in range(MNIST_STEPS)]
    out = {}
    for proj_kind in PROJ_KINDS:
        scfg = run_settings("mnist_mlp", cfg.batch_size, proj_kind)[0]
        # warm-up: the kernels' load and the solver libraries' handles
        train_run(dev, cfg, scfg, "sketched_fixed", 3, batches)
        runs = {}
        for variant in VARIANTS:
            r = train_run(dev, cfg, scfg, variant, MNIST_STEPS, batches,
                          eval_batch=test, epoch=MNIST_EPOCH)
            check_counts(f"mnist_mlp {variant} {proj_kind}", r["launches"],
                         _expected_counts(variant, proj_kind,
                                          cfg.num_hidden_layers * MNIST_STEPS))
            if variant.startswith("sketched"):
                first = statistics.mean(r["losses"][:10])
                last = statistics.mean(r["losses"][-10:])
                if not last < first:
                    raise AssertionError(
                        f"mnist_mlp {variant} {proj_kind} did not learn: "
                        f"mean loss {first:.4f} -> {last:.4f}")
            runs[variant] = r
        for a, b in zip(runs["standard"]["res"].params,
                        runs["monitor"]["res"].params):
            for key in a:
                torch.testing.assert_close(a[key], b[key], rtol=0, atol=1e-6)
        for variant, r in runs.items():
            acc = r["res"].history[-1].get("test_acc")
            out[f"{variant}/{proj_kind}"] = dict(
                step_ms=r["step_ms"], peak_mem_mib=r["peak_mem_mib"],
                launches=r["launches"], loss_first10=statistics.mean(
                    r["losses"][:10]),
                loss_last10=statistics.mean(r["losses"][-10:]),
                test_acc=acc, final_rank=r["ranks"][-1],
                ranks_seen=sorted(set(r["ranks"])))
            log(f"mnist_mlp {variant} {proj_kind}: " + json.dumps(
                out[f"{variant}/{proj_kind}"]))
    return out


def phase_monitor_pair(dev) -> dict:
    """MONITOR_HEALTHY and MONITOR_PROBLEMATIC (784 -> 1024 x15 -> 10,
    relu) in the monitor variant with psparse projections, counted: 15
    psparse updates a step. Prints each run's pathology flags."""
    import torch
    from repro_torch.configs.paper import MONITOR_HEALTHY, MONITOR_PROBLEMATIC
    from repro_torch.core.monitor import detect_pathologies
    from repro_torch.data.synthetic import (
        class_prototypes, classification_batch,
    )
    from repro_torch.launch.paper import run_settings
    from repro_torch.sketches import node_paths
    from repro_torch.telemetry import flag_paths

    out = {}
    for name, cfg in (("monitor_healthy", MONITOR_HEALTHY),
                      ("monitor_problematic", MONITOR_PROBLEMATIC)):
        scfg, noise = run_settings(name, cfg.batch_size, "psparse")
        gen = torch.Generator(device=dev).manual_seed(11)
        protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
        batches = [classification_batch(gen, protos, cfg.batch_size, noise)
                   for _ in range(MONITOR_STEPS)]
        train_run(dev, cfg, scfg, "monitor", 3, batches)       # warm-up
        r = train_run(dev, cfg, scfg, "monitor", MONITOR_STEPS, batches)
        check_counts(f"{cfg.name} monitor psparse", r["launches"],
                     {"sketch_update": 0, "psparse_update":
                      cfg.num_hidden_layers * MONITOR_STEPS})
        res = r["res"]
        k = 2 * int(res.sketch.rank) + 1
        flags = flag_paths(detect_pathologies(res.monitor, k),
                           node_paths(res.sketch))
        out[cfg.name] = dict(
            step_ms=r["step_ms"], peak_mem_mib=r["peak_mem_mib"],
            launches=r["launches"], loss_first=r["losses"][0],
            loss_last=r["losses"][-1],
            flags={n: len(p) for n, p in sorted(flags.items())})
        print(f"{cfg.name} pathology flags (layers of "
              f"{cfg.num_hidden_layers}): {json.dumps(out[cfg.name]['flags'])}",
              flush=True)
        log(f"{cfg.name}: " + json.dumps(out[cfg.name]))
    return out


def _well_posed_psparse(cfg, scfg):
    """psparse projections whose three implicit matrices have full rank
    over the active columns, and the seed that drew them. The reference's
    multiply-shift signs are rank-deficient there for most draws, and a
    rank-deficient sketch leaves the reconstruction to rounding, which no
    two devices share."""
    import torch
    from repro_torch.sketches import init_psparse_projections
    k_active = scfg.k0
    for seed in range(10_000):
        gen = torch.Generator().manual_seed(seed)
        proj = init_psparse_projections(gen, cfg.batch_size, scfg.k_max,
                                        scfg.proj_density)
        if all(int(torch.linalg.matrix_rank(proj[n][:, :k_active]))
               == k_active for n in ("upsilon", "omega", "phi")):
            return proj, seed
    raise AssertionError("no well-posed psparse projections in 10000 draws")


def phase_train_device_vs_cpu(dev) -> dict:
    """A reduced MLP in f32: one sketched_fixed step's gradients and new
    tree, and the reconstruction of its first node in both modes, on the
    card and on the CPU from the same weights, tree and batch, with each
    projection kind. Tree within TOL; gradients and reconstruction
    factors within RECON_TOL (rtol, and atol times max|CPU|)."""
    import torch
    from repro_torch.configs.paper import MLPConfig
    from repro_torch.core.reconstruct import reconstruct
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.sketches import tree_to
    from repro_torch.models.mlp import mlp_init
    from repro_torch.train.paper_trainer import (
        ce_loss, init_mlp_sketch, sketched_forward,
    )

    cfg = MLPConfig(name="reduced", d_in=64, d_hidden=96, d_out=10,
                    num_hidden_layers=3, batch_size=64)
    out = {}
    for proj_kind in PROJ_KINDS:
        scfg = SketchConfig(rank=3, max_rank=6, beta=0.9, batch_size=64,
                            recon_mode="fast", proj_kind=proj_kind)
        gen = torch.Generator().manual_seed(5)
        params = mlp_init(gen, cfg)
        tree = init_mlp_sketch(gen, cfg, scfg, "sketched_fixed")
        seed = None
        if proj_kind == "psparse":
            proj, seed = _well_posed_psparse(cfg, scfg)
            tree = dataclasses.replace(tree, proj=proj)
        x = torch.randn((cfg.batch_size, cfg.d_in), generator=gen)
        y = torch.randint(0, cfg.d_out, (cfg.batch_size,), generator=gen)

        def drive(device):
            live = [{k: v.detach().to(device).requires_grad_(True)
                     for k, v in p.items()} for p in params]
            sk = tree_to(tree, device)
            logits, new = sketched_forward(live, x.to(device), sk, cfg, scfg,
                                           "sketched_fixed")
            loss = ce_loss(logits, y.to(device))
            grads = torch.autograd.grad(
                loss, [p[k] for p in live for k in sorted(p)])
            node = new.nodes["hidden"]
            recs = [reconstruct(node.x[0], node.y[0], node.z[0],
                                new.proj["omega"], new.k_active, mode=mode)
                    for mode in ("fast", "faithful")]
            return ([t.detach().cpu() for t in grads],
                    [t.cpu() for t in (node.x, node.y, node.z)],
                    [t.cpu() for r in recs for t in (r.left, r.right)])

        grads_d, tree_d, rec_d = drive(dev)
        grads_c, tree_c, rec_c = drive("cpu")
        errs = {}
        for what, got, want, tol in (("tree", tree_d, tree_c, TOL),
                                     ("grads", grads_d, grads_c, RECON_TOL),
                                     ("reconstruct", rec_d, rec_c,
                                      RECON_TOL)):
            err = 0.0
            for g, w in zip(got, want):
                scale = float(w.abs().max())
                torch.testing.assert_close(g, w, rtol=tol, atol=tol * scale)
                err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
            errs[what] = err
        out[proj_kind] = dict(max_rel_err=errs, psparse_seed=seed)
        log(f"train device vs cpu ({proj_kind}): " + json.dumps(out[proj_kind]))
    return out


def phase_lm_step_device_vs_cpu(dev) -> dict:
    """One LM train step's loss and gradients in f32 with plain backprop
    (the sketched FFN's reconstruction is phase 6's first half), on the
    card and on the CPU from the same weights and batch: reduced
    tinyllama at S 80, not a multiple of the attention kernels' 64-row
    tiles, and reduced gemma3 at S 80, past its 32-token window. Within
    TOL * max|CPU| each; the card's step counted."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.models.transformer import SketchSettings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.train.state import RunConfig, init_train_state
    from repro_torch.train.step import make_train_step

    B, S = 2, 80
    out = {}
    for name in ("tinyllama-1.1b", "gemma3-27b"):
        cfg = reduced(get_arch(name))
        run = RunConfig(seq_len=S, global_batch=B,
                        optimizer=AdamWConfig(lr=3e-4), warmup_steps=1,
                        total_steps=1, sketch=SketchSettings(enabled=False))
        pipe = PipelineConfig(seed=1, global_batch=B, seq_len=S,
                              vocab=cfg.vocab_size)
        tokens, labels = host_batch(pipe, 0)
        cpu = init_train_state(0, cfg, run, device="cpu")

        def loss_and_grads(where):
            state = init_train_state(0, cfg, run, device=where,
                                     params=cpu.params)
            reset_counts()
            loss, _, _, grads, _ = make_train_step(cfg, run).loss_and_grads(
                state, {"tokens": tokens.to(where),
                        "labels": labels.to(where)})
            torch.cuda.synchronize()
            return ([loss.cpu()] + [g.cpu() for g in tree_leaves(grads)],
                    read_counts())

        got, launches = loss_and_grads(dev)
        want, _ = loss_and_grads(torch.device("cpu"))
        check_counts(f"lm step {cfg.name}", launches,
                     {"flash_attention": cfg.num_layers,
                      "flash_attention_bwd": cfg.num_layers})
        err = 0.0
        for g, w in zip(got, want):
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale)
            err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
        out[cfg.name] = dict(S=S, window=cfg.window_size,
                             loss=float(want[0]), max_rel_err=err,
                             launches=launches)
        log(f"lm step device vs cpu ({cfg.name}): " + json.dumps(
            out[cfg.name]))
    return out


def _lm_run_config(mode: str, proj_kind: str, steps: int,
                   batch: int = LM_BATCH, seq: int = LM_SEQ):
    from repro_torch.models.transformer import SketchSettings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.train.state import RunConfig
    ckw = LM_MODES[mode]
    # as launch/train.py builds it: lr 3e-4, k_max 17, warmup
    # min(20, steps // 5 + 1)
    return RunConfig(
        seq_len=seq, global_batch=batch,
        optimizer=AdamWConfig(lr=3e-4),
        warmup_steps=min(20, steps // 5 + 1), total_steps=steps,
        sketch=SketchSettings(enabled=True, k_max=17, proj_kind=proj_kind),
        compression=CompressionConfig(**ckw) if ckw else None)


def _mass_check(dev, cfg, run, state, step, batch) -> dict:
    """One more step's gradients through the compression by hand: the
    insert kernel against its plain version on the real v_pre, and
    v_new + update == v_pre exactly away from the sent coordinates."""
    import torch
    from repro_torch.kernels.csvec_insert import csvec_insert, csvec_insert_ref
    from repro_torch.models.transformer import flat_paths
    from repro_torch.optim.flat import FlatLayout
    from repro_torch.optim.sketched_sgd import (
        countsketch_finish, countsketch_local,
    )
    from repro_torch.train.state import finalize_run

    comp = finalize_run(cfg, run).compression
    layout = FlatLayout(state.params, flat_paths(state.params, cfg))
    grads = step.loss_and_grads(state, batch)[3]
    local = countsketch_local(grads, state.opt["err"], comp, layout)
    del grads
    v_pre = local.v_pre.clone()
    zeros = torch.zeros((comp.cs_rows, comp.cs_cols), device=dev)
    got = csvec_insert(zeros, local.cs.params, v_pre)
    want = csvec_insert_ref(zeros, local.cs.params, v_pre)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * scale)
    insert_err = float((got - want).abs().max())
    del got, want
    update_tree, err, _ = countsketch_finish(local, local.cs)
    update = layout.ravel(update_tree)
    del update_tree
    sent = update != 0
    n_sent = int(sent.sum())
    total = err["v"] + update
    if not torch.equal(torch.where(sent, v_pre, total), v_pre):
        raise AssertionError("v_new + update != v_pre away from the sent "
                             "coordinates")
    torch.testing.assert_close(total[sent], v_pre[sent], rtol=1e-6,
                               atol=1e-6 * float(v_pre[sent].abs().max()))
    if n_sent != comp.cs_k or bool(err["u"][sent].any()):
        raise AssertionError(f"{n_sent} coordinates sent, u not zeroed")
    return dict(sent=n_sent, insert_max_abs_err=insert_err,
                insert_scale=scale)


def _nan_guard_check(state, step, batch, want: dict) -> dict:
    """The NaN guard at full width, as tests/test_torch_lm_train.py's
    ``test_nan_guard_keeps_the_old_state_and_counts_a_skip`` holds it on
    the CPU: one ``w_down`` entry set to NaN, then one step. The loss is
    not finite, the skip is counted, the step advances, and the
    parameters (the NaN included), u, v, every sketch node, AdamW's
    count and the sketch's step stay as they were. The step launches
    what a compressed step launches (``want``): the insert of a NaN
    gradient, the quantiser and the top-k on a table of NaN."""
    import torch
    from repro_torch.optim.flat import FlatLayout
    state.params["layers"][0]["mlp"]["w_down"][0, 0] = float("nan")
    before = FlatLayout(state.params).ravel(state.params).clone()
    u, v = state.opt["err"]["u"].clone(), state.opt["err"]["v"].clone()
    nodes = {name: [t.clone() for t in (n.x, n.y, n.z)]
             for name, n in state.sketch.nodes.items()}
    count, skipped = int(state.opt["count"]), state.skipped
    at, sketch_at = state.step, state.sketch.step
    reset_counts()
    new, m = step(state, batch)
    launches = read_counts()
    torch.cuda.synchronize()
    check_counts("nan guard step", launches, want)
    checks = dict(
        loss_not_finite=not math.isfinite(float(m["loss"])),
        skip_counted=new.skipped == m["skipped_total"] == skipped + 1,
        step_advanced=new.step == at + 1,
        params=_same(FlatLayout(new.params).ravel(new.params), before),
        u=torch.equal(new.opt["err"]["u"], u),
        v=torch.equal(new.opt["err"]["v"], v),
        adamw_count=int(new.opt["count"]) == count,
        sketch=all(torch.equal(a, b) for name, n in new.sketch.nodes.items()
                   for a, b in zip((n.x, n.y, n.z), nodes[name])),
        sketch_step=new.sketch.step == sketch_at)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"nan guard step: {failed} do not hold")
    out = dict(checks, loss=str(float(m["loss"])), launches=launches)
    del new, before, u, v, nodes
    return out


def _profile_step(state, step, batch, top: int = 15, groups=None):
    """One more train step under torch.profiler, recording the card's
    kernels only: the step's wall time (inflated by the profiler), the
    kernels' device time in all, and the kernels that took most of it
    (device ms and launches by name); for each {label: regex} of
    ``groups``, the device ms and share of the kernels whose names match.
    A spin kernel and a synchronisation lead in, as in
    ``_device_kernels``. The caller sets ``idle_share`` against its
    median step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and "spin_kernel" not in ev.key:
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    attention_ms = sum(ms for n, ms, _ in rows if "flash_" in n)
    # the EMA update kernels and the sum of their splits
    update_ms = sum(ms for n, ms, _ in rows if "sketch_update" in n
                    or "psparse_update" in n or "ema::" in n)
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               attention_ms=attention_ms,
               attention_share=attention_ms / max(device_ms, 1e-9),
               update_ms=update_ms,
               update_share=update_ms / max(device_ms, 1e-9),
               top=[dict(name=n[:120], ms=ms, calls=c)
                    for n, ms, c in rows[:top]])
    for label, pattern in (groups or {}).items():
        hit = [(ms, c) for n, ms, c in rows if re.search(pattern, n)]
        out[f"{label}_ms"] = sum(ms for ms, _ in hit)
        out[f"{label}_calls"] = sum(c for _, c in hit)
        out[f"{label}_share"] = out[f"{label}_ms"] / max(device_ms, 1e-9)
    return state, out


def lm_run(dev, cfg, mode: str, proj_kind: str, steps: int,
           batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """One counted, timed run of ``steps`` train steps of (batch, seq)
    from a fresh state: per-step host time (each step ends in the loss's
    device sync), peak memory, launches; then, with compression, the
    mass check on one more step."""
    import gc
    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    # what earlier phases left in reference cycles would count in the peak
    gc.collect()
    torch.cuda.empty_cache()
    left_mib = torch.cuda.memory_allocated() / 2**20
    run = _lm_run_config(mode, proj_kind, steps, batch, seq)
    pipe = PipelineConfig(seed=0, global_batch=batch, seq_len=seq,
                          vocab=cfg.vocab_size)
    state = init_train_state(0, cfg, run, device=dev)
    step = make_train_step(cfg, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, skipped, stamps = [], [], [time.perf_counter()]
    for s in range(steps):
        tokens, labels = host_batch(pipe, s, device=dev)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        skipped.append(m["skipped_total"])
        stamps.append(time.perf_counter())
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    what = f"lm {mode} {proj_kind} B={batch} S={seq}"
    kernel = "psparse_update" if proj_kind == "psparse" else "sketch_update"
    want = {kernel: 2 * cfg.num_layers * steps,
            "flash_attention": cfg.num_layers * steps,
            "flash_attention_bwd": cfg.num_layers * steps}
    if run.compression is not None:
        want.update(csvec_insert=steps, csvec_topk=steps)
        if run.compression.wire_dtype == "int8":
            want["csvec_quant"] = steps
    check_counts(what, launches, want)
    if not all(math.isfinite(v) for v in losses) or skipped[-1]:
        raise AssertionError(f"{what}: losses {losses}, skipped {skipped[-1]}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    out = dict(batch=batch, seq=seq, steps=steps,
               step_ms=statistics.median(step_ms[1:]),
               step_ms_samples=step_ms, peak_mem_mib=peak,
               allocated_before_mib=left_mib,
               launches=launches, launches_per_step={
                   k: v / steps for k, v in launches.items()},
               losses=losses, loss_first5=statistics.mean(losses[:5]),
               loss_last5=statistics.mean(losses[-5:]), skipped=skipped[-1])
    tokens, labels = host_batch(pipe, steps, device=dev)
    state, out["profile"] = _profile_step(state, step, {"tokens": tokens,
                                                        "labels": labels})
    # the share of a median step the card spends on no kernel
    out["profile"]["idle_share"] = max(
        0.0, 1 - out["profile"]["device_ms"] / out["step_ms"])
    if run.compression is not None:
        from repro_torch.kernels.csvec_topk import prune_stats
        # the pruned search on the last step's table, a real gradient's
        out["topk_prune"] = prune_stats()
        tokens, labels = host_batch(pipe, steps + 1, device=dev)
        out["mass_check"] = _mass_check(
            dev, cfg, run, state, step, {"tokens": tokens, "labels": labels})
        tokens, labels = host_batch(pipe, steps + 2, device=dev)
        out["nan_guard"] = _nan_guard_check(
            state, step, {"tokens": tokens, "labels": labels},
            {k: v // steps for k, v in want.items()})
        log(f"{what}: nan guard {json.dumps(out['nan_guard'])}")
    log(f"{what}: " + json.dumps({k: v for k, v in out.items()
                                  if k not in ("step_ms_samples", "losses")}))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lm_train(dev) -> dict:
    """tinyllama-1.1b at full width: the three LM_MODES with Gaussian
    projections for LM_STEPS steps (the compressed ones LM_CS_STEPS),
    then LM_PSPARSE_STEPS steps with
    psparse projections, then LM_CTX_STEPS steps without compression at
    B LM_CTX_BATCH x S LM_CTX_SEQ, whose peak must stay under 80 GB.
    Without compression the loss must fall at S LM_SEQ."""
    from repro_torch.configs import get_arch
    cfg = get_arch("tinyllama-1.1b")
    out = {f"{mode}/gaussian": lm_run(
        dev, cfg, mode, "gaussian", LM_STEPS if mode == "none" else
        LM_CS_STEPS) for mode in LM_MODES}
    base = out["none/gaussian"]
    if not base["loss_last5"] < base["loss_first5"]:
        raise AssertionError(
            f"lm without compression did not learn: mean loss "
            f"{base['loss_first5']:.4f} -> {base['loss_last5']:.4f}")
    out["none/psparse"] = lm_run(dev, cfg, "none", "psparse",
                                 LM_PSPARSE_STEPS)
    # at the model's own context: the plain attention's S x chunk
    # intermediates would not fit; the kernels save o and lse only
    ctx = lm_run(dev, cfg, "none", "gaussian", LM_CTX_STEPS, LM_CTX_BATCH,
                 LM_CTX_SEQ)
    if ctx["peak_mem_mib"] * 2**20 >= PEAK_LIMIT_BYTES:
        raise AssertionError(f"lm at S={LM_CTX_SEQ}: peak "
                             f"{ctx['peak_mem_mib']:.0f} MiB over 80 GB")
    out[f"none/gaussian/B{LM_CTX_BATCH}xS{LM_CTX_SEQ}"] = ctx
    return out


def phase_launcher(dev) -> dict:
    """``python -m repro_torch.launch.train --reduced --compress
    countsketch`` (its ``main``, on the CUDA device) for 6 steps,
    checkpointing every 3 into a temporary directory."""
    import tempfile
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train as train_launcher

    steps, layers = 6, reduced(get_arch("tinyllama-1.1b")).num_layers
    with tempfile.TemporaryDirectory() as ckpt_dir:
        reset_counts()
        state, hist = train_launcher.main([
            "--reduced", "--compress", "countsketch", "--steps", str(steps),
            "--ckpt-every", "3", "--ckpt-dir", ckpt_dir])
        launches = read_counts()
        saved = sorted(os.listdir(ckpt_dir))
    check_counts("launcher", launches, {"sketch_update": 2 * layers * steps,
                                        "csvec_insert": steps,
                                        "csvec_topk": steps,
                                        "flash_attention": layers * steps,
                                        "flash_attention_bwd": layers * steps})
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or state.skipped or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"launcher: {len(hist)} steps, losses {losses}")
    if saved != ["step_0000000003", "step_0000000006"]:
        raise AssertionError(f"launcher checkpoints {saved}")
    out = dict(steps=steps, losses=losses, launches=launches,
               checkpoints=saved, device=str(state.params["embed"][
                   "embedding"].device))
    log("launcher: " + json.dumps(out))
    return out


# the ring all-reduce: the grid of tests/test_ring.py's sizes and a
# million elements at W 2, 3, 4 and 8, both wires, then the DP runs'
# full-width buffers (run (a)'s fused dense buffer at W 4 on the fp32
# wire; run (b)'s sketch increments at W 2 on the int8 wire and its
# gradient wire, the count-sketch table and four scalars, at W 2 on the
# fp32 wire)
RING_WORKERS = (2, 3, 4, 8)
RING_SIZES = (3, 129, 1000, 1_048_576)
# the DP runs: tinyllama-1.1b at full width, global B 8 x S 128, W workers
# in one process: (a) fused, fp32 sketch wire, ring, dense gradients; (b)
# overlap, int8 sketch wire, ring, an fp32 count sketch with p2 = 2 (its
# per-worker {u, v} are 8.8 GB a worker, so W 2)
DP_RUNS = {"fused_w4": dict(workers=4, dp_collective="fused",
                            sketch_wire_dtype="fp32", compression=None),
           "overlap_w2": dict(workers=2, dp_collective="overlap",
                              sketch_wire_dtype="int8",
                              compression=dict(mode="countsketch",
                                               cs_p2=2))}
DP_STEPS = 10


def ring_bound(W: int, N: int, wire: str, replicas: bool
               ) -> tuple[float, str]:
    """The bytes the call must move at 3.35 TB/s: the W shards read once,
    the merged vector written once (to each of the W replica rows when
    ``replicas``), and on the int8 wire the W residual rows written once:
    (4 W + 4) N on the fp32 wire as the DP step calls it, (8 W + 4) N on
    the int8 wire."""
    out_rows = (W if replicas else 1) + (W if wire == "int8" else 0)
    return 4 * (W + out_rows) * N / PEAK_BYTES_S * 1e3, "bytes"


def _ring_kernels_per_call(fn) -> int | None:
    """The ring kernels (by name) in a profile of one call of ``fn``, or
    None if the profiler lost its markers."""
    seen = _device_kernels(fn, 1)
    if seen is None:
        return None
    return sum(n for name, (n, _) in seen.items()
               if any(k in name for k in RING_KERNELS))


def _ring_shards(dev, W: int, N: int, seed: int):
    """test_ring.py's draw: standard normal rows times 10^U{-3..3} per
    worker (numpy for the grid; on the card for the full-width sizes)."""
    import numpy as np
    import torch
    if N <= RING_SIZES[-1]:
        rng = np.random.default_rng(seed)
        xs = (rng.standard_normal((W, N)) * 10.0 ** rng.integers(
            -3, 4, size=(W, 1))).astype(np.float32)
        return torch.from_numpy(xs).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((W, N), generator=gen, device=dev)
    xs *= 10.0 ** torch.randint(-3, 4, (W, 1), generator=gen, device=dev)
    return xs


def _ring_case(dev, label: str, W: int, N: int, wire: str, seed: int,
               iters: int) -> dict:
    """The kernel against its plain version, bit for bit (every replica
    and residual row, with and without ``replicas``; the plain version
    on the CPU for the grid, on the card at full width), the int8
    ledger, the kernels one call launches against ``kernels_per_call``,
    then the timings: the DP step's call (device 0's replica) beside
    ``xs.sum(0)`` and the bound of what it writes, and the call that
    writes every replica beside its own bound."""
    import torch
    from repro_torch.kernels.ring_allreduce import (
        kernels_per_call, ring_allreduce, ring_allreduce_plain,
    )
    xs = _ring_shards(dev, W, N, seed)
    where = xs.device if N > RING_SIZES[-1] else torch.device("cpu")
    want_y, want_res = ring_allreduce_plain(xs.to(where), wire)
    y, res = ring_allreduce(xs, wire, replicas=True)
    torch.cuda.synchronize()
    for d in range(W):
        if not torch.equal(y[d].to(where), want_y):
            raise AssertionError(f"ring {label}: replica {d} differs from "
                                 f"the plain version")
    if not torch.equal(res.to(where), want_res):
        raise AssertionError(f"ring {label}: residuals differ")
    ledger = 0.0
    if wire == "int8":
        total = xs.double().sum(0)
        led = y[0].double() + res.double().sum(0)
        ledger = float((led - total).abs().max())
        limit = 8 * W * float(xs.abs().max()) * 2.0 ** -24
        if ledger > limit:
            raise AssertionError(f"ring {label}: ledger off by {ledger:.3e}"
                                 f" > {limit:.3e}")
        del total, led
    del y, res
    torch.cuda.empty_cache()
    y, res = ring_allreduce(xs, wire)
    torch.cuda.synchronize()
    if not (torch.equal(y.to(where), want_y)
            and torch.equal(res.to(where), want_res)):
        raise AssertionError(f"ring {label}: device 0's replica or the "
                             f"residuals differ without replicas")
    del y, res, want_y, want_res
    torch.cuda.empty_cache()
    kernels = _ring_kernels_per_call(lambda: ring_allreduce(xs, wire))
    if kernels is not None and kernels != kernels_per_call(W, wire):
        raise AssertionError(f"ring {label}: one call launched {kernels} "
                             f"kernels, not {kernels_per_call(W, wire)}")
    ms, call_ms = time_ms(lambda: ring_allreduce(xs, wire), iters, 2)
    rep_ms, rep_call_ms = time_ms(
        lambda: ring_allreduce(xs, wire, replicas=True), iters, 2)
    plain_ms, plain_call_ms = time_ms(
        lambda: ring_allreduce_plain(xs, wire), iters, 2)
    lib_ms = lib_call_ms = None
    if wire == "fp32":
        lib_ms, lib_call_ms = time_ms(lambda: xs.sum(0), iters, 2)
    bound_ms, bound_by = ring_bound(W, N, wire, False)
    row = dict(case=label, W=W, N=N, wire=wire, max_abs_err=0.0,
               ledger_max_abs=ledger, kernels_per_call=kernels, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by, replicas_ms=rep_ms,
               replicas_bound_ms=ring_bound(W, N, wire, True)[0],
               call_ms=call_ms, replicas_call_ms=rep_call_ms,
               plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms)
    log(f"ring_allreduce {json.dumps(row)}")
    del xs
    torch.cuda.empty_cache()
    return row


def phase_ring(dev) -> dict[str, list[dict]]:
    """ring_allreduce at the grid and at the DP runs' full-width buffers:
    bitwise against its plain version, replicas equal, the int8 ledger
    dequant(y) + sum_d res_d = sum_d x_d within 8 W ulps of the largest
    shard element, the kernels a call launches; timed (CUDA events and
    torch.profiler) as the DP step calls it and with every replica,
    each beside the bound of what it writes, its plain version and, on
    the fp32 wire, ``xs.sum(0)``."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import num_params, sketch_groups
    from repro_torch.optim.compression import (
        CompressionConfig, resolve_countsketch,
    )
    rows = []
    for W in RING_WORKERS:
        for N in RING_SIZES:
            for wire in ("fp32", "int8"):
                rows.append(_ring_case(dev, f"W{W}_N{N}_{wire}", W, N, wire,
                                       W * 7 + N, 20 if N > 10**5 else 100))
    cfg = get_arch("tinyllama-1.1b")
    sketch = sum(3 * cfg.num_layers * w * 17
                 for w in sketch_groups(cfg).values())
    fused, overlap = DP_RUNS["fused_w4"], DP_RUNS["overlap_w2"]
    cs = resolve_countsketch(CompressionConfig(**overlap["compression"]),
                             num_params(cfg))
    # the segments n (1), scalars (3) and the sketch or the table
    rows.append(_ring_case(dev, "fused_w4_fp32", fused["workers"],
                           num_params(cfg) + sketch + 4, "fp32", 11, 3))
    rows.append(_ring_case(dev, "overlap_w2_int8", overlap["workers"],
                           sketch, "int8", 12, 20))
    rows.append(_ring_case(dev, "overlap_w2_cs_fp32", overlap["workers"],
                           cs.cs_rows * cs.cs_cols + 4, "fp32", 13, 20))
    for W in (2, 4):
        for N in (1000, RING_SIZES[-1]):
            for kind in ("nan", "inf"):
                rows.append(_ring_nonfinite_case(dev, W, N, kind))
    return {"ring_allreduce": rows}


def _ring_nonfinite_case(dev, W: int, N: int, kind: str) -> dict:
    """The int8 ring with a NaN or an inf in one worker's row (in the
    first chunk and at the ragged end): y, every replica and every
    residual row equal to the plain version's (on the CPU) with NaN in
    the same places, with and without replicas."""
    import torch
    from repro_torch.kernels.ring_allreduce import (
        ring_allreduce, ring_allreduce_plain,
    )
    xs = _ring_shards(dev, W, N, W * 11 + N)
    xs[1, 17] = xs[W - 1, N - 1] = float(kind)
    want_y, want_res = ring_allreduce_plain(xs.cpu(), "int8")
    for replicas in (True, False):
        y, res = ring_allreduce(xs, "int8", replicas=replicas)
        torch.cuda.synchronize()
        if not (all(_same(row.cpu(), want_y) for row in y.reshape(-1, N))
                and _same(res.cpu(), want_res)):
            raise AssertionError(f"ring W{W} N{N} int8 {kind}: differs from "
                                 f"the plain version (replicas={replicas})")
    row = dict(case=f"W{W}_N{N}_int8_{kind}", W=W, N=N, wire="int8",
               max_abs_err=0.0, nan_y=int(torch.isnan(want_y).sum()),
               nan_res=int(torch.isnan(want_res).sum()))
    log(f"ring_allreduce {json.dumps(row)}")
    return row


def _dp_run_config(kind: str, steps: int, batch: int = LM_BATCH,
                   seq: int = LM_SEQ):
    from repro_torch.models.transformer import SketchSettings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.train.state import RunConfig
    spec = dict(DP_RUNS[kind])
    comp = spec.pop("compression")
    workers = spec.pop("workers")
    return RunConfig(
        seq_len=seq, global_batch=batch, optimizer=AdamWConfig(lr=3e-4),
        warmup_steps=min(20, steps // 5 + 1), total_steps=steps,
        sketch=SketchSettings(enabled=True, k_max=17),
        compression=CompressionConfig(**comp) if comp else None,
        dp_axis_name="data", dp_workers=workers, ring_wire=True, **spec)


def _dp_expected(run, layers: int, steps: int) -> dict:
    """Launches of ``steps`` DP steps: each worker's sketched forward
    updates 2 nodes a layer (the overlap's increment sweep; its second
    forward consumes the merged tree), one flash forward a layer a
    forward, one backward a layer; a compressed step inserts each
    worker's table and takes one top-k; the ring merges once (fused) or
    twice (overlap: the int8 sketch, then the fp32 gradient wire)."""
    W, overlap = run.dp_workers, run.dp_collective == "overlap"
    want = {"sketch_update": 2 * layers * W * steps,
            "flash_attention": (2 if overlap else 1) * layers * W * steps,
            "flash_attention_bwd": layers * W * steps,
            "ring_allreduce": (2 if overlap else 1) * steps}
    if run.compression is not None:
        want.update(csvec_insert=W * steps, csvec_topk=steps)
    return want


def _capture_int8_ring():
    """Wrap the step's flat-segment merge so that its int8 ring calls keep
    a copy of their inputs (the workers' adjusted increments) and their
    output. Returns (the record, a function undoing the wrap)."""
    from repro_torch.optim.flat import tree_map
    from repro_torch.train import step as step_mod
    orig = step_mod.psum_flat_segments
    seen: dict = {}

    def wrapped(trees, **kw):
        if kw.get("ring") == "int8":
            trees = [tree_map(lambda t: t.clone(), t) for t in trees]
            seen["in"], seen["out"] = trees, orig(trees, **kw)
            return seen["out"]
        return orig(trees, **kw)

    step_mod.psum_flat_segments = wrapped
    return seen, lambda: setattr(step_mod, "psum_flat_segments", orig)


def _ledger_check(seen: dict) -> dict:
    """merged + sum_w residual_w = the f32 sum of the workers' adjusted
    increments, within 8 W ulps of their largest element, leaf by leaf."""
    import torch
    from repro_torch.optim.flat import get_path, leaf_paths
    trees, (merged, res) = seen["in"], seen["out"]
    W = len(trees)
    worst = 0.0
    for p in leaf_paths(merged):
        xs = torch.stack([get_path(t, p) for t in trees]).double()
        led = get_path(merged, p).double() + get_path(res, p).double().sum(0)
        err = float((led - xs.sum(0)).abs().max())
        limit = 8 * W * float(xs.abs().max()) * 2.0 ** -24
        if err > limit:
            raise AssertionError(f"sketch wire ledger {p}: {err:.3e} > "
                                 f"{limit:.3e}")
        worst = max(worst, err / max(float(xs.abs().max()), 1e-30))
    return dict(leaves=len(leaf_paths(merged)), max_err_of_max=worst)


def dp_run(dev, cfg, kind: str, steps: int = DP_STEPS,
           batch: int = LM_BATCH, seq: int = LM_SEQ) -> dict:
    """One counted, timed run of the W-worker DP step from a fresh state,
    as ``lm_run``; then, on the int8 sketch wire, one more step whose
    ring inputs and output are held to the ledger, and one profiled."""
    import gc
    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_dp_train_step

    gc.collect()
    torch.cuda.empty_cache()
    run = _dp_run_config(kind, steps, batch, seq)
    pipe = PipelineConfig(seed=0, global_batch=batch, seq_len=seq,
                          vocab=cfg.vocab_size)
    state = init_train_state(0, cfg, run, device=dev)
    step = make_dp_train_step(cfg, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, stamps = [], [time.perf_counter()]
    for s in range(steps):
        tokens, labels = host_batch(pipe, s, device=dev)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        stamps.append(time.perf_counter())
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    what = f"dp {kind} W={run.dp_workers} B={batch} S={seq}"
    check_counts(what, launches, _dp_expected(run, cfg.num_layers, steps))
    if not all(math.isfinite(v) for v in losses) or state.skipped:
        raise AssertionError(f"{what}: losses {losses}, skipped "
                             f"{state.skipped}")
    if peak * 2**20 >= PEAK_LIMIT_BYTES:
        raise AssertionError(f"{what}: peak {peak:.0f} MiB over 80 GB")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    out = dict(workers=run.dp_workers, layout=run.dp_collective,
               sketch_wire=run.sketch_wire_dtype, ring_wire=True,
               compression=DP_RUNS[kind]["compression"], batch=batch,
               seq=seq, steps=steps, step_ms=statistics.median(step_ms[1:]),
               step_ms_samples=step_ms, peak_mem_mib=peak, launches=launches,
               losses=losses, loss_first5=statistics.mean(losses[:5]),
               loss_last5=statistics.mean(losses[-5:]))
    if not out["loss_last5"] < out["loss_first5"]:
        raise AssertionError(f"{what} did not learn: mean loss "
                             f"{out['loss_first5']:.4f} -> "
                             f"{out['loss_last5']:.4f}")
    if run.sketch_wire_dtype == "int8":
        seen, undo = _capture_int8_ring()
        try:
            tokens, labels = host_batch(pipe, steps, device=dev)
            state, _ = step(state, {"tokens": tokens, "labels": labels})
            out["ledger"] = _ledger_check(seen)
        finally:
            undo()
        del seen
    tokens, labels = host_batch(pipe, steps + 1, device=dev)
    state, out["profile"] = _profile_step(state, step, {"tokens": tokens,
                                                        "labels": labels})
    out["profile"]["idle_share"] = max(
        0.0, 1 - out["profile"]["device_ms"] / out["step_ms"])
    log(f"{what}: " + json.dumps({k: v for k, v in out.items()
                                  if k not in ("step_ms_samples",
                                               "losses")}))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dp_train(dev) -> dict:
    """tinyllama-1.1b at full width, the DP_RUNS for DP_STEPS steps each:
    counted, learning, under 80 GB, ring launches every step."""
    from repro_torch.configs import get_arch
    cfg = get_arch("tinyllama-1.1b")
    return {kind: dp_run(dev, cfg, kind) for kind in DP_RUNS}


def phase_dp_vs_cpu(dev) -> dict:
    """Reduced tinyllama, W 4, B 8 x S 16, 3 steps of each DP_RUNS
    setting on the card (the kernels) and on the CPU (their plain
    versions), from the same state: losses within rtol TOL, parameters
    within TOL * max|CPU|; the fp32 sketch wire's tree within TOL * max,
    the int8 wire's tree plus the workers' ledgers (an int8 code may move
    one step where the increments differ in their last bits)."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.optim.flat import FlatLayout
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_dp_train_step

    cfg = reduced(get_arch("tinyllama-1.1b"))
    B, S, steps = 8, 16, 3
    pipe = PipelineConfig(seed=3, global_batch=B, seq_len=S,
                          vocab=cfg.vocab_size)
    out = {}
    for kind in DP_RUNS:
        run = dataclasses.replace(_dp_run_config(kind, steps, B, S),
                                  dp_workers=4)
        cpu0 = init_train_state(0, cfg, run, device="cpu")

        def drive(where):
            state = init_train_state(0, cfg, run, device=where,
                                     params=cpu0.params, sketch=cpu0.sketch)
            step = make_dp_train_step(cfg, run)
            reset_counts()
            losses = []
            for s in range(steps):
                tokens, labels = host_batch(pipe, s)
                state, m = step(state, {"tokens": tokens.to(where),
                                        "labels": labels.to(where)})
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            return state, losses, read_counts()

        got, loss_d, launches = drive(dev)
        want, loss_c, _ = drive(torch.device("cpu"))
        check_counts(f"dp {kind} on the card against the CPU", launches,
                     _dp_expected(run, cfg.num_layers, steps))
        torch.testing.assert_close(torch.tensor(loss_d), torch.tensor(loss_c),
                                   rtol=TOL, atol=0)
        lay = FlatLayout(want.params)
        p_d, p_c = lay.ravel(got.params).cpu(), lay.ravel(want.params)
        torch.testing.assert_close(p_d, p_c, rtol=0,
                                   atol=TOL * float(p_c.abs().max()))
        tree_err = 0.0
        for n, node in want.sketch.nodes.items():
            for a in "xyz":
                t_c = getattr(node, a)
                t_d = getattr(got.sketch.nodes[n], a).cpu()
                if run.sketch_wire_dtype == "int8":
                    t_c = t_c + want.opt["sketch_err"][n][a].sum(0)
                    t_d = t_d + got.opt["sketch_err"][n][a].cpu().sum(0)
                scale = float(t_c.abs().max())
                torch.testing.assert_close(t_d, t_c, rtol=TOL,
                                           atol=TOL * scale)
                tree_err = max(tree_err, float((t_d - t_c).abs().max())
                               / max(scale, 1e-30))
        out[kind] = dict(losses_card=loss_d, losses_cpu=loss_c,
                         params_max_abs_diff=float((p_d - p_c).abs().max()),
                         tree_max_diff_of_max=tree_err, launches=launches)
        log(f"dp {kind} device vs cpu: " + json.dumps(out[kind]))
    return out


def phase_dp_launcher(dev) -> dict:
    """``launch.train --reduced --dp 4 --dp-collective overlap
    --sketch-wire-dtype int8 --ring-wire --compress countsketch --cs-p2 2``
    on the card for 4 steps, checkpointing every 2, then again to 6 steps
    from the checkpoint: the per-worker ledgers restore
    (``per_worker_v1``, 4 workers), two ring merges a step."""
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train as train_launcher

    layers = reduced(get_arch("tinyllama-1.1b")).num_layers
    flags = ["--reduced", "--dp", "4", "--dp-collective", "overlap",
             "--sketch-wire-dtype", "int8", "--ring-wire", "--compress",
             "countsketch", "--cs-p2", "2", "--ckpt-every", "2"]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        reset_counts()
        first, h1 = train_launcher.main(flags + ["--steps", "4",
                                                 "--ckpt-dir", ckpt_dir])
        meta = Checkpointer(ckpt_dir).metadata()
        again, h2 = train_launcher.main(flags + ["--steps", "6",
                                                 "--ckpt-dir", ckpt_dir])
        launches = read_counts()
    if (len(h1), len(h2), again.step) != (4, 2, 6) or again.skipped:
        raise AssertionError(f"dp launcher: {len(h1)} + {len(h2)} steps, "
                             f"at step {again.step}")
    if (meta.get("residual_layout"), meta.get("dp_workers")) != (
            "per_worker_v1", 4):
        raise AssertionError(f"dp launcher checkpoint metadata {meta}")
    if tuple(again.opt["err"]["u"].shape[:1]) != (4,):
        raise AssertionError("dp launcher: per-worker err not restored")
    check_counts("dp launcher", launches, {
        "sketch_update": 2 * layers * 4 * 6, "flash_attention":
        2 * layers * 4 * 6, "flash_attention_bwd": layers * 4 * 6,
        "csvec_insert": 4 * 6, "csvec_topk": 6, "ring_allreduce": 2 * 6})
    losses = [h["loss"] for h in h1 + h2]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dp launcher losses {losses}")
    out = dict(steps=6, resumed_at=4, losses=losses, launches=launches,
               metadata={k: meta[k] for k in ("residual_layout",
                                              "dp_workers")})
    log("dp launcher: " + json.dumps(out))
    return out


def phase_device_vs_cpu(dev, arch="tinyllama-1.1b", S0=8, refill_len=8,
                        max_context=32, tol=TOL, scaled=False) -> dict:
    """A reduced model in f32 served on the card and on the CPU, from the
    same weights, projections and monitor tree: tokens equal, logits and
    sketches within rtol ``tol`` and atol ``tol`` (times max|CPU| when
    ``scaled``)."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.sketches import (
        NodeSpec, gaussian_projections, init_node_tree,
    )

    cfg = reduced(get_arch(arch))
    B, k = 2, 9
    gen = torch.Generator().manual_seed(2)
    params = init_params(gen, cfg)
    tree = init_node_tree(gen, {"res": NodeSpec(cfg.d_model, cfg.num_layers)},
                          num_tokens=B, k_max=k)
    proj = {n: gaussian_projections(gen, n, k) for n in (B * S0, refill_len)}
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen)
    refill_prompt = torch.randint(0, cfg.vocab_size, (refill_len,),
                                  generator=gen)

    def drive(device):
        eng = ServeEngine(cfg=cfg, params=params, max_context=max_context,
                          monitor=True, device=device, projections=proj,
                          initial_tree=tree)
        toks = [eng.start(prompts)]
        logits = []
        for _ in range(5):
            toks.append(eng.decode_step())
            logits.append(eng.last_logits)
        eng.refill(1, refill_prompt)
        toks.append(eng.decode_step())
        logits.append(eng.last_logits)
        node = eng._slots["mon"].tree.nodes["res"]
        return ([t.cpu() for t in toks], torch.stack(logits).cpu(),
                [t.cpu() for t in (node.x, node.y, node.z)])

    from repro_torch.models.transformer import ATTN_KINDS
    reset_counts()
    toks_d, logits_d, sk_d = drive(dev)
    launches = read_counts()
    kinds = cfg.layer_types       # 8 token steps: prefill, 6 decodes, refill
    check_counts(f"serve {cfg.name} on the card against the CPU", launches,
                 {"sketch_update": 8 * cfg.num_layers,
                  "flash_attention": 2 * sum(k in ATTN_KINDS for k in kinds),
                  "mlstm_chunk": 2 * kinds.count("mlstm")})
    toks_c, logits_c, sk_c = drive("cpu")
    if not all(torch.equal(a, b) for a, b in zip(toks_d, toks_c)):
        raise AssertionError(f"{cfg.name}: device and CPU tokens differ")
    err = rel = 0.0
    for a, b in [(logits_d, logits_c)] + list(zip(sk_d, sk_c)):
        scale = float(b.abs().max()) if scaled else 1.0
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale)
        err = max(err, float((a - b).abs().max()))
        rel = max(rel, float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30))
    log(f"device vs cpu ({cfg.name}, S0 {S0}): tokens equal, max abs diff "
        f"{err:.3e}, {rel:.3e} of max; launches {launches}")
    return dict(arch=cfg.name, prompt_len=S0, max_abs_diff=err,
                max_diff_of_max=rel, launches=launches)


def counted_run(what: str, train_fn, data_fn, want: dict) -> dict:
    """One counted, timed run of ``train_fn(data_fn) -> PaperTrainResult``:
    launch counts from 0 (then held to ``want``), per-step host time
    (each step ends in the loss's device sync), peak memory; losses must
    be finite."""
    import torch
    stamps = []

    def timed_data(s):
        stamps.append(time.perf_counter())
        return data_fn(s)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = train_fn(timed_data)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    launches = read_counts()
    check_counts(what, launches, want)
    losses = [h["loss"] for h in res.history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite loss in {losses}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    return dict(res=res, launches=launches, losses=losses,
                step_ms=statistics.median(step_ms[1:]),
                peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20)


def _learns(what: str, losses: list, n: int = 10) -> None:
    first, last = statistics.mean(losses[:n]), statistics.mean(losses[-n:])
    if not last < first:
        raise AssertionError(f"{what} did not learn: mean loss {first:.4f} "
                             f"-> {last:.4f}")


def _learns_well(what: str, losses: list, bound: float) -> None:
    last = statistics.mean(losses[-10:])
    if not last <= bound:
        raise AssertionError(f"{what} did not learn: last-10 mean loss "
                             f"{last:.4f} above {bound:.4f}")


def _summary(r: dict) -> dict:
    return dict(step_ms=r["step_ms"], peak_mem_mib=r["peak_mem_mib"],
                launches=r["launches"], loss_first10=statistics.mean(
                    r["losses"][:10]),
                loss_last10=statistics.mean(r["losses"][-10:]))


def _close_trees(what: str, got, want, rtol: float, atol_rel: float) -> float:
    """Each tensor of ``got`` within rtol, atol_rel * max|want| of
    ``want``'s (both on the CPU); returns the largest |diff| / max|want|."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol_rel * scale,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
    return err


def _c5_nan_step(dev) -> dict:
    """C5: one MNIST_MLP sketched_fixed step with the faithful (pinv)
    reconstruction and a NaN in one input entry: the loss is NaN and the
    step does not raise (the card's SVD is cuSOLVER's)."""
    import torch
    from repro_torch.configs.paper import MNIST_MLP
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.models.mlp import mlp_init
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.train.paper_trainer import init_mlp_sketch, make_step

    cfg = MNIST_MLP
    scfg = SketchConfig(rank=2, max_rank=16, beta=0.95,
                        batch_size=cfg.batch_size, recon_mode="faithful")
    gen = torch.Generator(device=dev).manual_seed(21)
    params = mlp_init(gen, cfg)
    tree = init_mlp_sketch(gen, cfg, scfg, "sketched_fixed")
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    x = torch.randn((cfg.batch_size, cfg.d_in), generator=gen, device=dev)
    y = torch.randint(0, cfg.d_out, (cfg.batch_size,), generator=gen,
                      device=dev)
    x[3, 7] = float("nan")
    reset_counts()
    _, _, new, loss = make_step(cfg, scfg, "sketched_fixed", opt_cfg)(
        params, init_adamw(params, opt_cfg), tree, x, y)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("c5 faithful NaN step", launches,
                 {"sketch_update": cfg.num_hidden_layers})
    if not math.isnan(float(loss)):
        raise AssertionError(f"c5: loss {float(loss)} on a NaN input")
    out = dict(loss=str(float(loss)), launches=launches,
               nan_in_tree=bool(torch.isnan(new.nodes["hidden"].y).any()))
    log("c5 faithful NaN step: " + json.dumps(out))
    return out


def _corange_ab(dev, cfg, scfg, res) -> dict:
    """COR_AB_STEPS steps from one state (a run's last) with the corange
    forward's batched form against its sequential one, on the card:
    losses within rtol COR_AB_TOL, parameters within COR_AB_PARAM_ATOL."""
    import torch
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.train.paper_trainer import (
        _corange_forward, ce_loss, value_and_grad,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    protos = torch.randn((cfg.d_out, cfg.d_in), generator=gen, device=dev)
    batches = [classification_batch(gen, protos, cfg.batch_size, 1.2)
               for _ in range(COR_AB_STEPS)]
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    runs = []
    for batched in (True, False):
        params, sk = res.params, res.sketch
        opt = init_adamw(params, opt_cfg)
        losses = []
        for x, y in batches:
            def loss_fn(p):
                logits, new = _corange_forward(p, x, sk, cfg, scfg,
                                               batched=batched)
                return ce_loss(logits, y), new

            loss, sk, grads = value_and_grad(loss_fn, params)
            with torch.no_grad():
                params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
            losses.append(float(loss))
        runs.append((losses, [t.cpu() for t in tree_leaves(params)]))
    (la, pa), (lb, pb) = runs
    torch.testing.assert_close(torch.tensor(la), torch.tensor(lb),
                               rtol=COR_AB_TOL, atol=0)
    err = 0.0
    for a, b in zip(pa, pb):
        torch.testing.assert_close(a, b, rtol=0, atol=COR_AB_PARAM_ATOL)
        err = max(err, float((a - b).abs().max()))
    return dict(losses_batched=la, losses_sequential=lb,
                params_max_abs_diff=err)


def _mlp_dp_run(dev, cfg, scfg, collective: str, params, tree, batches):
    """One counted run of the paper MLP's data-parallel step."""
    from types import SimpleNamespace
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.train.paper_trainer import make_dp_step

    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    step = make_dp_step(cfg, scfg, "sketched_fixed", opt_cfg, MLP_DP_WORKERS,
                        collective=collective)

    def train_fn(data_fn):
        p, opt, sk, hist = params, init_adamw(params, opt_cfg), tree, []
        for s in range(len(batches)):
            x, y = data_fn(s)
            p, opt, sk, loss = step(p, opt, sk, x, y)
            hist.append({"loss": float(loss)})
        return SimpleNamespace(params=p, sketch=sk, history=hist)

    return counted_run(
        f"mlp dp {collective}", train_fn, lambda s: batches[s],
        {"sketch_update": 3 * MLP_DP_WORKERS * len(batches)})


def _rel_errs(got, want) -> float:
    """The largest |got - want| / max|want| over paired tensors."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def _steps_vs_cpu(dev, what: str, step, params, tree, batches, opt_cfg,
                  tol: float) -> dict:
    """``step`` over ``batches`` on the card and on the CPU from one
    state: losses within rtol TOL, each parameter leaf and each sketch
    within ``tol`` * its max|CPU|. Returns the readings (largest |diff| /
    max|CPU|)."""
    import torch
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.optim.flat import tree_leaves, tree_map
    from repro_torch.sketches import tree_to

    def drive(where):
        p = tree_map(lambda t: t.to(where), params)
        opt, sk, losses = init_adamw(p, opt_cfg), tree_to(tree, where), []
        for x, y in batches:
            p, opt, sk, loss = step(p, opt, sk, x.to(where), y.to(where))
            losses.append(float(loss))
        return losses, [t.cpu() for t in tree_leaves(p)], [
            getattr(sk.nodes[n], a).cpu() for n in sorted(sk.nodes)
            for a in "xyz"]

    loss_d, p_d, t_d = drive(dev)
    loss_c, p_c, t_c = drive(torch.device("cpu"))
    out = dict(losses_card=loss_d, losses_cpu=loss_c,
               loss_max_rel_diff=max(abs(a - b) / abs(b)
                                     for a, b in zip(loss_d, loss_c)),
               params_max_diff_of_max=_rel_errs(p_d, p_c),
               tree_max_diff_of_max=_rel_errs(t_d, t_c))
    log(f"{what} card vs cpu: " + json.dumps(out))
    if not (out["loss_max_rel_diff"] <= TOL
            and out["params_max_diff_of_max"] <= tol
            and out["tree_max_diff_of_max"] <= tol):
        raise AssertionError(f"{what}: card against CPU beyond rtol {TOL} "
                             f"(losses), {tol} (parameters, trees)")
    return out


def _mlp_dp_vs_cpu(dev, cfg, scfg, tol: float, seed: int) -> dict:
    """Each layout's MLP_DP_CPU_STEPS steps of the MLP's data-parallel
    step (W MLP_DP_WORKERS, ``cfg.batch_size`` rows a worker) on the card
    and on the CPU from one state and batches (``_steps_vs_cpu``)."""
    import torch
    from repro_torch.models.mlp import mlp_init
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.paper_trainer import init_mlp_sketch, make_dp_step

    gen = torch.Generator().manual_seed(seed)
    params = mlp_init(gen, cfg)
    tree = init_mlp_sketch(gen, cfg, scfg, "sketched_fixed")
    rows = MLP_DP_WORKERS * cfg.batch_size
    batches = [(torch.randn((rows, cfg.d_in), generator=gen),
                torch.randint(0, cfg.d_out, (rows,), generator=gen))
               for _ in range(MLP_DP_CPU_STEPS)]
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    return {c: _steps_vs_cpu(
        dev, f"mlp dp {cfg.name} {c}",
        make_dp_step(cfg, scfg, "sketched_fixed", opt_cfg, MLP_DP_WORKERS,
                     collective=c), params, tree, batches, opt_cfg, tol)
        for c in ("per_node", "overlap")}


def _conv_vs_cpu(dev) -> dict:
    """CONV_CPU_STEPS sketched_fixed steps of the full-size conv stem
    (CIFAR_CONV, B 32 x 32 x 32 x 3) with each projection kind on the
    card and on the CPU from one state and batches (``_steps_vs_cpu`` at
    CONV_CPU_TOL). The CPU runs the update kernels' plain versions, which
    the tests hold against the reference."""
    import torch
    from repro_torch.configs.paper import CIFAR_CONV
    from repro_torch.data.synthetic import cifar_prototypes, fake_cifar_batch
    from repro_torch.launch.paper import run_settings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.paper_trainer import (
        conv_init, init_conv_sketch, make_conv_step,
    )

    cfg = CIFAR_CONV
    gen = torch.Generator().manual_seed(9)
    protos = cifar_prototypes(gen, cfg.d_out, cfg.hw, cfg.channels)
    batches = [fake_cifar_batch(gen, protos, cfg.batch_size)
               for _ in range(CONV_CPU_STEPS)]
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    out = {}
    for proj_kind in PROJ_KINDS:
        scfg = run_settings("cifar_conv", cfg.batch_size, proj_kind)[0]
        params = conv_init(gen, cfg)
        tree = init_conv_sketch(gen, cfg, scfg)
        out[proj_kind] = _steps_vs_cpu(
            dev, f"cifar_conv {proj_kind}",
            make_conv_step(cfg, scfg, "sketched_fixed", opt_cfg), params,
            tree, batches, opt_cfg, CONV_CPU_TOL)
    return out


def phase_paper_experiments(dev) -> dict:
    """The rest of the paper's experiments at their configs' full sizes,
    each run counted from 0 and checked, its step ms (median over steps
    2-N) and peak memory kept:

    (c5) one MNIST_MLP sketched_fixed step with the faithful (pinv)
         reconstruction and a NaN input entry: NaN loss, no exception;
    (a) MNIST_MLP corange, COR_STEPS steps with Gaussian and with
        psparse-corange projections: learns, launches no update kernel;
        then COR_AB_STEPS steps of the corange forward's batched form
        against its sequential one from the Gaussian run's last state;
    (b) CIFAR_CONV (B 32, 32 x 32 x 3) on stand-in CIFAR batches,
        CONV_STEPS steps of standard and of sketched_fixed with each
        projection kind: each learns (``_learns_well``), two update
        launches a sketched step of the projection's kind; then
        CONV_CPU_STEPS sketched steps of each kind on the card against
        the CPU;
    (c) the CIFAR hybrid (exact stem, dense tail) on the same kind of
        batches at HYBRID_LR, HYBRID_STEPS steps of standard and of
        sketched_fixed from one init: each learns, three sketch_update
        launches a sketched step;
    (d) PINN_POISSON, PINN_STEPS steps with the monitor on and off from
        one init: parameters within 1e-6, three sketch_update launches a
        step with it (T 1,024 x d 50 x k 17), none without; the L2
        relative error of each;
    (e) MNIST_MLP sketched_fixed data-parallel, W 4 x 32 rows (global B
        128), MLP_DP_STEPS steps in each layout from one state: trees and
        losses equal bit for bit between per_node and overlap, parameters
        within 1e-6 * max, 3 W sketch_update launches a step; then
        MLP_DP_CPU_STEPS steps of each layout on the card against the
        CPU, of a reduced MLP at TOL and of MNIST_MLP at MLP_DP_FULL_TOL."""
    import torch
    from repro_torch.configs.paper import (
        CIFAR_CONV, CIFAR_HYBRID, MNIST_MLP, PINN_POISSON, MLPConfig,
    )
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data.synthetic import (
        cifar_prototypes, class_prototypes, classification_batch,
        fake_cifar_batch, pinn_points,
    )
    from repro_torch.launch.paper import PINN_BOUNDARY, run_settings
    from repro_torch.models.mlp import conv_stem_init, mlp_init
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.train.paper_trainer import (
        init_mlp_sketch, l2_rel_error, train, train_conv, train_hybrid,
        train_pinn,
    )

    out = {"c5": _c5_nan_step(dev)}

    # (a) corange
    cfg = MNIST_MLP
    gen = torch.Generator(device=dev).manual_seed(100)
    noise = run_settings("mnist_mlp", cfg.batch_size, "gaussian")[1]
    protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
    batches = [classification_batch(gen, protos, cfg.batch_size, noise)
               for _ in range(COR_STEPS)]
    params = mlp_init(torch.Generator(device=dev).manual_seed(0), cfg)
    for proj_kind in PROJ_KINDS:
        scfg = run_settings("mnist_mlp", cfg.batch_size, proj_kind)[0]
        r = counted_run(
            f"mnist_mlp corange {proj_kind}", lambda data_fn: train(
                cfg, scfg, "corange", steps=COR_STEPS, batch_fn=data_fn,
                params=params, device=dev), lambda s: batches[s], {})
        _learns(f"mnist_mlp corange {proj_kind}", r["losses"])
        out[f"corange/{proj_kind}"] = _summary(r)
        if proj_kind == "gaussian":
            out["corange/batched_vs_sequential"] = _corange_ab(
                dev, cfg, scfg, r["res"])
        log(f"corange {proj_kind}: " + json.dumps(out[f"corange/{proj_kind}"]))
    log("corange batched vs sequential: "
        + json.dumps(out["corange/batched_vs_sequential"]))

    # (b) the sketched conv stem
    cfg = CIFAR_CONV
    gen = torch.Generator(device=dev).manual_seed(101)
    scfg, noise = run_settings("cifar_conv", cfg.batch_size, "gaussian")
    protos = cifar_prototypes(gen, cfg.d_out, cfg.hw, cfg.channels)
    batches = [fake_cifar_batch(gen, protos, cfg.batch_size, noise)
               for _ in range(CONV_STEPS)]
    for variant, proj_kind in (("standard", "gaussian"),
                               ("sketched_fixed", "gaussian"),
                               ("sketched_fixed", "psparse")):
        scfg = run_settings("cifar_conv", cfg.batch_size, proj_kind)[0]
        what = f"cifar_conv {variant} {proj_kind}"
        r = counted_run(what, lambda data_fn: train_conv(
            cfg, scfg, variant, steps=CONV_STEPS, batch_fn=data_fn,
            device=dev), lambda s: batches[s],
            _expected_counts(variant, proj_kind, 2 * CONV_STEPS))
        out[f"conv/{variant}/{proj_kind}"] = _summary(r)
        log(f"{what}: " + json.dumps(out[f"conv/{variant}/{proj_kind}"]))
        _learns_well(what, r["losses"], LEARN_FRAC * math.log(cfg.d_out))
    out["conv/vs_cpu"] = _conv_vs_cpu(dev)

    # (c) the CIFAR hybrid
    cfg = dataclasses.replace(CIFAR_HYBRID, learning_rate=HYBRID_LR)
    scfg = run_settings("cifar_hybrid", cfg.batch_size, "gaussian")[0]
    gen = torch.Generator(device=dev).manual_seed(102)
    protos = cifar_prototypes(gen, cfg.d_out)
    batches = [fake_cifar_batch(gen, protos, cfg.batch_size)
               for _ in range(HYBRID_STEPS)]
    pgen = torch.Generator(device=dev).manual_seed(0)
    hparams = {"stem": conv_stem_init(pgen), "mlp": mlp_init(pgen, cfg)}
    for variant in ("standard", "sketched_fixed"):
        what = f"cifar_hybrid {variant}"
        r = counted_run(what, lambda data_fn: train_hybrid(
            cfg, scfg, variant, steps=HYBRID_STEPS, batch_fn=data_fn,
            params=hparams, device=dev), lambda s: batches[s],
            _expected_counts(variant, "gaussian",
                             cfg.num_hidden_layers * HYBRID_STEPS))
        out[f"hybrid/{variant}"] = _summary(r)
        log(f"{what}: " + json.dumps(out[f"hybrid/{variant}"]))
        _learns_well(what, r["losses"], LEARN_FRAC * math.log(cfg.d_out))

    # (d) the PINN, monitor on and off
    cfg = PINN_POISSON
    scfg = run_settings("pinn_poisson", cfg.batch_size, "gaussian")[0]
    gen = torch.Generator(device=dev).manual_seed(103)
    points = [pinn_points(gen, cfg.batch_size, PINN_BOUNDARY)
              for _ in range(PINN_STEPS)]
    pgen = torch.Generator(device=dev).manual_seed(0)
    pparams = mlp_init(pgen, cfg)
    tree = init_mlp_sketch(pgen, cfg, scfg, "monitor")
    pinn = {}
    for monitor in (True, False):
        what = f"pinn_poisson monitor {'on' if monitor else 'off'}"
        r = counted_run(what, lambda data_fn: train_pinn(
            cfg, scfg, steps=PINN_STEPS, points_fn=data_fn, monitor=monitor,
            params=pparams, sketch=tree, device=dev), lambda s: points[s],
            {"sketch_update": cfg.num_hidden_layers * PINN_STEPS
             if monitor else 0})
        pinn[monitor] = r["res"]
        key = f"pinn/monitor_{'on' if monitor else 'off'}"
        out[key] = dict(_summary(r),
                        l2_rel_error=l2_rel_error(r["res"].params, cfg))
        print(f"{what}: L2 relative error {out[key]['l2_rel_error']:.6f}",
              flush=True)
    for a, b in zip(tree_leaves(pinn[True].params),
                    tree_leaves(pinn[False].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    if not all(bool(torch.isfinite(getattr(pinn[True].sketch.nodes["hidden"],
                                           a)).all()) for a in "xyz"):
        raise AssertionError("pinn: non-finite monitor sketch")
    log("pinn: " + json.dumps({k: v for k, v in out.items()
                               if k.startswith("pinn")}))

    # (e) the MLP data-parallel step
    cfg = dataclasses.replace(MNIST_MLP,
                              batch_size=MLP_DP_BATCH // MLP_DP_WORKERS)
    scfg = run_settings("mnist_mlp", cfg.batch_size, "gaussian")[0]
    gen = torch.Generator(device=dev).manual_seed(104)
    protos = class_prototypes(gen, cfg.d_out, cfg.d_in)
    batches = [classification_batch(gen, protos, MLP_DP_BATCH, noise)
               for _ in range(MLP_DP_STEPS)]
    pgen = torch.Generator(device=dev).manual_seed(0)
    dparams = mlp_init(pgen, cfg)
    dtree = init_mlp_sketch(pgen, cfg, scfg, "sketched_fixed")
    dp = {c: _mlp_dp_run(dev, cfg, scfg, c, dparams, dtree, batches)
          for c in ("per_node", "overlap")}
    a, b = dp["per_node"], dp["overlap"]
    if a["losses"] != b["losses"] or not all(
            torch.equal(getattr(a["res"].sketch.nodes["hidden"], t),
                        getattr(b["res"].sketch.nodes["hidden"], t))
            for t in "xyz"):
        raise AssertionError("mlp dp: per_node and overlap trees or losses "
                             "differ")
    pa = [t.cpu() for t in tree_leaves(a["res"].params)]
    pb = [t.cpu() for t in tree_leaves(b["res"].params)]
    layouts_err = _close_trees("mlp dp layouts' params", pa, pb, 0, 1e-6)
    _learns("mlp dp per_node", a["losses"], 5)
    for c, r in dp.items():
        out[f"mlp_dp/{c}"] = dict(_summary(r), workers=MLP_DP_WORKERS,
                                  global_batch=MLP_DP_BATCH)
    out["mlp_dp/params_max_diff_of_max"] = layouts_err
    out["mlp_dp/vs_cpu"] = _mlp_dp_vs_cpu(
        dev, MLPConfig(name="reduced", d_in=64, d_hidden=96, d_out=10,
                       num_hidden_layers=3, batch_size=16),
        SketchConfig(rank=3, max_rank=6, beta=0.9, batch_size=16,
                     recon_mode="fast"), TOL, 8)
    out["mlp_dp/vs_cpu_full"] = _mlp_dp_vs_cpu(dev, cfg, scfg,
                                               MLP_DP_FULL_TOL, 8)
    log("mlp dp: " + json.dumps({k: v for k, v in out.items()
                                 if k.startswith("mlp_dp")}))
    return out


def mlstm_bwd_bound(B, H, S, Dk, Dv, W, elem: int,
                    tensor_cores: bool) -> tuple[float, str, float]:
    """(bound_ms, bound_by, f32_bound_ms) of one mlstm_chunk_bwd call.
    Operations: ``mlstm_chunk.mlstm_bwd_flops``, the function's causal
    products and state products (recomputed states included) each
    counted once, at the bf16 rate on the tensor-core path and at the
    f32 rate (the FMA kernels' arithmetic; f32_bound_ms on both paths).
    The tensor-core kernels' extra products (each split two or three
    times, full tiles past the causal half: ``mlstm_bwd_tc_flops``) are
    the design's own work, not the function's, and are not in the
    bound. Bytes: q, k, v read once in their type, li, lf, h and dh in
    f32, dq, dk, dv written once in their type and dli, dlf in f32."""
    from repro_torch.kernels.mlstm_chunk import mlstm_bwd_flops
    nbytes = (2 * B * H * S * (2 * Dk + Dv) * elem
              + 4 * B * H * S * (4 + 2 * Dv))
    t_b = nbytes / PEAK_BYTES_S
    flops = mlstm_bwd_flops(B, H, S, Dk, Dv, W)
    t_f32 = flops / PEAK_F32_FLOP_S
    t_o = flops / PEAK_BF16_FLOP_S if tensor_cores else t_f32
    f32_ms = max(t_b, t_f32) * 1e3
    return (t_b * 1e3, "bytes", f32_ms) if t_b >= t_o else (
        t_o * 1e3, "operations", f32_ms)


def phase_mlstm_bwd(dev) -> list[dict]:
    """mlstm_chunk_bwd at each MLSTM_BWD_CASES shape against its plain
    version on the same inputs widened exactly (``mlstm_chunk.bwd_gap``:
    each gradient within rtol 1e-4, atol 1e-4 * max|plain|, bf16 outputs
    with their one rounding on top) and against a second call of itself
    (bit for bit: no atomics), then timed beside its bound and the plain
    version. h comes from the forward kernel, v is a view of (B, S, H, Dv)
    storage, as in the model. Each row names its path
    (``uses_tensor_cores``); the MLSTM_BWD_TC rows must take the tensor
    cores, and where the profiler kept the kernels' names, those of the
    tensor-core kernels. No one PyTorch call computes the function:
    library_ms is None."""
    import torch
    from repro_torch.kernels import mlstm_chunk as MC
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for label, B, H, S, Dk, Dv, chunk, dt, shift, gates in MLSTM_BWD_CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        q, k = rand(B, H, S, Dk).to(dtype), rand(B, H, S, Dk).to(dtype)
        v = rand(B, S, H, Dv).to(dtype).transpose(1, 2)
        li = rand(B, H, S) * 0.5 + shift
        bias = (torch.linspace(3.0, 6.0, H, device=dev)[:, None]
                if gates == "model" else 2.0)
        lf = torch.nn.functional.logsigmoid(rand(B, H, S) + bias)
        h, _ = MC.mlstm_chunk(q, k, v, li, lf, chunk=chunk)
        dh = rand(B, H, S, Dv)
        args = (q, k, v, li, lf, h, dh)
        got = MC.mlstm_chunk_bwd(*args, chunk=chunk)
        again = MC.mlstm_chunk_bwd(*args, chunk=chunk)
        wide = (q.float(), k.float(), v.float(), li, lf, h, dh)
        want = MC.mlstm_chunk_bwd_plain(*wide, chunk=chunk)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv", "dli", "dlf")
        gaps = {n: MC.bwd_gap(g, w) for n, g, w in zip(names, got, want)}
        if not max(gaps.values()) <= 1:
            raise AssertionError(f"mlstm_chunk_bwd {label}: share of the "
                                 f"allowance used {gaps}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"mlstm_chunk_bwd {label}: two calls "
                                 f"differ")
        abs_errs = {n: float((g.float() - w).abs().max())
                    for n, g, w in zip(names, got, want)}
        del got, again, want
        big = S >= 512
        it, plain_it = (10, 3) if big else (100, 10)
        ms, call_ms = time_ms(lambda: MC.mlstm_chunk_bwd(*args, chunk=chunk),
                              it, 2)
        ms_from = time_ms.source
        plain_ms, plain_call_ms = time_ms(
            lambda: MC.mlstm_chunk_bwd_plain(*args, chunk=chunk), plain_it, 1)
        tc = MC.uses_tensor_cores(q, k, v, chunk)
        if tc != (label in MLSTM_BWD_TC):
            raise AssertionError(f"mlstm_chunk_bwd {label}: tensor cores "
                                 f"{tc}, expected {label in MLSTM_BWD_TC}")
        bound_ms, bound_by, f32_bound_ms = mlstm_bwd_bound(
            B, H, S, Dk, Dv, min(chunk, S), q.element_size(), tc)
        split = _device_kernels(
            lambda: MC.mlstm_chunk_bwd(*args, chunk=chunk), 3) if big \
            else None
        us_by_kernel = split and {
            (re.search(r"bwd_[a-z]+_(kernel|tc)", n) or [n])[0]: us / 3
            for n, (_, us) in split.items()}
        if us_by_kernel and tc != ("bwd_sweep_tc" in us_by_kernel):
            raise AssertionError(f"mlstm_chunk_bwd {label}: kernels "
                                 f"{sorted(us_by_kernel)} on the path "
                                 f"tensor cores {tc}")
        rows.append(dict(
            case=label, B=B, H=H, S=S, Dk=Dk, Dv=Dv, W=min(chunk, S),
            dtype=dt, forget_gates=gates,
            path="tensor_cores" if tc else "fma", gaps=gaps,
            abs_err=abs_errs, max_abs_err=max(abs_errs.values()), ms=ms,
            ms_from=ms_from, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by, f32_bound_ms=f32_bound_ms,
            issued_gflop=MC.mlstm_bwd_tc_flops(
                B, H, S, Dk, Dv, min(chunk, S)) / 1e9 if tc else None,
            call_ms=call_ms, plain_call_ms=plain_call_ms,
            us_by_kernel=us_by_kernel))
        log(f"mlstm_chunk_bwd {json.dumps(rows[-1])}")
        del q, k, v, li, lf, h, dh, args, wide
        torch.cuda.empty_cache()
    return rows


def _launcher_run_config(proj_kind: str, steps: int, batch: int, seq: int,
                         k_max: int, grad_clip: float = 1.0,
                         compression: dict | None = None, **dp):
    """A run as launch/train.py builds it (lr 3e-4, the global-norm clip
    at ``grad_clip``, warmup min(20, steps // 5 + 1)) at ``k_max``;
    ``compression`` holds CompressionConfig's keywords, ``dp`` the
    data-parallel fields."""
    from repro_torch.models.transformer import SketchSettings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.train.state import RunConfig
    return RunConfig(
        seq_len=seq, global_batch=batch,
        optimizer=AdamWConfig(lr=3e-4, grad_clip=grad_clip),
        warmup_steps=min(20, steps // 5 + 1), total_steps=steps,
        sketch=SketchSettings(enabled=True, k_max=k_max,
                              proj_kind=proj_kind),
        compression=CompressionConfig(**compression) if compression
        else None, **dp)


def _xlstm_run_config(proj_kind: str, steps: int, batch: int, seq: int):
    # at XLSTM_TRAIN's k_max, with the global-norm clip off
    # (XLSTM_GRAD_CLIP)
    return _launcher_run_config(proj_kind, steps, batch, seq,
                                XLSTM_TRAIN["k_max"],
                                grad_clip=XLSTM_GRAD_CLIP)


def _carry_mass(tree, batch: int) -> dict:
    """Each node's stack entries whose x, y or z holds no mass. Where a
    psparse matrix has no support row below the carry's B rows (the
    reference's zero-padded rows reach only those), its sketch of a
    carry node rightly stays zero: such sketches are listed, not
    failed. So are an "expert_in" stack's psparse sketches: an expert
    whose occupied slots never held a matrix's support row keeps that
    sketch at zero, in the reference too."""
    import torch
    from repro_torch.kernels.psparse_update import psparse_rows
    from repro_torch.models.transformer import CARRY_NODE_KINDS
    from repro_torch.sketches import is_psparse
    proj = tree.proj
    dead = []
    if is_psparse(proj):
        dead = [a for a, p in zip("xyz", proj.params)
                if not bool((psparse_rows(p, proj.m, proj.num_tokens)
                             < batch).any())]
    out = {}
    for name, node in tree.nodes.items():
        carry = name in CARRY_NODE_KINDS
        listed = name == "expert_in" and is_psparse(proj)
        for a in "xyz":
            mass = getattr(node, a).abs().sum(dim=(-2, -1))
            empty = int((mass == 0).sum())
            want = mass.numel() if carry and a in dead else 0
            if (empty != want and not listed) or \
                    not bool(torch.isfinite(mass).all()):
                raise AssertionError(
                    f"{name}.{a}: {empty} of {mass.numel()} entries hold "
                    f"no mass, expected {want}")
            out[f"{name}.{a}"] = dict(entries=mass.numel(), empty=empty,
                                      min_mass=float(mass.min()))
    return dict(by_leaf=out, psparse_dead=dead)


def _slstm_ms(state, cfg, batch: int, seq: int) -> float:
    """Host ms of the sLSTM blocks' forward and backward at (batch, seq),
    each block timed apart between synchronisations on the trained
    weights and a random bf16 input: the one Python loop's cost a step."""
    import torch
    from repro_torch.models import ssm
    gen = torch.Generator(
        device=state.params["embed"]["embedding"].device).manual_seed(4)
    total = 0.0
    for l, kind in enumerate(cfg.layer_types):
        if kind != "slstm":
            continue
        p = {n: t.detach().requires_grad_(True)
             for n, t in state.params["layers"][l]["mix"].items()}
        x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                        device=gen.device).to(cfg.dtype).requires_grad_(True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, _ = ssm.slstm_apply(p, x, cfg=cfg, mode="train")
        torch.autograd.grad(y.float().sum(), [x, *p.values()])
        torch.cuda.synchronize()
        total += time.perf_counter() - t
        del p, x, y
    return total * 1e3


def _train_counts(cfg, run, steps: int) -> dict:
    """Launches of ``steps`` train steps of a dense-FFN or recurrent arch
    under ``run``, each step and worker: one flash forward and one flash
    backward an attention layer, one mlstm_chunk and one mlstm_chunk_bwd
    an mLSTM layer, one update kernel per node entry ("res" or "ffn_in"
    and "ffn_h" on every layer, the carry nodes on the layers of their
    kind); a data-parallel step in the fused layout merges once, through
    the ring with ``run.ring_wire``; the count sketch inserts each
    worker's table and takes one top-k, and quantises the table on its
    int8 wire."""
    from repro_torch.models.transformer import (
        ATTN_KINDS, node_layer_count, sketch_groups,
    )
    kinds = cfg.layer_types
    n_m, n_a = kinds.count("mlstm"), sum(k in ATTN_KINDS for k in kinds)
    kernel = "psparse_update" if run.sketch.proj_kind == "psparse" \
        else "sketch_update"
    entries = sum(node_layer_count(cfg, n) for n in sketch_groups(cfg))
    W = run.dp_workers if run.dp_axis_name else 1
    if W > 1 and run.dp_collective != "fused":
        raise ValueError("_train_counts counts the fused layout's only")
    want = {kernel: entries * W * steps,
            "flash_attention": n_a * W * steps,
            "flash_attention_bwd": n_a * W * steps,
            "mlstm_chunk": n_m * W * steps,
            "mlstm_chunk_bwd": n_m * W * steps,
            "ring_allreduce": steps if W > 1 and run.ring_wire else 0}
    if run.compression is not None:
        want.update(csvec_insert=W * steps, csvec_topk=steps)
        if run.compression.wire_dtype == "int8":
            want["csvec_quant"] = W * steps
    return want


def recurrent_run(dev, cfg, run, *, repeat_batch: bool = False,
                  profile_groups=None, profile_extra=None) -> dict:
    """One counted, timed run of ``run.total_steps`` train steps of
    (``run.global_batch``, ``run.seq_len``) from a fresh state (each step
    on the pipeline's next batch, or with ``repeat_batch`` on its first):
    losses finite and no skip, launches (``_train_counts``), peak memory
    under 80 GB, every sketch's mass (``_carry_mass``, a worker's
    B/W carry rows); with ``profile_groups`` one more step under
    torch.profiler (device ms and shares of the kernels each regex
    names, and the idle share), and ``profile_extra(state)``'s entries
    beside it; with compression on one device, the mass check
    (``_mass_check``) on one more step."""
    import gc
    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    left_mib = torch.cuda.memory_allocated() / 2**20
    steps, batch, seq = run.total_steps, run.global_batch, run.seq_len
    proj_kind = run.sketch.proj_kind
    pipe = PipelineConfig(seed=0, global_batch=batch, seq_len=seq,
                          vocab=cfg.vocab_size)
    state = init_train_state(0, cfg, run, device=dev)
    step = make_train_step(cfg, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, skipped, stamps = [], [], [time.perf_counter()]
    for s in range(steps):
        tokens, labels = host_batch(pipe, 0 if repeat_batch else s,
                                    device=dev)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        skipped.append(m["skipped_total"])
        stamps.append(time.perf_counter())
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    what = f"{cfg.name} {proj_kind} B={batch} S={seq}"
    W = run.dp_workers if run.dp_axis_name else 1
    if W > 1:
        what += f" W={W} {run.dp_collective}"
    check_counts(what, launches, _train_counts(cfg, run, steps))
    if not all(math.isfinite(v) for v in losses) or skipped[-1]:
        raise AssertionError(f"{what}: losses {losses}, skipped {skipped[-1]}")
    if peak * 2**20 >= PEAK_LIMIT_BYTES:
        raise AssertionError(f"{what}: peak {peak:.0f} MiB over 80 GB")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    out = dict(batch=batch, seq=seq, steps=steps, proj_kind=proj_kind,
               k_max=run.sketch.k_max, repeat_batch=repeat_batch,
               grad_clip=run.optimizer.grad_clip,
               step_ms=statistics.median(step_ms[1:] or step_ms),
               step_ms_samples=step_ms, peak_mem_mib=peak,
               allocated_before_mib=left_mib, launches=launches,
               losses=losses, skipped=skipped[-1], workers=W,
               mass=_carry_mass(state.sketch, batch // W))
    if profile_groups is not None:
        tokens, labels = host_batch(pipe, steps, device=dev)
        state, out["profile"] = _profile_step(
            state, step, {"tokens": tokens, "labels": labels},
            groups=profile_groups)
        out["profile"]["idle_share"] = max(
            0.0, 1 - out["profile"]["device_ms"] / out["step_ms"])
        if profile_extra is not None:
            out.update(profile_extra(state, out))
    if run.compression is not None and W == 1:
        tokens, labels = host_batch(pipe, steps + 1, device=dev)
        out["mass_check"] = _mass_check(
            dev, cfg, run, state, step, {"tokens": tokens, "labels": labels})
    out["seconds"] = time.perf_counter() - t0
    log(f"{what}: " + json.dumps({k: v for k, v in out.items()
                                  if k not in ("step_ms_samples",)}))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_run(dev, cfg, proj_kind: str, steps: int, batch: int,
              seq: int, profile: bool = False,
              repeat_batch: bool = False) -> dict:
    """``recurrent_run`` of xlstm (``_xlstm_run_config``); with
    ``profile`` the backward kernels' and the forward's device ms and
    shares of a traced step, and the sLSTM blocks' share of the median
    step."""
    def slstm(state, out):
        ms = _slstm_ms(state, cfg, batch, seq)
        return dict(slstm_ms=ms, slstm_share_of_step=ms / out["step_ms"])

    groups = {"mlstm_chunk_bwd": MLSTM_BWD_KERNELS,
              "mlstm_chunk": r"mlstm_(gates|scores|state|n)_(kernel|tc)"}
    return recurrent_run(
        dev, cfg, _xlstm_run_config(proj_kind, steps, batch, seq),
        repeat_batch=repeat_batch, profile_groups=groups if profile else None,
        profile_extra=slstm)


def _xlstm_step_vs_cpu(dev, S: int, chunk: int, tol: float) -> dict:
    """Reduced xlstm (8 layers, 7 mLSTM) in f32, B 2 x S at mLSTM chunk
    ``chunk``, monitor sketches at k_max 9: one train step's loss,
    gradients and new tree on the card and on the CPU from one state,
    within ``tol`` * max|CPU| each (XLSTM_DVC_STEPS); the card's step
    counted."""
    import functools
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.models import ssm
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.sketches import tree_to
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    cfg = reduced(get_arch("xlstm-1.3b"))
    B = 2
    run = _xlstm_run_config("gaussian", 1, B, S)
    pipe = PipelineConfig(seed=3, global_batch=B, seq_len=S,
                          vocab=cfg.vocab_size)
    tokens, labels = host_batch(pipe, 0)
    cpu = init_train_state(0, cfg, run, device="cpu")

    def one_step(where):
        state = init_train_state(0, cfg, run, device=where,
                                 params=cpu.params,
                                 sketch=tree_to(cpu.sketch, where))
        reset_counts()
        loss, _, _, grads, tree = make_train_step(cfg, run).loss_and_grads(
            state, {"tokens": tokens.to(where), "labels": labels.to(where)})
        if where != "cpu":
            torch.cuda.synchronize()
        leaves = [t for n in sorted(tree.nodes) for t in
                  (tree.nodes[n].x, tree.nodes[n].y, tree.nodes[n].z)]
        return ([loss.cpu()] + [g.cpu() for g in tree_leaves(grads)]
                + [t.cpu() for t in leaves]), read_counts()

    apply = ssm.mlstm_apply
    try:
        ssm.mlstm_apply = functools.partial(apply, chunk=chunk)
        got, launches = one_step(dev)
        want, _ = one_step("cpu")
    finally:
        ssm.mlstm_apply = apply
    n_m = cfg.layer_types.count("mlstm")
    what = f"xlstm step {cfg.name} S={S} chunk={chunk}"
    check_counts(what, launches,
                 {"sketch_update": cfg.num_layers + 2 * n_m,
                  "mlstm_chunk": n_m, "mlstm_chunk_bwd": n_m})
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * scale,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
    out = dict(B=B, S=S, chunk=chunk, tol=tol, loss=float(want[0]),
               max_rel_err=err, launches=launches)
    log(f"xlstm step device vs cpu: {json.dumps(out)}")
    return out


def phase_xlstm_train(dev) -> dict:
    """xlstm-1.3b training: (a) the backward kernels at MLSTM_BWD_CASES
    (``phase_mlstm_bwd``); (b) full width at ``layers`` at B 4 x S 512,
    Gaussian then psparse projections (XLSTM_TRAIN), the Gaussian run
    profiled and, on one repeated batch, required to learn (the mean of
    its last 3 losses XLSTM_LEARN_DROP below its first 3's); (c) B 1 x S
    2048 at ``ctx_layers``; (d) reduced xlstm, one step on the card
    against the CPU at each of XLSTM_DVC_STEPS."""
    from repro_torch.configs import get_arch
    x = XLSTM_TRAIN
    cfg = dataclasses.replace(get_arch("xlstm-1.3b"), num_layers=x["layers"])
    out = {"kernel_rows": phase_mlstm_bwd(dev)}
    out["gaussian"] = xlstm_run(dev, cfg, "gaussian", x["steps"], x["batch"],
                                x["seq"], profile=True, repeat_batch=True)
    first, last = (statistics.mean(out["gaussian"]["losses"][:3]),
                   statistics.mean(out["gaussian"]["losses"][-3:]))
    if not last < (1 - XLSTM_LEARN_DROP) * first:
        raise AssertionError(f"xlstm did not learn its repeated batch: mean "
                             f"loss {first:.4f} -> {last:.4f}")
    out["psparse"] = xlstm_run(dev, cfg, "psparse", x["psparse_steps"],
                               x["batch"], x["seq"])
    out["ctx"] = xlstm_run(
        dev, dataclasses.replace(cfg, num_layers=x["ctx_layers"]),
        "gaussian", x["ctx_steps"], x["ctx_batch"], x["ctx_seq"])
    for S, chunk, tol in XLSTM_DVC_STEPS:
        out[f"vs_cpu_s{S}_w{chunk}"] = _xlstm_step_vs_cpu(dev, S, chunk, tol)
    return out


def _rglru_scan_ms(dev, cfg, batch: int, seq: int) -> dict:
    """Device ms of one RG-LRU scan at (batch, seq, lru) in f32, forward
    and backward (``time_ms``), on log a in (-0.1, 0] (the model's decays
    lie in [0.9, 1) at init) and N(0, 1) inputs: the scan's cost a
    layer, which a traced step cannot name (its kernels are PyTorch's
    elementwise ones)."""
    import torch
    from repro_torch.models.rglru import lru_dim, rglru_scan
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (batch, seq, lru_dim(cfg))
    la = torch.rand(shape, generator=gen, device=dev) * -0.1
    b = torch.randn(shape, generator=gen, device=dev)
    dh = torch.randn(shape, generator=gen, device=dev)
    fwd_ms, fwd_call_ms = time_ms(lambda: rglru_scan(la, b), 20, 3)
    fwd_from = time_ms.source
    leaves = [la.requires_grad_(True), b.requires_grad_(True)]
    h = rglru_scan(*leaves)
    bwd_ms, bwd_call_ms = time_ms(lambda: torch.autograd.grad(
        h, leaves, dh, retain_graph=True), 20, 3)
    out = dict(shape=list(shape), fwd_ms=fwd_ms, fwd_call_ms=fwd_call_ms,
               bwd_ms=bwd_ms, bwd_call_ms=bwd_call_ms,
               ms_from=[fwd_from, time_ms.source])
    del la, b, dh, h, leaves
    torch.cuda.empty_cache()
    return out


def _rgemma_step_vs_cpu(dev) -> dict:
    """Reduced recurrentgemma-2b cut to one period and the tail (5
    layers) in f32, B 2 x S 64, sketched FFN backprop and the rglru_h
    carry node (Gaussian, k_max 9): one train step's loss, gradients and
    new tree on the card and on the CPU from one state, within TOL *
    max|CPU| each; the card's step counted."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.sketches import tree_to
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    c = RGEMMA_DVC
    cfg = dataclasses.replace(reduced(get_arch("recurrentgemma-2b")),
                              num_layers=c["layers"])
    run = _launcher_run_config("gaussian", 1, c["batch"], c["seq"],
                               c["k_max"])
    pipe = PipelineConfig(seed=3, global_batch=c["batch"], seq_len=c["seq"],
                          vocab=cfg.vocab_size)
    tokens, labels = host_batch(pipe, 0)
    cpu = init_train_state(0, cfg, run, device="cpu")

    def one_step(where):
        state = init_train_state(0, cfg, run, device=where,
                                 params=cpu.params,
                                 sketch=tree_to(cpu.sketch, where))
        reset_counts()
        loss, _, _, grads, tree = make_train_step(cfg, run).loss_and_grads(
            state, {"tokens": tokens.to(where), "labels": labels.to(where)})
        if where != "cpu":
            torch.cuda.synchronize()
        leaves = [t for n in sorted(tree.nodes) for t in
                  (tree.nodes[n].x, tree.nodes[n].y, tree.nodes[n].z)]
        return ([loss.cpu()] + [g.cpu() for g in tree_leaves(grads)]
                + [t.cpu() for t in leaves]), read_counts()

    got, launches = one_step(dev)
    want, _ = one_step("cpu")
    what = f"recurrentgemma step {cfg.name} S={c['seq']}"
    n_r = cfg.layer_types.count("rglru")
    check_counts(what, launches,
                 {"sketch_update": 2 * cfg.num_layers + n_r,
                  "flash_attention": cfg.num_layers - n_r,
                  "flash_attention_bwd": cfg.num_layers - n_r})
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
    out = dict(c, tol=TOL, loss=float(want[0]), max_rel_err=err,
               launches=launches)
    log(f"recurrentgemma step device vs cpu: {json.dumps(out)}")
    return out


def phase_rgemma_train(dev) -> dict:
    """recurrentgemma-2b training at full width and all 26 layers
    (RGEMMA_TRAIN): (a) B 4 x S 512, Gaussian projections on one repeated
    batch, profiled (the flash kernels' device share; the RG-LRU scan's
    device ms a layer, ``_rglru_scan_ms``) and required to learn (the
    mean of its last 3 losses RGEMMA_LEARN_DROP below its first 3's);
    (b) psparse projections on fresh batches; (c) B 1 x S 4096; (d) the
    reduced step on the card against the CPU."""
    from repro_torch.configs import get_arch
    cfg = get_arch("recurrentgemma-2b")
    x = RGEMMA_TRAIN
    n_r = cfg.layer_types.count("rglru")

    def scan(state, out):
        sc = _rglru_scan_ms(dev, cfg, x["batch"], x["seq"])
        sc["share_of_device_ms"] = n_r * (sc["fwd_ms"] + sc["bwd_ms"]) / \
            out["profile"]["device_ms"]
        return dict(rglru_scan=sc)

    out = {"gaussian": recurrent_run(
        dev, cfg, _launcher_run_config("gaussian", x["steps"], x["batch"],
                                       x["seq"], x["k_max"]),
        repeat_batch=True, profile_extra=scan,
        profile_groups={"flash_fwd": r"flash_fwd", "flash_bwd":
                        r"flash_bwd_(delta|dq|dkdv|sum)"})}
    first, last = (statistics.mean(out["gaussian"]["losses"][:3]),
                   statistics.mean(out["gaussian"]["losses"][-3:]))
    if not last < (1 - RGEMMA_LEARN_DROP) * first:
        raise AssertionError(f"recurrentgemma did not learn its repeated "
                             f"batch: mean loss {first:.4f} -> {last:.4f}")
    out["psparse"] = recurrent_run(
        dev, cfg, _launcher_run_config("psparse", x["psparse_steps"],
                                       x["batch"], x["seq"], x["k_max"]))
    out["ctx"] = recurrent_run(
        dev, cfg, _launcher_run_config("gaussian", x["ctx_steps"],
                                       x["ctx_batch"], x["ctx_seq"],
                                       x["k_max"]))
    out["vs_cpu"] = _rgemma_step_vs_cpu(dev)
    return out


def _moe_layer_ms(dev, state, cfg, batch: int, seq: int) -> dict:
    """Device ms, at the train step's shapes on the trained state, of the
    pieces a traced step cannot name apart: one layer's expert FFN
    forward and backward on its (E, C, d) slab (cuBLAS's batched
    products and the swiglu), and one stacked "expert_in" update
    (``sketch_update`` over the E triples, against the tree's first C
    projection rows)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import _update_expert_triple
    E, d = cfg.num_experts, cfg.d_model
    C = moe.capacity(batch * seq, E, cfg.experts_per_token,
                     cfg.capacity_factor)
    gen = torch.Generator(device=dev).manual_seed(6)
    xg = torch.randn((E, C, d), generator=gen, device=dev).to(cfg.dtype)
    w = [state.params["layers"][0]["moe"][n].detach().requires_grad_(True)
         for n in ("we_gate", "we_up", "we_down")]
    fwd_ms, _ = time_ms(lambda: moe._expert_ffn(xg, *w), 20, 3)
    fwd_from = time_ms.source
    out = moe._expert_ffn(xg, *w)
    dy = torch.randn_like(out)
    bwd_ms, _ = time_ms(lambda: torch.autograd.grad(
        out, w, dy, retain_graph=True), 20, 3)
    bwd_from = time_ms.source
    tree = state.sketch
    node = tree.nodes["expert_in"]
    one = type(node)(x=node.x[0], y=node.y[0], z=node.z[0], psi=node.psi[0])
    st = _launcher_run_config("gaussian", 1, batch, seq,
                              QWEN_TRAIN["k_max"]).sketch
    upd_ms, upd_call_ms = time_ms(lambda: _update_expert_triple(
        one, xg, tree.proj, tree.k_active, st), 50, 5)
    res = dict(experts=E, capacity=C, ffn_fwd_ms=fwd_ms, ffn_bwd_ms=bwd_ms,
               stacked_update_ms=upd_ms, stacked_update_call_ms=upd_call_ms,
               ms_from=[fwd_from, bwd_from, time_ms.source])
    del xg, w, out, dy
    torch.cuda.empty_cache()
    return res


def _moe_step_vs_cpu(dev) -> dict:
    """Reduced qwen3-moe (2 layers, 4 experts top-2) in f32, B 2 x S 64,
    "attn_o" sketched backprop and the "expert_in" stacks (Gaussian,
    k_max 9): one train step's loss, gradients and new tree on the card
    and on the CPU from one state, within TOL * max|CPU| each, and each
    layer's routing selections equal; the card's step counted."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.models import moe
    from repro_torch.optim.flat import tree_leaves
    from repro_torch.sketches import tree_to
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    c = QWEN_DVC
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"))
    run = _launcher_run_config("gaussian", 1, c["batch"], c["seq"],
                               c["k_max"])
    pipe = PipelineConfig(seed=3, global_batch=c["batch"], seq_len=c["seq"],
                          vocab=cfg.vocab_size)
    tokens, labels = host_batch(pipe, 0)
    cpu = init_train_state(0, cfg, run, device="cpu")
    inner = moe.route

    def one_step(where):
        state = init_train_state(0, cfg, run, device=where,
                                 params=cpu.params,
                                 sketch=tree_to(cpu.sketch, where))
        chosen = []

        def route(*a):
            res = inner(*a)
            chosen.append(res[2])
            return res

        moe.route = route
        try:
            reset_counts()
            loss, _, aux, grads, tree = make_train_step(
                cfg, run).loss_and_grads(state, {
                    "tokens": tokens.to(where), "labels": labels.to(where)})
            if where != "cpu":
                torch.cuda.synchronize()
        finally:
            moe.route = inner
        leaves = [t for n in sorted(tree.nodes) for t in
                  (tree.nodes[n].x, tree.nodes[n].y, tree.nodes[n].z)]
        return ([loss.cpu(), aux.cpu()]
                + [g.cpu() for g in tree_leaves(grads)]
                + [t.cpu() for t in leaves]), read_counts(), \
            [t.cpu() for t in chosen]

    got, launches, got_routes = one_step(dev)
    want, _, want_routes = one_step("cpu")
    what = f"MoE step {cfg.name} S={c['seq']}"
    L = cfg.num_layers
    check_counts(what, launches, {"sketch_update": 2 * L,
                                  "flash_attention": L,
                                  "flash_attention_bwd": L})
    if len(got_routes) != L or not all(
            torch.equal(g, w) for g, w in zip(got_routes, want_routes)):
        raise AssertionError(f"{what}: the card's routing differs")
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g - w).abs().max()) / max(scale, 1e-30))
    out = dict(c, tol=TOL, loss=float(want[0]), aux=float(want[1]),
               max_rel_err=err, launches=launches,
               routed=[int(t.numel()) for t in want_routes])
    log(f"MoE step device vs cpu: {json.dumps(out)}")
    return out


def phase_qwen3_moe_train(dev) -> dict:
    """qwen3-moe-30b-a3b training at full width cut to 3 layers
    (QWEN_TRAIN): (a) B 4 x S 512, Gaussian projections on one repeated
    batch, profiled (flash's device share, the idle share; one layer's
    expert FFN and one stacked update timed apart, ``_moe_layer_ms``)
    and required to learn (the mean of its last 3 losses QWEN_LEARN_DROP
    below its first 3's); (b) psparse projections on fresh batches; (c)
    the reduced step on the card against the CPU."""
    from repro_torch.configs import get_arch
    x = QWEN_TRAIN
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                              num_layers=x["layers"])

    def layer(state, out):
        ms = _moe_layer_ms(dev, state, cfg, x["batch"], x["seq"])
        dev_ms = out["profile"]["device_ms"]
        ms["ffn_share_of_device_ms"] = cfg.num_layers * (
            ms["ffn_fwd_ms"] + ms["ffn_bwd_ms"]) / dev_ms
        ms["stacked_update_share_of_device_ms"] = \
            cfg.num_layers * ms["stacked_update_ms"] / dev_ms
        return dict(moe_layer=ms)

    out = {"gaussian": recurrent_run(
        dev, cfg, _launcher_run_config("gaussian", x["steps"], x["batch"],
                                       x["seq"], x["k_max"]),
        repeat_batch=True, profile_extra=layer,
        profile_groups={"flash_fwd": r"flash_fwd", "flash_bwd":
                        r"flash_bwd_(delta|dq|dkdv|sum)"})}
    first, last = (statistics.mean(out["gaussian"]["losses"][:3]),
                   statistics.mean(out["gaussian"]["losses"][-3:]))
    if not last < (1 - QWEN_LEARN_DROP) * first:
        raise AssertionError(f"qwen3-moe did not learn its repeated batch: "
                             f"mean loss {first:.4f} -> {last:.4f}")
    out["psparse"] = recurrent_run(
        dev, cfg, _launcher_run_config("psparse", x["psparse_steps"],
                                       x["batch"], x["seq"], x["k_max"]))
    out["vs_cpu"] = _moe_step_vs_cpu(dev)
    return out


def _lm_steps_vs_cpu(dev, what: str, cfg, run, *, steps: int = 1,
                     patch: bool = False) -> dict:
    """``steps`` train steps of the reduced ``cfg`` under ``run`` (one
    device or W workers) on the card and on the CPU, from one state and
    the same batches (with ``patch`` stand-in patch embeddings in each,
    ``models.frontends.fake_patch_embeds``): losses within rtol TOL, the
    parameters, every sketch triple and the count sketch's {u, v} within
    TOL * max|CPU|; the card's launches counted (``_train_counts``)."""
    import torch
    from repro_torch.data.pipeline import PipelineConfig, host_batch
    from repro_torch.models.frontends import fake_patch_embeds
    from repro_torch.optim.flat import FlatLayout
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    B, S = run.global_batch, run.seq_len
    pipe = PipelineConfig(seed=3, global_batch=B, seq_len=S,
                          vocab=cfg.vocab_size)
    gen = torch.Generator().manual_seed(3)
    batches = []
    for s in range(steps):
        tokens, labels = host_batch(pipe, s)
        batches.append({"tokens": tokens, "labels": labels})
        if patch:
            batches[-1]["patch_embeds"] = fake_patch_embeds(
                gen, B, cfg.num_frontend_tokens, cfg.d_model, cfg.dtype)
    cpu0 = init_train_state(0, cfg, run, device="cpu")

    def drive(where):
        state = init_train_state(0, cfg, run, device=where,
                                 params=cpu0.params, sketch=cpu0.sketch)
        step = make_train_step(cfg, run)
        reset_counts()
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(where) for k, v in b.items()})
            losses.append(float(m["loss"]))
        if where != "cpu":
            torch.cuda.synchronize()
        return state, losses, read_counts()

    got, loss_d, launches = drive(dev)
    want, loss_c, _ = drive("cpu")
    check_counts(what, launches, _train_counts(cfg, run, steps))
    torch.testing.assert_close(torch.tensor(loss_d), torch.tensor(loss_c),
                               rtol=TOL, atol=0, msg=lambda m: f"{what}: {m}")
    lay = FlatLayout(want.params)
    pairs = [("params", lay.ravel(got.params), lay.ravel(want.params))]
    pairs += [(f"{n}.{a}", getattr(got.sketch.nodes[n], a), getattr(node, a))
              for n, node in want.sketch.nodes.items() for a in "xyz"]
    pairs += [(f"err.{k}", got.opt["err"][k], v)
              for k, v in want.opt.get("err", {}).items()]
    errs = {}
    for name, g, w in pairs:
        g, scale = g.cpu(), float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale,
                                   msg=lambda m: f"{what} {name}: {m}")
        errs[name] = float((g - w).abs().max()) / max(scale, 1e-30)
    if got.skipped or want.skipped:
        raise AssertionError(f"{what}: skipped {got.skipped}/{want.skipped}")
    out = dict(batch=B, seq=S, steps=steps, workers=run.dp_workers,
               seconds=time.perf_counter() - t0, tol=TOL,
               losses_card=loss_d, losses_cpu=loss_c,
               max_rel_err=max(errs.values()), rel_err=errs,
               launches=launches)
    log(f"{what}: " + json.dumps(out))
    return out


def phase_musicgen_train(dev) -> dict:
    """musicgen-large training at full width and all 48 layers
    (MUSICGEN_TRAIN): (a) B 4 x S 512, Gaussian projections on one
    repeated batch, profiled (the flash kernels' device share) and
    required to learn (the mean of its last 3 losses MUSICGEN_LEARN_DROP
    below its first 3's); (b) psparse projections on fresh batches."""
    from repro_torch.configs import get_arch
    cfg = get_arch("musicgen-large")
    x = MUSICGEN_TRAIN
    out = {"gaussian": recurrent_run(
        dev, cfg, _launcher_run_config("gaussian", x["steps"], x["batch"],
                                       x["seq"], x["k_max"]),
        repeat_batch=True,
        profile_groups={"flash_fwd": r"flash_fwd", "flash_bwd":
                        r"flash_bwd_(delta|dq|dkdv|sum)"})}
    first, last = (statistics.mean(out["gaussian"]["losses"][:3]),
                   statistics.mean(out["gaussian"]["losses"][-3:]))
    if not last < (1 - MUSICGEN_LEARN_DROP) * first:
        raise AssertionError(f"musicgen did not learn its repeated batch: "
                             f"mean loss {first:.4f} -> {last:.4f}")
    out["psparse"] = recurrent_run(
        dev, cfg, _launcher_run_config("psparse", x["psparse_steps"],
                                       x["batch"], x["seq"], x["k_max"]))
    return out


def phase_internvl2_train_vs_cpu(dev) -> dict:
    """Reduced internvl2-76b (2 layers, 4 patch positions), two train
    steps with stand-in patch embeddings spliced over the first positions,
    on the card against the CPU (``_lm_steps_vs_cpu``)."""
    from repro_torch.configs import get_arch, reduced
    c = REDUCED_DVC
    cfg = reduced(get_arch("internvl2-76b"))
    run = _launcher_run_config("gaussian", 2, c["batch"], c["seq"],
                               c["k_max"])
    return _lm_steps_vs_cpu(dev, "internvl2 steps with patch embeddings",
                            cfg, run, steps=2, patch=True)


def _dp_fields(workers: int) -> dict:
    return dict(dp_axis_name="data", dp_workers=workers,
                dp_collective="fused", ring_wire=True)


def phase_recurrent_dp(dev) -> dict:
    """xlstm-1.3b and recurrentgemma-2b trained data-parallel
    (RECURRENT_DP: W 2 workers on the fp32 ring, the fused layout) at
    full width cut to RECURRENT_DP_LAYERS, each worker's carry rows
    against its own projections; then a reduced W 2 step of each on the
    card against the CPU."""
    from repro_torch.configs import get_arch, reduced
    x, c = RECURRENT_DP, REDUCED_DVC
    k_max = {"xlstm-1.3b": XLSTM_TRAIN["k_max"],
             "recurrentgemma-2b": RGEMMA_TRAIN["k_max"]}
    clip = {"xlstm-1.3b": XLSTM_GRAD_CLIP, "recurrentgemma-2b": 1.0}
    out = {}
    for arch, layers in RECURRENT_DP_LAYERS.items():
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        run = _launcher_run_config(
            "gaussian", x["steps"], x["batch"], x["seq"], k_max[arch],
            grad_clip=clip[arch], **_dp_fields(x["workers"]))
        # xlstm's step is its workers' sLSTM loops on the host (88% idle
        # at 16 layers on an H100): profiling its 20,000 launches would
        # cost more than the run
        out[arch] = recurrent_run(
            dev, cfg, run, profile_groups=None if arch == "xlstm-1.3b"
            else {})
    for arch in RECURRENT_DP_LAYERS:
        cfg = reduced(get_arch(arch))
        run = _launcher_run_config(
            "gaussian", 1, c["batch"], REDUCED_DVC_SEQ.get(arch, c["seq"]),
            c["k_max"], **_dp_fields(x["workers"]))
        out[f"{arch}/vs_cpu"] = _lm_steps_vs_cpu(
            dev, f"{arch} W {x['workers']} step", cfg, run)
    return out


def phase_recurrent_cs(dev) -> dict:
    """xlstm-1.3b and recurrentgemma-2b trained with the fp32 count
    sketch (RECURRENT_CS) on one device at full width cut to
    RECURRENT_CS_LAYERS: no skip, and the mass check on one more step
    (v_new + update = v_pre away from the sent coordinates); then a
    reduced compressed step of each on the card against the CPU, fp32
    and the int8 table with p2."""
    from repro_torch.configs import get_arch, reduced
    x, c = RECURRENT_CS, REDUCED_DVC
    out = {}
    for arch, layers in RECURRENT_CS_LAYERS.items():
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        clip = XLSTM_GRAD_CLIP if arch == "xlstm-1.3b" else 1.0
        k_max = XLSTM_TRAIN["k_max"] if arch == "xlstm-1.3b" \
            else RGEMMA_TRAIN["k_max"]
        run = _launcher_run_config("gaussian", x["steps"], x["batch"],
                                   x["seq"], k_max, grad_clip=clip,
                                   compression=x["compression"])
        out[arch] = recurrent_run(dev, cfg, run)
    small = dict(mode="countsketch", cs_cols=512, cs_k=64)
    for arch in RECURRENT_CS_LAYERS:
        cfg = reduced(get_arch(arch))
        for label, comp in (("fp32", small),
                            ("int8_p2", dict(small, wire_dtype="int8",
                                             cs_p2=2))):
            run = _launcher_run_config(
                "gaussian", 2, c["batch"] // 2,
                REDUCED_DVC_SEQ.get(arch, c["seq"]), c["k_max"],
                compression=comp)
            out[f"{arch}/vs_cpu_{label}"] = _lm_steps_vs_cpu(
                dev, f"{arch} compressed ({label}) steps", cfg, run, steps=2)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"chip_smoke: no src/repro_torch beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    # one nvcc per source, all started together
    t_start = t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        log(f"nvcc {name}:\n{text}")
    card = gpu_line()
    print(card, flush=True)
    log(f"built in {build_s:.1f}s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # wall seconds of each phase (the script must end inside the
    # contract's 1200 s, build included)
    phase_s = {"build": build_s}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    kernel_rows = timed("kernels", phase_kernels, dev)
    kernel_rows.update(timed("cs_kernels", phase_cs_kernels, dev))
    kernel_rows.update(timed("flash", phase_flash, dev))
    kernel_rows.update(timed("mlstm", phase_mlstm, dev))
    kernel_rows.update(timed("ring", phase_ring, dev))
    saved_bytes = timed("saved_bytes", phase_saved_bytes, dev)
    serve = timed("serve", phase_serve, dev, get_arch("tinyllama-1.1b"),
                  batch=8, prompt_len=128, new_tokens=32, refill_len=64,
                  max_context=256)
    # gemma3-27b at full width, cut to one pattern period (5 local, 1
    # global); prompts of twice the window
    gemma = dataclasses.replace(get_arch("gemma3-27b"), num_layers=6)
    serve_gemma = timed("serve_gemma3", phase_serve, dev, gemma, batch=2,
                        prompt_len=2048, new_tokens=16, refill_len=1100,
                        max_context=2304)
    # xlstm-1.3b at full width, one pattern period, random bf16 weights
    serve_xlstm = timed("serve_xlstm", phase_serve, dev,
                        dataclasses.replace(get_arch("xlstm-1.3b"),
                                            num_layers=XLSTM_SERVE_LAYERS),
                        **XLSTM_SERVE)
    # recurrentgemma-2b at full width cut in depth, random bf16 weights
    serve_rgemma = timed("serve_recurrentgemma", phase_serve, dev,
                         dataclasses.replace(get_arch("recurrentgemma-2b"),
                                             num_layers=RGEMMA_SERVE_LAYERS),
                         **RGEMMA_SERVE)
    # qwen3-moe-30b-a3b at full width cut in depth, random weights drawn
    # in bf16
    serve_qwen = timed("serve_qwen3_moe", phase_serve, dev,
                       dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                                           num_layers=QWEN_SERVE_LAYERS),
                       **QWEN_SERVE, draw_in_dtype=True)
    # musicgen-large at full width and depth; internvl2-76b at full width
    # cut in depth, its weights drawn in bf16
    serve_musicgen = timed("serve_musicgen", phase_serve, dev,
                           get_arch("musicgen-large"), **MUSICGEN_SERVE)
    serve_internvl = timed(
        "serve_internvl2", phase_serve, dev,
        dataclasses.replace(get_arch("internvl2-76b"),
                            num_layers=INTERNVL_SERVE_LAYERS),
        **INTERNVL_SERVE, draw_in_dtype=True)
    dvc = timed("device_vs_cpu", phase_device_vs_cpu, dev)
    # reduced xlstm, two 256-token chunks a prompt
    dvc_xlstm = timed("device_vs_cpu_xlstm", phase_device_vs_cpu, dev,
                      "xlstm-1.3b", S0=512, refill_len=16, max_context=530,
                      tol=XLSTM_DVC_TOL, scaled=True)
    mnist = timed("mnist_mlp", phase_train_mnist, dev)
    pair = timed("monitor_pair", phase_monitor_pair, dev)
    train_dvc = timed("train_device_vs_cpu", phase_train_device_vs_cpu, dev)
    lm_step_dvc = timed("lm_step_device_vs_cpu",
                        phase_lm_step_device_vs_cpu, dev)
    lm = timed("lm_train", phase_lm_train, dev)
    launcher = timed("lm_launcher", phase_launcher, dev)
    dp = timed("dp_train", phase_dp_train, dev)
    dp_dvc = timed("dp_device_vs_cpu", phase_dp_vs_cpu, dev)
    dp_launcher = timed("dp_launcher", phase_dp_launcher, dev)
    paper = timed("paper_experiments", phase_paper_experiments, dev)
    xlstm = timed("xlstm_train", phase_xlstm_train, dev)
    kernel_rows["mlstm_chunk_bwd"] = xlstm.pop("kernel_rows")
    rgemma = timed("recurrentgemma_train", phase_rgemma_train, dev)
    qwen = timed("qwen3_moe_train", phase_qwen3_moe_train, dev)
    musicgen = timed("musicgen_train", phase_musicgen_train, dev)
    internvl = timed("internvl2_train_vs_cpu", phase_internvl2_train_vs_cpu,
                     dev)
    rec_dp = timed("recurrent_dp", phase_recurrent_dp, dev)
    rec_cs = timed("recurrent_cs", phase_recurrent_cs, dev)
    dp_phases_s = sum(phase_s[k] for k in
                      ("dp_train", "dp_device_vs_cpu", "dp_launcher"))
    log(f"data-parallel phases: {dp_phases_s:.1f} s")

    # launches on every counted run of the paths, and per path
    by_path = {"serve/gaussian": serve["launches"],
               "serve/psparse": serve["psparse_launches"],
               "serve_gemma3/gaussian": serve_gemma["launches"],
               "serve_gemma3/psparse": serve_gemma["psparse_launches"],
               "serve_xlstm/gaussian": serve_xlstm["launches"],
               "serve_xlstm/psparse": serve_xlstm["psparse_launches"],
               "serve_recurrentgemma/gaussian": serve_rgemma["launches"],
               "serve_recurrentgemma/psparse":
                   serve_rgemma["psparse_launches"],
               "serve_qwen3_moe/gaussian": serve_qwen["launches"],
               "serve_qwen3_moe/psparse": serve_qwen["psparse_launches"],
               "serve_vs_cpu/tinyllama": dvc["launches"],
               "serve_vs_cpu/xlstm": dvc_xlstm["launches"],
               **{f"mnist_mlp/{k}": v["launches"] for k, v in mnist.items()},
               **{k: v["launches"] for k, v in pair.items()},
               **{f"lm_step_vs_cpu/{k}": v["launches"]
                  for k, v in lm_step_dvc.items()},
               **{f"lm/{k}": v["launches"] for k, v in lm.items()},
               "lm_launcher": launcher["launches"],
               **{f"dp/{k}": v["launches"] for k, v in dp.items()},
               **{f"dp_vs_cpu/{k}": v["launches"] for k, v in dp_dvc.items()},
               "dp_launcher": dp_launcher["launches"],
               **{f"paper/{k}": v["launches"] for k, v in paper.items()
                  if isinstance(v, dict) and "launches" in v},
               **{f"xlstm_train/{k}": v["launches"]
                  for k, v in xlstm.items()},
               **{f"recurrentgemma_train/{k}": v["launches"]
                  for k, v in rgemma.items()},
               **{f"qwen3_moe_train/{k}": v["launches"]
                  for k, v in qwen.items()},
               "serve_musicgen/gaussian": serve_musicgen["launches"],
               "serve_musicgen/psparse": serve_musicgen["psparse_launches"],
               "serve_internvl2/gaussian": serve_internvl["launches"],
               "serve_internvl2/psparse": serve_internvl["psparse_launches"],
               **{f"musicgen_train/{k}": v["launches"]
                  for k, v in musicgen.items()},
               "internvl2_vs_cpu": internvl["launches"],
               **{f"recurrent_dp/{k}": v["launches"]
                  for k, v in rec_dp.items()},
               **{f"recurrent_cs/{k}": v["launches"]
                  for k, v in rec_cs.items()}}
    sources = {"sketch_update": ("src/repro_torch/csrc/sketch_update.cu",
                                 "src/repro/kernels/sketch_update.py:60",
                                 "prefill"),
               "psparse_update": ("src/repro_torch/csrc/psparse_update.cu",
                                  "src/repro/kernels/psparse_update.py:249",
                                  "mnist_mlp"),
               "csvec_insert": ("src/repro_torch/csrc/csvec_insert.cu",
                                "src/repro/kernels/csvec_insert.py:62",
                                "train"),
               "csvec_topk": ("src/repro_torch/csrc/csvec_topk.cu",
                              "src/repro/kernels/csvec_topk.py:199",
                              "train_k256"),
               "csvec_quant": ("src/repro_torch/csrc/csvec_quant.cu",
                               "src/repro/kernels/csvec_quant.py:61",
                               "train"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:81",
                                   "tinyllama_ctx"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "gradient of src/repro/kernels/ref.py::"
                   "flash_attention_ref; no Pallas backward",
                   "tinyllama_ctx"),
               "mlstm_chunk": ("src/repro_torch/csrc/mlstm_chunk.cu",
                               "src/repro/kernels/mlstm_chunk.py:74",
                               "serve_bf16"),
               "mlstm_chunk_bwd": (
                   "src/repro_torch/csrc/mlstm_chunk_bwd.cu",
                   "gradient of src/repro/models/ssm.py::_mlstm_chunk_scan; "
                   "no Pallas backward", "train_bf16"),
               "ring_allreduce": ("src/repro_torch/csrc/ring_allreduce.cu",
                                  "src/repro/kernels/ring_allreduce.py:209",
                                  "fused_w4_fp32")}
    kernels = []
    for name, (source, replaces, main_case) in sources.items():
        rows = kernel_rows[name]
        main_row = next(r for r in rows
                        if r.get("case_k", r["case"]) == main_case)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[name] for c in by_path.values()),
            launches_by_path={p: c[name] for p, c in by_path.items()
                              if c[name]},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], main_case=main_row,
            stacked=[r for r in rows if "experts" in r] or None,
            by_shape=rows))
    kernels[0]["kernel_launches"] = serve["kernel_launches"]
    kernels[1]["kernel_launches"] = serve["psparse_kernel_launches"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, torch=torch.__version__,
        cuda=torch.version.cuda, kernels=kernels,
        flash_saved_bytes=saved_bytes, serve=serve, serve_gemma3=serve_gemma,
        serve_xlstm=serve_xlstm, serve_recurrentgemma=serve_rgemma,
        serve_qwen3_moe=serve_qwen,
        device_vs_cpu=dvc,
        device_vs_cpu_xlstm=dvc_xlstm, mnist_mlp=mnist, monitor_pair=pair,
        train_device_vs_cpu=train_dvc, lm_step_device_vs_cpu=lm_step_dvc,
        lm_train=lm, lm_launcher=launcher, dp_train=dp,
        dp_device_vs_cpu=dp_dvc, dp_launcher=dp_launcher,
        dp_phases_s=dp_phases_s, paper_experiments=paper,
        xlstm_train=xlstm, recurrentgemma_train=rgemma,
        qwen3_moe_train=qwen, serve_musicgen=serve_musicgen,
        serve_internvl2=serve_internvl, musicgen_train=musicgen,
        internvl2_train_vs_cpu=internvl, recurrent_dp=rec_dp,
        recurrent_cs=rec_cs, phase_s=phase_s, total_s=time.perf_counter()
        - t_start),
        indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
