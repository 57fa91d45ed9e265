#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. the card: name and power limit, torch and CUDA versions;
  2. the build: compiles the Hopper kernels of src/repro_torch/csrc;
  3. the kernels: each kernel against its plain PyTorch version at the
     shapes its path gives it -- mx_gemm's weight-streaming tile (M <=
     32) at M 4 (decode), 16 (verify) and 32 (prefill chunk) over
     full-width phi3-mini-3.8b's, h2o-danube-3-4b's, phi3.5-moe-42b-
     a6.6b's and deepseek-v2-lite-16b's serving shapes (N 64 to
     102,400, K 10,944), the rows of the M 4 and M 16 calls bitwise
     those of the M 32 call; the calibration fused_quant_gemm (the
     mx_quant kernel then that tile; phi3-mini's shapes at M 32, the
     MoE's at M 4, 16 and 32, deepseek's at M 32 with its latent
     up-projections' K 512, and its wo at M 4) and paged decode
     attention (phi3-mini's 4
     pages a slot and the MoE's GQA 8 x 4, Dh 128, within 1e-5, and 256
     pages a slot at ~4,000 live slots, within attn_limit); mx_gemm's
     wgmma
     tile (M > 32: mx_gemm_tiled) at
     Table 6's shapes, h2o-danube-3-4b's 4160-token prefill, a ragged
     shape and deepseek's prefill of w_uk / w_uv (M 48, K 512), in all
     four operand formats, two calls bitwise equal; and
     olmo-7b training shapes (M = 2048 tokens) and deepseek's (M 8192:
     w_kr's N 64 and K 64, dense0's 10,944) for
     fused_quant_gemm_tiled (fused_quant_gemm at M > 32, the mx_quant
     kernel then the wgmma tile: forward e4m3, dx e5m2 on the transposed
     weights) and mx_dw_gemm (the dw_requant pass, then the wgmma tile
     on its payload; the payload bitwise, two calls bitwise equal, the
     pass timed alone too) -- with
     its time (CUDA events, median of 20 cold-L2 launches; a call under
     0.1 ms in batches, see Timer), the plain version's, the bound
     (bytes over 3.35 TB/s or operations over the peak for the operands'
     type, 1979 TFLOP/s for fp8 and 989 for bf16, whichever is larger)
     and a PyTorch library call where one computes the same function;
     the baselines' kernels at the same
     training shapes: group_gemm (the per_group forward, dx and dW, on
     the wgmma tile with the per-group rescale at its K-128 promotion,
     with torch._scaled_mm beside it as well), mx_quant (the
     quantizer's group pass) and global_amax (its level-1 scale, one
     pass over x; bitwise its plain version on the training inputs and
     on NaN, inf, zero, subnormal and ragged inputs), each timed alone
     and the two as the linear layers call them; the contiguous (ring) decode attention at
     h2o-danube-3-4b's decode shape (two rows wrapped past C = 4096,
     two partial) and at recurrentgemma-2b's local-attention shape (G
     10, Dh 256), fp8 and bf16, beside SDPA on a bf16 cache, within 1e-5
     plus twice the plain version's own error against float64 (see
     attn_limit); the verify (q_len > 1) form of both decode kernels at
     phi3-mini's verify step (S 4, G 1; paged and contiguous, 64 and
     ~4096 slots), at h2o-danube-3-4b's widths (contiguous,
     unwrapped, S 4, G 4) and at the MoE's (paged, S 4, G 4), within
     the same limit of the 5-D plain version and each draft row bitwise
     the q_len = 1 kernel at that draft's limit; each decode line also
     prints the kernel's share of its bound and its time over SDPA's;
     paged decode attention at stablelm-12b's Dh 160 and minitron-8b's
     Dh 128 (GQA 8 x 4); and the 256,000-wide heads: mx_gemm's M <= 32
     tile over stablelm's, minitron's and recurrentgemma's heads, and
     at minitron's training shape (M 4096, N or K 256,000)
     fused_quant_gemm forward and dx, mx_dw_gemm and mx_quant; the same
     tile over rwkv6-3b's decode shapes (N 160 and 64 among them) and
     musicgen-medium's head, the training kernels at rwkv6's ragged N
     160 and 64 (M 4096), and the contiguous decode attention at
     musicgen's Server shape (24 kv heads, G 1, Dh 64);
  4. the engine: phi3-mini-3.8b at full width on random weights from a
     seed serves 8 requests through the paged engine; every serving
     kernel must have been launched on that path (the calibration's
     fused_quant_gemm calls each one global_amax and one mx_quant
     launch); a second run from the
     same seed must give the same streams; under identity placement
     (REPRO_PAGED_PLACEMENT=identity) the streams equal the floating
     pages' token for token; the legacy Server (REPRO_SERVE_PAGED=0)
     serves them too; speculative verify (spec_decode=True, k 4) serves
     them with the n-gram draft, an oracle draft of the plain streams and
     the oracle under identity placement, each stream equal to the plain
     one, launching the verify forms; 2 prompts of ~4000 tokens give the
     same streams plainly and with the oracle draft (depth cut to 8
     layers); the reference's
     three serving switches, each for one run (REPRO_SERVE_PREQUANT=0:
     no mx_quant launch but the calibration's, streams phase 4's up to
     a tie; REPRO_SERVE_DELAYED_ACT=0: fused_quant_gemm at every
     quantized site of every decode step; REPRO_DECODE_ATTN=einsum: no
     decode_attn launch, and every attention call of a second run within
     attn_limit of the kernel on the same rows); the prefix cache at
     its default (Engine(num_slots=4, max_len=640), 8 layers: phase 4's
     requests,
     then 6 requests sharing a 512-token system prompt and the prompt
     alone: 6 hits, 5 · 512 + 511 prompt tokens skipped, a
     copy-on-write that leaves the donor's pages byte for byte, the
     wave's streams those of REPRO_PREFIX_CACHE=0 bit for bit, and in
     a bf16-cache run at 4 layers the full hit's too); preemption to
     the host (num_pages=12 where 32 back the slots: 8 requests of 64
     new tokens preempt and swap back in, each victim's pages byte for
     byte after its round trip, the streams those of a fully backed
     pool, at 8 layers, a decode row's logits at B 1 bitwise the same
     row's at B 4; REPRO_PREEMPTION=0 at 4 layers the same, with no
     preemption); observability at 8 layers (phase engine obs: under
     REPRO_QUANT_HEALTH=1 the streams those of the health-off engine,
     the sampled calls those the countdown predicts, an unsampled decode
     step launching on the card exactly what a health-off step launches
     and a sampled one more, act scales x 0.25 recommending a refresh and
     refresh_act_scales() giving back the calibration bit for bit;
     REPRO_KV_CACHE=bf16: the streams of kv_cache_dtype="bf16", every
     paged decode attention call on the bf16 pool beside its plain
     version, a decode and a verify row at B 1 bitwise at B 4, a
     preempting 12-page bf16 pool (4 layers) the fully backed pool's
     streams; the serving CLI's --metrics-out and --trace-out, one
     engine.step span a step, a traced and an untraced decode step
     launching alike; a traced moss olmo-7b step's train.data and
     train.step spans); the per_group and per_tensor recipes serving phase
     4's requests at 8 layers (group_gemm at every quantized site of
     every decode step and prefill chunk and of the calibration, none in
     per_tensor; both recipes' steps on the card against the CPU, on
     the smoke model and at full width, 2 layers, with the CPU's
     calibrated scales; group_gemm at M 4, 16 and 32
     over phi3-mini's decode shapes within 1e-5 of its plain
     version); phi3.5-moe-
     42b-a6.6b at full width, depth cut to 4 layers, serving 8 requests
     on floating pages through the masked dense combine (each decode
     step's launches as counted from the code: 3 expert GEMMs per
     expert per layer, the attention's 4 and the head's; the
     calibration's fused_quant_gemm per (layer, expert) site), equal
     streams on a second run, on identity rows and with speculative
     verify (oracle draft); deepseek-v2-lite-16b (MLA, 64 experts top-6
     and 2 shared, a leading dense layer) at full width, 4 of 27 layers,
     serving 8 requests through the default Engine (identity rows and
     the whole-prompt prefill on its latent cache; each decode step's
     launches as counted from the code: the M <= 32 tile at every
     delayed site, 192 a MoE layer, and one just-in-time fused call
     for each layer's wo; no decode attention kernel), equal streams on
     a second run; phi3.5-moe (4 layers) in per_group and per_tensor
     (each decode step's launches as counted: group_gemm at every
     (layer, expert) site in per_group), and in each served recipe a
     decode row at B 1 against the same row at B 4 (the streams served
     one at a time must equal the mixed batch's wherever they differ);
     then
     h2o-danube-3-4b (sliding window 4096) at full
     width, 12 of its 24 layers, serves 6 requests whose rings wrap, through
     identity rows and the whole-prompt prefill, launching decode_attn
     and not decode_attn_paged, with equal streams on a second run;
     stablelm-12b and minitron-8b at full width, 8 layers, on floating
     pages, and recurrentgemma-2b at full width, 8 of 26 layers (two
     griffin units and the tail), on identity rows, phase 4's requests
     and one of 2,100 prompt tokens whose 2048-slot ring wraps, each
     decode step's launches as counted from the code; rwkv6-3b at full
     width, 8 of 32 layers, on identity rows, a decode row at B 1
     bitwise the same row at B 4 (the legacy Server of both is held to
     the reference's Server on the CPU, tests/test_torch_archs.py);
     musicgen-medium (12 of 48 layers) and phi-3-vision-4.2b (8 of 32) through
     the legacy Server, their engines refusing them; the
     port on the card must agree with the port on the CPU on smoke-size
     models (phi3-mini's chunked step, also under the two scale
     switches, phi3.5-moe's steps and its engine's streams, deepseek's
     engine streams, h2o's prefill past the window and its ring decode,
     stablelm's and minitron's chunked steps, recurrentgemma's prefill
     and decode past its window, rwkv6's, musicgen's and
     phi-3-vision's prefill and decode);
  5. the ablation (the paper's Table 6): the quantizer/GEMM entry points
     of kernels.ops at its three (M, N, K) shapes -- the MOSS GEMM
     (mx_gemm's wgmma tile), the COAT GEMM (group_gemm: the same tile,
     each K-128 partial sum rescaled by its row's group scale), the port's
     per-tensor GEMM (pt_matmul, f32 upcast product), TE's fp8 GEMM
     (torch._scaled_mm, cuBLASLt), bf16 torch.matmul, the fused MOSS
     linear layer (moss_linear: fused_quant_gemm at M > 32, the mx_quant
     kernel then the wgmma tile) and the three quantizers -- once as a
     user calls them (each kernel launched exactly as counted,
     moss_linear must agree with its plain version), then timed;
  6. training: olmo-7b at full width, depth cut to 4 layers, takes 3
     moss, 3 bf16, 3 per_group and 3 per_tensor steps of batch 1 x 2048
     tokens from the same weights and batches; each quantized recipe
     must launch exactly its kernels the counted number of times;
     llama2-7b (RMSNorm) at full width, 4 layers, 3 moss and 3 bf16
     steps of 1 x 4096 tokens under the same gates; the smoke-size
     olmo-7b trains 3 steps in moss, per_group and per_tensor, and the
     smoke-size llama2-7b in moss, on the card and on the CPU from the
     same initial state and batches, each device on its own
     trajectory;
  7. MoE training: phi3.5-moe-42b-a6.6b at full width, depth cut to 1
     layer, batch 2 x 4096 (8192 tokens: the grouped route): moe_gmm (the
     mx_quant kernel over the buffer, then the wgmma tile per row block,
     column tile and expert) and moe_dw_gemm (the dw_requant pass, then
     the wgmma tile per k tile, n tile and expert) against their plain
     versions on layer 0's routing of the first batch (up, down, dx, dW;
     an empty and a full expert; moe_gmm's rows past each expert's size
     exactly 0; the dW twice bitwise, an empty expert's exactly 0),
     timed beside bf16 torch.bmm; then 3 moss and 3 bf16 steps from
     the same weights and batches, each moss step launching exactly its
     kernels, none in bf16; deepseek-v2-lite-16b at full width, 3 of 27
     layers (dense0 + 2 MoE), 2 x 4096: the same moe_gmm / moe_dw_gemm
     checks at E 64, then 3 moss and 3 bf16 steps, finite, the loss
     falling, each moss step's launches as counted; the smoke-size MoE
     and deepseek train 3 moss steps on the grouped route on the card
     and on the CPU (phase 6's check); phi3.5-moe's moss steps again
     under REPRO_MOE_EXPERTS=vmapped (the experts one by one: each
     step's launches as counted, losses within 1e-2 of the grouped
     steps', both times printed); stablelm-12b (2 layers), minitron-8b
     (1 layer) and recurrentgemma-2b (5 layers: a griffin unit and the
     2-layer tail), rwkv6-3b (4 layers), musicgen-medium (4) and
     phi-3-vision-4.2b (4; both on the frontend stub's embeddings) at
     full width, 3 moss and 3 bf16 steps of 1 x 4096 each, launches as
     counted; their smoke models in moss on the card and on the CPU
     (phase 6's check);
  8. the kernels line (JSON; group_gemm with a "serving" entry: its
     times at the serving rows, its launches the per_group steps' and
     engine's; a "deepseek" entry where a kernel was checked at
     deepseek's shapes or launched on its serving or training path,
     with those launches; a "families" entry with the checks at the
     six families' shapes and their launches; group_gemm's
     "moe_baselines" and moe_gmm's "vmapped_ab"), the card line, and
     the last line
     {"ok": true, "device": {...}}.

Each phase prints its wall seconds, and the script its total.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
FP8_FLOPS = 1979e12                 # dense fp8 tensor-core peak
ARCH = "phi3-mini-3.8b"
GEMM_KN = [(3072, 3072), (3072, 8192), (8192, 3072), (3072, 32064)]
# h2o-danube-3-4b's decode GEMMs (K, N): q and o, k and v, gate and up,
# the head, down
H2O_DECODE_KN = [(3840, 3840), (3840, 960), (3840, 10240), (3840, 32000),
                 (10240, 3840)]
# phi3.5-moe-42b-a6.6b's decode GEMMs (K, N): q and o, k and v, each
# expert's up and gate, its down, the head
MOE_DECODE_KN = [(4096, 4096), (4096, 1024), (4096, 6400), (6400, 4096),
                 (4096, 32064)]
# mx_gemm's M <= 32 tile: decode (batch 4), verify (4 x 4 drafts) and
# prefill-chunk (32 tokens) rows
SMALL_M = (4, 16, 32)
TRAIN_ARCH = "olmo-7b"
TRAIN_LAYERS = 4                    # of 32: f32 master + grads + moments
TRAIN_M = 2048                      # batch 1 x seq 2048 (paper Table 8)
TRAIN_KN = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 50304)]
# the quantizer's timed shapes ((M, K), fmt, x dtype): olmo-7b's forward
# input (bf16 activations, e4m3) and its down projection's dx input (the
# f32 gradient, e5m2); the first is the kernels line's entry
QUANT_TIMED = [((TRAIN_M, 4096), "e4m3", "bfloat16"),
               ((TRAIN_M, 11008), "e5m2", "float32")]
# the paper's Table 6 GEMM shapes (M, N, K), as benchmarks/run.py has them
TABLE6_MNK = [(2048, 7168, 4096), (4096, 2048, 7168), (4096, 4096, 8192)]
# mx_gemm's wgmma tile (M > 32) at (M, N, K): Table 6; h2o-danube-3-4b's
# whole-prompt prefill of 4160 tokens (qkv, o, gate and up, down); a
# ragged shape (M, N not multiples of 128, K % 64 == 32); the first is
# the kernels line's mx_gemm_tiled entry
TILED_MNK = TABLE6_MNK + [(4160, 5760, 3840), (4160, 3840, 3840),
                          (4160, 10240, 3840), (4160, 3840, 10240),
                          (130, 200, 96)]
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 1                      # of 32: f32 master + grads + moments
MOE_BATCH, MOE_SEQ = 2, 4096        # 8192 tokens > 4096: the grouped route
# of 32: 32 layers are ~84 GB in bf16 (launch/profile_serve.py's
# MOE_SERVE_LAYERS must equal it)
MOE_SERVE_LAYERS = 4
# deepseek-v2-lite-16b (MLA, 64 experts top-6 + 2 shared, a leading dense
# layer): served at 4 of 27 layers (dense0 + 3 MoE), trained at 3 (dense0
# + 2 MoE; launch/profile_serve.py's MOE_SERVE_LAYERS must equal
# MLA_SERVE_LAYERS)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SERVE_LAYERS, MLA_TRAIN_LAYERS = 4, 3
MLA_BATCH, MLA_SEQ = 2, 4096        # 8192 tokens > 4096: the grouped route
# its decode GEMMs (K, N): wq, w_dkv, w_kr, wo, dense0's up and gate, its
# down, an expert's up and gate, its down, the shared experts' up and
# gate, their down, the head
MLA_DECODE_KN = [(2048, 3072), (2048, 512), (2048, 64), (2048, 2048),
                 (2048, 10944), (10944, 2048), (2048, 1408), (1408, 2048),
                 (2048, 2816), (2816, 2048), (2048, 102400)]
# the prefill's latent up-projections (w_uk, w_uv: K 512) at a 48-token
# prompt bucket, through the M > 32 tile (M, N, K)
MLA_PREFILL_MNK = [(48, 2048, 512)]
# its training GEMMs at M = 8192 (K, N): w_kr (N 64 forward, K 64 in dx,
# N 64 in dW), dense0's up (N 10944; K 10944 in dx) and down (K 10944)
MLA_TRAIN_KN = [(2048, 64), (2048, 10944), (10944, 2048)]
LLAMA_ARCH = "llama2-7b"
LLAMA_LAYERS = 4                    # of 32: f32 master + grads + moments
LLAMA_M = 4096                      # batch 1 x seq 4096 (paper Table 8)
TIE = 1e-3                          # a top-two logit gap <= TIE * max|logit|
RING_ARCH = "h2o-danube-3-4b"       # sliding window 4096: a ring cache
# prompts at or past the window (the keep-last-C prefill), two that wrap
# during decode, two that refill slots at other depths
RING_PROMPTS = [4160, 4120, 4072, 4060, 512, 97]
RING_MAX_NEW, RING_MAX_LEN = 48, 4352
RING_LAYERS = 12                    # of 24 (its 24 ran ~25 s a run)
# paged decode attention, pages of 16 (B, KV, G, Dh, pages a slot,
# n_valid): phi3-mini's serving phase and a long context, and the MoE
# serving phase's (phi3.5-moe: GQA 8 x 4, Dh 128)
PAGED_SHAPES = {"phi3": (4, 32, 1, 96, 4, [17, 64, 33, 5]),
                "phi3-long": (4, 32, 1, 96, 256, [3000, 4096, 3517, 3999]),
                "phi3.5-moe": (4, 8, 4, 128, 4, [17, 64, 33, 5]),
                "stablelm": (4, 8, 4, 160, 4, [17, 64, 33, 5]),
                "minitron": (4, 8, 4, 128, 4, [17, 64, 33, 5])}
# contiguous decode attention (B, KV, G, Dh, C, n_valid): h2o-danube-3-4b's
# decode (rows 0-1 wrapped, 2-3 partial), recurrentgemma-2b's local layer
RING_SHAPES = {"h2o": (4, 8, 4, 120, 4096, [4100, 4200, 300, 97]),
               "recurrentgemma": (4, 1, 10, 256, 2048, [2048, 2500, 1000,
                                                        1]),
               # musicgen-medium's Server: 24 kv heads, G 1, Dh 64, 64 slots
               "musicgen": (4, 24, 1, 64, 64, [17, 64, 33, 5])}
# the verify (q_len > 1) form of decode attention (layout, B, KV, S, G, Dh,
# page size or C, pages a slot, n_valid after the S-token write):
# phi3-mini's verify step in the spec engine phase (4 pages of 16 a slot;
# under identity placement its contiguous rows of max_len 64), phi3-mini
# at a long context (256 pages a slot; identity rows of 4160 slots) and
# h2o-danube-3-4b's widths on an unwrapped contiguous cache (S 4 x G 4:
# two blocks a kv head), and the MoE serving phase's verify step (4
# drafts x G 4 = 16 rows a kv head on pages)
VERIFY_SHAPES = {
    "phi3": ("paged", 4, 32, 4, 1, 96, 16, 4, [17, 64, 33, 5]),
    "phi3-long": ("paged", 4, 32, 4, 1, 96, 16, 256,
                  [3000, 4096, 3517, 3999]),
    "phi3-identity": ("contiguous", 4, 32, 4, 1, 96, 64, 1,
                      [17, 64, 33, 5]),
    "phi3-identity-long": ("contiguous", 4, 32, 4, 1, 96, 4160, 1,
                           [3000, 4096, 3517, 3999]),
    "h2o": ("contiguous", 4, 8, 4, 4, 120, 4096, 1, [4096, 4000, 300, 97]),
    "phi3.5-moe": ("paged", 4, 8, 4, 4, 128, 16, 4, [17, 64, 33, 5]),
}
# the kernel checks at the MoE serving phase's shapes, reported in the
# kernels line under "moe_serving" beside each kernel's own entry
MOE_CHECKED = ("mx_gemm", "fused_quant_gemm", "decode_attn_paged",
               "decode_attn_paged_verify")
# the verify entries of the kernels line: the shapes of the spec engine
# phase's launches
VERIFY_REPORTED = {"decode_attn_paged_verify": "phi3",
                   "decode_attn_verify": "phi3-identity"}
# the spec engine phase's long-context run: 2 prompts of ~4000 tokens
SPEC_LONG_PROMPTS, SPEC_LONG_MAX_NEW, SPEC_LONG_MAX_LEN = [4000, 3968], 32, 4160
SPEC_LONG_LAYERS = 8                # of 32 (full width)
SPEC_K = 4
# the prefix phase: a 512-token system prompt (16 chunks of 32) shared
# by a wave of 6 requests; its bf16-cache twin at this depth
PREFIX_SYSTEM, PREFIX_MAX_LEN, PREFIX_BF16_LAYERS = 512, 640, 4
PREFIX_LAYERS = 8                   # the fp8-cache runs, of 32
# the three serving switches' runs (and the default run they are held
# to), of phi3-mini's 32 layers: cut to pay for the last three families
HATCH_LAYERS = 8
# the preempt phase: 12 pages where 4 slots of 128 tokens need 32, at 8
# of phi3-mini's 32 layers; the reservation run (about one request at a
# time) at 4
PREEMPT_PAGES, PREEMPT_MAX_LEN, PREEMPT_MAX_NEW = 12, 128, 64
PREEMPT_LAYERS, PREEMPT_RESERVE_LAYERS = 8, 4
# the baselines served at this depth of phi3-mini's 32 layers (at 32
# until the families' phases needed the time); their card-vs-CPU check
# at full width at the second
BASELINE_LAYERS, BASELINE_CHECK_LAYERS = 8, 2
# three more families at full width: stablelm-12b (qk-norm, 25% partial
# rotary, Dh 160), minitron-8b (squared ReLU, a non-gated FFN, vocab
# 256,000) and recurrentgemma-2b (RG-LRU + local attention on a 2048-slot
# ring, GeGLU, the tied head embed/head_t, vocab 256,000); each served at
# this depth and trained at this one, batch 1 x 4096
STABLELM, MINITRON, GEMMA = "stablelm-12b", "minitron-8b", "recurrentgemma-2b"
# and the reference's last three: rwkv6-3b (attention-free: the chunked
# WKV and its one-token update in plain torch, 10 quantized sites a
# layer; identity rows),
# musicgen-medium (embeddings input, sinusoidal positions, MHA Dh 64,
# vocab 2048) and phi-3-vision-4.2b (embeddings input, the phi3-mini
# backbone), whose engines refuse them (as the reference's): the legacy
# Server serves them from token prompts through the embedding table,
# their training takes the frontend stub's embeddings
RWKV, MUSICGEN, PHI3V = "rwkv6-3b", "musicgen-medium", "phi-3-vision-4.2b"
FAMILIES = (STABLELM, MINITRON, GEMMA, RWKV, MUSICGEN, PHI3V)
# phi-3-vision's backbone (phi3-mini) is served at 32 layers by phase 4;
# recurrentgemma (26 layers), rwkv6 (32) and musicgen (48) were served at
# full depth until phase engine obs came, ~10-14 s a run each
FAMILY_SERVE_LAYERS = {STABLELM: 8, MINITRON: 8, GEMMA: 8, RWKV: 8,
                       MUSICGEN: 12, PHI3V: 8}
# trained at full width: each recipe's step holds the f32 weights, their
# gradients, both moments and AdamW's new copies of three of them at its
# peak (stablelm at 4 layers, 2.14B parameters, ran out of the 80 GB in
# bf16), and minitron's f32 logits of 1 x 4096 x 256,000 and their
# gradient (4.2 GB each) beside its 2.1B embedding and head parameters
FAMILY_TRAIN_LAYERS = {STABLELM: 2, MINITRON: 1, GEMMA: 5, RWKV: 4,
                       MUSICGEN: 4, PHI3V: 4}
FAMILY_TRAIN_M = 4096               # paper Table 8's sequence
# recurrentgemma's engine: phase 4's 8 requests and one of this many
# prompt tokens, whose ring (2048 slots) wraps at its prefill
GEMMA_LONG_PROMPT, GEMMA_MAX_LEN = 2100, 2176
# the three heads (K, N): row 1 at M 4/16/32 over each; minitron's at M
# 4096 (its training forward, dx at K 256,000, dW, and row 9 on its f32
# gradient)
FAMILY_HEAD_KN = [(5120, 100352), (4096, 256000), (2560, 256000)]
HEAD_TRAIN_KN = (4096, 256000)
# rwkv6-3b's decode (K, N): the ddlerp LoRA's N 160, the decay LoRA's 64,
# the time mix's square projections, the channel mix's two, its head; its
# training's ragged N (ddlerp_w1, decay_w1); musicgen-medium's head
RWKV_DECODE_KN = [(2560, 160), (2560, 64), (2560, 2560), (2560, 8960),
                  (8960, 2560), (2560, 65536)]
RWKV_TRAIN_KN = [(2560, 160), (2560, 64)]
MUSICGEN_HEAD_KN = (1536, 2048)
REPLACES = {
    "mx_gemm": "src/repro/kernels/mx_gemm.py:61",
    "mx_gemm_tiled": "src/repro/kernels/mx_gemm.py:61",
    "fused_quant_gemm": "src/repro/kernels/mx_fused.py:101",
    "fused_quant_gemm_tiled": "src/repro/kernels/mx_fused.py:101",
    "decode_attn_paged": "src/repro/kernels/decode_attn.py:408",
    "decode_attn": "src/repro/kernels/decode_attn.py:222",
    "decode_attn_paged_verify": "src/repro/kernels/decode_attn.py:408",
    "decode_attn_verify": "src/repro/kernels/decode_attn.py:222",
    "mx_dw_gemm": "src/repro/kernels/mx_bwd.py:104",
    # the requant along tokens inside the TPU kernel's K loop
    "dw_requant": "src/repro/kernels/mx_bwd.py:104",
    "group_gemm": "src/repro/kernels/group_gemm.py:61",
    "mx_quant": "src/repro/kernels/mx_quant.py:51",
    # the level-1 scale, computed outside the Pallas quantizer
    "global_amax": "src/repro/kernels/ref.py:167",
    "moe_gmm": "src/repro/kernels/moe_gmm.py:129",
    "moe_dw_gemm": "src/repro/kernels/moe_gmm.py:232",
}
SOURCES = {
    "mx_gemm": "src/repro_torch/csrc/mx_gemm.cu",
    "mx_gemm_tiled": "src/repro_torch/csrc/mx_gemm.cu",
    # the mx_quant kernel, then mx_gemm.cu's tile for M
    "fused_quant_gemm": "src/repro_torch/csrc/mx_quant.cu + "
                        "src/repro_torch/csrc/mx_gemm.cu",
    "fused_quant_gemm_tiled": "src/repro_torch/csrc/mx_quant.cu + "
                              "src/repro_torch/csrc/mx_gemm.cu",
    "decode_attn_paged": "src/repro_torch/csrc/decode_attn.cu",
    "decode_attn": "src/repro_torch/csrc/decode_attn.cu",
    "decode_attn_paged_verify": "src/repro_torch/csrc/decode_attn.cu",
    "decode_attn_verify": "src/repro_torch/csrc/decode_attn.cu",
    # the dw_requant pass, then the wgmma tile on its payload
    "mx_dw_gemm": "src/repro_torch/csrc/mx_dw_gemm.cu",
    "dw_requant": "src/repro_torch/csrc/mx_dw_gemm.cu",
    "group_gemm": "src/repro_torch/csrc/group_gemm.cu",
    "mx_quant": "src/repro_torch/csrc/mx_quant.cu",
    "global_amax": "src/repro_torch/csrc/mx_quant.cu",
    "moe_gmm": "src/repro_torch/csrc/moe_gmm.cu",
    "moe_dw_gemm": "src/repro_torch/csrc/moe_gmm.cu",
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound_ms(nbytes: float, flops: float,
             peak: float = FP8_FLOPS) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over ``peak`` (the card's rate for the operands' type),
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def against(ms: float, bound: float, library: float) -> str:
    """A decode line's tail: the kernel's share of its bound and its
    time over SDPA's."""
    return (f", {bound / ms:.1%} of the bound, {ms / library:.3f}x "
            f"SDPA's time")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each.

    Events around one launch of a few microseconds measure the launch
    more than the kernel, so a call under 0.1 ms is timed in batches:
    behind a sleep on the card (so that the host queues the whole batch
    before it starts), one pair of events holds 20 (flush, call) pairs;
    the time of 20 flushes alone, taken the same way, is subtracted, and
    the per-call median over 7 batches is returned."""

    BATCH = 20

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def _median(self, fn, n: int, batch: int) -> float:
        torch = self.torch
        times = []
        for _ in range(n):
            if batch == 1:
                self.flush.zero_()
            else:
                torch.cuda._sleep(20_000_000)          # ~10 ms of cycles
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(batch):
                if batch > 1:
                    self.flush.zero_()
                if fn is not None:
                    fn()
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in times)

    def ms(self, fn, n: int = 20, batched: bool = False) -> float:
        """``batched`` times in batches whatever the call's time: for a
        wrapper whose host work (checks, copies) outlasts a short kernel,
        one pair of events around one call would time the host."""
        for _ in range(3):
            fn()
        t = self._median(fn, n, 1)
        if t >= 0.1 and not batched:
            return t
        b = self.BATCH
        return (self._median(fn, 7, b) - self._median(None, 7, b)) / b


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # full-f32 reference products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    lib = _build.build()
    _build.library()
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.monotonic() - t0:.1f} s")


def _activations(torch, gen, m, k):
    x = torch.randn(m, k, device="cuda", generator=gen)
    out = torch.rand(m, k, device="cuda", generator=gen) < 0.002
    return (x * (1 + 300.0 * out)).to(torch.bfloat16)


def phase_kernels(torch, timer) -> dict:
    import torch.nn.functional as F
    from repro_torch.core.quant import mx_operand, quant_mx, quant_per_tensor
    from repro_torch.kernels import (decode_attn, dispatch, mx_fused, mx_gemm,
                                     mx_quant)
    from repro_torch.models.attention import _quant_kv

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    weights = {}
    for k, n in GEMM_KN:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        weights[k, n] = quant_per_tensor(w).q

    # -- mx_gemm's M <= 32 tile: decode, verify and chunk rows ---------
    # (each (K, N) at M 32 first; the M 4 and M 16 calls' rows must be
    # the M 32 call's first rows bit for bit: a row's bits do not depend
    # on the batch)
    worst, moe_worst, mla_worst = 0.0, 0.0, 0.0
    for k, n in GEMM_KN + H2O_DECODE_KN + MOE_DECODE_KN + MLA_DECODE_KN:
        if (k, n) not in weights:
            w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
            weights[k, n] = quant_per_tensor(w).q
        qw = weights[k, n]
        xq = quant_mx(_activations(torch, gen, max(SMALL_M), k))
        rows = {}
        for m in sorted(SMALL_M, reverse=True):
            q, se = xq.q[:m].contiguous(), xq.sexp[:m].contiguous()
            before = mx_gemm.counter.count
            got = mx_gemm.mx_gemm(q, se, qw)
            if mx_gemm.counter.count != before + 1:
                raise AssertionError(f"mx_gemm M={m}: the M <= 32 tile "
                                     "was not launched once")
            want = mx_gemm.mx_gemm_plain(q, se, qw)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not (err <= 1e-5 * scale and torch.isfinite(got).all()):
                raise AssertionError(f"mx_gemm M={m} K={k} N={n}: max err "
                                     f"{err} > 1e-5 * {scale}")
            rows[m] = got
            if not torch.equal(got.view(torch.int32),
                               rows[max(SMALL_M)][:m].view(torch.int32)):
                raise AssertionError(f"mx_gemm K={k} N={n}: the M={m} "
                                     "rows differ from the same rows at "
                                     f"M={max(SMALL_M)}")
            worst = max(worst, err)
            if (k, n) in MOE_DECODE_KN:
                moe_worst = max(moe_worst, err)
            if (k, n) in MLA_DECODE_KN:
                mla_worst = max(mla_worst, err)
            opnd = mx_operand(q, se)
            wb = qw.to(torch.bfloat16)
            t = timer.ms(lambda: mx_gemm.mx_gemm(q, se, qw))
            tp = timer.ms(lambda: mx_gemm.mx_gemm_plain(q, se, qw))
            tl = timer.ms(lambda: torch.matmul(opnd, wb))
            b, by = bound_ms(m * k + m * k // 32 + k * n + 4 * m * n,
                             2.0 * m * n * k)
            print(f"mx_gemm M={m:2d} K={k} N={n} split "
                  f"{mx_gemm.small_split(k, n)}: max_err {err:.3g} (max|ref| "
                  f"{scale:.3g}), no payload output, {t:.4f} ms, plain "
                  f"{tp:.4f} ms, library {tl:.4f} ms, bound {b * 1e3:.2f} "
                  f"us ({by}), {b / t:.1%} of the bound, {t / tl:.3f}x "
                  "torch.matmul's time")
            if (m, k, n) == (4, 3072, 8192):
                res["mx_gemm"] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                      bound_ms=b, bound_by=by)
        print(f"mx_gemm K={k} N={n}: rows at M "
              f"{sorted(SMALL_M)[:-1]} bitwise the M={max(SMALL_M)} rows")
    res["mx_gemm"]["max_abs_err"] = worst
    res["mx_gemm"]["moe_serving"] = dict(
        kn=MOE_DECODE_KN, m=list(SMALL_M), max_abs_err=moe_worst)
    res["mx_gemm"]["deepseek"] = dict(
        kn=MLA_DECODE_KN, m=list(SMALL_M), max_abs_err=mla_worst)

    # -- fused_quant_gemm: M = 32 (the calibration forward) -----------
    # and at the MoE serving phase's shapes, M 4, 16 and 32 (its
    # calibration forward and, under REPRO_SERVE_DELAYED_ACT=0, its decode
    # and chunk rows); deepseek's calibration at M 32 (its decode shapes
    # and the latent up-projections' K 512) and its wo at every decode
    # step (just in time, M 4)
    worst, moe_worst, mla_worst = 0.0, 0.0, 0.0
    cases = [(fmt, 32, k, n) for fmt in ("e4m3", "e5m2") for k, n in GEMM_KN]
    cases += [("e4m3", m, k, n) for k, n in MOE_DECODE_KN for m in SMALL_M]
    mla_cases = [("e4m3", 32, k, n) for k, n in MLA_DECODE_KN
                 + [(512, 2048)]] + [("e4m3", 4, 2048, 2048)]
    cases += mla_cases
    for k, n in [(512, 2048)]:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        weights[k, n] = quant_per_tensor(w).q
    for fmt, m, k, n in cases:
        qw = weights[k, n]
        x = _activations(torch, gen, m, k)
        # the call as dispatch.fused_quant_matmul makes it: the
        # level-1 scale, the quantizer, the M <= 32 tile
        counters = (mx_quant.counter_amax, mx_quant.counter,
                    mx_gemm.counter)
        counts = [c.count for c in counters]
        s = dispatch.global_scale(x, fmt)
        acc, q, se = mx_fused.fused_quant_gemm(x, s, qw, fmt)
        if [c.count - n for c, n in zip(counters, counts)] != [1] * 3:
            raise AssertionError(f"fused_quant_gemm M={m}: not one "
                                 "global_amax, one mx_quant and one "
                                 "mx_gemm launch")
        acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(x, s, qw, fmt)
        q_mis = int((q.view(torch.uint8) != q_p.view(torch.uint8)).sum())
        e_mis = int((se != se_p).sum())
        err = float((acc - acc_p).abs().max())
        scale = float(acc_p.abs().max())
        print(f"fused_quant_gemm {fmt} M={m} K={k} N={n}: max_err "
              f"{err:.3g} (max|ref| {scale:.3g}), payload mismatches "
              f"q {q_mis} / sexp {e_mis} (of {q.numel()} / "
              f"{se.numel()})", end="")
        if q_mis or e_mis or not err <= 1e-5 * scale:
            print()
            raise AssertionError(f"fused_quant_gemm {fmt} M={m} K={k} "
                                 f"N={n}")
        worst = max(worst, err)
        if (k, n) in MOE_DECODE_KN:
            moe_worst = max(moe_worst, err)
        if (fmt, m, k, n) in mla_cases:
            mla_worst = max(mla_worst, err)
        opnd = mx_operand(q_p, se_p)
        wb = qw.to(torch.bfloat16)
        t = timer.ms(lambda: mx_fused.fused_quant_gemm(x, s, qw, fmt))
        tp = timer.ms(lambda: mx_fused.fused_quant_gemm_plain(
            x, s, qw, fmt))
        tl = timer.ms(lambda: torch.matmul(opnd, wb))
        b, by = bound_ms(2 * m * k + 4 + k * n + 4 * m * n + m * k
                         + m * k // 32, 2.0 * m * n * k)
        print(f", {t:.4f} ms, plain {tp:.4f} ms, library {tl:.4f} ms, "
              f"bound {b * 1e3:.2f} us ({by}), {b / t:.1%} of the "
              f"bound, {t / tl:.3f}x torch.matmul's time")
        if (fmt, m, k, n) == ("e4m3", 32, 3072, 8192):
            res["fused_quant_gemm"] = dict(ms=t, plain_ms=tp,
                                           library_ms=tl, bound_ms=b,
                                           bound_by=by)
    res["fused_quant_gemm"]["max_abs_err"] = worst
    res["fused_quant_gemm"]["moe_serving"] = dict(
        kn=MOE_DECODE_KN, m=list(SMALL_M), max_abs_err=moe_worst)
    res["fused_quant_gemm"]["deepseek"] = dict(
        mkn=[c[1:] for c in mla_cases], max_abs_err=mla_worst)

    # -- decode_attn_paged: pages of 16 ------------------------------
    # (the G query rows of each (slot, kv-head), as dispatch passes them)
    # at PAGED_SHAPES; the kernels line reports phi3-mini's serving
    # shape, and the MoE's under "moe_serving"
    t_ = 16
    worst, moe, fam = 0.0, {}, {}
    for name, (b_, kvh, g, dh, n_p, nv_list) in PAGED_SHAPES.items():
        pool = b_ * n_p + 1
        kf = torch.randn(pool, kvh, t_, dh, device="cuda", generator=gen)
        vf = torch.randn(pool, kvh, t_, dh, device="cuda", generator=gen)
        bt = torch.randperm(pool - 1, device="cuda", generator=gen)[
            :b_ * n_p].reshape(b_, n_p).to(torch.int32)
        nv = torch.tensor(nv_list, dtype=torch.int32, device="cuda")
        sm = dh ** -0.5
        for kv_dtype in ("fp8", "bf16"):
            q = torch.randn(b_, kvh, g, dh, device="cuda", generator=gen)
            if kv_dtype == "fp8":
                (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
            else:
                k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            args = (q, k, v, ks, vs, nv, bt)
            if kv_dtype == "fp8":
                # SDPA on the slots' pages gathered into a bf16 cache,
                # with the slot mask
                tl = timer.ms(sdpa_on_pages(torch, F, q, kf, vf, bt, nv, sm))
            got = decode_attn.decode_attn_paged(*args, sm_scale=sm)
            want = decode_attn.decode_attn_paged_plain(*args, sm_scale=sm)
            if n_p == 4:
                err, lim = float((got - want).abs().max()), 1e-5
                gate = ""
            else:
                cont = [None if x is None else decode_attn.gather_pages(
                    x, bt) for x in (k, v, ks, vs)]
                err, own, lim = attn_limit(torch, got, want, decode_attn_f64(
                    torch, q, *cont, nv, sm))
                gate = f" (plain vs f64 {own:.3g}, limit {lim:.3g})"
                del cont
            if not (err <= lim and torch.isfinite(got).all()):
                raise AssertionError(f"decode_attn_paged {name} {kv_dtype}: "
                                     f"max err {err} > {lim}")
            worst = max(worst, err)
            t = timer.ms(lambda: decode_attn.decode_attn_paged(
                *args, sm_scale=sm))
            tp = timer.ms(lambda: decode_attn.decode_attn_paged_plain(
                *args, sm_scale=sm))
            # the function's work: the G query rows of each (b, kv-head)
            live = int(torch.clamp_max(nv, n_p * t_).sum())
            elt = 1 if kv_dtype == "fp8" else 2
            nbytes = (b_ * kvh * g * dh * (2 + 4)           # q (bf16), out
                      + 2 * live * kvh * dh * elt           # live K and V
                      + (2 * live * kvh * 4 if ks is not None else 0)
                      + 4 * b_ + 4 * b_ * n_p)              # n_valid, table
            b, by = bound_ms(nbytes, 4.0 * live * kvh * g * dh,
                             FP8_FLOPS if kv_dtype == "fp8" else BF16_FLOPS)
            print(f"decode_attn_paged {name} {kv_dtype} B={b_} KV={kvh} "
                  f"G={g} Dh={dh} T={t_} NP={n_p} n_valid={nv.tolist()}: "
                  f"max_err {err:.3g}{gate}, {t:.4f} ms, plain {tp:.4f} ms, "
                  f"library {tl:.4f} ms (SDPA, gathered bf16 cache), bound "
                  f"{b * 1e3:.2f} us ({by}){against(t, b, tl)}")
            if kv_dtype == "fp8" and name == "phi3":
                res["decode_attn_paged"] = dict(ms=t, plain_ms=tp,
                                                library_ms=tl, bound_ms=b,
                                                bound_by=by)
            if name == "phi3.5-moe":
                moe = dict(shape=[b_, kvh, g, dh, n_p], n_valid=nv_list,
                           max_abs_err=max(moe.get("max_abs_err", 0.0), err))
            if name in ("stablelm", "minitron"):
                fam.setdefault(name, dict(shape=[b_, kvh, g, dh, n_p],
                                          n_valid=nv_list))[kv_dtype] = dict(
                    max_abs_err=err, ms=t, plain_ms=tp, library_ms=tl,
                    bound_ms=b)
            del k, v, ks, vs, got, want
        del kf, vf
    res["decode_attn_paged"]["moe_serving"] = moe
    res["decode_attn_paged"]["families"] = fam
    res["decode_attn_paged"]["max_abs_err"] = worst
    return res


def phase_mx_gemm_tiled(torch, timer) -> dict:
    """mx_gemm's wgmma tile (M > 32) against its plain version at
    TILED_MNK: within 1e-5 * max|ref|, finite, two calls bitwise equal,
    e4m3 activations and weights; the first Table 6 shape and the ragged
    one also in the other three operand formats.  Timed (e4m3) beside
    the plain version and torch.matmul on the bf16 operands; the bound
    counts fp8 operations (bound_ms), though the tile runs bf16 products
    (at most 989 TFLOP/s, half that rate)."""
    from repro_torch.core.quant import mx_operand, quant_mx, quant_per_tensor
    from repro_torch.kernels import mx_gemm

    gen = torch.Generator(device="cuda").manual_seed(7)
    res, worst, mla_worst = {}, 0.0, 0.0
    for m, n, k in TILED_MNK + MLA_PREFILL_MNK:
        x = _activations(torch, gen, m, k)
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        fmts = [("e4m3", "e4m3")]
        if (m, n, k) in (TILED_MNK[0], TILED_MNK[-1]):
            fmts += [("e4m3", "e5m2"), ("e5m2", "e4m3"), ("e5m2", "e5m2")]
        for xf, wf in fmts:
            xq = quant_mx(x, 32, xf)
            q, se = xq.q.contiguous(), xq.sexp.contiguous()
            qw = quant_per_tensor(w, wf).q
            before = mx_gemm.counter_tiled.count
            got = mx_gemm.mx_gemm(q, se, qw)
            again = mx_gemm.mx_gemm(q, se, qw)
            if mx_gemm.counter_tiled.count != before + 2:
                raise AssertionError(f"mx_gemm M={m}: the wgmma tile was "
                                     "not launched")
            want = mx_gemm.mx_gemm_plain(q, se, qw)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            same = torch.equal(got.view(torch.int32), again.view(torch.int32))
            line = (f"mx_gemm_tiled {xf} x {wf} M={m} N={n} K={k}: max_err "
                    f"{err:.3g} (max|ref| {scale:.3g}), two calls "
                    f"{'bitwise' if same else 'DIFFER'}")
            if not (err <= 1e-5 * scale and torch.isfinite(got).all()
                    and same):
                raise AssertionError(line)
            worst = max(worst, err)
            if (m, n, k) in MLA_PREFILL_MNK:
                mla_worst = max(mla_worst, err)
            del got, again, want
            if (xf, wf) != ("e4m3", "e4m3"):
                print(line)
                continue
            opnd, wb = mx_operand(q, se), qw.to(torch.bfloat16)
            t = timer.ms(lambda: mx_gemm.mx_gemm(q, se, qw))
            tp = timer.ms(lambda: mx_gemm.mx_gemm_plain(q, se, qw))
            tl = timer.ms(lambda: torch.matmul(opnd, wb))
            b, by = bound_ms(m * k + m * k // 32 + k * n + 4 * m * n,
                             2.0 * m * n * k)
            print(f"{line}, {t:.4f} ms ({2e-9 * m * n * k / t:.1f} TFLOP/s), "
                  f"plain {tp:.4f} ms, library {tl:.4f} ms (torch.matmul "
                  f"bf16), bound {b:.4f} ms ({by})")
            if (m, n, k) == TILED_MNK[0]:
                res["mx_gemm_tiled"] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                            bound_ms=b, bound_by=by)
            del opnd, wb
        del x, w
        torch.cuda.empty_cache()
    res["mx_gemm_tiled"]["max_abs_err"] = worst
    res["mx_gemm_tiled"]["deepseek"] = dict(mnk=MLA_PREFILL_MNK,
                                            max_abs_err=mla_worst)
    return res


def sdpa_on_pages(torch, F, q, kf, vf, bt, nv, sm):
    """A call of SDPA that computes the paged kernel's function on a bf16
    cache: q (B, KV, S, G, Dh) or (B, KV, G, Dh), the pages of (P, KV,
    T, Dh) ``kf``/``vf`` gathered by ``bt`` into (B, KV, C, Dh) bf16
    (outside the call), the S·G rows as SDPA's query positions under
    each draft's slot mask."""
    from repro_torch.kernels.decode_attn import gather_pages

    kb = gather_pages(kf.bfloat16(), bt)
    vb = gather_pages(vf.bfloat16(), bt)
    return sdpa_on_cache(torch, F, q, kb, vb, nv, sm)


def sdpa_on_cache(torch, F, q, kb, vb, nv, sm):
    """As ``sdpa_on_pages`` on a contiguous bf16 cache (B, KV, C, Dh)."""
    s_len = q.shape[2] if q.dim() == 5 else 1
    b, kvh, g, dh = q.shape[0], q.shape[1], q.shape[-2], q.shape[-1]
    c = kb.shape[2]
    back = torch.arange(s_len - 1, -1, -1, device=q.device)
    lim = torch.clamp_max(nv.long()[:, None] - back[None], c)   # (B, S)
    live = torch.arange(c, device=q.device)[None, None] < lim[:, :, None]
    mask = live[:, None, :, None, :].expand(b, 1, s_len, g, c).reshape(
        b, 1, s_len * g, c)
    qb = q.reshape(b, kvh, s_len * g, dh).bfloat16()
    return lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                  attn_mask=mask, scale=sm)


def decode_attn_f64(torch, q, k, v, ks, vs, nv, sm, flips: bool = False):
    """decode_attn_ref's function evaluated in float64 (bf16 q and K,
    the weights rounded to bf16 as there): the yardstick of the f32
    round-off of the plain version and the kernel.  q (B, KV, G, Dh), or
    the verify form (B, KV, S, G, Dh) whose draft j sees the slots below
    n_valid - (S-1-j).  ``flips`` also returns, per output, what moving
    every weight's bf16 rounding by one ulp moves it by at the most:
    sum over slots of ulp(w) * |v|."""
    c = k.shape[2]
    f = lambda t: t.float().to(torch.bfloat16).double()
    q5 = q if q.dim() == 5 else q[:, :, None]
    back = torch.arange(q5.shape[2] - 1, -1, -1, device=q.device)
    s = torch.einsum("bksgd,bktd->bksgt", f(q5), f(k)) * sm
    if ks is not None:
        s = s * ks.double()[:, :, None, None, :]
    lim = torch.clamp_max(nv.long()[:, None] - back[None], c)     # (B, S)
    live = torch.arange(c, device=q.device)[None, None] < lim[:, :, None]
    s = s.masked_fill(~live[:, None, :, None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True)
    if vs is not None:
        w = w * vs.double()[:, :, None, None, :]
    wb = w.to(torch.bfloat16).double()
    out = torch.einsum("bksgt,bktd->bksgd", wb, f(v))
    if not flips:
        return out if q.dim() == 5 else out[:, :, 0]
    # a bf16 weight m * 2^e (m in [0.5, 1)) has an ulp of 2^(e - 8)
    ulp = torch.where(wb != 0, torch.exp2(
        torch.frexp(wb).exponent.double() - 8), 0.0)
    bound = torch.einsum("bksgt,bktd->bksgd", ulp, f(v).abs())
    return (out, bound) if q.dim() == 5 else (out[:, :, 0], bound[:, :, 0])


def attn_limit(torch, got, want, exact) -> tuple[float, float, float]:
    """(kernel-vs-plain error, the plain version's own error against
    float64, the limit): 1e-5 absolute plus twice the plain version's
    own round-off.  Over thousands of slots the f32 sums of the scores,
    of the exponentials and of the weighted V, taken in another order,
    flip the bf16 rounding of some weights, so the two f32 versions
    drift apart with the context length; the f64 evaluation says by how
    much the plain version itself does."""
    err = float((got - want).abs().max())
    own = float((want.double() - exact).abs().max())
    return err, own, 1e-5 + 2.0 * own


def phase_ring_kernels(torch, timer) -> dict:
    """decode_attn (the contiguous ring) against decode_attn_ref at
    RING_SHAPES, fp8 and bf16, within ``attn_limit``; timed beside the
    plain version and SDPA
    (torch.nn.functional.scaled_dot_product_attention) on a bf16 cache
    of the same shape with the boolean slot mask, the G query rows of a
    kv head as SDPA's query positions."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    from repro_torch.models.attention import _quant_kv

    gen = torch.Generator(device="cuda").manual_seed(6)
    res, worst = {}, 0.0
    for name, (b_, kvh, g, dh, c, nv) in RING_SHAPES.items():
        q = torch.randn(b_, kvh, g, dh, device="cuda", generator=gen)
        kf = torch.randn(b_, kvh, c, dh, device="cuda", generator=gen)
        vf = torch.randn(b_, kvh, c, dh, device="cuda", generator=gen)
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        live = torch.arange(c, device="cuda")[None] < \
            torch.clamp_max(nv, c)[:, None]
        qb, kb, vb = q.bfloat16(), kf.bfloat16(), vf.bfloat16()
        mask = live[:, None, None, :]
        sm = dh ** -0.5
        tl = timer.ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=sm))
        for kv_dtype in ("fp8", "bf16"):
            if kv_dtype == "fp8":
                (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
            else:
                k, v, ks, vs = kb, vb, None, None
            args = (q, k, v, ks, vs, nv)
            got = decode_attn.decode_attn(*args, sm_scale=sm)
            want = decode_attn.decode_attn_ref(*args, sm_scale=sm)
            err, own, lim = attn_limit(torch, got, want, decode_attn_f64(
                torch, *args, sm))
            if not (err <= lim and torch.isfinite(got).all()):
                raise AssertionError(f"decode_attn {name} {kv_dtype}: max "
                                     f"err {err} > {lim}")
            worst = max(worst, err)
            t = timer.ms(lambda: decode_attn.decode_attn(*args,
                                                         sm_scale=sm))
            tp = timer.ms(lambda: decode_attn.decode_attn_ref(
                *args, sm_scale=sm))
            # the work this run's data needs: the live slots of each row
            n_live = int(live.sum())
            elt = 1 if kv_dtype == "fp8" else 2
            nbytes = (b_ * kvh * g * dh * (2 + 4)       # q (bf16), out f32
                      + 2 * n_live * kvh * dh * elt     # live K and V
                      + (2 * n_live * kvh * 4 if ks is not None else 0)
                      + 4 * b_)                         # n_valid
            b, by = bound_ms(nbytes, 4.0 * n_live * kvh * g * dh,
                             FP8_FLOPS if kv_dtype == "fp8" else BF16_FLOPS)
            print(f"decode_attn {name} {kv_dtype} B={b_} KV={kvh} G={g} "
                  f"Dh={dh} C={c} n_valid={nv.tolist()}: max_err "
                  f"{err:.3g} (plain vs f64 {own:.3g}, limit {lim:.3g}), "
                  f"{t:.4f} ms, plain {tp:.4f} ms, library "
                  f"{tl:.4f} ms (SDPA, bf16 cache), bound {b * 1e3:.2f} us "
                  f"({by}){against(t, b, tl)}")
            if (name, kv_dtype) == ("h2o", "fp8"):
                res["decode_attn"] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                          bound_ms=b, bound_by=by)
            if (name, kv_dtype) == ("musicgen", "fp8"):
                res["musicgen"] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                       bound_ms=b, bound_by=by,
                                       max_abs_err=err)
            del k, v, ks, vs, got, want
        del q, kf, vf, qb, kb, vb
    res["decode_attn"]["max_abs_err"] = worst
    res["decode_attn"]["families"] = {"musicgen": res.pop("musicgen")}
    torch.cuda.empty_cache()
    return res


def phase_verify_kernels(torch, timer) -> dict:
    """The verify (q_len > 1) form of both decode kernels at
    VERIFY_SHAPES, fp8 and bf16: within ``attn_limit`` of the 5-D plain
    version, each draft row bitwise the q_len = 1 kernel at that draft's
    limit; the kernel's launch timed apart from the wrapper's depth
    check, beside the plain version and SDPA on the gathered bf16 cache
    with each draft's slot mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    from repro_torch.models.attention import _quant_kv

    gen = torch.Generator(device="cuda").manual_seed(7)
    res, worst, moe = {}, {}, {}
    for name, (layout, b_, kvh, s_len, g, dh, t_, n_p, nv) in \
            VERIFY_SHAPES.items():
        paged = layout == "paged"
        key = "decode_attn_paged_verify" if paged else "decode_attn_verify"
        c = t_ * n_p
        slots = b_ * n_p + 1 if paged else b_
        q = torch.randn(b_, kvh, s_len, g, dh, device="cuda", generator=gen)
        kf = torch.randn(slots, kvh, t_, dh, device="cuda", generator=gen)
        vf = torch.randn(slots, kvh, t_, dh, device="cuda", generator=gen)
        bt = torch.randperm(slots - 1, device="cuda", generator=gen)[
            :b_ * n_p].reshape(b_, n_p).to(torch.int32) if paged else None
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        rows = q.reshape(b_, kvh, s_len * g, dh)
        sm = dh ** -0.5
        tl = timer.ms(sdpa_on_pages(torch, F, q, kf, vf, bt, nv, sm)
                      if paged else sdpa_on_cache(
                          torch, F, q, kf.bfloat16(), vf.bfloat16(), nv, sm),
                      batched=True)
        for kv_dtype in ("fp8", "bf16"):
            if kv_dtype == "fp8":
                (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
            else:
                k, v, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            tail = (bt,) if paged else ()
            kernel, launch = ((decode_attn.decode_attn_paged,
                               decode_attn.launch_paged) if paged else
                              (decode_attn.decode_attn, decode_attn.launch))
            plain = (decode_attn.decode_attn_paged_plain if paged
                     else decode_attn.decode_attn_ref)
            args = (k, v, ks, vs, nv) + tail
            got = kernel(rows, *args, sm_scale=sm, q_len=s_len).reshape(
                q.shape)
            want = plain(q, *args, sm_scale=sm)
            cont = [None if x is None else
                    (decode_attn.gather_pages(x, bt) if paged else x)
                    for x in (k, v, ks, vs)]
            err, own, lim = attn_limit(torch, got, want, decode_attn_f64(
                torch, q, *cont, nv, sm))
            if not (err <= lim and torch.isfinite(got).all()):
                raise AssertionError(f"{key} {name} {kv_dtype}: max err "
                                     f"{err} > {lim}")
            for j in range(s_len):
                solo = kernel(q[:, :, j].contiguous(), k, v, ks, vs,
                              nv - (s_len - 1 - j), *tail, sm_scale=sm)
                if not torch.equal(got[:, :, j], solo):
                    raise AssertionError(f"{key} {name} {kv_dtype}: draft "
                                         f"{j} differs from the q_len = 1 "
                                         "kernel at its limit")
            worst[key] = max(worst.get(key, 0.0), err)
            # the kernel's launch alone (the wrapper's depth check, a few
            # small launches, timed apart), in batches: one pair of
            # events around one short launch would time the host
            t = timer.ms(lambda: launch(rows, *args, sm_scale=sm,
                                        q_len=s_len), batched=True)
            tw = timer.ms(lambda: kernel(rows, *args, sm_scale=sm,
                                         q_len=s_len), batched=True)
            tp = timer.ms(lambda: plain(q, *args, sm_scale=sm),
                          batched=True)
            # the work this run's data needs: each row's live slots, the
            # widest row's K and V read once
            n_live = int(torch.clamp_max(nv, c).sum())
            row_slots = sum(min(int(n) - (s_len - 1 - j), c)
                            for n in nv.tolist() for j in range(s_len))
            elt = 1 if kv_dtype == "fp8" else 2
            nbytes = (b_ * kvh * s_len * g * dh * (2 + 4)  # q, out f32
                      + 2 * n_live * kvh * dh * elt        # live K and V
                      + (2 * n_live * kvh * 4 if ks is not None else 0)
                      + 4 * b_ + (4 * b_ * n_p if paged else 0))
            b, by = bound_ms(nbytes, 4.0 * row_slots * kvh * g * dh,
                             FP8_FLOPS if kv_dtype == "fp8" else BF16_FLOPS)
            print(f"{key} {name} {kv_dtype} B={b_} KV={kvh} S={s_len} "
                  f"G={g} Dh={dh} C={c}"
                  f"{f' (T={t_})' if paged else ''} n_valid={nv.tolist()}: "
                  f"max_err {err:.3g} (plain vs f64 {own:.3g}, limit "
                  f"{lim:.3g}), drafts bitwise the q_len=1 kernel, "
                  f"{t:.4f} ms (the wrapper with its depth check "
                  f"{tw:.4f} ms), plain {tp:.4f} ms, library {tl:.4f} ms "
                  f"(SDPA, bf16 cache), bound {b * 1e3:.2f} us ({by})"
                  f"{against(t, b, tl)}")
            if VERIFY_REPORTED.get(key) == name and kv_dtype == "fp8":
                res[key] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                bound_ms=b, bound_by=by)
            if name == "phi3.5-moe":
                moe = dict(shape=[b_, kvh, s_len, g, dh, n_p],
                           n_valid=nv.tolist(),
                           max_abs_err=max(moe.get("max_abs_err", 0.0), err))
            del k, v, ks, vs, got, want, cont
        del q, kf, vf, rows
    for key, err in worst.items():
        res[key]["max_abs_err"] = err
    res["decode_attn_paged_verify"]["moe_serving"] = moe
    torch.cuda.empty_cache()
    return res


def phase_train_kernels(torch, timer) -> dict:
    """fused_quant_gemm (forward e4m3 on bf16 activations, dx e5m2 on
    the f32 gradient against the transposed weights) and mx_dw_gemm at
    olmo-7b training shapes (M 2048) and at deepseek-v2-lite-16b's (M
    8192: N 64 and, in dx, K 64, half of a last K-128 step; K and N
    10,944, K % 128 = 64), reported under "deepseek"."""
    from repro_torch.core.quant import mx_operand, quant_per_tensor
    from repro_torch.kernels import (dispatch, mx_bwd, mx_fused, mx_gemm,
                                     mx_quant)

    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    worst_f = worst_d = worst_r = 0.0
    mla_f = mla_d = 0.0
    mla_m = MLA_BATCH * MLA_SEQ
    for m, k, n in ([(TRAIN_M, k, n) for k, n in TRAIN_KN]
                    + [(mla_m, k, n) for k, n in MLA_TRAIN_KN]):
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        del w
        x = _activations(torch, gen, m, k)
        g = torch.randn(m, n, device="cuda", generator=gen) * 1e-3
        qwt = qw.T.contiguous()
        for what, xin, wq, fmt in (("fwd", x, qw, "e4m3"),
                                   ("dx", g, qwt, "e5m2")):
            kk, nn = wq.shape
            # the call as dispatch.fused_quant_matmul makes it: the
            # level-1 scale, the quantizer, the wgmma tile
            counters = (mx_quant.counter_amax, mx_quant.counter,
                        mx_gemm.counter_tiled)
            counts = [c.count for c in counters]
            s = dispatch.global_scale(xin, fmt)
            acc, q, se = mx_fused.fused_quant_gemm(xin, s, wq, fmt)
            if [c.count - n for c, n in zip(counters, counts)] != [1] * 3:
                raise AssertionError(f"fused_quant_gemm {what} M={m}: not "
                                     "one global_amax, one mx_quant and "
                                     "one mx_gemm_tiled launch")
            acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(xin, s, wq,
                                                               fmt)
            q_mis = int((q.view(torch.uint8) != q_p.view(torch.uint8))
                        .sum())
            e_mis = int((se != se_p).sum())
            err = float((acc - acc_p).abs().max())
            scale = float(acc_p.abs().max())
            print(f"fused_quant_gemm {what} {fmt} M={m} K={kk} N={nn}: "
                  f"max_err {err:.3g} (max|ref| {scale:.3g}), payload "
                  f"mismatches q {q_mis} / sexp {e_mis}", end="")
            if q_mis or e_mis or not (err <= 1e-5 * scale
                                      and torch.isfinite(acc).all()):
                print()
                raise AssertionError(f"fused_quant_gemm {what} K={kk} "
                                     f"N={nn}")
            worst_f = max(worst_f, err)
            if m == mla_m:
                mla_f = max(mla_f, err)
            opnd, wb = mx_operand(q_p, se_p), wq.to(torch.bfloat16)
            del acc, acc_p, q, se
            t = timer.ms(lambda: mx_fused.fused_quant_gemm(xin, s, wq, fmt))
            tp = timer.ms(lambda: mx_fused.fused_quant_gemm_plain(
                xin, s, wq, fmt))
            tl = timer.ms(lambda: torch.matmul(opnd, wb))
            b, by = bound_ms(xin.element_size() * m * kk + 4 + kk * nn
                             + 4 * m * nn + m * kk + m * kk // 32,
                             2.0 * m * nn * kk)
            print(f", {t:.4f} ms, plain {tp:.4f} ms, library {tl:.4f} ms, "
                  f"bound {b:.4f} ms ({by})")
            if (what, m, k, n) == ("fwd", TRAIN_M, 4096, 11008):
                res["fused_quant_gemm_tiled"] = dict(
                    ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
                    bound_by=by)
            if what == "fwd":
                xq_q, xq_e = q_p, se_p
            del opnd, wb, q_p, se_p
        # dW against the forward's residual and the e5m2 gradient: the
        # dw_requant pass, then the wgmma tile on its payload
        gq = quant_per_tensor(g, "e5m2").q
        acc, qt, et = mx_bwd.mx_dw_gemm(xq_q, xq_e, gq, "e4m3", payload=True)
        again = mx_bwd.mx_dw_gemm(xq_q, xq_e, gq, "e4m3")
        acc_p, qt_p, et_p = mx_bwd.mx_dw_gemm_plain(xq_q, xq_e, gq, "e4m3",
                                                    payload=True)
        q_mis = int((qt.view(torch.uint8) != qt_p.view(torch.uint8)).sum())
        e_mis = int((et != et_p).sum())
        err = float((acc - acc_p).abs().max())
        scale = float(acc_p.abs().max())
        same = torch.equal(acc.view(torch.int32), again.view(torch.int32))
        print(f"mx_dw_gemm M={m} K={k} N={n}: max_err {err:.3g} (max|ref| "
              f"{scale:.3g}), requant payload mismatches q {q_mis} / sexp "
              f"{e_mis}, two calls bitwise {same}", end="")
        if q_mis or e_mis or not (same and err <= 1e-5 * scale
                                  and torch.isfinite(acc).all()):
            print()
            raise AssertionError(f"mx_dw_gemm K={k} N={n}")
        worst_d = max(worst_d, err)
        if m == mla_m:
            mla_d = max(mla_d, err)
        worst_r = max(worst_r, float((mx_operand(qt, et).float()
                                      - mx_operand(qt_p, et_p).float())
                                     .abs().max()))
        opnd, gb = mx_operand(qt_p, et_p), gq.to(torch.bfloat16)
        del acc, again, acc_p, qt, et, qt_p, et_p
        t = timer.ms(lambda: mx_bwd.mx_dw_gemm(xq_q, xq_e, gq))
        tp = timer.ms(lambda: mx_bwd.mx_dw_gemm_plain(xq_q, xq_e, gq))
        tl = timer.ms(lambda: torch.matmul(opnd, gb))
        # the residual and its exponents read, q' and e' written and read
        # once more by the tile, the gradient read, dW written
        b, by = bound_ms(m * k + m * k // 32 + m * n + 4 * k * n,
                         2.0 * m * n * k)
        flops = 2.0 * m * n * k
        print(f", {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s; the requant "
              f"pass and the tile), plain {tp:.4f} ms, library {tl:.4f} ms, "
              f"bound {b:.4f} ms ({by})")
        if (m, k, n) == (TRAIN_M, 4096, 11008):
            res["mx_dw_gemm"] = dict(ms=t, plain_ms=tp, library_ms=tl,
                                     bound_ms=b, bound_by=by)
            # the requant pass alone: the residual and its exponents read
            # once, q' and e' written once
            t = timer.ms(lambda: mx_bwd.dw_requant(xq_q, xq_e), batched=True)
            tp = timer.ms(lambda: mx_bwd.requant_m(xq_q, xq_e))
            b, by = bound_ms(2 * (m * k + m * k // 32), 0.0)
            print(f"dw_requant M={m} K={k}: {t:.4f} ms (the wrapper), plain "
                  f"{tp:.4f} ms, bound {b:.4f} ms ({by}), payload bitwise "
                  "at every shape above")
            res["dw_requant"] = dict(ms=t, plain_ms=tp, library_ms=None,
                                     bound_ms=b, bound_by=by)
        del x, g, qw, qwt, gq, xq_q, xq_e, opnd, gb
        torch.cuda.empty_cache()
    res["fused_quant_gemm_tiled"]["max_abs_err"] = worst_f
    res["mx_dw_gemm"]["max_abs_err"] = worst_d
    for name, err in (("fused_quant_gemm_tiled", mla_f),
                      ("mx_dw_gemm", mla_d)):
        res[name]["deepseek"] = dict(m=mla_m, kn=MLA_TRAIN_KN,
                                     max_abs_err=err)
    res["dw_requant"]["max_abs_err"] = worst_r
    return res


def _col_major(q):
    """An fp8 (K, N) operand as torch._scaled_mm takes its second
    argument: column-major (a row-major (N, K) copy, transposed)."""
    return q.T.contiguous().T


def phase_recipe_kernels(torch, timer) -> dict:
    """group_gemm at olmo-7b training shapes: the per_group forward
    (e4m3 activations per 128 along K against the e4m3 weights), dx
    (the e5m2 gradient per 128 along N against Wᵀ) and dW (the
    residual's transpose requantized per 128 tokens against the e5m2
    gradient); the level-1 scale (global_amax) bitwise its plain version
    on the quantizer's inputs and on edge cases (NaN, inf, zeros,
    subnormals, ragged sizes, the head's (2048, 50304) gradient); then
    mx_quant and global_amax at (2048, 4096) e4m3 on bf16 input and
    (2048, 11008) e5m2 on f32 input, each timed, and the two as the
    linear layers call them (dispatch.mx_quantize)."""
    from repro_torch.core.quant import quant_per_group, quant_per_tensor
    from repro_torch.kernels import dispatch, group_gemm, mx_quant

    gen = torch.Generator(device="cuda").manual_seed(3)
    m = TRAIN_M
    one = torch.ones((), dtype=torch.float32, device="cuda")
    res = {}
    worst = 0.0

    def check(what, xq, qw):
        nonlocal worst
        # the operands as dispatch.group_matmul hands them over
        # (the dW operand is quantized from a transposed view)
        xq = xq._replace(q=xq.q.contiguous())
        mm, kk = xq.q.shape
        nn = qw.shape[1]
        got = group_gemm.group_gemm(xq.q, xq.s, qw)
        want = group_gemm.group_gemm_plain(xq.q, xq.s, qw)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not (err <= 1e-5 * scale and torch.isfinite(got).all()):
            raise AssertionError(f"group_gemm {what} M={mm} K={kk} N={nn}: "
                                 f"max err {err} > 1e-5 * {scale}")
        worst = max(worst, err)
        del got, want
        xb, wb = xq.q.to(torch.bfloat16), qw.to(torch.bfloat16)
        wc = _col_major(qw)
        t = timer.ms(lambda: group_gemm.group_gemm(xq.q, xq.s, qw))
        tp = timer.ms(lambda: group_gemm.group_gemm_plain(xq.q, xq.s, qw))
        tl = timer.ms(lambda: torch.matmul(xb, wb))
        ts = timer.ms(lambda: torch._scaled_mm(
            xq.q, wc, scale_a=one, scale_b=one, out_dtype=torch.float32,
            use_fast_accum=False))
        b, by = bound_ms(mm * kk + 4 * mm * (kk // 128) + kk * nn
                         + 4 * mm * nn, 2.0 * mm * nn * kk)
        fl = 2.0 * mm * nn * kk / 1e9
        print(f"group_gemm {what} {xq.q.dtype} x {qw.dtype} M={mm} K={kk} "
              f"N={nn}: max_err {err:.3g} (max|ref| {scale:.3g}), "
              f"{t:.4f} ms ({fl / t:.1f} TFLOP/s, the wgmma tile), plain "
              f"{tp:.4f} ms, library {tl:.4f} ms (torch.matmul bf16, "
              f"{fl / tl:.1f} TFLOP/s), {ts:.4f} ms (torch._scaled_mm fp8, "
              f"{fl / ts:.1f} TFLOP/s), bound {b:.4f} ms ({by})")
        return dict(ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
                    bound_by=by)

    for k, n in TRAIN_KN:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        wq = quant_per_tensor(w)
        del w
        x = _activations(torch, gen, m, k)
        xq = quant_per_group(x, 128, "e4m3")
        row = check("fwd", xq, wq.q)
        if (k, n) == (4096, 11008):
            res["group_gemm"] = row
        if (k, n) in ((4096, 11008), (11008, 4096)):
            g = torch.randn(m, n, device="cuda", generator=gen) * 1e-3
            check("dx", quant_per_group(g, 128, "e5m2"),
                  wq.q.T.contiguous())
            xt = quant_per_group(xq.dequant(torch.bfloat16).T, 128, "e4m3")
            check("dW", xt, quant_per_tensor(g, "e5m2").q)
            del g, xt
        del x, xq, wq
        torch.cuda.empty_cache()
    res["group_gemm"]["max_abs_err"] = worst

    # the level-1 scale: the global_amax kernel bitwise its plain version
    # on the two training inputs below and on the edge cases (NaN
    # propagates, inf gives inf, zeros and subnormals give TINY / FP8_MAX,
    # ragged sizes take the kernel's scalar tail, a shape of many blocks)
    worst_s = 0.0
    for label, x, fmt in _amax_cases(torch, gen):
        got = mx_quant.global_amax(x, fmt)
        want = mx_quant.global_scale_plain(x, fmt)
        same = _same_scale(torch, got, want)
        print(f"global_amax {label} {x.dtype} {tuple(x.shape)} {fmt}: "
              f"{float(got):.6g}, plain {float(want):.6g}, bitwise {same}")
        if not same:
            raise AssertionError(f"global_amax {label}")
        if torch.isfinite(want):
            worst_s = max(worst_s, float((got - want).abs()))
        del x

    for (mm, kk), fmt, dt in QUANT_TIMED:
        x = _activations(torch, gen, mm, kk).to(getattr(torch, dt))
        s = dispatch.global_scale(x, fmt)
        q, se = mx_quant.mx_quant(x, s, fmt)
        q_p, se_p = mx_quant.mx_quant_plain(x, s, fmt)
        q_mis = int((q.view(torch.uint8) != q_p.view(torch.uint8)).sum())
        e_mis = int((se != se_p).sum())
        print(f"mx_quant {fmt} {dt} M={mm} K={kk}: payload mismatches q "
              f"{q_mis} / sexp {e_mis} (of {q.numel()} / {se.numel()})",
              end="")
        if q_mis or e_mis:
            print()
            raise AssertionError(f"mx_quant {fmt} K={kk}")
        t = timer.ms(lambda: mx_quant.mx_quant(x, s, fmt))
        tp = timer.ms(lambda: mx_quant.mx_quant_plain(x, s, fmt))
        b, by = bound_ms(x.element_size() * mm * kk + 4 + mm * kk
                         + mm * kk // 32, 0.0)
        print(f", {t:.4f} ms ({b / t:.1%} of the bound), plain {tp:.4f} "
              f"ms, library none, bound {b:.4f} ms ({by})")
        # the level-1 scale alone: x read once, s written
        ta = timer.ms(lambda: mx_quant.global_amax(x, fmt))
        tap = timer.ms(lambda: mx_quant.global_scale_plain(x, fmt))
        tal = timer.ms(lambda: torch.linalg.vector_norm(x, float("inf")))
        ba, bya = bound_ms(x.element_size() * mm * kk + 4, 0.0)
        print(f"global_amax {dt} M={mm} K={kk}: {ta:.4f} ms ({ba / ta:.1%} "
              f"of the bound), plain {tap:.4f} ms, library {tal:.4f} ms "
              f"(torch.linalg.vector_norm(x, inf): the amax alone), bound "
              f"{ba:.4f} ms ({bya})")
        # the quantizer as the linear layers call it: the level-1 scale,
        # then the group pass (dispatch.mx_quantize; x cold, then from L2)
        tc = timer.ms(lambda: dispatch.mx_quantize(x, fmt))
        tcp = timer.ms(lambda: mx_quant.mx_quant_plain(
            x, mx_quant.global_scale_plain(x, fmt), fmt))
        print(f"quantizer as called (global_amax + mx_quant) {fmt} {dt} "
              f"M={mm} K={kk}: {tc:.4f} ms, plain {tcp:.4f} ms, bound "
              f"{ba + b:.4f} ms (both passes' bytes)")
        if fmt == "e4m3":
            res["mx_quant"] = dict(ms=t, plain_ms=tp, library_ms=None,
                                   bound_ms=b, bound_by=by, max_abs_err=0.0)
            res["global_amax"] = dict(ms=ta, plain_ms=tap, library_ms=tal,
                                      bound_ms=ba, bound_by=bya,
                                      max_abs_err=worst_s)
        del x, q, se, q_p, se_p
    return res


def _same_scale(torch, got, want) -> bool:
    """Two level-1 scales bit for bit (a NaN equal to any NaN)."""
    if bool(torch.isnan(want)):
        return bool(torch.isnan(got))
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _amax_cases(torch, gen):
    """(label, x, fmt) for the global_amax gate: the two training inputs
    of the quantizer timings, then the edge cases."""
    m = TRAIN_M
    out = []
    for (mm, kk), fmt, dt in QUANT_TIMED:
        out.append(("training", _activations(torch, gen, mm, kk).to(
            getattr(torch, dt)), fmt))
    big = torch.randn(m, 4096, device="cuda", generator=gen)
    nan, inf = big.clone(), big.clone()
    nan[1000, 17] = float("nan")
    inf[7, 4095] = -float("inf")
    for dt in (torch.float32, torch.bfloat16):
        out += [("all-zero", torch.zeros(33, 4096, device="cuda", dtype=dt),
                 "e4m3"),
                ("with a NaN", nan.to(dt), "e4m3"),
                ("with an inf", inf.to(dt), "e5m2"),
                ("ragged (scalar tail)", torch.randn(
                    3, 37, device="cuda", generator=gen).to(dt), "e4m3"),
                ("one group", torch.randn(1, 32, device="cuda",
                                          generator=gen).to(dt), "e5m2")]
    out.append(("all-subnormal", torch.full((5, 96), 1e-40, device="cuda"),
                "e4m3"))
    out.append(("all-subnormal", torch.full((5, 96), -1e-40, device="cuda")
                .to(torch.bfloat16), "e5m2"))
    # the head's dx gradient: (2048, 50304) f32, more blocks than one wave
    head = torch.randn(m, 50304, device="cuda", generator=gen) * 1e-3
    head[m - 1, 50303] = 7.5
    out.append(("head gradient", head, "e5m2"))
    return out


def phase_table6(torch, timer) -> dict:
    """The paper's Table 6 on the card: per (M, N, K), the GEMMs on
    pre-quantized operands, the fused MOSS linear layer and the
    quantizers, through the ablation entry points (kernels.ops,
    kernels.dispatch).  Each entry point is first called once as a user
    calls it, between a reset and a read of the launch counts; the
    fused linear layer is held against its plain version (1e-5 *
    max|ref|, f32 sum order); then each is timed (median of 10 cold-L2
    calls).  TE's GEMM is cuBLASLt's fp8 product (torch._scaled_mm),
    timed beside the port's per-tensor GEMM (pt_matmul, f32
    accumulation).  It reports times; there is no speed gate."""
    from repro_torch.core.quant import quant_per_group, quant_per_tensor
    from repro_torch.kernels import (dispatch, group_gemm, mx_fused,
                                     mx_gemm, mx_quant, ops)

    counters = [mx_quant.counter, mx_quant.counter_amax, mx_gemm.counter,
                mx_gemm.counter_tiled, group_gemm.counter,
                mx_fused.counter_tiled]
    gen = torch.Generator(device="cuda").manual_seed(4)
    launches = {c.name: 0 for c in counters}
    for m, n, k in TABLE6_MNK:
        x = _activations(torch, gen, m, k)
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        xg, xt = quant_per_group(x, 128), quant_per_tensor(x)
        # the weight row-major for the port's GEMMs, column-major for
        # cuBLASLt's fp8 product
        wq = quant_per_tensor(w)
        wc = _col_major(wq.q)
        xb, wb = x, w.to(torch.bfloat16)
        for c in counters:
            c.reset()
        q, sexp, s = ops.mx_quantize(x)
        outs = [ops.mx_matmul(q, sexp, wq.q, s, wq.s),
                ops.coat_matmul(xg.q, xg.s, wq.q, wq.s),
                dispatch.pt_matmul(xt, wq), torch.matmul(xb, wb)]
        lin = ops.moss_linear(x, w, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for c in counters:
            launches[c.name] += c.count
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"table 6 M={m} N={n} K={k}: non-finite")
        sx = dispatch.global_scale(x)
        acc_p, _, _ = mx_fused.fused_quant_gemm_plain(x, sx, wq.q)
        want = acc_p * (sx * wq.s)
        err = float((lin - want).abs().max())
        scale = float(want.abs().max())
        if not (err <= 1e-5 * scale and torch.isfinite(lin).all()):
            raise AssertionError(f"table 6 moss_linear M={m} N={n} K={k}: "
                                 f"max err {err} > 1e-5 * {scale}")
        ref = outs[-1].float()
        rel = [float((o.float() - ref).norm() / ref.norm()) for o in outs]
        del lin, acc_p, want
        t = {
            "moss_gemm": lambda: ops.mx_matmul(q, sexp, wq.q, s, wq.s),
            "coat_gemm": lambda: ops.coat_matmul(xg.q, xg.s, wq.q, wq.s),
            "pt_matmul": lambda: dispatch.pt_matmul(xt, wq),
            "te_gemm": lambda: torch._scaled_mm(
                xt.q, wc, scale_a=xt.s, scale_b=wq.s,
                out_dtype=torch.bfloat16, use_fast_accum=False),
            "bf16_gemm": lambda: torch.matmul(xb, wb),
            "moss_linear": lambda: ops.moss_linear(x, w),
            "mx_quantize": lambda: ops.mx_quantize(x),
            "quant_per_group": lambda: quant_per_group(x, 128),
            "quant_per_tensor": lambda: quant_per_tensor(x),
        }
        t = {name: timer.ms(fn, n=10) for name, fn in t.items()}
        flops = 2.0 * m * n * k
        tflops = ", ".join(
            f"{name} {flops / t[name] / 1e9:.1f}" for name in
            ("moss_gemm", "coat_gemm", "pt_matmul", "te_gemm", "bf16_gemm",
             "moss_linear"))
        print(f"table6 M={m} N={n} K={k}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; GEMM TFLOP/s {tflops}; COAT / MOSS GEMM time (both the "
            f"wgmma tile) {t['coat_gemm'] / t['moss_gemm']:.3f}; rel L2 vs "
            f"bf16 moss "
            f"{rel[0]:.3g}, coat {rel[1]:.3g}, pt {rel[2]:.3g}; "
            f"moss_linear vs plain max_err {err:.3g} (max|ref| {scale:.3g})")
        del x, w, xg, xt, wq, wc, xb, wb, q, sexp, outs, ref
        torch.cuda.empty_cache()
    print(f"launches on the ablation path: {json.dumps(launches)}")
    # per shape: mx_quantize and moss_linear's quantizer launch
    # global_amax and mx_quant, mx_matmul and moss_linear's GEMM the
    # wgmma tile (M > 32), never the M <= 32 tile; coat_matmul launches
    # group_gemm; moss_linear is one fused_quant_gemm call
    n = len(TABLE6_MNK)
    want = {"mx_quant": 2 * n, "global_amax": 2 * n, "mx_gemm": 0,
            "mx_gemm_tiled": 2 * n,
            "group_gemm": n, "fused_quant_gemm_tiled": n}
    if launches != want:
        raise AssertionError(f"ablation path: launches {launches}, "
                             f"expected {want}")
    return launches


def _requests(Request, np, cfg, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n),
                                               dtype=np.int32),
                    max_new=16)
            for i, n in enumerate(rng.integers(16, 49, size=8))]


def _checked(torch, fn, finite):
    """``fn`` (a serving step), noting whether its logits are finite."""
    def step(*a):
        logits, caches = fn(*a)
        finite.append(torch.isfinite(logits).all())
        return logits, caches
    return step


def _record_gaps(torch, eng, gaps: dict):
    """For every token ``eng`` emits, record in ``gaps[rid]`` the gap
    between the top two logits it was sampled from and max|logit| (one
    host read a step: for the untimed runs only)."""
    step, on_token, last = eng.decode, eng.sched.on_token, {}

    def decode(params, caches, toks):
        logits, caches = step(params, caches, toks)
        if toks.shape[1] == 1:
            lg, rows = logits[:, 0], list(eng.kv.rows)
        else:                     # a prefill chunk: its last real token
            st = eng._staging
            n_real = min(toks.shape[1], st.req.prompt_len - st.pos)
            lg, rows = logits[:, n_real - 1], [st.req.rid]
        top = torch.topk(lg.float(), 2, dim=-1).values
        last.update(rows={rid: i for i, rid in enumerate(rows)},
                    gap=(top[:, 0] - top[:, 1]).cpu().tolist(),
                    big=lg.float().abs().amax(-1).cpu().tolist())
        return logits, caches

    def rec(req, token):
        i = last["rows"][req.rid]
        gaps.setdefault(req.rid, []).append((last["gap"][i], last["big"][i]))
        return on_token(req, token)

    eng.decode, eng.sched.on_token = decode, rec


def _divergence(got: list, want: list, gaps: dict) -> list:
    """(request, token, gap) for each stream of ``got`` that leaves
    ``want``: the first token that differs and the top-two gap of the
    logits ``want``'s run sampled it from, over max|logit| (``gaps``:
    ``_record_gaps`` of that run)."""
    out = []
    for rid, (a, b) in enumerate(zip(got, want)):
        if a != b:
            t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap, big = gaps[rid][t]
            out.append((rid, t, gap / big))
    return out


def _divergence_line(div: list, n: int) -> str:
    return ("streams equal phase 4's" if not div else
            f"{len(div)} of {n} streams leave phase 4's: " + ", ".join(
                f"request {rid} at token {t} (top-two gap {g:.3g} of "
                "max|logit|)" for rid, t, g in div))


def _step_deltas(eng, counters, log: list):
    """Record in ``log`` each decode step's (B, 1) launches by counter."""
    step = eng.decode

    def decode(params, caches, toks):
        before = [c.count for c in counters]
        out = step(params, caches, toks)
        if toks.shape[1] == 1:
            log.append({c.name: c.count - b
                        for c, b in zip(counters, before)})
        return out

    eng.decode = decode


def _engine(seed: int = 0, arch: str = ARCH, layers: int | None = None,
            over: dict | None = None, num_slots: int = 4, **engine_kw):
    """A full-width engine of ``arch`` (depth cut to ``layers`` if
    given, config fields replaced by ``over``) on weights from ``seed``,
    ``num_slots`` slots, pages of 16, on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if over:
        cfg = cfg.replace(**over)
    return Engine(cfg, random_params(cfg, seed, "cuda"),
                  num_slots=num_slots, page_size=16, device="cuda",
                  **engine_kw)


def _serve_once(torch, np, seed: int, float_pages: bool = True,
                reqs=None, max_len: int = 64, arch: str = ARCH,
                layers: int | None = None, gaps: dict | None = None,
                step_log: tuple | None = None, wrap_decode=None,
                over: dict | None = None, chunked: bool = True,
                after=None, **engine_kw):
    """Serve ``reqs`` (phase 4's 8 requests by default) through a
    full-width engine of ``arch`` (depth cut to ``layers`` if given,
    config fields replaced by ``over``) on weights from ``seed``; with
    ``gaps`` records each token's top-two logit gap, with ``step_log``
    ((counters, list)) each decode step's launches; ``wrap_decode(eng)``
    wraps the engine's own step first.  The engine must take the
    placement ``float_pages`` and the prefill ``chunked`` (the
    whole-prompt prefill where False); ``after(eng)`` is called once the
    requests are served.  Returns the requests, the build and serve
    seconds and the engine's stats (with the run's peak memory)."""
    from repro_torch.serving import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = _engine(seed, arch=arch, layers=layers, over=over,
                  max_len=max_len, **engine_kw)
    cfg = eng.cfg
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    if (eng.float_pages, eng.chunked) != (float_pages, chunked):
        raise AssertionError(f"engine took float_pages={eng.float_pages}, "
                             f"chunked={eng.chunked}")
    if eng.spec != bool(engine_kw.get("spec_decode")):
        raise AssertionError(f"engine took spec={eng.spec}")
    if wrap_decode is not None:
        wrap_decode(eng)
    finite = []
    eng.decode = _checked(torch, eng.decode, finite)
    if eng.spec:
        eng.verify = _checked(torch, eng.verify, finite)
    if step_log is not None:
        _step_deltas(eng, *step_log)
    if gaps is not None:
        _record_gaps(torch, eng, gaps)
    if reqs is None:
        reqs = _requests(Request, np, cfg, seed)
    t0 = time.monotonic()
    eng.run(reqs, log=None)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError("a request did not finish with max_new tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the main path")
    st = eng.stats()
    st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if after is not None:
        after(eng)
    del eng
    torch.cuda.empty_cache()
    return reqs, build_s, run_s, st


def _beside_kernels(torch, eng, name: str, rel: list, attn: list):
    """Wrap ``eng``'s decode step, run under ``name``=einsum, and the
    einsum path (``dispatch.decode_attention_plain``) for that run.
    Before each decode step, the same step with the decode kernels
    (``name`` unset) on the same cache and tokens; ``rel`` gets max|d
    logit| / max|logit| of the two (a tensor a step).  Each writes the
    step's K and V at the same depth in every layer before it reads
    them, so the einsum step reads the cache its own run holds.  Every
    einsum attention call also runs the kernel on the same rows; ``attn``
    gets ``attn_limit``'s (error, own error, limit) against the float64
    evaluation and whether each output is within that limit plus twice
    what one bf16 ulp of every weight moves it by (each version rounds a
    weight to bf16, either of them may land one ulp from the other).
    Returns the function that puts dispatch back."""
    import os

    from repro_torch.kernels import dispatch

    step, plain = eng.decode, dispatch.decode_attention_plain

    def decode(params, caches, toks):
        if toks.shape[1] == 1:
            value = os.environ.pop(name)
            try:
                ref, _ = step(params, caches, toks)
            finally:
                os.environ[name] = value
        logits, caches = step(params, caches, toks)
        if toks.shape[1] == 1:
            ref = ref.float()
            rel.append((logits.float() - ref).abs().amax()
                       / ref.abs().amax())
        return logits, caches

    def both(q, k, v, ks, vs, n_valid, block_table=None, *, sm_scale):
        out = plain(q, k, v, ks, vs, n_valid, block_table, sm_scale=sm_scale)
        if block_table is None:
            got = dispatch.decode_attention(q, k, v, ks, vs, n_valid,
                                            sm_scale=sm_scale)
        else:
            got = dispatch.decode_attention_paged(
                q, k, v, ks, vs, n_valid, block_table, sm_scale=sm_scale)
        attn.append(_attn_pair(torch, got, out, q, k, v, ks, vs, n_valid,
                               block_table, sm_scale))
        return out

    eng.decode, dispatch.decode_attention_plain = decode, both
    return lambda: setattr(dispatch, "decode_attention_plain", plain)


def _attn_pair(torch, got, out, q, k, v, ks, vs, n_valid, block_table,
               sm_scale) -> tuple:
    """A decode attention call's kernel output ``got`` against its plain
    version's ``out`` on the same inputs: ``attn_limit``'s (error, own
    error, limit) against the float64 evaluation, and whether each
    output is within that limit plus twice what one bf16 ulp of every
    weight moves it by."""
    from repro_torch.kernels import decode_attn

    if block_table is None:
        cont = (k, v, ks, vs)
    else:
        cont = [None if x is None else decode_attn.gather_pages(
            x, block_table) for x in (k, v, ks, vs)]
    exact, flip = decode_attn_f64(torch, q, *cont,
                                  n_valid.expand(q.shape[0]), sm_scale,
                                  flips=True)
    err, own, lim = attn_limit(torch, got, out, exact)
    ok = bool(((got - out).abs().double() <= lim + 2 * flip).all())
    return err, own, lim, ok


def _paged_beside_plain(torch, attn: list):
    """Every paged decode attention kernel call (q_len 1) from now on
    also runs its plain version on the same inputs, untimed and
    uncounted; ``attn`` gets ``_attn_pair``'s result.  Returns the
    function that puts dispatch back."""
    from repro_torch.kernels import dispatch

    kernel, plain = (dispatch.decode_attention_paged,
                     dispatch.decode_attention_plain)

    def checked(q, k, v, ks, vs, n_valid, block_table, *, sm_scale):
        got = kernel(q, k, v, ks, vs, n_valid, block_table,
                     sm_scale=sm_scale)
        out = plain(q, k, v, ks, vs, n_valid, block_table,
                    sm_scale=sm_scale)
        attn.append(_attn_pair(torch, got, out, q, k, v, ks, vs, n_valid,
                               block_table, sm_scale))
        return got

    dispatch.decode_attention_paged = checked
    return lambda: setattr(dispatch, "decode_attention_paged", kernel)


def _with_env(name: str, value: str, fn):
    import os

    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _legacy_server(torch, np):
    """The legacy Server (what REPRO_SERVE_PAGED=0 selects) serves
    phase 4's requests on the same weights: every request finishes with
    max_new tokens, the logits are finite, and the contiguous decode
    kernel is launched."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.runtime_flags import serve_paged
    from repro_torch.kernels import decode_attn
    from repro_torch.launch.serve import Server, random_params
    from repro_torch.serving import Request

    if _with_env("REPRO_SERVE_PAGED", "0", serve_paged):
        raise AssertionError("REPRO_SERVE_PAGED=0 does not select the "
                             "legacy Server")
    cfg = get_config(ARCH)
    srv = Server(cfg, random_params(cfg, 0, "cuda"), batch_slots=4,
                 max_len=64, device="cuda")
    finite = []
    srv.decode = _checked(torch, srv.decode, finite)
    srv.prefill = _checked(torch, srv.prefill, finite)
    reqs = _requests(Request, np, cfg, 0)
    decode_attn.counter_contiguous.reset()
    t0 = time.monotonic()
    srv.run(reqs, log=None)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    n = decode_attn.counter_contiguous.count
    toks = sum(len(r.out) for r in reqs)
    print(f"legacy Server {ARCH} full width: 8 requests, {toks} tokens in "
          f"{run_s:.2f} s ({toks / run_s:.1f} tok/s), decode_attn "
          f"launches {n}")
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError("legacy Server: a request did not finish")
    if not bool(torch.stack(finite).all()) or n <= 0:
        raise AssertionError("legacy Server: non-finite logits or no "
                             "decode_attn launch")
    del srv
    torch.cuda.empty_cache()


def phase_engine(torch, np) -> dict:
    from repro_torch.kernels import decode_attn, mx_fused, mx_gemm, mx_quant

    counters = [mx_gemm.counter, mx_fused.counter, mx_quant.counter,
                mx_quant.counter_amax, decode_attn.counter]
    for c in counters:
        c.reset()
    reqs, build_s, run_s, st = _serve_once(torch, np, seed=0)
    launches = {c.name: c.count for c in counters}
    toks = sum(len(r.out) for r in reqs)
    print(f"engine {ARCH} full width: 8 requests, {toks} tokens, build "
          f"(weights, prequant, calibration) {build_s:.2f} s, serve "
          f"{run_s:.2f} s = {toks / run_s:.1f} tok/s, "
          f"{st['decode_steps']} decode steps, mean decode step "
          f"{1e3 * st['mean_decode_step_s']:.2f} ms, "
          f"{st['chunk_prefill_steps']} prefill chunks")
    print(f"launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    # the calibration forward's fused_quant_gemm calls (M 32) are the
    # serving path's only quantizer launches: one global_amax and one
    # mx_quant each, beside one launch of the M <= 32 tile (counted in
    # mx_gemm with the decode steps')
    for name in ("mx_quant", "global_amax"):
        if launches[name] != launches["fused_quant_gemm"]:
            raise AssertionError(f"{name} {launches[name]} launches, "
                                 f"{launches['fused_quant_gemm']} "
                                 "calibration calls")
    gaps = {}
    again, *_ = _serve_once(torch, np, seed=0, gaps=gaps)
    if [r.out for r in reqs] != [r.out for r in again]:
        raise AssertionError("two runs from the same seed differ")
    print("second run from the same seed: identical streams")
    ident, _, run_i, _ = _with_env(
        "REPRO_PAGED_PLACEMENT", "identity",
        lambda: _serve_once(torch, np, seed=0, float_pages=False))
    if [r.out for r in reqs] != [r.out for r in ident]:
        raise AssertionError("identity placement's streams differ from "
                             "the floating pages'")
    print(f"identity placement: streams equal the floating pages' (serve "
          f"{run_i:.2f} s)")
    _legacy_server(torch, np)
    return launches, [list(r.out) for r in reqs], gaps


class Oracle:
    """A draft source that proposes a plain run's streams (``truth``,
    one list per request id): every draft is accepted."""

    def __init__(self, truth):
        self.truth = truth

    def propose(self, req, k):
        t = self.truth[req.rid]
        return t[len(req.out):len(req.out) + k]


def _spec_line(label, reqs, run_s, st, launches):
    toks = sum(len(r.out) for r in reqs)
    rate = st["spec_accept_rate"]
    ms = st["mean_verify_step_s"]
    print(f"spec {label}: {len(reqs)} requests, {toks} tokens, serve "
          f"{run_s:.2f} s = {toks / run_s:.1f} tok/s, "
          f"{st['spec_verify_steps']} verify steps of "
          f"{'n/a' if ms is None else f'{1e3 * ms:.2f}'} ms mean, "
          f"{st['decode_steps']} plain decode steps, accept rate "
          f"{'n/a' if rate is None else f'{rate:.3f}'}, verify-form "
          f"launches {json.dumps(launches)}")


def phase_engine_spec(torch, np, plain: list) -> dict:
    """Speculative verify at full width and depth: phi3-mini serves phase
    4's 8 requests with spec_decode=True, spec_k=4 three times -- with
    the default n-gram draft, with an oracle draft that proposes phase
    4's plain streams (``plain``), and with the oracle under identity
    placement -- and every stream must equal phase 4's token for token;
    the verify form must have been launched.  Then 2 prompts of ~4000
    tokens (max_len 4160, 32 new tokens) are served plainly and with the
    oracle draft on the same weights, full width with the depth cut to
    SPEC_LONG_LAYERS, with equal streams."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attn
    from repro_torch.serving import Request

    counters = [decode_attn.counter_verify,
                decode_attn.counter_contiguous_verify]
    counts = lambda: {c.name: c.count for c in counters}
    for c in counters:
        c.reset()
    oracle = Oracle(dict(enumerate(plain)))
    runs = [("n-gram draft", True, {}),
            ("oracle draft", True, dict(draft=oracle)),
            ("oracle draft, identity placement", False,
             dict(draft=oracle))]
    for label, float_pages, kw in runs:
        before = counts()
        run = lambda: _serve_once(torch, np, seed=0, float_pages=float_pages,
                                  spec_decode=True, spec_k=SPEC_K, **kw)
        reqs, _, run_s, st = (run() if float_pages else _with_env(
            "REPRO_PAGED_PLACEMENT", "identity", run))
        if [list(r.out) for r in reqs] != plain:
            raise AssertionError(f"spec {label}: streams differ from "
                                 "phase 4's plain streams")
        _spec_line(label, reqs, run_s, st,
                   {n: c - before[n] for n, c in counts().items()})
        if kw and st["spec_verify_steps"] <= 0:
            raise AssertionError(f"spec {label}: no verify step")
    launches = counts()
    print(f"verify-form launches on the spec path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "spec path")

    # the long context: plain, then the oracle over the plain streams
    cfg = get_config(ARCH)

    def long_requests():
        rng = np.random.default_rng(3)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n,
                                                   dtype=np.int32),
                        max_new=SPEC_LONG_MAX_NEW)
                for i, n in enumerate(SPEC_LONG_PROMPTS)]

    base, _, run_b, st_b = _serve_once(torch, np, seed=0,
                                       reqs=long_requests(),
                                       max_len=SPEC_LONG_MAX_LEN,
                                       layers=SPEC_LONG_LAYERS)
    toks = sum(len(r.out) for r in base)
    print(f"long context plain ({SPEC_LONG_LAYERS} layers): prompts "
          f"{SPEC_LONG_PROMPTS}, {toks} tokens, "
          f"serve {run_b:.2f} s, {st_b['chunk_prefill_steps']} prefill "
          f"chunks, {st_b['decode_steps']} decode steps of "
          f"{1e3 * st_b['mean_decode_step_s']:.2f} ms mean")
    before = counts()
    truth = {r.rid: list(r.out) for r in base}
    spec, _, run_s, st = _serve_once(
        torch, np, seed=0, reqs=long_requests(), max_len=SPEC_LONG_MAX_LEN,
        layers=SPEC_LONG_LAYERS, spec_decode=True, spec_k=SPEC_K,
        draft=Oracle(truth))
    n_long = {n: c - before[n] for n, c in counts().items()}
    _spec_line("long context, oracle draft", spec, run_s, st, n_long)
    if [list(r.out) for r in spec] != list(truth.values()):
        raise AssertionError("spec long context: streams differ from the "
                             "plain run's")
    if n_long["decode_attn_paged_verify"] <= 0:
        raise AssertionError("spec long context: no verify launch")
    print("long context: spec streams equal the plain run's")
    return launches


def _serve_ring_once(torch, np, seed: int):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine, Request

    cfg = get_config(RING_ARCH).replace(n_layers=RING_LAYERS)
    t0 = time.monotonic()
    eng = Engine(cfg, random_params(cfg, seed, "cuda"), num_slots=4,
                 max_len=RING_MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    c = eng.kv.slot_tokens
    if eng.float_pages or eng.chunked or not eng.kv.ring or c != cfg.window:
        raise AssertionError("the windowed arch did not take identity rows "
                             "and the whole-prompt prefill on its ring")
    finite = []
    eng.decode = _checked(torch, eng.decode, finite)
    eng.prefill = _checked(torch, eng.prefill, finite)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n,
                                               dtype=np.int32),
                    max_new=RING_MAX_NEW)
            for i, n in enumerate(RING_PROMPTS)]
    t0 = time.monotonic()
    eng.run(reqs, log=None)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError("ring: a request did not finish with max_new "
                             "tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("ring: non-finite logits")
    wrapped = sum(r.prompt_len + r.max_new - 1 > c for r in reqs)
    st = eng.stats()
    del eng
    torch.cuda.empty_cache()
    return reqs, build_s, run_s, st, wrapped


def phase_engine_ring(torch, np) -> dict:
    """h2o-danube-3-4b at full width, RING_LAYERS of its 24 layers, on
    random weights: 6
    requests through identity rows and the whole-prompt prefill, their
    rings wrapping; decode_attn and both mx_gemm tiles launched,
    decode_attn_paged not; a second run from the same seed gives the same
    streams."""
    from repro_torch.kernels import decode_attn, mx_fused, mx_gemm, mx_quant

    counters = [mx_gemm.counter, mx_gemm.counter_tiled, mx_fused.counter,
                mx_quant.counter, mx_quant.counter_amax,
                decode_attn.counter_contiguous, decode_attn.counter]
    for c in counters:
        c.reset()
    reqs, build_s, run_s, st, wrapped = _serve_ring_once(torch, np, seed=0)
    launches = {c.name: c.count for c in counters}
    toks = sum(len(r.out) for r in reqs)
    print(f"engine {RING_ARCH} full width, {RING_LAYERS} layers: "
          f"{len(reqs)} requests (prompts "
          f"{RING_PROMPTS}, {wrapped} rings wrapped), {toks} tokens, build "
          f"{build_s:.2f} s, serve {run_s:.2f} s = {toks / run_s:.1f} "
          f"tok/s, {st['prefill_calls']} prefills of "
          f"{st['mean_prefill_s']:.3f} s mean, {st['decode_steps']} decode "
          f"steps, mean decode step {1e3 * st['mean_decode_step_s']:.2f} ms")
    print(f"launches on the windowed path: {json.dumps(launches)}")
    if launches["decode_attn_paged"] != 0:
        raise AssertionError("the windowed path launched decode_attn_paged")
    # decode steps and the calibration forward take the M <= 32 tile,
    # the whole-prompt prefills the 128 x 128 tile; each calibration
    # call one mx_quant launch
    for name in ("mx_gemm", "mx_gemm_tiled", "fused_quant_gemm",
                 "mx_quant", "decode_attn"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "windowed path")
    for name in ("mx_quant", "global_amax"):
        if launches[name] != launches["fused_quant_gemm"]:
            raise AssertionError(f"windowed path: {name} launches differ "
                                 "from the calibration calls")
    if wrapped < 4:
        raise AssertionError(f"only {wrapped} rings wrapped")
    again, *_ = _serve_ring_once(torch, np, seed=0)
    if [r.out for r in reqs] != [r.out for r in again]:
        raise AssertionError("ring: two runs from the same seed differ")
    print("ring: second run from the same seed: identical streams")
    return launches


def _serve_line(label, reqs, run_s, st):
    toks = sum(len(r.out) for r in reqs)
    print(f"{label}: {len(reqs)} requests, {toks} tokens, serve "
          f"{run_s:.2f} s = {toks / run_s:.1f} tok/s, {st['decode_steps']} "
          f"decode steps, mean decode step "
          f"{1e3 * st['mean_decode_step_s']:.2f} ms, "
          f"{st['chunk_prefill_steps']} prefill chunks, peak memory "
          f"{st['peak_gib']:.2f} GiB")


def _check_steps(label, log: list, want: dict):
    """Every decode step of ``log`` launched exactly ``want``."""
    if not log:
        raise AssertionError(f"{label}: no decode step")
    for i, got in enumerate(log):
        if got != want:
            raise AssertionError(f"{label}: decode step {i} launched "
                                 f"{got}, expected {want}")
    print(f"{label}: each of {len(log)} decode steps launched "
          f"{json.dumps(want)}")


def _serving_counters():
    from repro_torch.kernels import decode_attn, mx_fused, mx_gemm, mx_quant

    return [mx_gemm.counter, mx_gemm.counter_tiled, mx_fused.counter,
            mx_quant.counter, mx_quant.counter_amax, decode_attn.counter,
            decode_attn.counter_contiguous, decode_attn.counter_verify,
            decode_attn.counter_contiguous_verify]


def phase_engine_hatch(torch, np):
    """The reference's three serving switches on full-width phi3-mini at
    HATCH_LAYERS layers, phase 4's requests and weights, each set for its
    run only, against a default run of the same model (its streams and
    top-two gaps):
    REPRO_SERVE_PREQUANT=0 (the bf16 tree quantized in every step
    against its build-time scales: no mx_quant launch but the
    calibration's, streams phase 4's up to a tie), REPRO_SERVE_DELAYED_
    ACT=0 (just-in-time activation scales: fused_quant_gemm at every
    quantized site of every decode step, each one global_amax, one
    mx_quant and one mx_gemm launch) and REPRO_DECODE_ATTN=einsum (the
    decode kernels' plain versions: no decode_attn launch of any form;
    then, untimed, every attention call within ``attn_limit`` of the
    kernel on the same rows: ``_einsum_beside_kernels``).  Each reports
    where its streams leave the default run's.  Returns the default run's
    streams, which phase ``engine obs`` holds its health-on run of the
    same engine against."""
    gaps = {}
    reqs, _, run_s, st = _serve_once(torch, np, seed=0, layers=HATCH_LAYERS,
                                     gaps=gaps)
    _serve_line(f"hatch default ({HATCH_LAYERS} layers)", reqs, run_s, st)
    plain = [list(r.out) for r in reqs]
    sites = 7 * HATCH_LAYERS + 1            # q k v o up gate down, head
    counters = _serving_counters()
    zero = {c.name: 0 for c in counters}
    runs = [
        ("REPRO_SERVE_PREQUANT", "0",
         {**zero, "mx_gemm": sites, "decode_attn_paged": HATCH_LAYERS}),
        ("REPRO_SERVE_DELAYED_ACT", "0",
         {**zero, "mx_gemm": sites, "fused_quant_gemm": sites,
          "mx_quant": sites, "global_amax": sites,
          "decode_attn_paged": HATCH_LAYERS}),
        ("REPRO_DECODE_ATTN", "einsum", {**zero, "mx_gemm": sites}),
    ]
    for name, value, want in runs:
        for c in counters:
            c.reset()
        log = []
        reqs, _, run_s, st = _with_env(name, value, lambda: _serve_once(
            torch, np, seed=0, layers=HATCH_LAYERS,
            step_log=(counters, log)))
        total = {c.name: c.count for c in counters}
        label = f"hatch {name}={value}"
        _serve_line(label, reqs, run_s, st)
        _check_steps(label, log, want)
        if name == "REPRO_SERVE_DELAYED_ACT":
            # no calibration: every quantizer launch is a site's, in a
            # decode step or a prefill chunk
            calls = sites * (st["decode_steps"] + st["chunk_prefill_steps"])
            if total["fused_quant_gemm"] != calls:
                raise AssertionError(f"{label}: {total['fused_quant_gemm']}"
                                     f" fused calls, expected {calls}")
            # other activation scales: other streams, reported
            div = _divergence([list(r.out) for r in reqs], plain, gaps)
            print(f"{label}: {_divergence_line(div, len(reqs))}")
            continue
        # the only quantizer launches are the calibration's
        if total["mx_quant"] != total["fused_quant_gemm"] or \
                total["fused_quant_gemm"] != sites:
            raise AssertionError(f"{label}: {total['mx_quant']} mx_quant "
                                 f"launches, {total['fused_quant_gemm']} "
                                 f"calibration calls of {sites} sites")
        div = _divergence([list(r.out) for r in reqs], plain, gaps)
        print(f"{label}: {_divergence_line(div, len(reqs))}")
        if name == "REPRO_DECODE_ATTN":
            _einsum_beside_kernels(torch, np, name, value)
        # the same weights' bits: equal streams up to a tie.  (The einsum
        # path is gated call by call above; its streams are reported.)
        if name == "REPRO_SERVE_PREQUANT" and any(g > TIE for *_, g in div):
            raise AssertionError(f"{label}: a stream leaves the default "
                                 "run's at a "
                                 f"top-two gap above {TIE} of max|logit|")
    return plain


def _einsum_beside_kernels(torch, np, name, value):
    """The hatch phase's run again under ``name``=``value`` (untimed),
    beside the kernels (``_beside_kernels``): every einsum attention call
    within ``attn_limit`` of the kernel on the same rows, or where not,
    within one bf16 rounding of the weights of it; each decode step's
    logits against the kernels' step on the same cache, reported.  A
    flipped bf16 attention output that moves one fp8 rounding of the next
    GEMM's input moves this random-weight model's logits by percents; a
    step without one gives the kernels' logits bit for bit."""
    rel, attn, restore = [], [], []
    try:
        _with_env(name, value, lambda: _serve_once(
            torch, np, seed=0, layers=HATCH_LAYERS,
            wrap_decode=lambda eng: restore.append(
                _beside_kernels(torch, eng, name, rel, attn))))
    finally:
        for fn in restore:
            fn()
    label = f"hatch {name}={value}"
    past = [a for a in attn if not a[0] <= a[2]]
    worst = max(attn, key=lambda a: a[0])
    over = ", ".join(f"{e:.3g} > {lim:.3g}" for e, _, lim, _ in past)
    print(f"{label}: {len(attn)} attention calls beside the kernel on the "
          f"same rows: max |einsum - kernel| {worst[0]:.3g} (plain vs f64 "
          f"{worst[1]:.3g}, limit {worst[2]:.3g}); {len(past)} past "
          f"attn_limit ({over}), {sum(not a[3] for a in past)} of them "
          "past one bf16 rounding of the weights")
    bad = [i for i, a in enumerate(attn) if not a[3]]
    if bad:
        raise AssertionError(f"{label}: attention call {bad[0]}: einsum vs "
                             f"kernel {attn[bad[0]][0]} past attn_limit "
                             "and one bf16 rounding of the weights")
    rel = torch.stack(rel).cpu().tolist()
    print(f"{label}: {len(rel)} decode steps beside the kernels' on the "
          f"same cache: logits bitwise equal in {rel.count(0.0)}, max|d "
          f"logit| / max|logit| {', '.join(f'{r:.3g}' for r in rel)}")


def _drained(torch, eng, finite, reqs, label):
    """Every request of ``reqs`` finished with its max_new tokens, every
    step's logits finite, no row left and the pool all free."""
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError(f"{label}: a request did not finish")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: non-finite logits")
    al = eng.kv.allocator
    if eng.kv.rows or eng._preempted or al.free_pages != al.num_pages:
        raise AssertionError(f"{label}: {len(eng.kv.rows)} rows, "
                             f"{len(eng._preempted)} parked, "
                             f"{al.free_pages} of {al.num_pages} pages free")


def _timed_run(torch, eng, reqs):
    t0 = time.monotonic()
    eng.run(reqs, log=None)
    torch.cuda.synchronize()
    return time.monotonic() - t0


def _pool_pages(torch, eng, pages) -> list:
    """A copy of physical ``pages`` of every pool tensor, as bytes."""
    from repro_torch.models.attention import _bytes
    from repro_torch.serving.paged_cache import _leaves

    idx = torch.tensor(pages, dtype=torch.int64, device="cuda")
    return [_bytes(buf).index_select(1, idx).clone()
            for pool in eng.kv.caches.values() for buf in _leaves(pool)]


def _same_pages(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _launch_line(label, counters):
    print(f"{label} launches: " + json.dumps(
        {c.name: c.count for c in counters if c.count}))


def _prefix_requests(Request, np, vocab):
    """The prefix phase's wave: 6 requests sharing a PREFIX_SYSTEM-token
    system prompt, each with its own 2-8-token suffix, and then the
    system prompt alone (a full hit)."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, vocab, PREFIX_SYSTEM, dtype=np.int32)
    wave = [Request(rid=100 + i, prompt=np.concatenate(
                [system, rng.integers(0, vocab, int(rng.integers(2, 9)),
                                      dtype=np.int32)]), max_new=16)
            for i in range(6)]
    return system, wave, Request(rid=200, prompt=system.copy(), max_new=16)


def _serve_prefix_wave(torch, np, layers=None, over=None, first=False,
                       check_donor=False):
    """Serve (phase 4's requests first if ``first``) the prefix wave and
    its full hit on one engine with the prefix cache at its default.
    With ``check_donor``, the donor's shared pages are held byte for
    byte across the full hit's copy-on-write.  Returns the streams
    (phase 4's, the wave's, the full hit's), the wave's mean TTFT and
    the engine's stats."""
    from repro_torch.serving import Request
    from repro_torch.serving.paged_cache import page_keys

    eng, finite = _engine(layers=layers, over=over,
                          max_len=PREFIX_MAX_LEN), []
    eng.decode = _checked(torch, eng.decode, finite)
    label = f"prefix {'on' if eng.prefix_cache else 'off'}"
    base = _requests(Request, np, eng.cfg, 0) if first else []
    if base:
        _timed_run(torch, eng, base)
    system, wave, full = _prefix_requests(Request, np, eng.cfg.vocab)
    wave_s = _timed_run(torch, eng, wave)
    ttft = float(np.mean([r.ttft for r in wave]))
    if check_donor:
        pages = eng.kv.allocator.lookup(page_keys(system, eng.kv.page_size))
        if len(pages) != PREFIX_SYSTEM // eng.kv.page_size:
            raise AssertionError(f"{label}: {len(pages)} system-prompt "
                                 "pages registered")
        before = _pool_pages(torch, eng, pages)
        cow0 = eng.kv.cow_copies
    _timed_run(torch, eng, [full])
    if check_donor:
        if eng.kv.cow_copies <= cow0:
            raise AssertionError(f"{label}: the full hit copied no page")
        if not _same_pages(torch, before, _pool_pages(torch, eng, pages)):
            raise AssertionError(f"{label}: the donor's shared pages "
                                 "changed under the full hit's write")
        print(f"{label}: the donor's {len(pages)} shared pages byte for "
              f"byte unchanged across the full hit's copy-on-write")
    _drained(torch, eng, finite, base + wave + [full], label)
    st = eng.stats()
    toks = sum(len(r.out) for r in wave)
    print(f"{label} ({eng.cfg.kv_cache_dtype} cache, {eng.cfg.n_layers} "
          f"layers): wave of {len(wave)} x {PREFIX_SYSTEM}+2..8 tokens in "
          f"{wave_s:.2f} s ({toks / wave_s:.1f} tok/s), mean TTFT "
          f"{1e3 * ttft:.1f} ms, prefix hits {st['prefix_hits']}, prefill "
          f"tokens skipped {st['prefill_tokens_skipped']}, pages shared "
          f"{st['pages_shared']}, CoW copies {st['cow_copies']}, "
          f"{st['chunk_prefill_steps']} prefill chunks, peak pool pages "
          f"{st['peak_pool_pages']}")
    out = ([list(r.out) for r in base], [list(r.out) for r in wave],
           list(full.out))
    del eng
    torch.cuda.empty_cache()
    return out, ttft, st


def phase_engine_prefix(torch, np):
    """The prefix cache at its default on full-width phi3-mini, depth cut
    to PREFIX_LAYERS, Engine(num_slots=4, max_len=640): phase 4's 8
    requests (their streams with and without the cache reported), then
    a wave of 6 requests sharing a 512-token system prompt (16 chunks),
    each with a 2-8-token suffix, then the system prompt alone.  The
    first wave request registers the prompt's 32 pages; the other five
    hit them (512 prompt tokens skipped each) and the last request hits
    them all (511 skipped: its last prompt token chunks, writing into a
    copy of the donor's last page).  Gates: 6 hits,
    5 · 512 + 511 skipped tokens, a copy-on-write that leaves the
    donor's pages byte for byte as they were, and the wave's streams
    (the five partial hits and the miss) bit for bit those of a
    REPRO_PREFIX_CACHE=0 serve.  The full hit reads positions 480-510
    from the fp8 pool where a cold serve's chunk reads its own bf16
    K/V, so its stream is held to the cold one in a bf16-cache run
    (depth cut to PREFIX_BF16_LAYERS, full width), with the wave's."""
    counters = _serving_counters()
    for c in counters:
        c.reset()
    (base, wave, full), ttft_on, st = _serve_prefix_wave(
        torch, np, layers=PREFIX_LAYERS, first=True, check_donor=True)
    _launch_line("prefix on", counters)
    skipped = 5 * PREFIX_SYSTEM + PREFIX_SYSTEM - 1
    if (st["prefix_hits"], st["prefill_tokens_skipped"]) != (6, skipped):
        raise AssertionError(f"prefix on: {st['prefix_hits']} hits, "
                             f"{st['prefill_tokens_skipped']} skipped "
                             f"tokens, expected 6 and {skipped}")
    if st["cow_copies"] < 1 or st["prefix_hit_requests"] != 6:
        raise AssertionError(f"prefix on: {st['cow_copies']} CoW copies, "
                             f"{st['prefix_hit_requests']} hit requests")
    (base_off, wave_off, full_off), ttft_off, st_off = _with_env(
        "REPRO_PREFIX_CACHE", "0", lambda: _serve_prefix_wave(
            torch, np, layers=PREFIX_LAYERS, first=True))
    print(f"prefix: phase 4's requests at max_len {PREFIX_MAX_LEN}, "
          f"{PREFIX_LAYERS} layers: {sum(a == b for a, b in zip(base, base_off))}"
          f" of {len(base)} streams equal with and without the cache")
    if st_off["prefix_hits"] or st_off["pages_shared"]:
        raise AssertionError("REPRO_PREFIX_CACHE=0 shared pages")
    if wave != wave_off:
        raise AssertionError("prefix on: the wave's streams differ from a "
                             "REPRO_PREFIX_CACHE=0 serve")
    print(f"prefix: the wave's 6 streams (5 partial hits) bit for bit "
          f"those of REPRO_PREFIX_CACHE=0; mean TTFT {1e3 * ttft_on:.1f} "
          f"ms with the cache, {1e3 * ttft_off:.1f} ms without; the full "
          f"hit's fp8 stream {'equals' if full == full_off else 'leaves'} "
          "the cold one")
    bf16 = dict(kv_cache_dtype="bf16")
    (_, wave_b, full_b), _, st_b = _serve_prefix_wave(
        torch, np, layers=PREFIX_BF16_LAYERS, over=bf16)
    (_, wave_bc, full_bc), _, _ = _with_env(
        "REPRO_PREFIX_CACHE", "0", lambda: _serve_prefix_wave(
            torch, np, layers=PREFIX_BF16_LAYERS, over=bf16))
    if st_b["prefix_hits"] != 6 or wave_b != wave_bc or full_b != full_bc:
        raise AssertionError(f"prefix bf16: {st_b['prefix_hits']} hits; "
                             "the wave's or the full hit's stream differs "
                             "from the cold serve's")
    print(f"prefix bf16 ({PREFIX_BF16_LAYERS} layers): the wave's and the "
          "full hit's streams bit for bit the cold serve's")


def _preempt_requests(Request, np, vocab):
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n),
                                               dtype=np.int32),
                    max_new=PREEMPT_MAX_NEW)
            for i, n in enumerate(rng.integers(16, 49, size=8))]


def _watch_swaps(torch, eng, log: dict):
    """Wrap ``eng``'s swaps: each victim's live pages are copied before
    its swap-out and held byte for byte after its swap-in; ``log`` gets
    the bytes moved out and each swap's seconds (synchronised around
    it, so that the host-to-device and device-to-host copies count)."""
    kv = eng.kv
    out, back, held = kv.swap_out, kv.swap_in, {}

    def swap_out(row):
        owner = kv.rows[row]
        n = -(-kv.lengths[row] // kv.page_size)
        held[owner] = _pool_pages(
            torch, eng, kv.allocator.table(owner).pages[:n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = out(row)
        torch.cuda.synchronize()
        log["out_s"].append(time.perf_counter() - t0)
        log["bytes"] += sum(t.numel() * t.element_size()
                            for ts in bundle["store"].values() for t in ts)
        return bundle

    def swap_in(bundle, total):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = back(bundle, total)
        torch.cuda.synchronize()
        log["in_s"].append(time.perf_counter() - t0)
        owner = bundle["owner"]
        pages = kv.allocator.table(owner).pages[:bundle["n_pages"]]
        if not _same_pages(torch, held.pop(owner),
                           _pool_pages(torch, eng, pages)):
            raise AssertionError(f"request {owner}: its pages differ after "
                                 "the swap round trip")
        log["round_trips"] += 1
        return row

    kv.swap_out, kv.swap_in = swap_out, swap_in


def _row_at_b1_and_b4(torch, np, eng, label, verify: bool = True) -> dict:
    """A decode step of ``eng``'s model over 4 rows at depths 19, 33, 8
    and 27 (each prefilled by the engine's own prefill into identity
    rows) and the same step of row 0 alone; then (with ``verify``) a
    verify step of SPEC_K positions a row over the same rows (4·SPEC_K
    rows, the most a 4-slot engine's verify step takes) and of row 0
    alone, under the row limit an engine with speculative decode gives
    its steps (``Engine.step_rows``).  Returns and prints max |logits(B 1) -
    logits(B 4)| of row 0 for each step (0 where every computation of a
    row is independent of the rows beside it), and the B-4 decode step's
    ms with the fixed row order (``core.row_order``) and without it."""
    from repro_torch.models.transformer import (cache_idx, init_caches,
                                                map_payloads, with_idx)
    from repro_torch.serving.paged_cache import write_row
    from repro_torch.train.steps import make_decode_step, make_verify_step

    cfg, rng = eng.cfg, np.random.default_rng(3)
    lens = [19, 33, 8, 27]
    b = len(lens)
    steps = dict(scales=eng.scales, act_scales=eng.act_scales)
    verify_step = make_verify_step(cfg, rows=b * SPEC_K, **steps)

    def row0(caches):
        return {n: with_idx(map_payloads(c, lambda t: t[:, :1].clone()),
                            cache_idx(c)[:1].clone())
                for n, c in caches.items()}

    def ms(step, caches, toks):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(eng.params, caches, toks)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times[1:])

    with torch.inference_mode():
        caches = init_caches(cfg, b, eng.max_len, per_slot=True,
                             device="cuda")
        feed = []
        for i, n in enumerate(lens):
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab, (1, n)).astype(np.int32)).cuda()
            logits, one = eng.prefill(eng.params, prompt)
            write_row(caches, one, i, n)
            feed.append(int(logits[0, -1].argmax()))
        toks = torch.tensor(feed, dtype=torch.int32, device="cuda")[:, None]
        drafts = torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, SPEC_K)).astype(np.int32)).cuda()
        drafts[:, 0] = toks[:, 0]
        # each step writes the positions at the caches' idx, which the
        # returned caches advance: every call below writes the same ones
        l1, _ = eng.decode(eng.params, row0(caches), toks[:1])
        l4, _ = eng.decode(eng.params, caches, toks)
        out = dict(decode=float((l1[0, -1] - l4[0, -1]).abs().max()),
                   verify=None)
        if verify:
            v1, _ = verify_step(eng.params, row0(caches), drafts[:1])
            v4, _ = verify_step(eng.params, caches, drafts)
            out["verify"] = float((v1[0] - v4[0]).abs().max())
        big = float(l4[0, -1].abs().max())
        out["fixed_ms"] = ms(make_decode_step(cfg, rows=b, **steps),
                             caches, toks)
        out["plain_ms"] = ms(make_decode_step(cfg, **steps), caches, toks)
    vline = ("" if not verify else f", verify ({SPEC_K} positions a row, "
             f"{b * SPEC_K} rows at B 4) max |d| {out['verify']:.4g}")
    print(f"{label}: row 0's logits at B 1 against B 4 (depths {lens}): "
          f"decode max |d| {out['decode']:.4g}{vline}, "
          f"of max|logit| {big:.4g}; a B-4 decode step "
          f"{out['fixed_ms']:.2f} ms in the fixed row order, "
          f"{out['plain_ms']:.2f} ms without it")
    return out


def _serve_preempt(torch, np, label, layers=None, swaps=None, after=None,
                   **kw):
    """The preempt phase's 8 requests on one engine (max_len
    PREEMPT_MAX_LEN); ``after(eng)`` is called once they are served.
    Returns the streams and the stats."""
    from repro_torch.serving import Request

    eng, finite = _engine(layers=layers, max_len=PREEMPT_MAX_LEN, **kw), []
    eng.decode = _checked(torch, eng.decode, finite)
    if swaps is not None:
        _watch_swaps(torch, eng, swaps)
    peak = [0]
    step = eng.decode

    def decode(params, caches, toks):
        if toks.shape[1] == 1:
            peak[0] = max(peak[0], toks.shape[0])
        return step(params, caches, toks)

    eng.decode = decode
    reqs = _preempt_requests(Request, np, eng.cfg.vocab)
    run_s = _timed_run(torch, eng, reqs)
    _drained(torch, eng, finite, reqs, label)
    st = eng.stats()
    toks = sum(len(r.out) for r in reqs)
    print(f"{label} ({eng.cfg.n_layers} layers, "
          f"{eng.kv.allocator.num_pages} pages, "
          f"{'usage' if eng.preemption else 'reservation'} admission): "
          f"{toks} tokens in {run_s:.2f} s = {toks / run_s:.1f} tok/s, "
          f"{st['decode_steps']} decode steps, peak decode rows {peak[0]}, "
          f"preemptions {st['preemptions']}, swap-ins {st['swap_ins']}, "
          f"peak pool pages {st['peak_pool_pages']}")
    if after is not None:
        after(eng)
    out = [list(r.out) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return out, st


def phase_engine_preempt(torch, np):
    """Preemption to the host on full-width phi3-mini, PREEMPT_LAYERS of
    its 32 layers: Engine(num_slots=4, max_len=128, num_pages=12), where
    32 pages would back the slots fully, serves 8 requests of 16-48
    prompt tokens and 64 new tokens.  Usage admission packs them until
    growth finds the pool dry, and the engine swaps victims out and back
    in.  Gates: preemptions > 0 and as many swap-ins, the pool free at
    the end, every victim's pages byte for byte the same after its swap
    round trip (every pool tensor, payloads and per-token scales), and
    the streams bit for bit those of the same requests on a fully backed
    pool; a victim decodes in smaller batches than on the fully backed
    pool, so a decode row's logits at B 1 must equal the same row's at
    B 4, in a decode and in a verify step (``_row_at_b1_and_b4`` on the
    preempting engine once its run is read: the norms' row sums, once in
    an order that depended on the batch, tools/preempt_trace.py).  Then
    REPRO_PREEMPTION=0 (reservation admission: about one request at a
    time on this pool), at PREEMPT_RESERVE_LAYERS layers beside its
    fully backed twin at that depth: equal streams and no preemption."""
    counters = _serving_counters()
    swaps = {"bytes": 0, "out_s": [], "in_s": [], "round_trips": 0}
    rows = {}

    def after(eng):
        # the run's own launches, then the row check on its engine
        _launch_line("preempt usage", counters)
        rows.update(_row_at_b1_and_b4(torch, np, eng, f"{ARCH} "
                                      f"({PREEMPT_LAYERS} layers)"))

    for c in counters:
        c.reset()
    small, st = _serve_preempt(torch, np, "preempt usage", swaps=swaps,
                               layers=PREEMPT_LAYERS, after=after,
                               num_pages=PREEMPT_PAGES)
    if rows["decode"] != 0.0 or rows["verify"] != 0.0:
        raise AssertionError(f"preempt: row 0 at B 1 differs from the same "
                             f"row at B 4 by {rows['decode']} (decode), "
                             f"{rows['verify']} (verify)")
    if not (st["preemptions"] > 0
            and st["swap_ins"] == st["preemptions"]
            == swaps["round_trips"]):
        raise AssertionError(f"preempt: {st['preemptions']} preemptions, "
                             f"{st['swap_ins']} swap-ins, "
                             f"{swaps['round_trips']} round trips")
    n = st["preemptions"]
    print(f"preempt: {n} swaps out and back, each victim's pages byte for "
          f"byte after its round trip; {swaps['bytes'] / 2 ** 20:.2f} MiB "
          f"to the host ({swaps['bytes'] / n / 2 ** 20:.2f} MiB a swap), "
          f"swap-out {1e3 * statistics.mean(swaps['out_s']):.2f} ms, "
          f"swap-in {1e3 * statistics.mean(swaps['in_s']):.2f} ms a swap")
    full, _ = _serve_preempt(torch, np, "preempt fully backed",
                             layers=PREEMPT_LAYERS)
    if small != full:
        raise AssertionError("preempt: streams differ from the fully "
                             "backed pool's")
    print("preempt: streams bit for bit the fully backed pool's")
    res, st_r = _with_env("REPRO_PREEMPTION", "0", lambda: _serve_preempt(
        torch, np, "reservation", layers=PREEMPT_RESERVE_LAYERS,
        num_pages=PREEMPT_PAGES))
    twin, _ = _serve_preempt(torch, np, "reservation fully backed",
                             layers=PREEMPT_RESERVE_LAYERS)
    if st_r["preemptions"] or res != twin:
        raise AssertionError(f"REPRO_PREEMPTION=0: {st_r['preemptions']} "
                             "preemptions, or streams differ from the fully "
                             "backed pool's")
    print("reservation admission: no preemption, streams bit for bit the "
          "fully backed pool's")


# phase engine obs: phi3-mini at HATCH_LAYERS (the hatch default run's
# engine, whose streams and decode step it is held against); the health
# run samples every OBS_EVERY + 1-th call of a step shape; the stale act
# scales are the calibrated ones times OBS_STALE
OBS_EVERY, OBS_STALE = 4, 0.25


def _with_envs(env: dict, fn):
    """``fn()`` with every variable of ``env`` set (``_with_env``)."""
    if not env:
        return fn()
    (name, value), *rest = env.items()
    return _with_env(name, value, lambda: _with_envs(dict(rest), fn))


def _card_launches(torch, fn):
    """``fn()``'s result and how many kernels, copies and memsets it ran
    on the card (torch.profiler's device events of the call)."""
    import tempfile

    from repro_torch.launch.profile_serve import GPU_CATS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, sum(e.get("ph") == "X" and e.get("cat") in GPU_CATS
                    for e in events)


def _health_step_launches(torch, np, eng, raw) -> dict:
    """On 4 identity rows at depths 19, 33, 8 and 27 (prefilled by the
    engine's own prefill), one (4, 1) decode step of a health-off build
    of the engine's step, of its unsampled step (``raw[0]``) and of its
    sampled, instrumented step (``raw[1]``), each after a warm-up call:
    the card's launches of each (torch.profiler), which must be equal
    but for the sampled step's statistics, and logits bitwise equal."""
    from repro_torch.models.transformer import init_caches
    from repro_torch.serving.paged_cache import write_row
    from repro_torch.train.steps import make_decode_step

    cfg, rng = eng.cfg, np.random.default_rng(3)
    off = make_decode_step(cfg, scales=eng.scales, act_scales=eng.act_scales,
                           rows=eng.step_rows)
    out = {}
    with torch.inference_mode():
        caches = init_caches(cfg, 4, eng.max_len, per_slot=True,
                             device="cuda")
        feed = []
        for i, n in enumerate([19, 33, 8, 27]):
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab, (1, n)).astype(np.int32)).cuda()
            logits, one = eng.prefill(eng.params, prompt)
            write_row(caches, one, i, n)
            feed.append(int(logits[0, -1].argmax()))
        toks = torch.tensor(feed, dtype=torch.int32, device="cuda")[:, None]
        # each call writes the same positions (the caches' idx is not
        # advanced in place)
        for name, step in (("health off", off), ("unsampled", raw[0]),
                           ("sampled", raw[1])):
            step(eng.params, caches, toks)
            res, n = _card_launches(
                torch, lambda: step(eng.params, caches, toks))
            out[name] = (res[0].float(), n)
    (want, n_off), (unsampled, n_un), (sampled, n_s) = out.values()
    if not (torch.equal(unsampled, want) and torch.equal(sampled, want)):
        raise AssertionError("obs: a health-on decode step's logits differ "
                             "from the health-off step's")
    if n_un != n_off or n_s <= n_off:
        raise AssertionError(f"obs: {n_un} launches an unsampled decode step,"
                             f" {n_off} health off, {n_s} sampled")
    return dict(off=n_off, unsampled=n_un, sampled=n_s)


def _obs_health(torch, np, hatch: list) -> dict:
    """(a) REPRO_QUANT_HEALTH=1, REPRO_QUANT_HEALTH_EVERY=OBS_EVERY on the
    hatch default's engine: its streams, every decode step's kernel
    launches and the calls its countdown samples; the card launches of
    a sampled and an unsampled step (``_health_step_launches``); then the
    same engine given stale act scales (the calibrated ones times
    OBS_STALE) serves the requests again and must recommend a refresh,
    and its ``refresh_act_scales()`` must give back the build's
    calibration (a fresh engine's: the same weights and calibration
    prompt) bit for bit."""
    from repro_torch.core.actscale import ActScale
    from repro_torch.serving import Request

    sites = 7 * HATCH_LAYERS + 1
    counters = _serving_counters()
    want_step = {**{c.name: 0 for c in counters}, "mx_gemm": sites,
                 "decode_attn_paged": HATCH_LAYERS}
    calls, steps, found = [], {False: [], True: []}, {}

    def wrap(eng):
        if not eng.health or eng.health_every != OBS_EVERY:
            raise AssertionError(f"obs: health {eng.health}, every "
                                 f"{eng.health_every}")
        raw = (eng.decode, eng.decode_h)

        def logged(fn, sampled):
            def step(params, caches, toks):
                before = [c.count for c in counters]
                out = fn(params, caches, toks)
                calls.append((tuple(toks.shape), sampled))
                if toks.shape[1] == 1:
                    steps[sampled].append({c.name: c.count - b for c, b in
                                           zip(counters, before)})
                return out
            return step

        eng.decode, eng.decode_h = logged(raw[0], False), logged(raw[1], True)
        found["raw"] = raw

    def after(eng):
        found["launches"] = _health_step_launches(torch, np, eng,
                                                  found.pop("raw"))
        fresh, fresh_qh = eng.act_scales, eng.qh
        eng.act_scales = {t: ActScale(a.s * OBS_STALE, a.sub)
                          for t, a in fresh.items()}
        eng.qh = None                          # a new aggregator
        eng._build_steps()
        reqs = _requests(Request, np, eng.cfg, 0)
        for r in reqs:
            r.rid += 100
        eng.run(reqs, log=None)
        found["stale"] = eng.qh
        found["fresh"] = fresh_qh
        found["tags"] = len(fresh)
        again = eng.refresh_act_scales()
        found["same"] = sorted(again) == sorted(fresh) and all(
            torch.equal(again[t].s, a.s) and torch.equal(again[t].sub, a.sub)
            for t, a in fresh.items())

    env = {"REPRO_QUANT_HEALTH": "1",
           "REPRO_QUANT_HEALTH_EVERY": str(OBS_EVERY)}
    for c in counters:
        c.reset()
    reqs, _, run_s, st = _with_envs(env, lambda: _serve_once(
        torch, np, seed=0, layers=HATCH_LAYERS, wrap_decode=wrap,
        after=after))
    _serve_line(f"obs health on ({HATCH_LAYERS} layers, every "
                f"{OBS_EVERY + 1}-th call of a shape sampled)", reqs, run_s,
                st)
    if [list(r.out) for r in reqs] != hatch:
        raise AssertionError("obs: the health-on streams differ from the "
                             "health-off engine's")
    seen = {}
    for shape, sampled in calls:
        i = seen.get(shape, 0)
        if sampled != (i % (OBS_EVERY + 1) == 0):
            raise AssertionError(f"obs: call {i} of shape {shape} sampled "
                                 f"{sampled}, not as the countdown predicts")
        seen[shape] = i + 1
    n_sampled = sum(s for _, s in calls)
    print(f"obs health: {len(calls)} step calls over {len(seen)} shapes, "
          f"{n_sampled} sampled where the countdown predicts; streams equal "
          "the health-off engine's")
    _check_steps("obs health unsampled", steps[False], want_step)
    _check_steps("obs health sampled", steps[True], want_step)
    n = found["launches"]
    print(f"obs health: a (4, 1) decode step launches {n['off']} on the card "
          f"health off, {n['unsampled']} unsampled, {n['sampled']} sampled "
          f"(+{n['sampled'] - n['off']}: the statistics of {sites} GEMM "
          "sites); "
          "logits bitwise equal")
    fresh, stale = found["fresh"], found["stale"]
    drift = {k: max(s["drift_max"] for s in q.report().values())
             for k, q in (("fresh", fresh), ("stale", stale))}
    ratio = [stale.report()[t]["drift_max"] / s["drift_max"]
             for t, s in fresh.report().items()]
    print(f"obs health: {len(fresh.report())} sites, {fresh.steps} sampled "
          f"steps, max drift {drift['fresh']:.4g}, refresh_recommended "
          f"{fresh.refresh_recommended}; with act scales x {OBS_STALE}: max "
          f"drift {drift['stale']:.4g} ({drift['stale'] / drift['fresh']:.3f}"
          f"x; a site's {min(ratio):.3f}-{max(ratio):.3f}x), "
          f"refresh_recommended {stale.refresh_recommended}")
    if n_sampled != fresh.steps or len(fresh.report()) != found["tags"]:
        raise AssertionError(f"obs: {fresh.steps} steps ingested of "
                             f"{n_sampled} sampled, {len(fresh.report())} "
                             f"sites of {found['tags']}")
    if not stale.refresh_recommended or drift["stale"] <= drift["fresh"]:
        raise AssertionError("obs: stale act scales did not recommend a "
                             "refresh")
    if not found["same"]:
        raise AssertionError("obs: refresh_act_scales() differs from the "
                             "build's calibration")
    print("obs health: refresh_act_scales() gives the build's calibration "
          "bit for bit")
    return dict(launches=n, sampled_steps=n_sampled, drift=drift,
                site_drift_ratio=[min(ratio), max(ratio)])


def _obs_kv_bf16(torch, np) -> dict:
    """(b) REPRO_KV_CACHE=bf16 on the hatch default's engine: a bf16 page
    pool (scales None) whose streams equal an engine built on
    ``kv_cache_dtype="bf16"``; every paged decode attention kernel call
    of the run beside its plain version on the same pages
    (``_paged_beside_plain``, within ``attn_limit`` or one bf16 rounding
    of the weights); a decode and a verify row at B 1 bitwise at B 4 on
    bf16 identity rows; a preempting 12-page bf16 pool (at
    PREEMPT_RESERVE_LAYERS) the fully backed pool's streams.  The mean
    decode step on either pool is timed in turns (fp8, bf16, bf16, fp8:
    the step is host-bound and moves with the host's load).  Returns the
    decode kernels' launches of these runs and the decode steps' ms."""
    counters = _serving_counters()
    for c in counters:
        c.reset()
    attn, found = [], {}

    def after(eng):
        found["run"] = {c.name: c.count for c in counters}
        pool = eng.kv.caches["blocks"]
        if pool.k.dtype != torch.bfloat16 or pool.k_scale is not None:
            raise AssertionError(f"obs: REPRO_KV_CACHE=bf16 gave a "
                                 f"{pool.k.dtype} pool")
        found["rows"] = _row_at_b1_and_b4(torch, np, eng,
                                          f"{ARCH} bf16 pool ({HATCH_LAYERS}"
                                          " layers)")
        found["all"] = {c.name: c.count for c in counters}

    restore = _paged_beside_plain(torch, attn)
    try:
        reqs, _, run_s, st = _with_env("REPRO_KV_CACHE", "bf16", lambda:
                                       _serve_once(torch, np, seed=0,
                                                   layers=HATCH_LAYERS,
                                                   after=after))
    finally:
        restore()
    _serve_line("obs REPRO_KV_CACHE=bf16 (each kernel call beside its plain "
                "version)", reqs, run_s, st)
    ms, twin = {"fp8": [], "bf16": []}, None
    for kv in ("fp8", "bf16", "bf16", "fp8"):
        got, _, run_k, st_k = _serve_once(torch, np, seed=0,
                                          layers=HATCH_LAYERS,
                                          over=dict(kv_cache_dtype=kv))
        ms[kv].append(1e3 * st_k["mean_decode_step_s"])
        if kv == "bf16" and twin is None:
            twin = got
            _serve_line('obs kv_cache_dtype="bf16"', got, run_k, st_k)
    if [r.out for r in reqs] != [r.out for r in twin]:
        raise AssertionError("obs: REPRO_KV_CACHE=bf16 streams differ from "
                             "the bf16 config's")
    past = [a for a in attn if not a[0] <= a[2]]
    bad = [a for a in past if not a[3]]
    worst = max(attn, key=lambda a: a[0])
    print(f"obs bf16 pool: {len(attn)} paged decode attention kernel calls "
          f"beside the plain version: max |kernel - plain| {worst[0]:.3g} "
          f"(plain vs f64 {worst[1]:.3g}, limit {worst[2]:.3g}); "
          f"{len(past)} past attn_limit, {len(bad)} of them past one bf16 "
          "rounding of the weights")
    if bad or not attn:
        raise AssertionError("obs: a bf16-pool attention call past its limit")
    rows = found["rows"]
    if rows["decode"] != 0.0 or rows["verify"] != 0.0:
        raise AssertionError(f"obs bf16: row 0 at B 1 differs from B 4 by "
                             f"{rows['decode']} / {rows['verify']}")
    print(f"obs: the mean decode step on the bf16 pool "
          f"{ms['bf16'][0]:.2f} and {ms['bf16'][1]:.2f} ms, on the fp8 pool "
          f"{ms['fp8'][0]:.2f} and {ms['fp8'][1]:.2f} ms (runs in turns "
          f"fp8, bf16, bf16, fp8; {HATCH_LAYERS} layers, 4 slots)")
    swaps = {"bytes": 0, "out_s": [], "in_s": [], "round_trips": 0}
    for c in counters:
        c.reset()
    small, st_s = _with_env("REPRO_KV_CACHE", "bf16", lambda: _serve_preempt(
        torch, np, "obs preempt bf16 pool", swaps=swaps,
        layers=PREEMPT_RESERVE_LAYERS, num_pages=PREEMPT_PAGES))
    full, _ = _with_env("REPRO_KV_CACHE", "bf16", lambda: _serve_preempt(
        torch, np, "obs fully backed bf16 pool",
        layers=PREEMPT_RESERVE_LAYERS))
    # the decode kernels' launches on the bf16 pools and rows: the run and
    # its row check, then the two preempt runs
    preempt = {c.name: c.count for c in counters}
    launches = {k: found["all"][k] + preempt[k] for k in
                ("decode_attn_paged", "decode_attn", "decode_attn_verify")}
    if not (st_s["preemptions"] > 0 and swaps["round_trips"]
            == st_s["swap_ins"] == st_s["preemptions"]) or small != full:
        raise AssertionError(f"obs bf16 preempt: {st_s['preemptions']} "
                             "preemptions, or streams differ from the fully "
                             "backed pool's")
    print(f"obs bf16 preempt: {st_s['preemptions']} swaps, each victim's "
          "pages byte for byte after its round trip; streams bit for bit "
          "the fully backed pool's")
    return dict(launches=launches, decode_ms=ms)


def _obs_cli(torch, np) -> dict:
    """(c) ``repro_torch.launch.serve`` (phi3-mini, HATCH_LAYERS layers,
    on the card) with --metrics-out and --trace-out: both files parse,
    one ``engine.step`` span a step of the engine, the engine_* and
    sched_* series present; then on the CLI's engine, 4 new requests
    admitted, one decode step with the tracer on and one with it off
    launch as many kernels on the card."""
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.obs.trace import get_tracer
    from repro_torch.serving import Engine, Request

    steps, real = [], Engine.step

    def counted(self):
        steps.append(1)
        return real(self)

    Engine.step = counted
    try:
        with tempfile.TemporaryDirectory() as d:
            m, t = os.path.join(d, "metrics.json"), os.path.join(d, "t.json")
            eng = serve.main(["--arch", ARCH, "--layers", str(HATCH_LAYERS),
                              "--metrics-out", m, "--trace-out", t])
            with open(m) as f:
                snap = json.load(f)
            with open(t) as f:
                events = json.load(f)
    finally:
        Engine.step = real
    tracer = get_tracer()
    n_spans = sum(e["name"] == "engine.step" for e in events)
    series = sorted(snap)
    print(f"obs CLI: {len(events)} trace events, {n_spans} engine.step "
          f"spans for {len(steps)} engine steps; {len(series)} series: "
          + ", ".join(series))
    if n_spans != len(steps) or not steps:
        raise AssertionError("obs CLI: engine.step spans and steps differ")
    for prefix in ("engine_", "sched_", "pages_"):
        if not any(k.startswith(prefix) for k in series):
            raise AssertionError(f"obs CLI: no {prefix}* series")
    rng = np.random.default_rng(12)
    eng.submit([Request(rid=100 + i, prompt=rng.integers(
        0, eng.cfg.vocab, 8 + 5 * i, dtype=np.int32), max_new=12)
        for i in range(4)])
    while eng.sched.queue or eng._staging is not None:
        eng.step()
    eng.step()
    if len(eng.kv.rows) != 4:
        raise AssertionError("obs CLI: the 4 requests are not resident")
    tracer.clear()
    _, on = _card_launches(torch, eng.step)
    n_ev = len(tracer)
    tracer.disable()
    _, off = _card_launches(torch, eng.step)
    tracer.clear()
    eng.run([], log=None)
    tracer.path = None
    print(f"obs CLI: a decode step launches {on} on the card with the tracer"
          f" on ({n_ev} events), {off} with it off")
    if on != off or not n_ev:
        raise AssertionError("obs CLI: tracing changed the launches")
    del eng
    torch.cuda.empty_cache()
    return dict(spans=n_spans, launches_traced=on, launches_untraced=off)


def _obs_train(torch) -> dict:
    """(d) One moss training step of olmo-7b at full width, the train
    phase's cut (TRAIN_LAYERS layers, 1 x TRAIN_M), through the training
    CLI's ``train`` with the tracer on: its ``train.data`` and
    ``train.step`` spans."""
    from repro_torch.launch.train import train
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        train(TRAIN_ARCH, smoke=False, steps=1, batch=1, seq=TRAIN_M,
              layers=TRAIN_LAYERS, device="cuda", log=print)
        events = tracer.events()
    finally:
        tracer.disable()
        tracer.clear()
    got = [(e["name"], e.get("args")) for e in events]
    print("obs train: spans " + ", ".join(
        f"{e['name']} {e['dur'] / 1e3:.1f} ms" for e in events))
    if got != [("train.data", {"step": 0}), ("train.step", {"step": 0})]:
        raise AssertionError(f"obs train: spans {got}")
    torch.cuda.empty_cache()
    return {e["name"]: e["dur"] / 1e3 for e in events}


def phase_engine_obs(torch, np, hatch: list) -> dict:
    """Observability and REPRO_KV_CACHE on full-width phi3-mini at
    HATCH_LAYERS layers, Engine(num_slots=4, max_len=64, page_size=16),
    phase 4's 8 requests: (a) quant-health (``_obs_health``), (b) the
    bf16 cache override (``_obs_kv_bf16``), (c) the serving CLI's
    metrics and trace (``_obs_cli``), (d) a traced training step
    (``_obs_train``).  Returns the decode kernels' launches on the bf16
    pool and rows, and the phase's numbers."""
    out = dict(health=_obs_health(torch, np, hatch),
               kv_bf16=_obs_kv_bf16(torch, np),
               cli=_obs_cli(torch, np), train_spans_ms=_obs_train(torch))
    print("obs: " + json.dumps(out))
    return out


def _group_gemm_serving(torch, timer) -> dict:
    """group_gemm (row 6) at the per_group serving rows, M 4 (decode),
    16 and 32 (prefill chunk), over phi3-mini's decode (K, N): e4m3
    activations per 128 along K against the e4m3 weight, within 1e-5 *
    max|ref| of the plain version, timed beside it and beside bf16
    torch.matmul.  Returns the kernels line's serving entry: the M 4
    row at (3072, 8192), as mx_gemm's, and the largest error."""
    from repro_torch.core.quant import quant_per_group, quant_per_tensor
    from repro_torch.kernels import group_gemm

    gen = torch.Generator(device="cuda").manual_seed(9)
    row, worst = {}, 0.0
    for k, n in GEMM_KN:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        qw = quant_per_tensor(w).q
        del w
        for m in SMALL_M:
            xq = quant_per_group(_activations(torch, gen, m, k), 128, "e4m3")
            got = group_gemm.group_gemm(xq.q, xq.s, qw)
            want = group_gemm.group_gemm_plain(xq.q, xq.s, qw)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not (err <= 1e-5 * scale and torch.isfinite(got).all()):
                raise AssertionError(f"group_gemm serving M={m} K={k} "
                                     f"N={n}: max err {err} > 1e-5 * {scale}")
            worst = max(worst, err)
            xb, wb = xq.q.to(torch.bfloat16), qw.to(torch.bfloat16)
            t = timer.ms(lambda: group_gemm.group_gemm(xq.q, xq.s, qw))
            tp = timer.ms(lambda: group_gemm.group_gemm_plain(xq.q, xq.s,
                                                              qw))
            tl = timer.ms(lambda: torch.matmul(xb, wb))
            b, by = bound_ms(m * k + 4 * m * (k // 128) + k * n + 4 * m * n,
                             2.0 * m * n * k)
            print(f"group_gemm serving M={m:2d} K={k} N={n}: max_err "
                  f"{err:.3g} (max|ref| {scale:.3g}), {t:.4f} ms, plain "
                  f"{tp:.4f} ms, library {tl:.4f} ms (torch.matmul bf16), "
                  f"bound {b * 1e3:.2f} us ({by}), {b / t:.1%} of the "
                  f"bound, {t / tl:.3f}x torch.matmul's time")
            if (m, k, n) == (4, 3072, 8192):
                row = dict(m=m, k=k, n=n, ms=t, plain_ms=tp, library_ms=tl,
                           bound_ms=b, bound_by=by)
    row["max_abs_err"] = worst
    row["checked_kn"], row["checked_m"] = GEMM_KN, list(SMALL_M)
    return row


def phase_engine_baselines(torch, np, timer) -> dict:
    """The paper's baselines served on full-width phi3-mini,
    BASELINE_LAYERS of its 32 layers, phase 4's requests and weights:
    per_group (COAT: each site's
    activation quantized per 128 along K against its calibrated group
    scales, the GEMM group_gemm, row 6) and per_tensor (TE: one
    calibrated scale, pt_matmul, no kernel of its own), weights
    pre-quantized per layer against their own amax.  Gates: every
    request finishes with finite logits; per decode step, per_group
    launches group_gemm at each of the 7 · layers + 1 quantized sites
    and decode_attn_paged once a layer, per_tensor only the latter; in
    all, group_gemm = sites · (decode steps + prefill chunks + the
    calibration forward).  Then each recipe's steps on the card
    against the CPU (within 2e-2 * max|logit|): on the smoke model, and
    at full width, 2 layers, with the CPU's calibrated activation
    scales; and row 6 at the serving shapes.  Returns group_gemm's serving entry
    and its launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.formats import PER_GROUP_CONFIG, PER_TENSOR_CONFIG
    from repro_torch.kernels import group_gemm

    cfg = get_config(ARCH).replace(n_layers=BASELINE_LAYERS)
    sites = 7 * cfg.n_layers + 1            # q k v o up gate down, head
    counters = _serving_counters() + [group_gemm.counter]
    zero = {c.name: 0 for c in counters}
    launches = 0
    for mode, qcfg in (("per_group", PER_GROUP_CONFIG),
                       ("per_tensor", PER_TENSOR_CONFIG)):
        for c in counters:
            c.reset()
        log = []
        per_step = {**zero, "decode_attn_paged": cfg.n_layers}
        if mode == "per_group":
            per_step["group_gemm"] = sites
        reqs, build_s, run_s, st = _serve_once(
            torch, np, seed=0, step_log=(counters, log),
            layers=BASELINE_LAYERS, over=dict(quant=qcfg))
        total = {c.name: c.count for c in counters}
        label = f"serve {mode}"
        _serve_line(label, reqs, run_s, st)
        print(f"{label}: build (weights, prequant, calibration) "
              f"{build_s:.2f} s, launches {json.dumps(total)}")
        _check_steps(label, log, per_step)
        want = (sites * (st["decode_steps"] + st["chunk_prefill_steps"] + 1)
                if mode == "per_group" else 0)
        if total["group_gemm"] != want:
            raise AssertionError(f"{label}: {total['group_gemm']} group_gemm "
                                 f"launches, expected {want}")
        launches += total["group_gemm"]
    # on the card against the CPU: the smoke model as
    # phase_small_reference checks it, and full width at 2 layers with
    # the CPU's calibrated scales (the card's own norm and RoPE
    # arithmetic move a few per_group group scales by up to ~1.6%, and
    # every fp8 rounding of those groups with them: tools/card_vs_cpu.py)
    small = get_config(ARCH, smoke=True)
    wide = cfg.replace(n_layers=BASELINE_CHECK_LAYERS)
    for mode, qcfg in (("per_group", PER_GROUP_CONFIG),
                       ("per_tensor", PER_TENSOR_CONFIG)):
        _small_steps(torch, np, small.replace(quant=qcfg),
                     f"smoke {ARCH} {mode}")
        _small_steps(torch, np, wide.replace(quant=qcfg),
                     f"{ARCH} {mode} ({BASELINE_CHECK_LAYERS} layers, the "
                     "CPU's activation scales)", cpu_scales=True)
    return {"serving": _group_gemm_serving(torch, timer),
            "launches": launches}


def phase_engine_moe(torch, np) -> dict:
    """phi3.5-moe-42b-a6.6b at full width (d 4096, 16 experts top-2, d_ff
    6400, GQA kv 8), 4 of its 32 layers (the engine builds from the
    seeded f32 tree, 41.6 GiB at the peak with 4 layers; all 32 would
    be ~84 GB even in bf16), on weights from a seed,
    serves phase 4's kind of 8 requests on floating pages.  Every
    decode step runs each layer's masked dense combine (3 expert GEMMs
    for each of the 16 experts, mx_gemm's M <= 32 tile, each against
    its expert's scales), the layer's 4 attention GEMMs and paged
    decode attention, and the head; the calibration runs fused_quant_
    gemm (global_amax, mx_quant, the tile) per (layer, expert) site.
    A second run from the same seed, identity rows, and speculative
    verify (k 4, an oracle draft of the plain streams) give the same
    streams."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_SERVE_LAYERS)
    print(f"engine {MOE_ARCH}: full width (d {cfg.d_model}, {cfg.n_heads} "
          f"heads, {cfg.n_kv} kv heads, {cfg.n_experts} experts top-"
          f"{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), depth cut "
          f"from 32 to {MOE_SERVE_LAYERS} layers")
    counters = _serving_counters()
    for c in counters:
        c.reset()
    log = []
    kw = dict(seed=0, arch=MOE_ARCH, layers=MOE_SERVE_LAYERS)
    reqs, build_s, run_s, st = _serve_once(torch, np, step_log=(counters,
                                                                  log), **kw)
    launches = {c.name: c.count for c in counters}
    _serve_line(f"engine {MOE_ARCH} ({MOE_SERVE_LAYERS} layers, build "
                f"{build_s:.2f} s)", reqs, run_s, st)
    print(f"launches on the MoE serving path: {json.dumps(launches)}")
    for name in ("mx_gemm", "fused_quant_gemm", "global_amax", "mx_quant",
                 "decode_attn_paged"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "MoE serving path")
    # calibration: one fused call per quantized site of every layer and
    # expert (q k v o, 3 per expert) and the head
    sites = MOE_SERVE_LAYERS * (4 + 3 * cfg.n_experts) + 1
    for name in ("fused_quant_gemm", "mx_quant", "global_amax"):
        if launches[name] != sites:
            raise AssertionError(f"MoE: {launches[name]} {name} launches, "
                                 f"{sites} calibration sites")
    zero = {c.name: 0 for c in counters}
    _check_steps("MoE decode", log, {**zero, "mx_gemm": sites,
                                      "decode_attn_paged": MOE_SERVE_LAYERS})
    plain = [list(r.out) for r in reqs]
    again, *_ = _serve_once(torch, np, **kw)
    if [list(r.out) for r in again] != plain:
        raise AssertionError("MoE: two runs from the same seed differ")
    print("MoE second run from the same seed: identical streams")
    ident, _, run_i, st_i = _with_env(
        "REPRO_PAGED_PLACEMENT", "identity",
        lambda: _serve_once(torch, np, float_pages=False, **kw))
    if [list(r.out) for r in ident] != plain:
        raise AssertionError("MoE: identity rows' streams differ from the "
                             "floating pages'")
    _serve_line("MoE identity rows (streams equal the floating pages')",
                ident, run_i, st_i)
    for c in counters:
        c.reset()
    spec, _, run_s, st = _serve_once(
        torch, np, spec_decode=True, spec_k=SPEC_K,
        draft=Oracle(dict(enumerate(plain))), **kw)
    n_verify = {c.name: c.count for c in counters}[
        "decode_attn_paged_verify"]
    if [list(r.out) for r in spec] != plain:
        raise AssertionError("MoE spec: streams differ from the plain run's")
    if st["spec_verify_steps"] <= 0 or n_verify <= 0:
        raise AssertionError("MoE spec: no verify step")
    _spec_line("MoE oracle draft (streams equal the plain run's)", spec,
               run_s, st, {"decode_attn_paged_verify": n_verify})
    return launches


def _mla_decode_launches(cfg) -> dict:
    """mx_gemm's launches in one decode step of deepseek, counted from
    the code: per layer the delayed sites wq, w_dkv and w_kr, the FFN's
    (dense0's, or the shared experts') 3 and each routed expert's 3 on
    the dense combine, and wo's fused call (just in time: one
    global_amax, one mx_quant and the M <= 32 tile); the head.  MLA's
    w_uk and w_uv are absorbed einsums in decode, not GEMMs."""
    moe_layers = cfg.n_layers - cfg.first_dense
    sites = (cfg.first_dense * (3 + 3)
             + moe_layers * (3 + 3 + 3 * cfg.n_experts) + 1)
    return {"mx_gemm": sites + cfg.n_layers,
            "fused_quant_gemm": cfg.n_layers, "mx_quant": cfg.n_layers,
            "global_amax": cfg.n_layers}


def phase_engine_mla(torch, np) -> dict:
    """deepseek-v2-lite-16b at full width (d 2048, 16 heads, MLA with a
    512-wide latent cache, 64 experts top-6 and 2 shared, a leading
    dense layer of 10,944), 4 of its 27 layers (dense0 + 3 MoE), on
    weights from a seed, serves phase 4's kind of 8 requests through
    the default Engine: identity rows and the whole-prompt prefill, as
    the reference serves MLA's latent cache, with pre-quantized weights
    (the absorbed decode on their bf16 copies) and delayed activation
    scales.  Every decode step launches, as counted from the code, the
    M <= 32 tile at every delayed site (64 experts x 3 in each MoE
    layer) and one just-in-time fused call for each layer's wo; no
    decode attention kernel runs (the absorbed einsums attend).  A
    second run from the same seed gives the same streams.  Returns the
    launches of the serving kernels on this path."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_SERVE_LAYERS)
    print(f"engine {MLA_ARCH}: full width (d {cfg.d_model}, {cfg.n_heads} "
          f"heads, kv_lora {cfg.kv_lora}, q_nope {cfg.q_nope}, q_rope "
          f"{cfg.q_rope}, {cfg.n_experts} experts top-{cfg.top_k} + "
          f"{cfg.n_shared} shared, d_ff {cfg.d_ff}, dense_ff "
          f"{cfg.dense_ff}, vocab {cfg.vocab}), depth cut from 27 to "
          f"{MLA_SERVE_LAYERS} layers ({cfg.first_dense} dense)")
    counters = _serving_counters()
    for c in counters:
        c.reset()
    log = []
    kw = dict(seed=0, arch=MLA_ARCH, layers=MLA_SERVE_LAYERS,
              float_pages=False, chunked=False)
    reqs, build_s, run_s, st = _serve_once(torch, np, step_log=(counters,
                                                                  log), **kw)
    launches = {c.name: c.count for c in counters}
    _serve_line(f"engine {MLA_ARCH} ({MLA_SERVE_LAYERS} layers, build "
                f"{build_s:.2f} s, {st['prefill_calls']} whole-prompt "
                f"prefills of {1e3 * st['mean_prefill_s']:.1f} ms mean)",
                reqs, run_s, st)
    print(f"launches on the MLA serving path: {json.dumps(launches)}")
    for name in ("mx_gemm", "mx_gemm_tiled", "fused_quant_gemm",
                 "global_amax", "mx_quant"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "MLA serving path")
    attn = {n: v for n, v in launches.items() if n.startswith("decode_attn")}
    if any(attn.values()):
        raise AssertionError(f"MLA: decode attention launched: {attn}")
    zero = {c.name: 0 for c in counters}
    _check_steps("MLA decode", log, {**zero, **_mla_decode_launches(cfg)})
    plain = [list(r.out) for r in reqs]
    again, *_ = _serve_once(torch, np, **kw)
    if [list(r.out) for r in again] != plain:
        raise AssertionError("MLA: two runs from the same seed differ")
    print("MLA second run from the same seed: identical streams")
    return launches


def phase_mla_train(torch, np) -> tuple[dict, dict]:
    """deepseek-v2-lite-16b at full width, 3 of its 27 layers (dense0 + 2
    MoE: 1.67 B parameters, whose f32 weights, gradients and moments
    are ~27 GB), batch 2 x 4096 (8192 tokens: the routed experts take
    the grouped kernels): moe_gmm and moe_dw_gemm checked on the first
    batch's routing at E 64 (phase_moe_kernels), then 3 moss and 3 bf16
    steps from the same weights on the same batches: finite, the loss
    falling in both, each moss step launching its kernels as counted
    from the code, none in bf16.  Returns the MoE kernels' checks and
    the launches of the moss run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import (group_gemm, moe_gmm, mx_bwd, mx_fused,
                                     mx_gemm, mx_quant)
    from repro_torch.launch.train import quant_from_name
    from repro_torch.models.layers import init_tree
    from repro_torch.models.transformer import model_defs
    from repro_torch.train.steps import (TrainHParams, init_train_state,
                                         make_train_step)

    hp = TrainHParams(peak_lr=3e-4, warmup_steps=0, total_steps=3)
    cfg_of = lambda mode: get_config(MLA_ARCH).replace(
        n_layers=MLA_TRAIN_LAYERS, quant=quant_from_name(mode))
    base = cfg_of("moss")
    tokens = MLA_BATCH * MLA_SEQ
    print(f"train {MLA_ARCH}: full width (d {base.d_model}, {base.n_heads} "
          f"heads, MLA kv_lora {base.kv_lora}, {base.n_experts} experts "
          f"top-{base.top_k} + {base.n_shared} shared, d_ff {base.d_ff}, "
          f"dense_ff {base.dense_ff}, vocab {base.vocab}, remat "
          f"{base.remat}), depth cut from 27 to {MLA_TRAIN_LAYERS} layers, "
          f"batch {MLA_BATCH} x {MLA_SEQ}")
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=MLA_SEQ,
                                  global_batch=MLA_BATCH, seed=0))
    batches = [data.batch_for_step(i) for i in range(3)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    init = init_tree(model_defs(base), gen, "cuda")
    print(f"train {MLA_ARCH}: "
          f"{sum(int(w.numel()) for w in tree_leaves(init)) / 1e9:.3f}B "
          "parameters")
    t0 = time.monotonic()
    timer = Timer(torch)
    res = phase_moe_kernels(torch, timer, base, init, batches[0]["tokens"])
    del timer
    print(f"MLA moe kernel checks: {time.monotonic() - t0:.1f} s")
    counters = [moe_gmm.counter, moe_gmm.counter_dw, mx_fused.counter,
                mx_fused.counter_tiled, mx_bwd.counter, mx_bwd.counter_requant,
                group_gemm.counter, mx_quant.counter, mx_quant.counter_amax,
                mx_gemm.counter, mx_gemm.counter_tiled]
    losses, launches = {}, {}
    for mode in ("moss", "bf16"):
        cfg = cfg_of(mode)
        state = init_train_state(cfg, hp, params=init, device="cuda")
        step = make_train_step(cfg, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        losses[mode] = []
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            state, met = step(state, batch)
            loss, aux = float(met["loss"]), float(met["aux"])
            gnorm = float(met["grad_norm"])
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            losses[mode].append(loss)
            print(f"train mla {mode} step {i}: loss {loss:.5f} aux "
                  f"{aux:.5f} grad_norm {gnorm:.4f} step {dt * 1e3:.1f} ms "
                  f"= {tokens / dt:.0f} tok/s")
            if not all(np.isfinite(v) for v in (loss, aux, gnorm)):
                raise AssertionError(f"train mla {mode} step {i}: "
                                     "non-finite")
        launches[mode] = {c.name: c.count for c in counters}
        print(f"train mla {mode}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {json.dumps(launches[mode])}")
        if not losses[mode][-1] < losses[mode][0]:
            raise AssertionError(f"train mla {mode}: the loss did not fall "
                                 f"({losses[mode]})")
        del state, step
        torch.cuda.empty_cache()
    # per moss step, from the code: the linear sites (each layer's MLA
    # wq, w_dkv, w_kr, w_uk, w_uv and wo, dense0's FFN or a MoE layer's
    # shared FFN: 9 a layer, and the head) take the fused tile in the
    # forward, the layers' again in the remat recompute, and dx and dW
    # at every site; each MoE layer's up, gate and down take moe_gmm in
    # the forward, the recompute and dx, and moe_dw_gemm for dW.  Each
    # fused call launches global_amax, mx_quant and the wgmma tile, each
    # moe_gmm call global_amax and mx_quant, each dW call one dw_requant
    moe_layers = MLA_TRAIN_LAYERS - base.first_dense
    sites = 9 * MLA_TRAIN_LAYERS + 1
    fused = 2 * sites + 9 * MLA_TRAIN_LAYERS
    gmm = 9 * moe_layers
    none = {c.name: 0 for c in counters}
    want = {"moss": {**none, "moe_gmm": 3 * gmm,
                     "moe_dw_gemm": 3 * 3 * moe_layers,
                     "fused_quant_gemm_tiled": 3 * fused,
                     "mx_quant": 3 * (fused + gmm),
                     "global_amax": 3 * (fused + gmm),
                     "mx_gemm_tiled": 3 * fused, "mx_dw_gemm": 3 * sites,
                     "dw_requant": 3 * (sites + 3 * moe_layers)},
            "bf16": none}
    for mode, got in launches.items():
        if got != want[mode]:
            raise AssertionError(f"mla {mode} launches {got}, expected "
                                 f"{want[mode]}")
    for i, (a, b) in enumerate(zip(losses["moss"], losses["bf16"])):
        print(f"train mla step {i}: moss vs bf16 loss rel "
              f"{abs(a - b) / abs(b):.3g}")
    del init
    torch.cuda.empty_cache()
    return res, launches["moss"]


def _build(torch, cfg, params, dev):
    """``params`` on ``dev`` built as the engine builds them
    (``prepare_weights``, ``calibrate_serving``: the switches in the
    environment apply): (weights, weight scales, activation scales)."""
    from repro_torch.serving.engine import (calibrate_serving,
                                            prepare_weights, to_device)

    with torch.inference_mode():
        qw, sc = prepare_weights(cfg, to_device(params, dev))
        return qw, sc, calibrate_serving(cfg, qw, sc)


def _moved(act, dev):
    """Calibrated activation scales moved to ``dev`` unchanged."""
    return {k: a._replace(s=a.s.to(dev),
                          sub=None if a.sub is None else a.sub.to(dev))
            for k, a in act.items()}


def _steps(torch, np, cfg, dev, built, prompt, feed_from=None):
    """One chunked-prefill step of ``prompt`` (13 tokens, pages 2 0 3 1
    of a 4-page pool) and three decode steps on ``dev`` with ``built``;
    each step fed its own greedy token, or ``feed_from``'s.  Returns
    each step's live logits on the host."""
    from repro_torch.models.transformer import init_paged_pools
    from repro_torch.train.steps import make_decode_step

    qw, sc, act = built
    step = make_decode_step(cfg, scales=sc, act_scales=act)
    pools = init_paged_pools(cfg, 64, 4, 16, dev)
    bt = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=dev)
    feed = np.zeros((1, 16), np.int32)
    feed[0, :len(prompt)] = prompt
    depth, logs = 0, []
    for i in range(4):
        idx = torch.tensor([depth], dtype=torch.int32, device=dev)
        pools = {n: c._replace(idx=idx, block_table=bt)
                 for n, c in pools.items()}
        logits, pools = step(qw, pools, torch.from_numpy(feed).to(dev))
        n_live = len(prompt) if i == 0 else 1
        logs.append(logits[0, :n_live].float().cpu().numpy())
        depth += n_live
        src = logs if feed_from is None else feed_from
        feed = np.array([[int(src[i][-1].argmax())]], np.int32)
    return logs


def _card_and_cpu(torch, np, cfg):
    """``cfg``'s weights from seed 0 built on the CPU and on the card,
    and the CPU's steps: (params, prompt, CPU build, CPU logits)."""
    from repro_torch.launch.serve import random_params

    params = random_params(cfg, 0, "cpu")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, 13)
    cpu = _build(torch, cfg, params, "cpu")
    return params, prompt, cpu, _steps(torch, np, cfg, "cpu", cpu, prompt)


def _small_steps(torch, np, cfg, label, cpu_scales=False):
    """``cfg`` on the card against the CPU (plain versions), built as
    the engine builds it, both devices fed the CPU's greedy tokens: one
    chunked-prefill step and three decode steps; logits within 2e-2 *
    max|logit| (f32 sums in another order, then bf16 roundings).  With
    ``cpu_scales`` the card serves with the CPU's calibrated activation
    scales, so that a calibration moved by the card's own norm and RoPE
    arithmetic does not move every fp8 rounding of a group."""
    params, prompt, cpu, logs = _card_and_cpu(torch, np, cfg)
    qw, sc, act = _build(torch, cfg, params, "cuda")
    if cpu_scales:
        act = _moved(cpu[2], "cuda")
    card = _steps(torch, np, cfg, "cuda", (qw, sc, act), prompt,
                  feed_from=logs)
    _close_logits(np, f"{label} step", logs, card)


def _close_logits(np, label, cpu: list, card: list):
    if len(cpu) != len(card):
        raise AssertionError(f"{label}: {len(card)} steps on the card, "
                             f"{len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(cpu, card)):
        tol = 2e-2 * float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        if not (np.isfinite(b).all() and err <= tol):
            raise AssertionError(f"{label} {i}: card vs CPU logits "
                                 f"{err} > {tol}")
        print(f"{label} {i}: card vs CPU max |d logit| {err:.3g} "
              f"(limit {tol:.3g})")


def _recorded_step(torch, fn, record: list):
    """Run ``fn()`` with every quantized linear, norm and MLA einsum of
    the port's models recording (kind, input, output) on the host into
    ``record``, in call order; the functions are restored after."""
    from repro_torch.core import linear
    from repro_torch.models import layers, mla, moe

    patched = []

    def wrap(mod, name, arg):
        f = getattr(mod, name)

        def g(*a, **k):
            out = f(*a, **k)
            record.append((name, a[arg].detach().float().cpu(),
                           out.detach().float().cpu()))
            return out
        setattr(mod, name, g)
        patched.append((mod, name, f))

    for mod in (linear, layers, mla, moe):
        wrap(mod, "qlinear", 0)
    for mod in (layers, mla):
        wrap(mod, "rmsnorm", 0)
    wrap(mla, "einsum", 1)
    try:
        return fn()
    finally:
        for mod, name, f in patched:
            setattr(mod, name, f)


def _norm_parted(torch, cfg, built, caches, toks, label):
    """Why a decode step's logits part the card from the CPU: the step
    runs on both devices from the CPU's weights, scales, caches and
    tokens, every quantized linear, norm and MLA einsum recorded.  The
    first call whose output differs must be a norm whose input is equal
    on both devices and whose output is at most one bf16 rounding away
    (2 ** -7 of its largest value): the card's own norm arithmetic, an
    f32 sum in another order (ROADMAP queue 3); every earlier call
    equal bit for bit.  Anything else raises."""
    from repro_torch.serving.engine import to_device
    from repro_torch.train.steps import make_decode_step

    qw, sc, act = built
    recs = {}
    for dev in ("cpu", "cuda"):
        recs[dev] = []
        step = make_decode_step(cfg, scales=to_device(sc, dev),
                                act_scales=_moved(act, dev))
        c = {n: v._replace(**{f: getattr(v, f).to(dev) for f in v._fields})
             for n, v in caches.items()}
        _recorded_step(torch, lambda: step(to_device(qw, dev), c,
                                           toks.to(dev)), recs[dev])
    for i, ((kind, xa, ya), (_, xb, yb)) in enumerate(zip(recs["cpu"],
                                                          recs["cuda"])):
        if torch.equal(ya, yb):
            continue
        d = float((ya - yb).abs().max())
        big = float(ya.abs().max())
        line = (f"{label}: first parting call {i} of {len(recs['cpu'])} "
                f"({kind}), input equal {torch.equal(xa, xb)}, "
                f"{int((ya != yb).sum())} of {ya.numel()} outputs apart, "
                f"max |d| {d:.3g} of {big:.3g}")
        print(line)
        if not (kind == "rmsnorm" and torch.equal(xa, xb)
                and d <= 2.0 ** -7 * big):
            raise AssertionError(line)
        return
    raise AssertionError(f"{label}: no recorded call parts the devices")


def _small_moe_engine(torch, np, arch: str = MOE_ARCH,
                      norm_flips: bool = False):
    """A MoE model's smoke config (phi3.5-moe's, or deepseek's on the
    whole-prompt path over its latent cache) served by the paged engine
    on the CPU and on the card from the same weights: 5 requests of 5-31
    prompt tokens, 8 new tokens each, a pinned chunk budget (latency
    targets no run can miss, so both devices take the same steps); equal
    streams, and each decode step's logits within 2e-2 * max|logit|.
    With ``norm_flips`` a step past that limit is traced site by site
    instead (``_norm_parted``: on an H100, deepseek's smoke logits moved
    3.6e-2 of max|logit| at one step from 2 of 256 outputs of one norm
    one bf16 rounding apart; PERF.md)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine, Request, SLOTargets

    cfg = get_config(arch, smoke=True)
    params = random_params(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 16, 23, 9, 31)]
    streams, logs, inputs = {}, {}, []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, num_slots=3, max_len=48, chunk_tokens=16,
                     slo=SLOTargets(ttft_s=1e9, tpot_s=1e9), device=dev)
        step, logs[dev] = eng.decode, []
        if dev == "cpu":
            built = (eng.params, eng.scales, eng.act_scales)

        def logged(p, caches, toks, step=step, out=logs[dev], dev=dev):
            if dev == "cpu" and norm_flips:
                inputs.append(({n: c._replace(**{
                    f: getattr(c, f).clone() for f in c._fields})
                    for n, c in caches.items()}, toks.clone()))
            logits, caches = step(p, caches, toks)
            out.append(logits.float().cpu().numpy())
            return logits, caches

        eng.decode = logged
        reqs = [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        eng.run(reqs, log=None)
        streams[dev] = [list(r.out) for r in reqs]
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"smoke {arch} engine: card streams "
                             f"{streams['cuda']} != CPU {streams['cpu']}")
    print(f"smoke {arch} engine: card streams equal the CPU's "
          f"({len(logs['cpu'])} steps)")
    if not norm_flips:
        _close_logits(np, f"smoke {arch} engine step", logs["cpu"],
                      logs["cuda"])
        return
    for i, (a, b) in enumerate(zip(logs["cpu"], logs["cuda"])):
        tol = 2e-2 * float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        print(f"smoke {arch} engine step {i}: card vs CPU max |d logit| "
              f"{err:.3g} (limit {tol:.3g})")
        if not np.isfinite(b).all():
            raise AssertionError(f"smoke {arch} engine step {i}: non-finite")
        if err > tol:
            _norm_parted(torch, cfg, built, *inputs[i],
                         f"smoke {arch} engine step {i}")


def phase_small_reference(torch, np):
    """The port on the card against the port on the CPU (plain
    versions) on smoke-size models: phi3-mini's serving steps (as built
    by default, under REPRO_SERVE_PREQUANT=0 and under
    REPRO_SERVE_DELAYED_ACT=0), phi3.5-moe's serving steps and its
    engine's streams, deepseek's engine streams (MLA's absorbed decode
    on the latent cache), and h2o's ring."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(ARCH, smoke=True)
    _small_steps(torch, np, cfg, f"smoke {ARCH}")
    for name in ("REPRO_SERVE_PREQUANT", "REPRO_SERVE_DELAYED_ACT"):
        _with_env(name, "0", lambda: _small_steps(
            torch, np, cfg, f"{ARCH} {name}=0"))
    _small_steps(torch, np, get_config(MOE_ARCH, smoke=True),
                 f"smoke {MOE_ARCH}")
    _small_moe_engine(torch, np)
    _small_moe_engine(torch, np, MLA_ARCH, norm_flips=True)
    # h2o-danube-3-4b at window 16: the prefill of 21 tokens keeps the
    # last 16 on its ring, then four ring decode steps
    _small_prefill_decode(torch, np, get_config(RING_ARCH, smoke=True)
                          .replace(window=16), "smoke ring step", 21)


def _small_prefill_decode(torch, np, cfg, label, prompt_len, max_len=48):
    """``cfg`` on the card against the CPU from the same seeded weights,
    each built as the engine builds it, fed the CPU's tokens: the
    whole-prompt prefill of ``prompt_len`` tokens into contiguous caches
    of ``max_len`` and four decode steps; logits within 2e-2 *
    max|logit|."""
    from repro_torch.core.actscale import calibrate_act_scales
    from repro_torch.launch.serve import random_params
    from repro_torch.serving.engine import prepare_weights, to_device
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    params = random_params(cfg, 0, "cpu")
    prompt = np.random.default_rng(6).integers(0, cfg.vocab,
                                               (1, prompt_len))
    outs = {}
    for dev in ("cpu", "cuda"):
        with torch.inference_mode():
            qw, sc = prepare_weights(cfg, to_device(params, dev))
            act = calibrate_act_scales(cfg, qw, sc)
        pre = make_prefill_step(cfg, max_len, scales=sc, act_scales=act)
        dec = make_decode_step(cfg, scales=sc, act_scales=act)
        logits, caches = pre(qw, torch.from_numpy(prompt).to(dev))
        logs = [logits[0].float().cpu().numpy()]
        for i in range(4):
            src = logs if dev == "cpu" else outs["cpu"]
            feed = torch.tensor([[int(src[i][-1].argmax())]],
                                dtype=torch.int32, device=dev)
            logits, caches = dec(qw, caches, feed)
            logs.append(logits[0].float().cpu().numpy())
        outs[dev] = logs
    _close_logits(np, label, outs["cpu"], outs["cuda"])


def phase_small_families(torch, np):
    """The six families' smoke models on the card against the CPU:
    stablelm's and minitron's serving steps on pages (``_small_steps``),
    recurrentgemma's prefill and decode steps on contiguous caches (its
    RG-LRU states and a 64-slot local-attention ring; the prompt of 70
    tokens wraps it), rwkv6's (its WKV state and shift states; a prompt
    of 37 tokens: two chunks of 16 and a padded third; ddlerp_w1's N 40
    and decay_w1's N 16 at rows 1 and 2), musicgen's and
    phi-3-vision's (token prompts through the embedding table, as their
    Server serves them; musicgen's sinusoidal positions); logits within
    2e-2 * max|logit|."""
    from repro_torch.configs.registry import get_config

    for arch in (STABLELM, MINITRON):
        _small_steps(torch, np, get_config(arch, smoke=True),
                     f"smoke {arch} step")
    _small_prefill_decode(torch, np, get_config(GEMMA, smoke=True),
                          f"smoke {GEMMA} step", 70, max_len=96)
    for arch in (RWKV, MUSICGEN, PHI3V):
        _small_prefill_decode(torch, np, get_config(arch, smoke=True),
                              f"smoke {arch} step", 37)


def _train_cfg(get_config, quant_from_name, mode, smoke, interval=500):
    qcfg = quant_from_name(mode, interval)
    cfg = get_config(TRAIN_ARCH, smoke=smoke).replace(quant=qcfg)
    return cfg if smoke else cfg.replace(n_layers=TRAIN_LAYERS)


TRAIN_MODES = ("moss", "bf16", "per_group", "per_tensor")


def _dense_launches(counters, layers: int,
                    layer_sites: int | None = None) -> dict:
    """The training kernels' launches in 3 steps of a model of ``layers``
    layers with ``layer_sites`` linear sites in them (7 a layer of a
    gated FFN by default), per recipe.  Per step: the forward at every
    linear site (the layers' and the head), the remat recompute of the
    layers' sites, dx and dW at every site; each fused_quant_gemm call
    (M > 32) launches global_amax, mx_quant and the wgmma tile, each
    mx_dw_gemm call the dw_requant pass and the tile (counted on
    mx_dw_gemm, not mx_gemm_tiled)."""
    if layer_sites is None:
        layer_sites = 7 * layers
    sites = layer_sites + 1
    fused = 3 * (2 * sites + layer_sites)
    none = {c.name: 0 for c in counters}
    return {
        "moss": {**none, "fused_quant_gemm_tiled": fused, "mx_quant": fused,
                 "global_amax": fused, "mx_gemm_tiled": fused,
                 "mx_dw_gemm": 3 * sites, "dw_requant": 3 * sites},
        "bf16": none,
        "per_group": {**none, "group_gemm": 3 * (3 * sites + layer_sites)},
        "per_tensor": none,                # pt_matmul: no kernel of its own
    }


def _train_modes(torch, np, arch, cfg_of, modes, m: int, label: str,
                 layer_sites: int | None = None, full_layers: int = 32):
    """3 steps of batch 1 x ``m`` in each recipe of ``modes`` from the
    same weights on the same batches (``cfg_of(mode)`` the config, cut
    from ``full_layers``); launches gated by ``_dense_launches`` (with
    ``layer_sites``), every quantized recipe's losses within 1e-2 of
    bf16's.  Returns the launches by recipe, with each recipe's step
    ms, tok/s and peak GiB under "timing"."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import (group_gemm, mx_bwd, mx_fused, mx_gemm,
                                     mx_quant)
    from repro_torch.train.steps import (TrainHParams, init_train_state,
                                         make_train_step)

    hp = TrainHParams(peak_lr=3e-4, warmup_steps=0, total_steps=3)
    base = cfg_of(modes[0])
    print(f"train {arch}: full width (d {base.d_model}, {base.n_heads} "
          f"heads, Dh {base.head_dim}, d_ff {base.d_ff}, vocab {base.vocab}, "
          f"{base.norm}, remat {base.remat}), depth cut from {full_layers} "
          f"to {base.n_layers} layers, batch 1 x {m}")
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=m,
                                  global_batch=1, seed=0))
    batches = [data.batch_for_step(i) for i in range(3)]
    if base.input_mode == "embeddings":
        # the training CLI's frontend stub
        from repro_torch.launch.train import stub_embeds

        for b in batches:
            b["embeds"] = stub_embeds(base, b["tokens"].cuda())
    # the initial weights wait on the host between recipes: on the card
    # they would stay beside each run's updated copy (minitron's f32
    # embedding and head alone are 8.4 GB)
    init = tree_map(lambda t: t.cpu(), init_train_state(
        base, hp, seed=0, device="cuda").params)
    torch.cuda.empty_cache()
    n_params = sum(int(w.numel()) for w in tree_leaves(init))
    print(f"train {arch}: {n_params / 1e9:.3f}B parameters")
    counters = [mx_fused.counter, mx_fused.counter_tiled, mx_bwd.counter,
                mx_bwd.counter_requant, group_gemm.counter, mx_quant.counter,
                mx_quant.counter_amax, mx_gemm.counter, mx_gemm.counter_tiled]
    losses, launches, timing = {}, {}, {}
    for mode in modes:
        cfg = cfg_of(mode)
        state = init_train_state(
            cfg, hp, params=tree_map(lambda t: t.to("cuda"), init),
            device="cuda")
        step_ms = []
        step = make_train_step(cfg, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        losses[mode] = []
        for i, batch in enumerate(batches):
            t0 = time.monotonic()
            state, met = step(state, batch)
            loss = float(met["loss"])
            gnorm = float(met["grad_norm"])
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            losses[mode].append(loss)
            step_ms.append(dt * 1e3)
            print(f"{label} {mode} step {i}: loss {loss:.5f} grad_norm "
                  f"{gnorm:.4f} lr {float(met['lr']):.3e} step "
                  f"{dt * 1e3:.1f} ms = {m / dt:.0f} tok/s")
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{label} {mode} step {i}: non-finite")
        launches[mode] = {c.name: c.count for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timing[mode] = dict(step_ms=step_ms[-1], tok_s=m / step_ms[-1] * 1e3,
                            peak_gib=peak)
        print(f"{label} {mode}: peak memory {peak:.2f} GiB, "
              f"launches {json.dumps(launches[mode])}")
        del state, step
        torch.cuda.empty_cache()
    want = _dense_launches(counters, base.n_layers, layer_sites)
    for mode in modes:
        if launches[mode] != want[mode]:
            raise AssertionError(f"{label} {mode} launches {launches[mode]},"
                                 f" expected {want[mode]} (forward, remat "
                                 "recompute, dx, dW)")
    for mode in modes:
        if mode == "bf16":
            continue
        for i, (a, b) in enumerate(zip(losses[mode], losses["bf16"])):
            rel = abs(a - b) / abs(b)
            print(f"{label} step {i}: {mode} vs bf16 loss rel {rel:.3g} "
                  "(limit 1e-2)")
            if not rel <= 1e-2:
                raise AssertionError(f"{label} step {i}: {mode} {a} vs "
                                     f"bf16 {b}")
    del init
    torch.cuda.empty_cache()
    launches["timing"] = timing
    return launches


def phase_train(torch, np) -> dict:
    """olmo-7b at full width, 4 of its 32 layers (f32 master weights,
    gradients and AdamW moments of all 32 would need ~110 GB), batch
    1 x 2048: 3 steps in each recipe (moss, bf16, per_group,
    per_tensor) from the same weights on the same batches, the
    baselines with just-in-time weight scales as the training CLI sets
    them; then llama2-7b (RMSNorm) at full width, 4 of its 32 layers,
    batch 1 x 4096 (paper Table 8's sequence), in moss and bf16.
    Returns the launches of olmo's training kernels on their paths."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import quant_from_name

    launches = _train_modes(
        torch, np, TRAIN_ARCH,
        lambda mode: _train_cfg(get_config, quant_from_name, mode,
                                smoke=False), TRAIN_MODES, TRAIN_M, "train")
    _train_modes(
        torch, np, LLAMA_ARCH,
        lambda mode: get_config(LLAMA_ARCH).replace(
            n_layers=LLAMA_LAYERS, quant=quant_from_name(mode)),
        ("moss", "bf16"), LLAMA_M, "train llama2")
    return {name: launches["moss"][name] for name in
            ("fused_quant_gemm_tiled", "mx_quant", "global_amax",
             "mx_gemm_tiled", "mx_dw_gemm", "dw_requant")} | {
                 "group_gemm": launches["per_group"]["group_gemm"]}


def _moe_cfg(get_config, quant_from_name, mode, smoke, interval=500):
    cfg = get_config(MOE_ARCH, smoke=smoke).replace(
        quant=quant_from_name(mode, interval))
    if smoke:     # 128 tokens: the grouped route only without the dense rule
        return cfg.replace(moe_decode_dense=False)
    return cfg.replace(n_layers=MOE_LAYERS)


def _moe_routing(torch, cfg, params, tokens):
    """The first MoE layer's dispatch of ``tokens`` through the port's
    modules (after the leading dense layers, if any), with the weights
    at their step-0 scales: the sorted token buffer (E·C, d) bf16 that
    the up and gate GEMMs take, the sizes and C."""
    from repro_torch.models import moe
    from repro_torch.models.attention import attention
    from repro_torch.models.layers import (apply_norm, embed_tokens,
                                           quant_mask_tree, wrap_qt_nojit)
    from repro_torch.models.mla import mla_attention
    from repro_torch.models.transformer import (_layers, build_segments,
                                                model_defs)

    att = mla_attention if cfg.family == "mla_moe" else attention
    with torch.no_grad():
        qp = wrap_qt_nojit(params, quant_mask_tree(model_defs(cfg)))
        x = embed_tokens(cfg, qp["embed"], tokens.to("cuda"))
        pos = torch.arange(x.shape[1], dtype=torch.int32, device="cuda")
        segs = build_segments(cfg)
        for seg in segs[:-1]:
            for p_l in _layers(qp[seg.name], seg.n):
                x, _, _ = seg.apply(cfg, cfg.quant, p_l, x, pos, None,
                                    "train")
        p0 = _layers(qp["blocks"], segs[-1].n)[0]
        h, _ = att(cfg, p0["attn"], apply_norm(cfg, p0["ln1"], x), pos,
                   cfg.quant)
        hn = apply_norm(cfg, p0["ln2"], x + h).reshape(-1, cfg.d_model)
        _, _, ids = moe.route(cfg, p0["moe"], hn)
        cap = moe._capacity(cfg, hn.shape[0])
        order, dest, sizes = moe.dispatch_plan(ids, cfg.n_experts, cap)
        buf = torch.zeros((cfg.n_experts * cap + 1, cfg.d_model),
                          dtype=hn.dtype, device="cuda")
        buf = buf.index_put((dest,), hn[order // cfg.top_k])
    return buf[:-1], sizes, cap


def phase_moe_kernels(torch, timer, cfg, params, tokens) -> dict:
    """moe_gmm and moe_dw_gemm against their plain versions at a MoE
    model's shapes (phi3.5-moe: E 16, d 4096, d_ff 6400; deepseek: E 64,
    d 2048, d_ff 1408; C from the routing of the first batch) on the
    first MoE layer's real token buffer and weights: the up
    forward (e4m3, K 4096, N 6400) at the routed sizes and at sizes with
    expert 0 empty and expert 1 at full capacity, the down forward on
    silu(gate) * up (K 6400, N 4096), dx (an e5m2 gradient against the
    transposed up payloads, K 6400, N 4096) and dW on the up forward's
    residual (Cp = C rounded up to 32).  Payloads bitwise, accumulations
    within 1e-5 * max|plain|.  The up forward and dW are timed beside
    their plain versions and bf16 torch.bmm over the same slots."""
    import torch.nn.functional as F
    from repro_torch.core.quant import (mx_operand, pad_axis,
                                        prequant_weight, quant_per_tensor)
    from repro_torch.kernels import dispatch, moe_gmm, mx_bwd

    e, dff, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, sizes, c = _moe_routing(torch, cfg, params, tokens)
    cp = c + (-c) % 32
    print(f"moe routing of batch 0 (layer 0): C {c}, Cp {cp}, sizes "
          f"{sizes.tolist()}")
    wq = {n: prequant_weight(params["blocks"]["moe"][n][0], 1, "e4m3")
          for n in ("w_up", "w_gate", "w_down")}
    worst = 0.0

    def check(what, xin, qw, sz, fmt):
        nonlocal worst
        s = dispatch.global_scale(xin, fmt)
        acc, q, se = moe_gmm.moe_gmm(xin, s, qw, sz, c, fmt)
        acc_p, q_p, se_p = moe_gmm.moe_gmm_plain(xin, s, qw, c, fmt)
        q_mis = int((q.view(torch.uint8) != q_p.view(torch.uint8)).sum())
        e_mis = int((se != se_p).sum())
        err = float((acc - acc_p).abs().max())
        scale = float(acc_p.abs().max())
        dead = ~(torch.arange(c, device="cuda")[None, :]
                 < sz[:, None]).reshape(-1)
        dead_nz = int((acc[dead] != 0).sum())
        print(f"moe_gmm {what} {fmt} E={e} C={c} K={xin.shape[1]} "
              f"N={qw.shape[2]} ({int(sz.sum())} routed rows): max_err "
              f"{err:.3g} (max|ref| {scale:.3g}), payload mismatches q "
              f"{q_mis} / sexp {e_mis}, nonzero outputs past the sizes "
              f"{dead_nz}")
        if q_mis or e_mis or dead_nz or not (err <= 1e-5 * scale
                                             and torch.isfinite(acc).all()):
            raise AssertionError(f"moe_gmm {what}")
        worst = max(worst, err)
        return q, se

    xq_q, xq_e = check("up fwd", x, wq["w_up"][0], sizes, "e4m3")
    sz2 = sizes.clone()
    sz2[0], sz2[1] = 0, c
    x2 = x.clone()
    x2[:c] = 0
    x2[c:2 * c] = _activations(torch, gen, c, d)
    check("up fwd (expert 0 empty, expert 1 full)", x2, wq["w_up"][0], sz2,
          "e4m3")
    del x2
    up, gate = (dispatch.moe_grouped_matmul(
        x, sizes, *wq[n], capacity=c, out_dtype=torch.bfloat16)[0]
        for n in ("w_up", "w_gate"))
    h = F.silu(gate.to(torch.float32)).to(torch.bfloat16) * up
    del up, gate
    check("down fwd", h, wq["w_down"][0], sizes, "e4m3")
    del h
    live = (torch.arange(c, device="cuda")[None, :]
            < sizes[:, None]).reshape(-1, 1)
    g = torch.randn(e * c, dff, device="cuda", generator=gen) * 1e-3 * live
    qwt = wq["w_up"][0].transpose(1, 2).contiguous()
    check("dx", g, qwt, sizes, "e5m2")
    del qwt
    gq = quant_per_tensor(g, "e5m2").q
    del g
    res = {"moe_gmm": {"max_abs_err": worst}}

    def slots(a):             # each expert's rows padded to Cp
        return pad_axis(a.reshape(e, c, -1), 1, 32).reshape(e * cp, -1)

    qx, sx, qg = slots(xq_q), slots(xq_e), slots(gq)
    acc, qt, et = moe_gmm.moe_dw_gemm(qx, sx, qg, sizes, cp, "e4m3",
                                      payload=True)
    same = torch.equal(acc.view(torch.int32), moe_gmm.moe_dw_gemm(
        qx, sx, qg, sizes, cp, "e4m3").view(torch.int32))
    acc_p, qt_p, et_p = moe_gmm.moe_dw_gemm_plain(qx, sx, qg, cp, "e4m3",
                                                  payload=True)
    q_mis = int((qt.view(torch.uint8) != qt_p.view(torch.uint8)).sum())
    e_mis = int((et != et_p).sum())
    err = float((acc - acc_p).abs().max())
    scale = float(acc_p.abs().max())
    empty_nz = int((acc[sizes == 0] != 0).sum())
    print(f"moe_dw_gemm E={e} Cp={cp} K={d} N={dff}: max_err {err:.3g} "
          f"(max|ref| {scale:.3g}), requant payload mismatches q {q_mis} / "
          f"sexp {e_mis}, two calls bitwise {same}, nonzero dW of the "
          f"{int((sizes == 0).sum())} empty experts {empty_nz}")
    if q_mis or e_mis or empty_nz or not (same and err <= 1e-5 * scale
                                          and torch.isfinite(acc).all()):
        raise AssertionError("moe_dw_gemm")
    res["moe_dw_gemm"] = {"max_abs_err": err}
    dw_opnd = torch.stack([mx_operand(q_, e_) for q_, e_ in zip(qt_p, et_p)])
    del acc, qt, et, acc_p, qt_p, et_p
    torch.cuda.empty_cache()

    # times: the up forward and dW, their plain versions, bf16 torch.bmm
    n_live = int(sizes.sum())
    qw = wq["w_up"][0]
    s = dispatch.global_scale(x)
    xb, wb = x.reshape(e, c, d), qw.to(torch.bfloat16)
    t = timer.ms(lambda: moe_gmm.moe_gmm(x, s, qw, sizes, c))
    tp = timer.ms(lambda: moe_gmm.moe_gmm_plain(x, s, qw, c))
    tl = timer.ms(lambda: torch.bmm(xb, wb))
    # every row is read and quantized; the products are the routed rows'
    b, by = bound_ms(2 * e * c * d + 4 + e * d * dff + 4 * e
                     + 4 * e * c * dff + e * c * d + e * c * d // 32,
                     2.0 * n_live * d * dff)
    flops = 2.0 * n_live * d * dff
    print(f"moe_gmm up fwd: {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s of "
          f"routed work; one mx_quant and one grouped wgmma tile), plain "
          f"{tp:.4f} ms, library {tl:.4f} ms (torch.bmm bf16 over the E x C "
          f"slots, {2.0 * e * c * d * dff / tl / 1e9:.1f} TFLOP/s), bound "
          f"{b:.4f} ms ({by}, {n_live} routed rows)")
    res["moe_gmm"].update(ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
                          bound_by=by)
    del xb, wb
    gb = qg.to(torch.bfloat16).reshape(e, cp, dff)
    t = timer.ms(lambda: moe_gmm.moe_dw_gemm(qx, sx, qg, sizes, cp))
    tp = timer.ms(lambda: moe_gmm.moe_dw_gemm_plain(qx, sx, qg, cp))
    tl = timer.ms(lambda: torch.bmm(dw_opnd, gb))
    qt = torch.empty((e, d, cp), dtype=qx.dtype, device="cuda")
    et = torch.empty((e, d, cp // 32), dtype=torch.int8, device="cuda")
    tr = timer.ms(lambda: mx_bwd.launch_requant(qx, sx, qt, et, "e4m3",
                                                sizes), batched=True)
    del qt, et
    # the kernel reads each expert's rows up to its size rounded to 32
    rows = int(torch.clamp_max((sizes + 31) // 32 * 32, cp).sum())
    b, by = bound_ms(rows * (d + d // 32 + dff) + 4 * e + 4 * e * d * dff,
                     2.0 * n_live * d * dff)
    # the pass reads the live groups and writes every group of q', e'
    br, _ = bound_ms(rows * (d + d // 32) + e * cp * (d + d // 32), 0.0)
    print(f"moe_dw_gemm: {t:.4f} ms (the dw_requant pass {tr:.4f} ms, "
          f"bound {br:.4f} ms (bytes), and the grouped tile), plain "
          f"{tp:.4f} ms, library {tl:.4f} ms (torch.bmm bf16 over the E x "
          f"Cp slots), bound {b:.4f} ms ({by}, {n_live} routed rows)")
    res["moe_dw_gemm"].update(ms=t, plain_ms=tp, library_ms=tl, bound_ms=b,
                              bound_by=by)
    del dw_opnd, gb, qx, sx, qg, x, wq
    torch.cuda.empty_cache()
    return res


def phase_moe_train(torch, np) -> tuple[dict, dict]:
    """phi3.5-moe-42b-a6.6b at full width, 1 of its 32 layers (the f32
    weights, gradients and moments of one layer are 25 GB; two would
    not fit the card's 80 GB at the training step's peak), batch
    2 x 4096: the kernel checks on the first batch's routing, then 3
    moss and 3 bf16 steps from the same weights on the same batches.
    Returns the MoE kernels' rows and the launches of the moss run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import (group_gemm, moe_gmm, mx_bwd, mx_fused,
                                     mx_gemm, mx_quant)
    from repro_torch.launch.train import quant_from_name
    from repro_torch.models.layers import init_tree
    from repro_torch.models.transformer import model_defs
    from repro_torch.train.steps import (TrainHParams, init_train_state,
                                         make_train_step)

    hp = TrainHParams(peak_lr=3e-4, warmup_steps=0, total_steps=3)
    base = _moe_cfg(get_config, quant_from_name, "moss", smoke=False)
    tokens = MOE_BATCH * MOE_SEQ
    print(f"train {MOE_ARCH}: full width (d {base.d_model}, "
          f"{base.n_heads} heads, {base.n_kv} kv heads, Dh {base.head_dim}, "
          f"{base.n_experts} experts top-{base.top_k}, d_ff {base.d_ff}, "
          f"vocab {base.vocab}, {base.norm}, remat {base.remat}), depth cut "
          f"from 32 to {MOE_LAYERS} layer, batch {MOE_BATCH} x {MOE_SEQ}")
    data = SyntheticLM(DataConfig(vocab=base.vocab, seq_len=MOE_SEQ,
                                  global_batch=MOE_BATCH, seed=0))
    batches = [data.batch_for_step(i) for i in range(3)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    init = init_tree(model_defs(base), gen, "cuda")
    print(f"train: {sum(int(w.numel()) for w in tree_leaves(init)) / 1e9:.3f}"
          "B parameters")
    t0 = time.monotonic()
    timer = Timer(torch)
    res = phase_moe_kernels(torch, timer, base, init,
                            batches[0]["tokens"])
    del timer
    print(f"moe kernel checks: {time.monotonic() - t0:.1f} s")
    counters = [moe_gmm.counter, moe_gmm.counter_dw, mx_fused.counter,
                mx_fused.counter_tiled, mx_bwd.counter, mx_bwd.counter_requant,
                group_gemm.counter, mx_quant.counter, mx_quant.counter_amax,
                mx_gemm.counter, mx_gemm.counter_tiled]
    losses, launches, step_ms = {}, {}, {}
    # moss and bf16 on the grouped kernels, then moss under
    # REPRO_MOE_EXPERTS=vmapped (the reference's A/B path: each expert's
    # three GEMMs one by one through qlinear)
    for run in ("moss", "bf16", "moss-vmapped"):
        mode = run.split("-")[0]
        path = "vmapped" if run.endswith("vmapped") else "grouped"
        prev = os.environ.get("REPRO_MOE_EXPERTS")
        os.environ["REPRO_MOE_EXPERTS"] = path
        cfg = _moe_cfg(get_config, quant_from_name, mode, smoke=False)
        state = init_train_state(cfg, hp, params=init, device="cuda")
        step = make_train_step(cfg, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        losses[run], step_ms[run] = [], []
        try:
            for i, batch in enumerate(batches):
                t0 = time.monotonic()
                state, met = step(state, batch)
                loss, aux = float(met["loss"]), float(met["aux"])
                gnorm = float(met["grad_norm"])
                torch.cuda.synchronize()
                dt = time.monotonic() - t0
                losses[run].append(loss)
                step_ms[run].append(dt * 1e3)
                print(f"train moe {run} step {i}: loss {loss:.5f} aux "
                      f"{aux:.5f} grad_norm {gnorm:.4f} step "
                      f"{dt * 1e3:.1f} ms = {tokens / dt:.0f} tok/s")
                if not all(np.isfinite(v) for v in (loss, aux, gnorm)):
                    raise AssertionError(f"train moe {run} step {i}: "
                                         "non-finite")
        finally:
            if prev is None:
                os.environ.pop("REPRO_MOE_EXPERTS")
            else:
                os.environ["REPRO_MOE_EXPERTS"] = prev
        launches[run] = {c.name: c.count for c in counters}
        print(f"train moe {run}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {json.dumps(launches[run])}")
        del state, step
        torch.cuda.empty_cache()
    # per moss step, from the code: attention q, k, v, o and the head
    # (5 sites) take the fused tile in the forward, the layer's 4 again
    # in the remat recompute, and dx and dW at all 5; the experts' up,
    # gate and down take moe_gmm in the forward, the recompute and dx,
    # and moe_dw_gemm for dW; each fused call (M 8192) launches mx_quant
    # and the wgmma tile (14 a step), each moe_gmm call mx_quant and the
    # grouped tile (9 a step): 23 mx_quant a step, 69 in 3, each behind
    # one global_amax; each dW call
    # (5 mx_dw_gemm, 3 moe_dw_gemm) one dw_requant pass: 8 a step
    # Vmapped, the experts' 3 GEMMs each take the fused tile per expert
    # (C 1336 rows > 32) in the forward, the recompute and dx, and
    # mx_dw_gemm for dW: 5 + 48, 4 + 48 and 5 + 48 fused calls and 5 + 48
    # dW calls a step, no moe_gmm or moe_dw_gemm.
    none = {c.name: 0 for c in counters}
    e3 = 3 * base.n_experts
    fused_v = 5 + 4 + 5 + 3 * e3
    want = {"moss": {**none, "moe_gmm": 3 * 9, "moe_dw_gemm": 3 * 3,
                     "fused_quant_gemm_tiled": 3 * 14,
                     "mx_quant": 3 * (14 + 9), "global_amax": 3 * (14 + 9),
                     "mx_gemm_tiled": 3 * 14,
                     "mx_dw_gemm": 3 * 5, "dw_requant": 3 * (5 + 3)},
            "bf16": none,
            "moss-vmapped": {**none, "fused_quant_gemm_tiled": 3 * fused_v,
                             "mx_quant": 3 * fused_v,
                             "global_amax": 3 * fused_v,
                             "mx_gemm_tiled": 3 * fused_v,
                             "mx_dw_gemm": 3 * (5 + e3),
                             "dw_requant": 3 * (5 + e3)}}
    for mode, got in launches.items():
        if got != want[mode]:
            raise AssertionError(f"moe {mode} launches {got}, expected "
                                 f"{want[mode]}")
    for i, (a, b) in enumerate(zip(losses["moss"], losses["bf16"])):
        rel = abs(a - b) / abs(b)
        print(f"train moe step {i}: moss vs bf16 loss rel {rel:.3g} "
              "(limit 1e-2)")
        if not rel <= 1e-2:
            raise AssertionError(f"train moe step {i}: moss {a} vs bf16 {b}")
    for i, (a, b) in enumerate(zip(losses["moss-vmapped"],
                                   losses["moss"])):
        rel = abs(a - b) / abs(b)
        print(f"train moe step {i}: REPRO_MOE_EXPERTS vmapped loss {a:.6f} "
              f"{step_ms['moss-vmapped'][i]:.1f} ms, grouped {b:.6f} "
              f"{step_ms['moss'][i]:.1f} ms (loss rel {rel:.3g}, limit "
              "1e-2)")
        if not rel <= 1e-2:
            raise AssertionError(f"train moe step {i}: vmapped {a} vs "
                                 f"grouped {b}")
    del init
    torch.cuda.empty_cache()
    res["vmapped_ab"] = {run: dict(step_ms=step_ms[run][-1],
                                   loss=losses[run][-1],
                                   launches=launches[run])
                         for run in ("moss", "moss-vmapped")}
    return res, launches["moss"]


def _family_cfg(arch, layers):
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def _family_sites(cfg) -> tuple[int, int]:
    """(linear sites in the layers, attention layers) of a dense,
    hybrid, rwkv6 or embeddings-input model, counted from the code: an
    attention layer's q, k, v, o and its FFN's up, down and, when gated,
    gate; a recurrent layer's RG-LRU projections x, gate branch, a, i
    and out and its FFN's; an rwkv6 layer's time mix (ddlerp_w1, r, k,
    v, g, decay_w1, o) and channel mix (k, v, r)."""
    if cfg.family == "ssm":
        return 10 * cfg.n_layers, 0
    ffn = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.family == "hybrid":
        units, rem = divmod(cfg.n_layers, 3)
        rec, attn = 2 * units + rem, units
    else:
        rec, attn = 0, cfg.n_layers
    return attn * (4 + ffn) + rec * (5 + ffn), attn


def _family_decode_launches(cfg, paged: bool) -> dict:
    """One decode step's launches, counted from the code: the M <= 32 tile
    at every delayed site and the head (the tied ``head_t`` too), and one
    decode attention a layer with attention: on pages (``paged``) or on
    contiguous rows (identity rows, a ring, the legacy Server's cache)."""
    sites, attn = _family_sites(cfg)
    key = "decode_attn_paged" if paged else "decode_attn"
    return {"mx_gemm": sites + 1, key: attn}


def _gemma_requests(Request, np, cfg):
    """Phase 4's 8 requests and one of GEMMA_LONG_PROMPT prompt tokens,
    past the 2048-slot window: its prefill keeps the last 2048 positions
    on the ring and every decode step overwrites the oldest slot."""
    reqs = _requests(Request, np, cfg, 0)
    rng = np.random.default_rng(7)
    reqs.append(Request(rid=len(reqs), prompt=rng.integers(
        0, cfg.vocab, GEMMA_LONG_PROMPT, dtype=np.int32), max_new=16))
    return reqs


def _server_run(torch, np, cfg, params, reqs, max_len, step_log=None):
    """``reqs`` through the legacy Server (4 slots, ``max_len``) on
    ``params``, each decode step's logits checked finite (and its
    launches logged with ``step_log``).  Returns the Server, the build and
    serve seconds, the mean decode step's ms and the peak GiB."""
    from repro_torch.launch.serve import Server

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    srv = Server(cfg, params, batch_slots=4, max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    finite, step_s = [], []
    srv.decode = _checked(torch, srv.decode, finite)
    if step_log is not None:
        _step_deltas(srv, *step_log)
    step = srv.decode

    def timed(*a):
        t = time.perf_counter()
        out = step(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    srv.decode = timed
    t0 = time.monotonic()
    srv.run(reqs, log=None)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{cfg.name} Server: non-finite logits")
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError(f"{cfg.name} Server: a request did not finish")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return srv, build_s, run_s, 1e3 * statistics.mean(step_s), peak


def _serve_embeddings_family(torch, np, cfg, counters) -> tuple[dict, list]:
    """An embeddings-input model (musicgen-medium, phi-3-vision-4.2b)
    on weights from seed 0: the Engine refuses it (as the reference's,
    before building anything); the legacy Server serves phase 4's 8
    requests from token prompts through the embedding table, with
    pre-quantized weights and delayed activation scales calibrated on
    the reference's random-embedding prompt.  Returns the serving row
    and each decode step's launches."""
    from repro_torch.launch.serve import random_params
    from repro_torch.serving import Engine, Request

    params = random_params(cfg, 0, "cuda")
    try:
        Engine(cfg, params, num_slots=4, max_len=64, device="cuda")
    except ValueError as e:
        print(f"engine {cfg.name}: refused ({e})")
    else:
        raise AssertionError(f"{cfg.name}: the Engine took an embeddings "
                             "model")
    for c in counters:
        c.reset()
    log = []
    reqs = _requests(Request, np, cfg, 0)
    srv, build_s, run_s, step_ms, peak = _server_run(
        torch, np, cfg, params, reqs, 64, step_log=(counters, log))
    launches = {c.name: c.count for c in counters}
    del srv, params
    torch.cuda.empty_cache()
    toks = sum(len(r.out) for r in reqs)
    print(f"legacy Server {cfg.name} ({cfg.n_layers} layers, build "
          f"{build_s:.2f} s): {len(reqs)} requests, {toks} tokens, serve "
          f"{run_s:.2f} s = {toks / run_s:.1f} tok/s, {len(log)} decode "
          f"steps, mean decode step {step_ms:.2f} ms, peak memory "
          f"{peak:.2f} GiB")
    return dict(layers=cfg.n_layers, launches=launches, tok_s=toks / run_s,
                decode_step_ms=step_ms, peak_gib=peak, path="Server"), log


def phase_families_serve(torch, np) -> dict:
    """stablelm-12b and minitron-8b at full width, depth cut to
    FAMILY_SERVE_LAYERS (the engine builds from the seeded f32 tree), on
    floating pages with chunked prefill; recurrentgemma-2b and rwkv6-3b
    (8 layers: 2 griffin units and the 2-layer tail; 8 rwkv6 blocks) on
    identity rows with the exact-length whole-prompt prefill;
    musicgen-medium (12 of 48) and phi-3-vision-4.2b (8 of 32) through
    the legacy Server, which their
    engines refuse (``_serve_embeddings_family``); each on weights from
    seed 0 with pre-quantized weights (recurrentgemma's tied head as
    embed/head_t) and delayed activation scales.  All serve phase 4's 8
    requests; recurrentgemma also one prompt of GEMMA_LONG_PROMPT tokens,
    whose ring wraps.  Gates: every request finishes with finite logits,
    every decode step launches what ``_family_decode_launches`` counts,
    the calibration one fused call a site; recurrentgemma's long request
    wraps its ring, and rwkv6's decode row at B 1 is bitwise the same row
    at B 4 (``_row_at_b1_and_b4``).  (The legacy Server of the two
    identity-row families is held to the reference's Server by the CPU
    tests.)  Returns, per family, its launches and serving numbers."""
    from repro_torch.serving import Request

    out = {}
    for arch in FAMILIES:
        layers = FAMILY_SERVE_LAYERS[arch]
        cfg = _family_cfg(arch, layers)
        identity = cfg.family in ("hybrid", "ssm")
        full = _family_cfg(arch, None).n_layers
        print(f"serve {arch}: full width (d {cfg.d_model}, {cfg.n_heads} "
              f"heads, {cfg.n_kv} kv heads, Dh {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, {cfg.act}, {cfg.norm}, qk_norm {cfg.qk_norm}, "
              f"rope_pct {cfg.rope_pct}, {cfg.pos_embedding} positions, "
              f"{cfg.input_mode} input, vocab {cfg.vocab}, tied "
              f"{cfg.tie_embeddings}), {cfg.n_layers} of {full} layers")
        counters = _serving_counters()
        zero = {c.name: 0 for c in counters}
        if cfg.input_mode == "embeddings":
            row, log = _serve_embeddings_family(torch, np, cfg, counters)
            per_step = {**zero, **_family_decode_launches(cfg, paged=False)}
        else:
            for c in counters:
                c.reset()
            log, seen = [], {}

            def after(eng, cfg=cfg, seen=seen, counters=counters):
                # the serving run's own launches, then the row check's
                seen.update({c.name: c.count for c in counters})
                if cfg.family == "ssm":
                    seen["rows"] = _row_at_b1_and_b4(
                        torch, np, eng, f"{cfg.name} decode", verify=False)

            kw = dict(seed=0, arch=arch, layers=layers,
                      float_pages=not identity, chunked=not identity,
                      after=after)
            if cfg.family == "hybrid":
                kw.update(max_len=GEMMA_MAX_LEN,
                          reqs=_gemma_requests(Request, np, cfg))
            reqs, build_s, run_s, st = _serve_once(
                torch, np, step_log=(counters, log), **kw)
            rows = seen.pop("rows", None)
            launches = dict(seen)
            _serve_line(f"engine {arch} ({cfg.n_layers} layers, build "
                        f"{build_s:.2f} s)", reqs, run_s, st)
            per_step = {**zero, **_family_decode_launches(
                cfg, paged=not identity)}
            streams = [list(r.out) for r in reqs]
            row = dict(layers=cfg.n_layers, launches=launches,
                       tok_s=sum(map(len, streams)) / run_s,
                       decode_step_ms=1e3 * st["mean_decode_step_s"],
                       peak_gib=st["peak_gib"])
            if rows is not None:
                if rows["decode"] != 0.0:
                    raise AssertionError(f"{arch}: a decode row at B 1 "
                                         "differs from the same row at B 4")
                row["b1_b4"] = rows
        print(f"launches on the {arch} serving path: "
              f"{json.dumps(row['launches'])}")
        sites = _family_sites(cfg)[0] + 1
        for name in ("fused_quant_gemm", "mx_quant", "global_amax"):
            if row["launches"][name] != sites:
                raise AssertionError(f"{arch}: {row['launches'][name]} "
                                     f"{name} launches, {sites} calibration "
                                     "sites")
        _check_steps(f"{arch} decode", log, per_step)
        row["decode_step_launches"] = per_step
        if cfg.family == "hybrid":
            long = reqs[-1]
            if long.prompt_len + len(long.out) <= cfg.window:
                raise AssertionError(f"{arch}: the long request did not "
                                     "wrap the ring")
            print(f"{arch}: the ring wrapped ({long.prompt_len} prompt + "
                  f"{len(long.out)} tokens on {cfg.window} slots)")
        out[arch] = row
    return out


def phase_families_train(torch, np) -> dict:
    """The six families at full width, depth cut to FAMILY_TRAIN_LAYERS
    (recurrentgemma's 5: one griffin unit and the 2-layer tail, so both
    segments run; minitron's 1: its f32 embedding and head, their
    gradients and moments, and its f32 logits of 1 x 4096 x 256,000 and
    their gradient, 4.2 GB each; rwkv6 4 of 32, musicgen 4 of 48,
    phi-3-vision 4 of 32, the embeddings models on the training CLI's
    frontend stub), batch 1 x 4096: 3 moss and 3 bf16 steps from the
    same weights on the same batches, launches as counted from the code
    (``_family_sites``), moss losses within 1e-2 of bf16's.  Returns,
    per family, the moss launches and each recipe's timing."""
    from repro_torch.launch.train import quant_from_name

    out = {}
    for arch in FAMILIES:
        layers = FAMILY_TRAIN_LAYERS[arch]
        base = _family_cfg(arch, layers)
        res = _train_modes(
            torch, np, arch,
            lambda mode, base=base: base.replace(quant=quant_from_name(mode)),
            ("moss", "bf16"), FAMILY_TRAIN_M, f"train {arch}",
            layer_sites=_family_sites(base)[0],
            full_layers=_family_cfg(arch, None).n_layers)
        out[arch] = dict(layers=layers, launches=res["moss"],
                         timing=res["timing"])
    return out


def _row1_small_m(torch, timer, gen, k, n, label) -> tuple[dict, float]:
    """mx_gemm's M <= 32 tile at M 32, 16 and 4 over (K, N): each within
    1e-5 * max|ref| of its plain version and its rows bitwise those of
    the M 32 call, timed (5 calls) beside its bound and torch.matmul in
    bf16.  Returns the M 4 row and the worst error."""
    from repro_torch.core.quant import mx_operand, quant_mx, quant_per_tensor
    from repro_torch.kernels import mx_gemm

    qw = quant_per_tensor(torch.randn(k, n, device="cuda",
                                      generator=gen) / k ** 0.5).q
    xq = quant_mx(_activations(torch, gen, max(SMALL_M), k))
    top, worst, row = None, 0.0, None
    for m in sorted(SMALL_M, reverse=True):
        q, se = xq.q[:m].contiguous(), xq.sexp[:m].contiguous()
        got = mx_gemm.mx_gemm(q, se, qw)
        want = mx_gemm.mx_gemm_plain(q, se, qw)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        top = got if top is None else top
        if not (err <= 1e-5 * scale and torch.isfinite(got).all()
                and torch.equal(got.view(torch.int32),
                                top[:m].view(torch.int32))):
            raise AssertionError(f"mx_gemm {label} M={m} K={k} N={n}: max "
                                 f"err {err} > 1e-5 * {scale}, or rows "
                                 "differ across M")
        worst = max(worst, err)
        opnd = mx_operand(q, se)
        t = timer.ms(lambda: mx_gemm.mx_gemm(q, se, qw), n=5)
        wb = qw.to(torch.bfloat16)
        tl = timer.ms(lambda: torch.matmul(opnd, wb), n=5)
        del wb
        b, by = bound_ms(m * k + m * k // 32 + k * n + 4 * m * n,
                         2.0 * m * n * k)
        print(f"mx_gemm {label} M={m:2d} K={k} N={n}: max_err {err:.3g} "
              f"(max|ref| {scale:.3g}), {t:.4f} ms, library {tl:.4f} ms "
              f"(torch.matmul bf16), bound {b:.4f} ms ({by}), "
              f"{b / t:.1%} of the bound")
        if m == 4:
            row = dict(ms=t, library_ms=tl, bound_ms=b)
        del got, want
    del qw, xq, top
    torch.cuda.empty_cache()
    return row, worst


def _training_gemms(torch, timer, gen, m, k, n, label) -> dict:
    """A linear layer's training kernels at (M, K, N) against their plain
    versions: fused_quant_gemm forward (e4m3) and dx (e5m2 on the f32
    gradient against the transposed weights), mx_quant alone on that
    gradient, and mx_dw_gemm on the forward's residual (payloads bitwise,
    sums within 1e-5 * max|ref|), each timed (5 calls) beside its bound
    and torch.matmul in bf16.  Returns the rows by kernel."""
    from repro_torch.core.quant import mx_operand, quant_per_tensor
    from repro_torch.kernels import dispatch, mx_bwd, mx_fused
    from repro_torch.kernels import mx_quant as mxq

    res = {}
    w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
    qw = quant_per_tensor(w).q
    del w
    x = _activations(torch, gen, m, k)
    g = torch.randn(m, n, device="cuda", generator=gen) * 1e-3
    for what, xin, wq, fmt in (("fwd", x, qw, "e4m3"),
                               ("dx", g, None, "e5m2")):
        if wq is None:
            wq = qw.T.contiguous()
        kk, nn = wq.shape
        s = dispatch.global_scale(xin, fmt)
        acc, q, se = mx_fused.fused_quant_gemm(xin, s, wq, fmt)
        acc_p, q_p, se_p = mx_fused.fused_quant_gemm_plain(xin, s, wq, fmt)
        q_mis = int((q.view(torch.uint8) != q_p.view(torch.uint8)).sum())
        e_mis = int((se != se_p).sum())
        err = float((acc - acc_p).abs().max())
        scale = float(acc_p.abs().max())
        if q_mis or e_mis or not (err <= 1e-5 * scale
                                  and torch.isfinite(acc).all()):
            raise AssertionError(f"fused_quant_gemm {label} {what} M={m} "
                                 f"K={kk} N={nn}: q {q_mis} / sexp {e_mis} "
                                 f"mismatches, max err {err} (max|ref| "
                                 f"{scale})")
        del acc, acc_p, q, se
        opnd, wb = mx_operand(q_p, se_p), wq.to(torch.bfloat16)
        del q_p, se_p
        t = timer.ms(lambda: mx_fused.fused_quant_gemm(xin, s, wq, fmt), n=5)
        tl = timer.ms(lambda: torch.matmul(opnd, wb), n=5)
        del opnd, wb
        b, by = bound_ms(xin.element_size() * m * kk + 4 + kk * nn
                         + 4 * m * nn + m * kk + m * kk // 32,
                         2.0 * m * nn * kk)
        print(f"fused_quant_gemm {label} {what} {fmt} M={m} K={kk} N={nn}: "
              f"max_err {err:.3g} (max|ref| {scale:.3g}), payloads bitwise, "
              f"{t:.4f} ms, library {tl:.4f} ms (torch.matmul bf16), bound "
              f"{b:.4f} ms ({by}), {b / t:.1%} of the bound")
        res.setdefault("fused_quant_gemm_tiled", {})[what] = dict(
            m=m, k=kk, n=nn, max_abs_err=err, ms=t, library_ms=tl,
            bound_ms=b)
        if what == "dx":
            # row 9 alone on the f32 gradient
            q_, se_ = mxq.mx_quant(xin, s, fmt)
            qw_, sw_ = mxq.mx_quant_plain(xin, s, fmt)
            mis = int((q_.view(torch.uint8) != qw_.view(torch.uint8))
                      .sum()) + int((se_ != sw_).sum())
            if mis:
                raise AssertionError(f"mx_quant {label} M={m} K={kk}: {mis} "
                                     "payload mismatches")
            del q_, se_, qw_, sw_
            t = timer.ms(lambda: mxq.mx_quant(xin, s, fmt), n=5)
            b, by = bound_ms(4 * m * kk + m * kk + m * kk // 32, 0.0)
            print(f"mx_quant {label} M={m} K={kk} f32 -> {fmt}: payloads "
                  f"bitwise, {t:.4f} ms, bound {b:.4f} ms ({by}), "
                  f"{b / t:.1%} of the bound")
            res["mx_quant"] = dict(m=m, k=kk, ms=t, bound_ms=b,
                                   max_abs_err=0.0)
        else:
            xq_fwd = mxq.mx_quant(xin, s, fmt)
        del wq
        torch.cuda.empty_cache()
    # dW: the forward's residual against the e5m2 gradient: (K, N) f32
    gq = quant_per_tensor(g, "e5m2").q
    del g, x
    acc = mx_bwd.mx_dw_gemm(*xq_fwd, gq, "e4m3")
    acc_p = mx_bwd.mx_dw_gemm_plain(*xq_fwd, gq, "e4m3")
    err = float((acc - acc_p).abs().max())
    scale = float(acc_p.abs().max())
    if not (err <= 1e-5 * scale and torch.isfinite(acc).all()):
        raise AssertionError(f"mx_dw_gemm {label} M={m} K={k} N={n}: max err "
                             f"{err} > 1e-5 * {scale}")
    del acc, acc_p
    torch.cuda.empty_cache()
    t = timer.ms(lambda: mx_bwd.mx_dw_gemm(*xq_fwd, gq), n=5)
    opnd, gb = mx_operand(*xq_fwd).T.contiguous(), gq.to(torch.bfloat16)
    tl = timer.ms(lambda: torch.matmul(opnd, gb), n=5)
    del opnd, gb
    b, by = bound_ms(m * k + m * k // 32 + m * n + 4 * k * n, 2.0 * m * n * k)
    print(f"mx_dw_gemm {label} M={m} K={k} N={n}: max_err {err:.3g} (max|ref| "
          f"{scale:.3g}), {t:.4f} ms, library {tl:.4f} ms (torch.matmul "
          f"bf16), bound {b:.4f} ms ({by}), {b / t:.1%} of the bound")
    res["mx_dw_gemm"] = dict(m=m, k=k, n=n, max_abs_err=err, ms=t,
                             library_ms=tl, bound_ms=b)
    del xq_fwd, gq, qw
    torch.cuda.empty_cache()
    return res


def phase_head_kernels(torch, timer) -> dict:
    """Rows 1, 2, 5 and 9 at the families' new shapes: mx_gemm's M <= 32
    tile at M 4/16/32 over the 256,000-wide heads (K, N) (stablelm's
    5120 x 100,352, minitron's 4096 x 256,000, recurrentgemma's head_t
    2560 x 256,000: 1.05e9 fp8 weights), over rwkv6-3b's decode (K, N)
    (ddlerp_w1's N 160, decay_w1's 64, the time and channel mixes, the
    2560 x 65,536 head) and musicgen-medium's head (1536 x 2048); and the
    training kernels (``_training_gemms``: rows 2, 5 and 9) at
    minitron's head, M 4096 (dx at K 256,000: 4.2 GB of input, past 2^31
    bytes), and at rwkv6's ragged N 160 and 64 (M 4096).  Returns the
    kernels line's "families" entries."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    res = {"mx_gemm": {}}
    worst = 0.0
    for label, shapes in (("head", FAMILY_HEAD_KN), (RWKV, RWKV_DECODE_KN),
                          (MUSICGEN, [MUSICGEN_HEAD_KN])):
        for k, n in shapes:
            row, err = _row1_small_m(torch, timer, gen, k, n, label)
            res["mx_gemm"][f"{k}x{n}"] = row
            worst = max(worst, err)
    res["mx_gemm"]["max_abs_err"] = worst
    for label, (k, n) in [("head", HEAD_TRAIN_KN)] + [
            (RWKV, kn) for kn in RWKV_TRAIN_KN]:
        for name, row in _training_gemms(torch, timer, gen, FAMILY_TRAIN_M,
                                         k, n, label).items():
            res.setdefault(name, {})[f"{k}x{n}"] = row
    return res


def _moe_engine_rows(torch, np, mode, quant, label) -> dict:
    """phi3.5-moe at full width, MOE_SERVE_LAYERS layers, in ``quant``:
    ``_row_at_b1_and_b4`` on its engine, then phase 4's requests served
    (floating pages), every decode step's launches gated (the dense
    combine's expert sites one by one: group_gemm at each delayed site
    in per_group, the M <= 32 tile in moss, per_tensor's pt_matmul no
    kernel of its own; decode_attn_paged once a layer).  A verify row
    must not move with its batch; where the decode row moved, the same
    requests on one slot (each alone) must give the same streams.
    Returns the rows' differences, the streams' equality and the serving
    numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import group_gemm

    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_SERVE_LAYERS)
    sites = MOE_SERVE_LAYERS * (4 + 3 * cfg.n_experts) + 1
    counters = _serving_counters() + [group_gemm.counter]
    zero = {c.name: 0 for c in counters}
    per_step = {**zero, "decode_attn_paged": MOE_SERVE_LAYERS}
    if mode == "per_group":
        per_step["group_gemm"] = sites
    elif mode == "moss":
        per_step["mx_gemm"] = sites
    rows = {}

    def check(eng):
        rows.update(_row_at_b1_and_b4(torch, np, eng, label))

    for c in counters:
        c.reset()
    log = []
    kw = dict(seed=0, arch=MOE_ARCH, layers=MOE_SERVE_LAYERS,
              over=dict(quant=quant))
    reqs, build_s, run_s, st = _serve_once(torch, np, step_log=(counters,
                                                                  log),
                                           wrap_decode=check, **kw)
    _serve_line(f"{label} (build {build_s:.2f} s)", reqs, run_s, st)
    _check_steps(f"{label} decode", log, per_step)
    mixed = [list(r.out) for r in reqs]
    out = dict(b1_b4_max_abs=rows["decode"],
               b1_b4_verify_max_abs=rows["verify"],
               tok_s=sum(map(len, mixed)) / run_s,
               decode_step_ms=1e3 * st["mean_decode_step_s"],
               decode_step_launches=per_step,
               b4_step_ms=dict(fixed=rows["fixed_ms"],
                               plain=rows["plain_ms"]))
    if rows["verify"] != 0.0:
        raise AssertionError(f"{label}: a verify row at B 1 differs from "
                             f"the same row at B 4 by {rows['verify']}")
    if rows["decode"] != 0.0:
        solo, *_ = _serve_once(torch, np, num_slots=1, **kw)
        same = [list(r.out) for r in solo] == mixed
        print(f"{label}: the streams served alone (1 slot) equal the mixed "
              f"batch's: {same}")
        if not same:
            raise AssertionError(f"{label}: a row's arithmetic depends on "
                                 "its batch and the streams moved with it")
        out["solo_streams_equal"] = same
    return out


def phase_engine_moe_baselines(torch, np) -> dict:
    """phi3.5-moe served in the paper's baselines at full width (4 of 32
    layers, phase 4's requests, weights pre-quantized per (layer,
    expert) against their own amax, calibrated activation scales per
    (layer, expert) site): per_group (COAT: group_gemm at every site of
    every expert, M <= 32) and per_tensor (TE: pt_matmul); and the
    moss engine's decode and verify rows at B 1 against B 4 (the dense
    combine is meant to keep a token's arithmetic independent of its
    batch: on the card the router's, the combine's and pt_matmul's f32
    products take a serving step's fixed row order, core.row_order).
    Returns each recipe's numbers."""
    from repro_torch.core.formats import (MOSS_CONFIG, PER_GROUP_CONFIG,
                                          PER_TENSOR_CONFIG)

    out = {}
    for mode, quant in (("per_group", PER_GROUP_CONFIG),
                        ("per_tensor", PER_TENSOR_CONFIG)):
        out[mode] = _moe_engine_rows(torch, np, mode, quant,
                                     f"serve {MOE_ARCH} {mode}")
    eng = _engine(arch=MOE_ARCH, layers=MOE_SERVE_LAYERS, max_len=64,
                  over=dict(quant=MOSS_CONFIG))
    rows = _row_at_b1_and_b4(torch, np, eng, f"serve {MOE_ARCH} moss")
    if rows["verify"] != 0.0:
        raise AssertionError(f"serve {MOE_ARCH} moss: a verify row at B 1 "
                             f"differs from B 4 by {rows['verify']}")
    out["moss"] = dict(b1_b4_max_abs=rows["decode"],
                       b1_b4_verify_max_abs=rows["verify"],
                       b4_step_ms=dict(fixed=rows["fixed_ms"],
                                       plain=rows["plain_ms"]))
    del eng
    torch.cuda.empty_cache()
    return out


def phase_small_train_reference(torch, np):
    """The smoke-size olmo-7b trains 3 steps of batch 2 x 64 on the card
    and on the CPU from the same initial state and batches, each device
    on its own trajectory, in moss (rescale_interval 2, so a refresh
    happens), per_group and per_tensor; so do the smoke-size llama2-7b
    in moss, the smoke-size phi3.5-moe and deepseek-v2-lite-16b in
    moss on the grouped route (moe_decode_dense off, so their 128 tokens
    take the grouped kernels), and the smoke-size stablelm-12b,
    minitron-8b, recurrentgemma-2b, rwkv6-3b, musicgen-medium and
    phi-3-vision-4.2b in moss (the embeddings models on the CPU's
    frontend-stub embeddings): losses within 1e-2 relative and equal
    scale_t at every step (f32 sums in another order and the rare fp8
    rounding flip they cause)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import quant_from_name, stub_embeds
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.steps import (TrainHParams, init_train_state,
                                         make_train_step)

    runs = [(TRAIN_ARCH, mode, _train_cfg(get_config, quant_from_name,
                                          mode, smoke=True, interval=2))
            for mode in ("moss", "per_group", "per_tensor")]
    runs.append((LLAMA_ARCH, "moss", get_config(LLAMA_ARCH, smoke=True)
                 .replace(quant=quant_from_name("moss", 2))))
    runs.append((MOE_ARCH, "moss", _moe_cfg(get_config, quant_from_name,
                                            "moss", smoke=True, interval=2)))
    runs.append((MLA_ARCH, "moss", get_config(MLA_ARCH, smoke=True).replace(
        quant=quant_from_name("moss", 2), moe_decode_dense=False)))
    for arch in FAMILIES:
        runs.append((arch, "moss", get_config(arch, smoke=True).replace(
            quant=quant_from_name("moss", 2))))
    for arch, mode, cfg in runs:
        hp = TrainHParams(peak_lr=1e-3, warmup_steps=0, total_steps=3)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=2, seed=0))
        cpu = init_train_state(cfg, hp, seed=0, device="cpu")
        card = cpu._replace(
            params=tree_map(lambda t: t.to("cuda"), cpu.params),
            opt=tree_map(lambda o: OptState(o.mu.to("cuda"),
                                            o.nu.to("cuda")), cpu.opt),
            scale_s0=tree_map(lambda t: t.to("cuda"), cpu.scale_s0))
        step = make_train_step(cfg, hp)
        for i in range(3):
            batch = data.batch_for_step(i)
            if cfg.input_mode == "embeddings":
                batch["embeds"] = stub_embeds(cfg, batch["tokens"])
            cpu, mc = step(cpu, batch)
            card, mg = step(card, batch)
            a, b = float(mc["loss"]), float(mg["loss"])
            rel = abs(a - b) / abs(a)
            same_t = tree_leaves(cpu.scale_t) == tree_leaves(card.scale_t)
            print(f"smoke train {arch} {mode} step {i}: card vs CPU loss "
                  f"{b:.6f} "
                  f"/ {a:.6f} (rel {rel:.3g}, limit 1e-2), scale_t equal "
                  f"{same_t}")
            if not (np.isfinite(b) and rel <= 1e-2 and same_t):
                raise AssertionError(f"smoke train {arch} {mode} step {i}: "
                                     "card vs CPU")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository "
                    "(src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script "
                    "drives the port on an NVIDIA GPU")
    t_start = time.monotonic()
    smi = phase_card(torch)
    t0 = time.monotonic()
    phase_build()
    print(f"phase build: {time.monotonic() - t0:.1f} s")
    timer = Timer(torch)
    t0 = time.monotonic()
    res = phase_kernels(torch, timer)
    res.update(phase_mx_gemm_tiled(torch, timer))
    res.update(phase_train_kernels(torch, timer))
    res.update(phase_recipe_kernels(torch, timer))
    res.update(phase_ring_kernels(torch, timer))
    res.update(phase_verify_kernels(torch, timer))
    print(f"phase kernels: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    heads = phase_head_kernels(torch, timer)
    print(f"phase head kernels: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches, plain, gaps = phase_engine(torch, np)
    print(f"phase engine: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    spec_launches = phase_engine_spec(torch, np, plain)
    print(f"phase engine spec: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    hatch = phase_engine_hatch(torch, np)
    print(f"phase engine hatch: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_engine_prefix(torch, np)
    print(f"phase engine prefix: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_engine_preempt(torch, np)
    print(f"phase engine preempt: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    obs = phase_engine_obs(torch, np, hatch)
    print(f"phase engine obs: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    baselines = phase_engine_baselines(torch, np, timer)
    print(f"phase engine baselines: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_engine_moe(torch, np)
    print(f"phase engine moe: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    moe_baselines = phase_engine_moe_baselines(torch, np)
    print(f"phase engine moe baselines: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    mla_serve_launches = phase_engine_mla(torch, np)
    print(f"phase engine mla: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ring_launches = phase_engine_ring(torch, np)
    print(f"phase engine ring: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    fam_serve = phase_families_serve(torch, np)
    print(f"phase engine families: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_small_reference(torch, np)
    phase_small_families(torch, np)
    print(f"phase small serving vs CPU: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_table6(torch, timer)
    print(f"phase table 6: {time.monotonic() - t0:.1f} s")
    del timer
    t0 = time.monotonic()
    train_launches = phase_train(torch, np)
    print(f"phase train: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    moe_res, moe_launches = phase_moe_train(torch, np)
    print(f"phase moe train: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    mla_res, mla_train_launches = phase_mla_train(torch, np)
    print(f"phase mla train: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    fam_train = phase_families_train(torch, np)
    print(f"phase families train: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_small_train_reference(torch, np)
    print(f"phase small train vs CPU: {time.monotonic() - t0:.1f} s")
    vmapped_ab = moe_res.pop("vmapped_ab")
    res.update(moe_res)
    # each row's launches come from its path: the serving kernels'
    # (mx_gemm is the M <= 32 tile, decode steps' and calibration's;
    # fused_quant_gemm the calibration forward's calls, M 32, each one
    # mx_quant and one mx_gemm launch) from the engine, the verify forms from
    # the spec engine, decode_attn from the windowed engine,
    # fused_quant_gemm_tiled (calls at M > 32), the global_amax,
    # mx_quant and mx_gemm_tiled launches they make, and mx_dw_gemm with its
    # dw_requant passes from the moss steps, group_gemm from the
    # per_group steps and the per_group engine (its decode steps, prefill
    # chunks and calibration), moe_gmm and moe_dw_gemm from the MoE moss
    # steps
    launches.update(spec_launches)
    launches.update(train_launches)
    launches["group_gemm"] += baselines["launches"]
    res["group_gemm"]["serving"] = baselines["serving"]
    launches["decode_attn"] = ring_launches["decode_attn"]
    # the decode kernels on phase engine obs's bf16 pools and rows
    # (REPRO_KV_CACHE=bf16), each counted from 0 for its runs
    for name, n in obs["kv_bf16"]["launches"].items():
        launches[name] += n
    launches["moe_gmm"] = moe_launches["moe_gmm"]
    launches["moe_dw_gemm"] = moe_launches["moe_dw_gemm"]
    # deepseek's own rows: its kernel checks (res[name]["deepseek"], the
    # MoE kernels' from its training phase) and each kernel's launches on
    # its serving and training paths, each counted from 0 for that path
    for name, row in mla_res.items():
        res[name]["deepseek"] = row
    for name in REPLACES:
        n = mla_serve_launches.get(name, 0) + mla_train_launches.get(name, 0)
        if n or "deepseek" in res[name]:
            res[name].setdefault("deepseek", {})["launches"] = dict(
                serving=mla_serve_launches.get(name, 0),
                training=mla_train_launches.get(name, 0))
    # the three families' rows: the kernel checks at their shapes (the
    # 256,000-wide heads, Dh 160) and each kernel's launches on their
    # serving and training paths, each counted from 0 for that path
    for name, row in heads.items():
        res[name]["families"] = row
    res["decode_attn_paged"].setdefault("families", {})
    for name in REPLACES:
        n = {arch: dict(serving=fam_serve[arch]["launches"].get(name, 0),
                        training=fam_train[arch]["launches"].get(name, 0))
             for arch in FAMILIES}
        if any(v["serving"] or v["training"] for v in n.values()):
            res[name].setdefault("families", {})["launches"] = n
    res["group_gemm"]["moe_baselines"] = moe_baselines
    res["moe_gmm"]["vmapped_ab"] = vmapped_ab
    print("families: " + json.dumps({"serving": fam_serve,
                                     "training": fam_train}))
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **{k: res[name][k] for k in
                       ("max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **({"moe_serving": res[name]["moe_serving"]}
                       if name in MOE_CHECKED else {}),
                    **({"deepseek": res[name]["deepseek"]}
                       if "deepseek" in res[name] else {}),
                    **({"serving": res[name]["serving"]}
                       if "serving" in res[name] else {}),
                    **{k: res[name][k] for k in ("families", "moe_baselines",
                                                 "vmapped_ab")
                       if k in res[name]})
               for name in REPLACES]
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
