#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  build     compile the kernels from src/repro_torch/kernels/csrc (one
            nvcc per source, in parallel) and print the card's name and
            power limit
  kernels   each kernel against its plain PyTorch version on the card,
            at its path's shapes: the int8 GEMM (both modes) exactly,
            at granite_3_2b's sites and at every site of llama3_2_3b and
            chatglm3_6b, musicgen_medium, nemotron_4_340b and the dense
            half and shared expert of llama4_maverick_400b_a17b (M 8 and
            256; its head N 202048), with the plan `gemm_plan` took; the
            requant's four forms
            (apply_rqt, heads-to-rows for ctx_rqt; the whole QAdd; the
            gated MLP's LUT, gate product and h_rqt; the ungated MLP's
            GELU LUT or squared ReLU) exactly at the chunk and decode
            shapes, per-channel, scalar-path and wrapping tables, and
            llama4's sh_rqt (int32 out within +-2^24, d 5120); the
            paged attention in both
            pool modes
            (int8, and int4-packed with per-head unpack operands) at S
            32 and 1, T 512 and 4096, on its tensor-core kernel (with
            the launch `paged_plan` took and its registers and spills),
            and at the new configs' heads (hd 128; group 3 with 8 kv
            heads, group 16 with 2; musicgen_medium's group 1 with 24
            at hd 64; nemotron_4_340b's group 12 with 8 at hd 192;
            llama4_maverick's group 5 with 8 at hd 128; S 32 and 1 at T
            512), equal to its
            plain version: 0 quanta moved and max |diff| 0; the
            quantized flash
            attention at full granite geometry (S 8192 x 8192 with bkv
            128 and 64 on the tensor-core kernel and bkv 256 on the
            CUDA-core one, and 128 queries at offset 8064 over 8192
            keys) and at hd 128 / 192, equal to its plain version (0
            quanta moved), with the kernel path `qfa_plan` took and its
            registers and spills; times beside bounds and the island
            floor
            the grouped int8 GEMM (the MoE's expert GEMMs, one launch
            over 64 experts) at olmoe_1b_7b's gate/up (K 2048, N 1024)
            and down (K 1024, N 2048) sites at C 4, 40 and 80 with
            per-(expert, channel) tables, exactly, with its plan, at
            llama4_maverick's 128 experts (C 4 and 8; gate/up K 5120 N
            8192 int8 out, down K 8192 N 5120 int32 out; 5.37 GB of
            weights a site), and at the write-then-gather attention's
            two products at
            granite's geometry (64 groups, C 128 and 4, scores K 64 N
            512, P.V K 512 N 64, int32 out)
            the int8 GEMM at falcon_mamba_7b's five sites (in_proj K
            4096 N 16384, x_proj K 8192 N 288, dt_proj K 256 N 8192,
            out_proj K 8192 N 4096, the head N 65024), M 8 and 256
            the int8 GEMM at zamba2_1_2b's sites (in_proj K 2048 N
            8384 int8 out, out_proj K 4096 N 2048, the shared
            attention's wq / wk / wv K 4096 N 2048 and wo, the head N
            32000), M 8 and 256; the grouped GEMM at the blockwise
            attention's two products at full granite width (8 kv-head
            groups of 4 x 1024 query rows, a tile; scores K 64 N 2048,
            P.V K 2048 N 64); the requant at falcon_mamba_7b's and
            zamba2_1_2b's conv requant, conv LUT, gate, Add and concat
            requant shapes (L 256 and 8 rows)
            the int8 GEMM at the NemoCNN's conv and head shapes (K 32,
            144, 288, 1024; N 16, 32, 64, 10; B 256 and the head at B
            8), both modes, and the requant per channel at its N 16, 32
            and 64
            the mesh-aware paged attention per head range (both pool
            modes, granite's K 8, S 32 and 1, T 512): each rank's launch
            of a "model" width of 2 and 4 over its own kv heads,
            concatenated, equal to the whole-pool launch (max |diff| 0);
            rank 0 of 2 (K 4, H 16) timed beside its bound, its plain
            version and SDPA
  entry     `quant_flash_attention` driven through its entry point (no
            serving path calls it), counts read around it
  cnn       the paper's NemoCNN at full width (channels 16/32/64, 32 x
            32 x 3 images, 10 classes; seeded init_np weights and BN
            statistics): the FullPrecision forward calibrated on 256
            seeded images on the card and on the CPU (every range within
            1e-4 of its span), then for each (bn_mode, act_bits) of
            CNN_CELLS one deploy from the card's ranges and the ID
            forward of the 256 images on the card (counts set to 0 just
            before and read just after: every conv and the head on the
            GEMM kernel, intbn's requant on the requant kernel; no op
            with a floating output) and on the CPU (plain versions):
            int32 logits and every block's and pool's int8 activations
            equal byte for byte; the FP-vs-ID logit correlation; images
            per second of apply_id on 4096 images by CUDA events, peak
            device memory; then `QConv2d` at stride 2 at its widths (16
            -> 32 channels, kernel 3 SAME and kernel 2 VALID, 256
            images) through the GEMM kernel, card == CPU
  calibrate granite_3_2b at full width cut to 2 layers: the
            FullPrecision forward of the entry point's calibration
            sample (`DecoderLM.calibrate`) on the card and on the CPU
            from the same init_np params, every range within 1e-4 of
            its span; the calibration time on each; one deploy from the
            card's ranges, the correlation of its int32 logits with the
            float logits on the sample (and of a DEFAULT_RANGES
            deploy's), then the parity below on that one table set
  parity    granite_3_2b (in the calibrate phase, 2 layers), llama3_2_3b
            and chatglm3_6b (PARITY_LAYERS, 1) at full width, calibrated
            on the card and deployed once, the card against the CPU
            (plain versions), at kv_bits 8 and 4: one prefill_chunk must
            give
            equal int32 logits and K/V pools (packed at 4) byte for
            byte, and the engine equal greedy tokens on the same ragged
            requests; torch.exp of the two devices is compared over
            [-104, 0] first (torch.exp, reported; the paged
            attention's `island_exp`, which must agree); granite also
            serves a system-prompt workload with an aligned-exact twin
            (one copy-on-write) with the prefix cache on and one
            scripted preemption, with equal tokens, equal prefix and
            preemption counters and both pools equal byte for byte
            after the drain
  main      granite_3_2b at full width over its first MAIN_LAYERS of 40
            layers (2 since the train_sharded phase; random seeded
            weights
            calibrated and deployed layer by layer by `deploy_model`, as
            every later phase's are): 8 ragged requests
            (prompts 17-300, 16 new tokens) through `ServingEngine`,
            every kernel of the path launched (GEMM launches by site
            and path, requant launches by form); a second run on a
            fresh engine with telemetry on, after `warmup()` and
            `reset_stats()`, with equal tokens (bit-neutrality), its
            full `stats()` and host time per step phase; a profiled
            third run with `record_function` ranges around each
            dispatch; then the same three runs over int4-packed pools
            (kv_bits 4) on the same tables
  open-loop on the same granite tables: 16 ragged requests closed-loop,
            then the same requests under Poisson arrivals at about twice
            the closed loop's requests per second (`run_open_loop`, TTFT
            and ITL SLOs), with equal tokens request by request
  prefix    on the same granite tables: 24 requests sharing a 256-token
            system prompt (32-token suffixes, 16 new tokens) over a pool
            of 40 pages (two cold requests and 2 pages), served cold and
            with the prefix cache (`benchmarks/serve_bench.py`'s
            shared-prefix-vs-cold lane at the main geometry): equal
            tokens, pages served from the cache, a clean arena after the
            drain; mean TTFT, peak concurrency and their ratios
  preempt   on the same granite tables, `PrioritySLOPolicy`: the main
            phase's 8 requests at class 0, then, once all 8 decode, 4
            class-1 requests, at kv_bits 8 and 4: at least 4
            preemptions, every class-0 request's tokens equal to its
            main run 1 tokens (every resume passes the engine's
            resume-parity oracle); then the open-loop phase's 16
            requests at classes i % 2 under the same arrivals with the
            TTFT SLO as aging target, tokens equal to the closed loop's,
            p99 TTFT per class
  async     dispatch depth 1 on the same granite tables: the main
            phase's 8 requests at kv_bits 8, depth 0 and depth 1 in
            turns (0, 1, 1, 0; fresh warmed engines, telemetry on), at
            kv_bits 4 at depth 1 (depth 0: main run 2), and the preempt
            cell at kv_bits 8, each run with the counts set to 0 just
            before and read just after; tokens equal depth 0's request
            by request; tok/s and host ms per step of the admission,
            harvest and dispatch phases of every run
  configs   llama3_2_3b and chatglm3_6b at full width, cut to their first
            CONFIG_LAYERS layers (1 of 28 since the embeds and train
            phases, 2 before, to keep the
            script under 1000 s; their deploy is most of its time), each
            served once (8 ragged requests, kv_bits 8, after
            `warmup()`): deploy time, device memory, launches by kernel
            (counts set to 0 just before the run), GEMM launches by site
            and path, the full `stats()`
  musicgen  musicgen_medium (LayerNorm with bias, ungated GELU MLP, MHA
            24/24 at hd 64): the 2-layer full-width card-vs-CPU parity
            at kv_bits 8 and 4 (as the parity phase), then the model
            at full width over its first MUSICGEN_LAYERS of 48 layers
            calibrated and deployed by `deploy_model` and served as the
            main phase's
            8-request cell at kv_bits 8 and 4: tokens, launches by
            kernel, by GEMM site and by requant form (the act form once
            a layer and step), tok/s, TTFT, ITL and the host's ms per
            step phase
  whole_prompt
            the reference's default arena and whole-prompt serving on
            granite_3_2b: the calibrate phase's 2-layer table set over
            `SlotArena` on the card and the CPU (chunked and bucketed:
            tokens, and both slot pools byte for byte); the main
            phase's tables over `SlotArena`, chunked and
            bucketed (`prefill_chunk` 0, bucket 16), tokens equal to
            main run 1's (paged) request by request, the path's kernels
            launched; `serve_batch` (8 prompts of 64 tokens in lockstep)
            equal to the engine on the same requests
  int_softmax
            integer-only attention (`attn_softmax="int"`) and the
            write-then-gather path: `int_softmax` on the card against
            the CPU byte for byte (the CPU test's int32-overflow cells
            and one chunk's scores at granite's attention, timed); the
            calibrate phase's 2-layer table set under the integer
            softmax in five engine cells (SlotArena chunked and
            bucketed, paged chunked and bucketed at kv_bits 8, paged
            chunked at 4), tokens card == CPU; the main tables
            under it at kv_bits 8 and 4 on the 8-request cell
            (counts set to 0 just before and read just after: no paged
            attention launch, the grouped GEMM twice a layer and
            dispatch, by shape; tok/s, TTFT, ITL), one dispatch under a
            TorchDispatchMode with no floating output in the attention;
            then the float island over the gather path
            (`paged_kernel=False`), tokens equal to main run 1's (the
            paged kernel)
  sharded   kv-head-sharded serving: the calibrate phase's 2-layer
            granite tables (saved once, loaded by each rank) serve the
            8-request cell over `SlotArena` at kv_bits 8 and the paged
            arena at 8 and 4, unsharded, then by SHARD_RANKS ranks on a
            (1, SHARD_RANKS) mesh with `kv_shard` sharing the one card
            over gloo: tokens and finish reasons equal on every rank,
            the ranks' pools concatenated along K equal the unsharded
            pools, each rank's counts (set to 0 before its cell) the
            path's kernels; per-rank pool bytes and step ms (gloo-staged,
            not a multi-GPU figure); then one nccl rank on a (1, 1) mesh
            with `kv_shard`, tokens equal (width 1 keeps every head: no
            collective runs, the nccl all-gather is not exercised)
  olmoe     olmoe_1b_7b (64 experts, top-8, d_ff 1024 an expert; the MoE
            family, exact-length whole-prompt prefill):
            MOE_PARITY_LAYERS at full width card vs CPU (a 200-token
            prefill's logits and slot
            pools, layer 0's gate images and expert picks at a prefill
            group and a decode group, the engine's tokens and pools
            after the drain), then the model at full width and
            MOE_LAYERS depth calibrated and deployed by `deploy_model`
            and served as the 8-request cell over `SlotArena` (run 1
            counted: launches a step by kernel, the grouped GEMM's by
            site; run 2 warmed with telemetry on: tok/s, TTFT, ITL, the
            host's ms per step phase) and over the paged arena (tokens
            equal)
  llama4    llama4_maverick_400b_a17b (pairs of a dense block and a MoE
            block with a shared expert; 128 experts top-1, d 5120, 40/8
            heads at hd 128, d_ff 8192): the dense half of a pair at
            full width (its float weights calibrated on the card,
            deployed, then a chunk and a decode dispatch card vs CPU at
            kv_bits 8 and 4, outputs and pools byte for byte; the MoE
            half at full width waits: ROADMAP §3); the reduced model
            calibrated on the card and the CPU on 4 x 32 tokens (ranges
            within 1e-4 of the span), deployed from the card's, the
            8-request cell over `SlotArena` and the paged arena (counts
            set to 0 just before and read just after: the path's
            kernels, sh_rqt on the requant's rqt form), tokens card ==
            CPU; its pair over int4-packed pools (one prefill_chunk and
            a decode, card == CPU; the engine refuses kv_bits 4 for the
            MoE family, as the reference does); its FQ step card vs CPU
  ssm       falcon_mamba_7b (the ssm family: Mamba-1 blocks, the integer
            causal conv1d, the softplus / exp(dt A) scan island as fixed
            float32 sequences, exact-length whole-prompt prefill): 2
            layers at full width (d 4096, d_inner 8192, state 16)
            calibrated on the card, card vs CPU (a 128-token prefill,
            one chunk of the scan, and a decode step after it: int32
            logits and both state leaves, h bit for bit; then 3
            requests, prompts 9-40, 4 new tokens, over `SlotArena` and
            the paged arena: tokens and the arenas' conv and h state
            after the drain; then the bf16 scan island at scan
            chunks of BF16_CHECK_CHUNK, card vs CPU: a one-chunk
            prefill's logits and state bit for bit, a two-chunk prompt
            served at its exact length, tokens and state), then the
            model at
            full width over its
            first SSM_LAYERS of 64 layers calibrated and deployed by
            `deploy_model` and served as the 8-request cell over
            `SlotArena` (warmed, counted: launches by kernel, by GEMM
            site and by requant form; tok/s, TTFT, ITL, device memory,
            deploy time; a second run with telemetry on: host ms per
            step phase; one decode dispatch's aten ops, the island's
            apart, and its time) and over the paged arena (tokens
            equal)
  blockwise granite_3_2b at full width cut to BLOCKWISE_LAYERS layers,
            the calibrate phase's tables, whole-prompt prefills of
            4097 and 6145 tokens over a contiguous cache of 8192
            positions (the reference's dense branch streams above 4096
            query rows: `_blockwise_attend`) and 3 decode steps after
            each, on the card (counts set to 0 just before and read
            just after: the grouped GEMM's two products a key block,
            the requant) and on the CPU: int32 logits, K/V bytes and
            the first 4 tokens equal; the card's prefill ms and peak
            memory
  hybrid    zamba2_1_2b (Mamba-2 blocks with d_inner 4096, 64 heads of
            64, state 64, and one shared attention over concat(x, x0)
            every 6 blocks, per-application tables): HYBRID_PARITY_LAYERS
            layers at full width (1 group and its shared application)
            calibrated on the card, card vs CPU (a 128-token prefill and
            3 decode steps: logits, conv, h bit for bit, the shared
            pools; 3 requests, 2 new tokens each, on 3 slots over
            `SlotArena` and the paged arena: tokens and the arenas'
            state; the bf16 island cell as in the ssm phase), then the
            model at full width
            over HYBRID_LAYERS layers deployed by `deploy_model` and
            served as the 8-request cell (prompts 254, 172, 256, 31,
            149, 255, 121, 257; 16 new tokens) over `SlotArena` (warmed,
            counted: launches by kernel, GEMM by site, requant by form;
            tok/s, TTFT, ITL, deploy s, resident and peak memory; one
            decode dispatch's aten ops with the island's share) and over
            the paged arena (tokens equal); then `QMamba2` at n_groups 2
            (reduced zamba2's block width) calibrated on the card,
            `apply_id` card vs CPU in the float32 and bf16 islands
            (accumulator, conv window, h bit for bit)
  nemotron  one nemotron_4_340b decoder layer at full width (d 18432,
            96/8 heads at hd 192, ungated squared-ReLU MLP at d_ff
            73728, about 3.45 B parameters; the whole model fits no
            card): its float weights drawn, calibrated on the card on
            its own float input (the embedding's init scale, 4 x 64
            tokens), deployed, and its ID `apply_id` run on the card
            and on the CPU over a paged arena: one chunk dispatch (2
            slots x 16 tokens of its int8 input) and one decode
            dispatch after it, outputs and K/V pools equal byte for
            byte, at kv_bits 8 and 4
  embeds    internvl2_76b (no embedding table: int8 embedding rows at
            meta["eps_in"]; d 8192, 64/8 heads at hd 128, group 8, d_ff
            28672, vocab 128256) at full width over its first
            EMBEDS_LAYERS of 80 layers: seeded weights calibrated on the
            card on a seeded float (4, 64, 8192) sample, deployed; card
            vs CPU, a 2 x 32-row prefill and 3 decodes (int32 logits
            and K/V bytes equal); then the card alone: a 2 x 1024-row
            prefill and 16 decodes, counted (every kernel of the
            kv_bits 8 path), timed (CUDA events), peak memory; the
            engine refuses the model
  train     FakeQuantized training: granite_3_2b at full width, 2
            layers, the loss and every gradient leaf of one 2 x 64
            batch on the card against the CPU (within 1e-3 relative and
            2e-2 relative L2); `launch.train.build` and
            `TrainSupervisor` at full width over TRAIN_LAYERS layers,
            batch 8 x 256, 12 steps with a checkpoint at 6, restarted
            from it (the resumed losses within 1e-3, the loss falling;
            ms a step, tokens/s, peak memory, the model FLOP/s share at
            6 N D, one step profiled); internvl2_76b's loss_fn_embeds
            at full width, 1 layer: finite, every leaf's gradient
            nonzero; then the MoE, ssm and hybrid families
            (TRAIN_FAMILIES): each one's FQ loss and every gradient
            leaf on one batch at full width and cut depth, card vs CPU
            (the MoE's differing (token, expert) choices counted), and
            `launch.train.build`'s step on the card (warm-up, then
            TRAIN_FAMILY_TIMED steps: ms a step, tokens/s, peak memory,
            the model FLOP/s share); then falcon_mamba_7b with the bf16
            scan island: card vs CPU on 1 x TRAIN_BF16_SEQ tokens in two
            chunks, and its trainer
  train_sharded  the training shardings: granite_3_2b at full width,
            SHARDED_TRAIN_LAYERS layers, batch 2 x 64, one FQ step
            unsharded on the card, then by two gloo ranks sharing the
            card on a (1, 2) mesh (loss and every leaf of the new
            params, qstate and moments bit-equal) and a (2, 1) mesh
            (within SHARDED_TRAIN_TOL), each rank's bytes equal to its
            placements', the (1, 2) result checkpointed and restored
            onto (2, 1) with equal leaves, and one nccl rank on (1, 1)
            (bit-equal); step times, gloo-staged on one card; then the
            float forward's cache (`init_caches(rep=FP)`): a 64-token
            prefill and 4 decodes card vs CPU and against the no-cache
            forward

Then a `kernels` JSON line (one entry a kernel, and the paged
attention's per-head-range launches of both pool modes with the
sharded phase's launch counts), the card line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout (no src/repro_torch beside it), it exits non-zero at once.
`--skip PHASE,...` leaves phases out (for a short development run),
the build, kernels and main phases excepted; a row whose launches a
skipped phase counts (the quantized flash attention's: entry; the
grouped GEMM's: olmoe; the per-head-range rows: sharded) carries
launches null.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet): HBM3 and dense int8
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
INT32_OPS_S = 33.5e12  # non-tensor int32 / f32 lanes (67 TFLOP/s FMA)
REPLACES = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:72",
    "int8_matmul_grouped": "src/repro/kernels/int8_matmul.py:72",
    "requant": "src/repro/kernels/requant_kernel.py:47",
    "paged_attention": "src/repro/kernels/paged_attention.py:238",
    "paged_attention_kv4": "src/repro/kernels/paged_attention.py:238",
    "quant_flash_attention": "src/repro/kernels/quant_attention.py:101",
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "int8_matmul_grouped": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "requant": "src/repro_torch/kernels/csrc/requant.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_kv4": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "quant_flash_attention":
        "src/repro_torch/kernels/csrc/quant_attention.cu",
}
# the __global__ functions of csrc/*.cu
KERNEL_NAMES = ("gemm_gemv_kernel", "gemm_wgmma_kernel", "requant_kernel",
                "requant_add_kernel", "requant_gate_kernel",
                "requant_act_kernel",
                "paged_attn_mma_kernel", "paged_attn_mma_packed_kernel",
                "quant_attn_mma_kernel", "quant_attn_kernel")
# the requant kernel's __global__ functions -> the call forms each serves
REQUANT_KERNELS = {"requant_kernel": "rqt, rqt_heads",
                   "requant_add_kernel": "add",
                   "requant_gate_kernel": "gate",
                   "requant_act_kernel": "act"}
# the kernels each serving path launches
PATH_KERNELS = {8: ("int8_matmul", "requant", "paged_attention"),
                4: ("int8_matmul", "requant", "paged_attention_kv4"),
                "moe": ("int8_matmul", "int8_matmul_grouped", "requant",
                        "paged_attention"),
                # the MoE with a shared expert in pairs (llama4): the
                # MoE's, sh_rqt on the requant kernel's int32-out rqt
                "llama4": ("int8_matmul", "int8_matmul_grouped", "requant",
                           "paged_attention"),
                # the write-then-gather path (either pool width): both
                # attention products on the grouped GEMM
                "gather": ("int8_matmul", "int8_matmul_grouped", "requant"),
                # the ssm family: projections on the GEMM, the conv's
                # requant and LUT, the gate and the Add on the requant
                "ssm": ("int8_matmul", "requant"),
                # the hybrid: the ssm's, and the shared attention on the
                # paged kernel (both arenas, prompts up to 4096 tokens)
                "hybrid": ("int8_matmul", "requant", "paged_attention"),
                # above 4096 rows over a contiguous cache: both products
                # of each key block on the grouped GEMM, no paged kernel
                "blockwise": ("int8_matmul", "int8_matmul_grouped",
                              "requant")}
# main-path engine settings; the main tables' depth (granite_3_2b's
# first MAIN_LAYERS of 40 at full width: 10 since the blockwise and
# hybrid phases, 4 since the embeds and train phases, 2 since the
# train_sharded phase, for the whole script's time; every phase on
# those tables scales with it)
N_SLOTS, PAGE, MAX_LEN, N_PAGES, CHUNK = 8, 16, 512, 256, 32
MAIN_LAYERS = 2
# the per-head-range paged attention: S at T MAX_LEN, and the "model"
# widths whose shards must concatenate to the whole-pool launch
SHARD_S = (CHUNK, 1)
SHARD_WIDTHS = (2, 4)
# the sharded phase's ranks (one card: they share it over gloo)
SHARD_RANKS = 2
# paged attention at full granite geometry (B 8, H 32, K 8, hd 64,
# pages of 16): (S, T), a prefill chunk and a decode step over the main
# cell's 512 positions and over 4096
PAGED_SHAPES = ((CHUNK, MAX_LEN), (1, MAX_LEN), (CHUNK, 4096), (1, 4096))
# the configs served beside granite_3_2b, and the geometry each gives
# the paged attention: (H, K, hd), GQA group 3 and group 16
CONFIGS = ("llama3_2_3b", "chatglm3_6b")
# the dense configs with LayerNorm and an ungated MLP: musicgen_medium
# served at full width (MUSICGEN_LAYERS deep), nemotron_4_340b one
# layer at full width; MHA (group 1) at hd 64, and group 12 at hd 192
VARIANTS = ("musicgen_medium", "nemotron_4_340b")
CONFIG_HEADS = {"llama3_2_3b": (24, 8, 128), "chatglm3_6b": (32, 2, 128),
                "musicgen_medium": (24, 24, 64),
                "nemotron_4_340b": (96, 8, 192),
                "internvl2_76b": (64, 8, 128),
                "llama4_maverick_400b_a17b": (40, 8, 128)}
# the nemotron layer's dispatches: slots and chunk tokens (the CPU side's
# float32 products, about 12 s a chunk and decode pair, bound them)
NEMO_SLOTS, NEMO_CHUNK = 2, 16
# the served depth of CONFIGS' full-width runs (their first layer of 28
# since the embeds and train phases, 2 before) and of musicgen_medium's
# (its first 2 of 48 since the MoE, ssm and hybrid train checks, 4
# before): the whole script's 1,000 s aim
CONFIG_LAYERS = 1
MUSICGEN_LAYERS = 2
# the parity phase's depth for CONFIGS (their first layer since the
# embeds and train phases, 2 before: the CPU side bounds the phase;
# granite's 2-layer parity runs in the calibrate phase)
PARITY_LAYERS = 1
# the MoE config, its served depth (None: all 16 layers; at 8 the slot
# and paged arenas' tokens differ, on the card and the CPU alike: the
# reference's parked rows take expert capacity, ROADMAP §3),
# and the grouped
# GEMM's shapes at its expert sites: (C, K, N) for gate/up and down at
# decode (8 slots: groups of 8 tokens, C 4) and whole-prompt prefills
# of 254 and 512 tokens (C 40, 80)
MOE_ARCH, MOE_LAYERS, MOE_EXPERTS = "olmoe_1b_7b", None, 64
# its card-vs-CPU parity depth (1 since the MoE, ssm and hybrid train
# checks, 2 before: the script's 1,000 s aim)
MOE_PARITY_LAYERS = 1
GROUPED_SHAPES = tuple((C, K, N) for C in (4, 40, 80)
                       for K, N in ((2048, 1024), (1024, 2048)))
# the ssm family's config and its served depth (the first SSM_LAYERS of
# its 64 at full width: 1 since the embeds and train phases, 2 before;
# deploy and the exact prefills bound the phase)
SSM_ARCH, SSM_LAYERS = "falcon_mamba_7b", 1
# its card-vs-CPU parity depth (1 since the train checks, 2 before)
SSM_PARITY_LAYERS = 1
# the ssm phase's card-vs-CPU cell (SSM_PARITY_LAYERS): a prefill of
# one scan chunk (layers.ssm.CHUNK), then requests with prompts 9-40
# and 4 new tokens
SSM_PREFILL, SSM_PARITY_GEN = 128, 4
# the ssm and hybrid bf16 island checks run at scan chunks of this
# length (a one-chunk prefill, a two-chunk prompt: 128 and 256 tokens
# before, 20.2 and 53.7 s of the phases on an H100 80GB HBM3 at 700 W
# host, the CPU side most of it)
BF16_CHECK_CHUNK = 32
# torch.exp card vs CPU over every EXP_STRIDE-th float32 in [-104, 0]
# (every one before PR 33: 10.7 s; every 4th before PR 34: 2.6 s)
EXP_STRIDE = 8
# blockwise phase: granite_3_2b's served depth (the first layer of the
# calibrate phase's 2-layer tables since the embeds and train phases:
# the CPU side's prefills bound the phase), the contiguous cache's
# positions, the whole prompts (above 4096 rows the attention streams:
# 3 and 4 key blocks of 2048; 6145 rows since the MoE, ssm and hybrid
# train checks, 8000 before, for the script's 1,000 s aim) and the
# tokens compared (the prefill's and 3 decodes')
BLOCKWISE_LAYERS, BLOCKWISE_LEN, BLOCKWISE_PROMPTS = 1, 8192, (4097, 6145)
BLOCKWISE_TOKENS = 4
# hybrid phase: the config, the parity depth (one group of 6 Mamba-2
# blocks and its shared application since the bf16 island cell, with a
# 1-block tail before it, a 2-block one before the embeds and train
# phases) and its engine's slots (the CPU
# side's island bounds the phase), the served depth of the 8-request
# cell (7 of 38 since the embeds and train phases: a group and a 1-block
# tail; 14 in PR 29; all 38 took 213 s) and its prompts
HYBRID_ARCH, HYBRID_PARITY_LAYERS, HYBRID_LAYERS = "zamba2_1_2b", 6, 7
HYBRID_PARITY_SLOTS, HYBRID_PARITY_GEN = 3, 2
HYBRID_PROMPTS = (254, 172, 256, 31, 149, 255, 121, 257)
# llama4 phase: llama4_maverick_400b_a17b (pairs of a dense block and a
# MoE block with a shared expert; 128 experts top-1, d 5120, 40/8 heads
# at hd 128, d_ff 8192, vocab 202048).  The dense half of a pair at full
# width card vs CPU (its MoE half: 16.1 G expert parameters, a 64.4 GB
# float32 draw, and the reference has no table set at that width,
# ROADMAP §3); the reduced model calibrated on the LLAMA4_SAMPLE tokens
# it deploys from, served as an 8-request cell (MoE exact-length
# prompts: at most one group of 64 or a whole number of groups, 6 new
# tokens) over both arenas; its FQ step card vs CPU on one MoE group
LLAMA4_ARCH, LLAMA4_MAX_LEN, LLAMA4_SAMPLE = ("llama4_maverick_400b_a17b",
                                              128, (4, 32))
LLAMA4_PROMPTS, LLAMA4_GEN = (5, 17, 64, 17, 5, 64, 17, 5), 6
LLAMA4_TRAIN = (2, 32)  # the FQ step's batch x sequence: 64 tokens
# the grouped GEMM at llama4's expert sites, one launch over 128
# experts: (C, K, N, output), capacity C 4 (a decode group of 8 slots;
# any group up to 409 tokens) and 8 (a group of 512), gate/up int8 out
# per (expert, channel), down int32 out
LLAMA4_EXPERTS = 128
LLAMA4_GROUPED = ((4, 5120, 8192, "int8"), (4, 8192, 5120, "int32"),
                  (8, 5120, 8192, "int8"), (8, 8192, 5120, "int32"))
# the write-then-gather attention's two products on the grouped GEMM at
# granite's attention (8 slots x 8 kv heads, group 4, hd 64, T 512): S,
# a chunk and a decode row
ATTN_GROUPED_S = (CHUNK, 1)
# int_softmax phase: the CPU test's overflow cells (tests/
# test_torch_int_softmax.py): eps_s, score amplitude, masked share, T
INT_SOFTMAX_CASES = ((1e-6, 2 ** 22, 0.0, 64), (1e-5, 10 ** 4, 0.3, 37),
                     (1e-4, 2 ** 22, 0.3, 37), (1e-3, 100, 0.5, 16),
                     (1e-2, 10 ** 4, 0.3, 130), (3e-3, 2 ** 22, 0.0, 37))
# whole_prompt phase: the bucketed mode's bucket; serve_batch's cell
BUCKET, BATCH_PROMPT = 16, 64
# open-loop phase: requests, their arrival rate over the closed loop's
# requests per second, and the SLOs of the goodput roll-up (seconds)
OPEN_LOOP_N, OPEN_LOOP_RATE, SLO_TTFT_S, SLO_ITL_S = 16, 2.0, 2.0, 0.25
# prefix phase: system-prompt and suffix tokens, requests per slot
PREFIX_LEN, SUFFIX_LEN, PREFIX_PER_SLOT = 256, 32, 3
# preempt phase: class-1 requests submitted once the 8 class-0 decode
N_URGENT = 4
# the card's float32 calibration against the CPU's, as a share of the span
CALIB_TOL = 1e-4
# the engine's record_function range around each dispatch
ANNOTATION = "repro_torch.serving/"
# cnn phase: the NemoCNN's (bn_mode, act_bits) cells, the images it is
# calibrated on and compared on, the images a timed forward takes and
# how many forwards are timed; its GEMMs at B 256, (M, K, N): conv1
# (K 27 padded to 32), conv2, conv3, the head, then the head at B 8
CNN_CELLS = (("fold", 8), ("intbn", 8), ("thresh", 8), ("thresh", 4),
             ("intbn", 4))
CNN_IMAGES, CNN_TIMED, CNN_TIMED_RUNS = 256, 4096, 5
CNN_GEMMS = ((256 * 1024, 32, 16), (256 * 256, 144, 32),
             (256 * 64, 288, 64), (256, 1024, 10), (8, 1024, 10))
# quantized flash attention at full granite geometry (B 1, H 32, K 8):
# (S_q, S_kv, hd, causal, q_offset, bkv); the first two are its entry
# phase; bkv 256, the last, takes the CUDA-core kernel (`qfa_plan`)
QFA_SHAPES = ((8192, 8192, 64, True, 0, 128),
              (128, 8192, 64, True, 8064, 128),
              (128, 256, 128, True, 0, 128), (128, 128, 192, False, 0, 128),
              (8192, 8192, 64, True, 0, 64), (8192, 8192, 64, True, 0, 256))
# lane-instructions of the exact float island per visible score: one
# accurate expf (~10) and ~10 more f32 / int steps (an estimate from the
# source, not a count of the compiled code)
ISLAND_INSTR = 20
QFA_SCALE, QFA_EPS = 1.0 / 2048.0, 0.02
# embeds phase: the embeds config (int8 embedding rows, no table), its
# served depth (1 of 80 layers at full width since the MoE, ssm and
# hybrid train checks, 2 before: the whole model is about 68 GB at int8,
# and the script has a 1,000 s aim), its calibration sample
# (CALIB_BATCH x 64 float rows),
# the card-vs-CPU cell (2 rows of 32 int8 rows, 3 decodes) and the card's
# cell (2 rows of 1024, 16 decodes)
EMBEDS_ARCH, EMBEDS_LAYERS = "internvl2_76b", 1
EMBEDS_PARITY, EMBEDS_PROMPT, EMBEDS_DECODES = 32, 1024, 16
EMBEDS_MAX = EMBEDS_PROMPT + EMBEDS_DECODES
# train phase: granite_3_2b at full width, FakeQuantized; the card-vs-CPU
# gradient (2 layers, batch 2 x 64; the loss within TRAIN_LOSS_TOL
# relative, every leaf's gradient within TRAIN_GRAD_TOL relative L2,
# the CPU tests' tolerances), then the trainer over TRAIN_LAYERS of 40
# layers at batch 8 x 256 for TRAIN_STEPS steps, a checkpoint at
# TRAIN_CKPT and a restart from it (the resumed losses within
# TRAIN_RESUME_TOL relative of the uninterrupted run's); internvl2_76b's
# loss_fn_embeds at full width, 1 layer, on 1 x 64 float rows
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_RESUME_TOL = 1e-3, 2e-2, 1e-3
# (2 trainer layers since the train_sharded phase, 4 before: time)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 8, 256
TRAIN_STEPS, TRAIN_CKPT = 12, 6
# the other trained families at full width: (arch, the card-vs-CPU
# check's depth, batch and sequence; the trainer's depth, batch and
# sequence).  olmoe: 1 of 16 layers on one MoE group of 512 tokens,
# then 2 layers at 4 x 512; falcon_mamba_7b 1 of 64 layers; zamba2_1_2b
# 7 of 38 (a group of 6 Mamba-2 blocks, its shared attention, a 1-block
# tail: its serving phase's depth) in the trainer, 6 (the group, no
# tail, since the train_sharded phase: time) in its card-vs-CPU check;
# the scan families' checks within
# one scan chunk (64 tokens each: the CPU
# side's island bounds them, 97 s at 128), their trainers over two
# chunks, falcon_mamba_7b at 8 x 256, zamba2_1_2b at 2 x 256 (time:
# 5.4 s a step at 8 x 256 on an H100 80GB HBM3 at 700 W, 65 s of the
# phase)
TRAIN_FAMILIES = (("olmoe_1b_7b", 1, 1, 512, 2, 4, 512),
                  ("falcon_mamba_7b", 1, 1, 64, 1, 8, 256),
                  ("zamba2_1_2b", 6, 1, 64, 7, 2, 256))
# (1 warm-up and 2 timed steps since the llama4 phase, 3 since the
# train_sharded phase, 2 and 5 since the bf16 island's train cell, 2 and
# 10 before: time)
TRAIN_FAMILY_WARM, TRAIN_FAMILY_TIMED = 1, 2
# the bf16 island's card-vs-CPU batch: 64 tokens in two chunks of 32
TRAIN_BF16_SEQ = 64
# card-vs-CPU gradient tolerances of those families (relative L2; the
# loss within TRAIN_LOSS_TOL for all): the MoE's about 2% of (token,
# expert) choices differ between the devices (bf16 router logits a
# rounding apart at the top-8 edge, the float ops before them not bit
# for bit across devices), and each moved choice moves expert
# gradients (the worst leaf 5.2e-2, the median 2.4e-2); the hybrid's 7
# layers compound bf16 rounding (worst 2.4e-2, median 1.6e-2; the
# reference's own jitted and op-by-op runs differ up to 2.3e-2 on its
# reduced 4 layers); measured on an H100 80GB HBM3 at 700 W
TRAIN_FAMILY_GRAD_TOL = {"moe": 1e-1, "ssm": TRAIN_GRAD_TOL, "hybrid": 5e-2}
# the card's dense bf16 peak (H100 SXM data sheet, without sparsity)
BF16_FLOPS_S = 989.4e12
# train_sharded phase: granite_3_2b at full width, SHARDED_TRAIN_LAYERS
# layers, the train cell's card-vs-CPU batch (2 x 64): the unsharded FQ
# step on the card, then two gloo ranks sharing the card on a (1, 2) and
# a (2, 1) ("data", "model") mesh, and one nccl rank on (1, 1).  The
# (2, 1) mesh's limits (each leaf's max |diff| over its max |value|):
# on the CPU (tests/test_torch_train_sharded.py SHARD_TOL) the loss is
# 8e-8 apart and the moments a bfloat16 rounding of each rank's
# partial weight gradients; on the card the split also halves every
# GEMM's row count, for which cuBLAS takes other kernels, so the rows'
# bfloat16 products differ as the card's and the CPU's do: the loss
# within the train phase's card-vs-CPU TRAIN_LOSS_TOL (measured 3.8e-5
# on an H100 80GB HBM3 at 700 W), the moments within 5e-2 (measured
# 1.4e-2), the params bit-equal (AdamW's first step moves each by lr
# times a sign); SHARDED_TRAIN_TIMED timed steps a mesh
SHARDED_TRAIN_LAYERS, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ = 2, 2, 64
SHARDED_TRAIN_TOL = {"loss": 1e-3, "trainable": 1e-6, "moments": 5e-2}
SHARDED_TRAIN_TIMED = 1
# the float forward's cache (same phase): the 2-layer model's prefill of
# FLOAT_CACHE_PREFILL tokens and FLOAT_CACHE_DECODES decodes through
# init_caches(rep=FP) for 2 rows, card vs CPU (logits within
# FLOAT_CACHE_TOL of their span) and each step against the no-cache
# forward over the whole sequence (FLOAT_NOCACHE_TOL of the span: the
# cache holds K / V in bfloat16)
FLOAT_CACHE_PREFILL, FLOAT_CACHE_DECODES = 64, 4
FLOAT_CACHE_TOL, FLOAT_NOCACHE_TOL = 1e-3, 5e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    t_mem = n_bytes / HBM_BYTES_S
    t_ops = n_ops / ops_rate
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def ptxas_summary(report: str) -> dict:
    """{kernel<template args>: "registers ... / spill ..."} from nvcc's
    -Xptxas -v report of one source."""
    out, fn = {}, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            # the kernel's name and integer template arguments, from
            # its mangled name
            mangled = line.split("'")[1]
            at = [mangled.find(k) for k in KERNEL_NAMES if k in mangled]
            # (integers and bools as numbers, int8_t and int as types)
            m = re.match(r"([a-z_]+_kernel)I?((?:L[ib]\d+E|[ai])*)",
                         mangled[min(at):] if at else "")
            fn = (m.group(1) + "<" + ", ".join(
                n or {"a": "int8", "i": "int32"}[t] for n, t in re.findall(
                    r"L[ib](\d+)E|([ai])", m.group(2))) + ">"
                  if m else mangled[:40])
        if "registers" in line or "spill" in line:
            out[fn] = (out[fn] + "; " if fn in out else "") + line.split(
                ":", 1)[-1].strip()
    return out


class Timer:
    """Median device time of one call.  Before each launch the L2 is
    flushed (the serving path reads each layer's weights once per
    step) and the stream is held busy by a sleep kernel, so the host's
    enqueue work lands inside the sleep and not inside the timed span."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, iters: int = 10, sleep_cycles: int = 4_000_000
                 ) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(sleep_cycles)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def rand_rqt(torch, np, rng, N, per_channel, *, int32_out):
    """A requant tree from the port's own scheduler (make_rqt)."""
    from repro_torch.core.requant import make_rqt

    eps_in = (rng.uniform(1e-5, 4e-5, size=N) if per_channel
              else float(rng.uniform(1e-5, 4e-5)))
    kw = dict(qmin=-(1 << 24), qmax=1 << 24) if int32_out else {}
    t = make_rqt(eps_in, 0.05, acc_bound=float(1 << 24), **kw)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in t.items()}


def gemm_case(torch, np, timer, rng, report, M, K, N, mode, site=""):
    """One int8_matmul shape against its plain version, exactly; its
    time beside its bound, plain and library times, and its plan.
    -> max |diff| (0)."""
    from repro_torch.kernels import int8_matmul, int8_matmul_plain
    from repro_torch.kernels.int8_matmul import gemm_plan

    x = torch.randint(-128, 128, (M, K), dtype=torch.int8, device="cuda")
    w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                      device="cuda").t()
    bias = torch.randint(-(1 << 20), 1 << 20, (N,), dtype=torch.int32,
                         device="cuda")
    rqt = (rand_rqt(torch, np, rng, N, True, int32_out=False)
           if mode == "int8" else None)
    got = int8_matmul(x, w, bias, rqt)
    want = int8_matmul_plain(x, w, bias, rqt)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if got.dtype != want.dtype or err != 0:
        raise AssertionError(
            f"int8_matmul {site} {mode} M={M} K={K} N={N}: max err {err}")
    del want
    ms = timer(lambda: int8_matmul(x, w, bias, rqt))
    plain = timer(lambda: int8_matmul_plain(x, w, bias, rqt), 3)
    lib = None
    # torch._int_mm takes M > 16 and K, N multiples of 8
    if mode == "int32" and M > 16 and K % 8 == 0 and N % 8 == 0:
        lib = timer(lambda: torch._int_mm(x, w))
    out_b = M * N * (1 if mode == "int8" else 4)
    n_bytes = M * K + K * N + 4 * N * (5 if mode == "int8" else 1)
    bms, by = bound_ms(n_bytes + out_b, 2.0 * M * N * K, INT8_OPS_S)
    p = gemm_plan(M, N, K)
    row = dict(shape=f"M={M} K={K} N={N} {mode}-out", ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
               max_abs_err=err, site=site,
               plan=f"{p.path} {p.bm}x{p.bn}, {p.splits} split(s), "
               f"{p.blocks} blocks")
    report.setdefault("int8_matmul", []).append(row)
    print(f"  int8_matmul {site + ' ' if site else ''}{row['shape']}: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
          f"({by}), library {lib if lib is None else round(lib, 4)} ms, "
          f"exact; {row['plan']}, {(n_bytes + out_b) / ms / 1e6:.0f} GB/s")
    return err


def check_int8_matmul(torch, np, timer, rng, report):
    worst = 0
    for M in (N_SLOTS, N_SLOTS * CHUNK):
        for K, N, mode in ((2048, 2048, "int8"), (2048, 512, "int8"),
                           (2048, 8192, "int8"), (2048, 2048, "int32"),
                           (8192, 2048, "int32"), (2048, 49408, "int32")):
            worst = max(worst, gemm_case(torch, np, timer, rng, report,
                                         M, K, N, mode))
    host_us_per_call(torch, np, rng, report)
    return worst


def check_config_gemms(torch, np, timer, rng, report):
    """The GEMM at every QLinear site of the configs served beside
    granite_3_2b, of VARIANTS, of EMBEDS_ARCH (`gemm_sites`; its head N
    128256, its down K 28672) and of LLAMA4_ARCH's dense half and
    shared expert (wq / wo K 5120 N 5120, wk / wv N 1024, gate / up N
    8192, down K 8192, the head N 202048), decode (M 8) and chunk (M
    256)."""
    from repro_torch.configs.base import get_config

    worst = 0
    for arch in CONFIGS + VARIANTS + (EMBEDS_ARCH, LLAMA4_ARCH):
        for (K, N, mode), site in gemm_sites(get_config(arch)).items():
            for M in (N_SLOTS, N_SLOTS * CHUNK):
                worst = max(worst, gemm_case(torch, np, timer, rng, report,
                                             M, K, N, mode,
                                             f"{arch} {site}"))
    return worst


def ssm_gemm_sites(cfg) -> dict:
    """(K, N, output type) of each QLinear site of an ssm model's
    serving path -> its name."""
    d, ds = cfg.d_model, cfg.ssm_state
    di, r = cfg.ssm_expand * d, -(-d // 16)
    return {(d, 2 * di, "int8"): "in_proj", (di, r + 2 * ds, "int8"):
            "x_proj", (r, di, "int32"): "dt_proj", (di, d, "int32"):
            "out_proj", (d, cfg.vocab_padded, "int32"): "head"}


def check_ssm_gemms(torch, np, timer, rng, report):
    """The GEMM at every site of SSM_ARCH (`ssm_gemm_sites`), decode (M
    8) and prefill (M 256)."""
    from repro_torch.configs.base import get_config

    worst = 0
    for (K, N, mode), site in ssm_gemm_sites(get_config(SSM_ARCH)).items():
        for M in (N_SLOTS, N_SLOTS * CHUNK):
            worst = max(worst, gemm_case(torch, np, timer, rng, report, M, K,
                                         N, mode, f"{SSM_ARCH} {site}"))
    return worst


def hybrid_gemm_sites(cfg) -> dict:
    """(K, N, output type) of each QLinear site of a hybrid model's
    serving path -> its name (wq, wk and wv share a shape at zamba2's
    32 / 32 heads)."""
    d, ds, hd = cfg.d_model, cfg.ssm_state, cfg.hd
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    sites = {(d, 2 * di + 2 * ds + H, "int8"): "in_proj",
             (di, d, "int32"): "out_proj",
             (2 * d, cfg.n_kv_heads * hd, "int8"): "wk/wv",
             (2 * d, cfg.n_heads * hd, "int8"): "wq",
             (cfg.n_heads * hd, d, "int32"): "wo",
             (d, cfg.vocab_padded, "int32"): "head"}
    if cfg.n_kv_heads == cfg.n_heads:
        sites[(2 * d, cfg.n_heads * hd, "int8")] = "wq/wk/wv"
    return sites


def check_hybrid_gemms(torch, np, timer, rng, report):
    """The GEMM at every site of HYBRID_ARCH (`hybrid_gemm_sites`),
    decode (M 8) and prefill (M 256)."""
    from repro_torch.configs.base import get_config

    worst = 0
    for (K, N, mode), site in hybrid_gemm_sites(
            get_config(HYBRID_ARCH)).items():
        for M in (N_SLOTS, N_SLOTS * CHUNK):
            worst = max(worst, gemm_case(torch, np, timer, rng, report, M, K,
                                         N, mode, f"{HYBRID_ARCH} {site}"))
    return worst


def check_blockwise_products(torch, np, timer, report):
    """The grouped GEMM at the blockwise attention's two products at
    full granite width (B 1, 32 heads, 8 kv heads: E 8 groups of group
    4 x the tile's rows; hd 64, key blocks of 2048), int32 out, exactly
    as the plain version; time beside the bytes bound (library null).
    -> max |diff| (0)."""
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )
    from repro_torch.kernels.int8_matmul import gemm_plan
    from repro_torch.layers.attention import (
        BLOCKWISE_BLOCK, BLOCKWISE_TILE_SCORES,
    )

    H, Kh, hd, blk = 32, 8, 64, BLOCKWISE_BLOCK
    rows = BLOCKWISE_TILE_SCORES["cuda"] // (H * blk)
    E, C = Kh, (H // Kh) * rows
    worst = 0
    q = torch.randint(-128, 128, (1, E, C, hd), dtype=torch.int8,
                      device="cuda")
    k = torch.randint(-128, 128, (E, blk, hd), dtype=torch.int8,
                      device="cuda")
    img = torch.randint(0, 128, (1, E, C, blk), dtype=torch.int8,
                        device="cuda")
    vt = torch.randint(-128, 128, (E, hd, blk), dtype=torch.int8,
                       device="cuda")
    for what, x, w, K, N in (("scores", q, k.transpose(1, 2), hd, blk),
                             ("P.V", img, vt.transpose(1, 2), blk, hd)):
        got = int8_matmul_grouped(x, w)
        want = int8_matmul_grouped_plain(x, w)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.dtype != torch.int32 or err != 0:
            raise AssertionError(f"int8_matmul_grouped blockwise {what}: "
                                 f"max err {err}")
        del want
        worst = max(worst, err)
        ms = timer(lambda: int8_matmul_grouped(x, w))
        plain = timer(lambda: int8_matmul_grouped_plain(x, w), 3)
        n_bytes = E * C * K + E * K * N + 4 * E * C * N
        bms, by = bound_ms(n_bytes, 2.0 * E * C * N * K, INT8_OPS_S)
        p = gemm_plan(C, N, K, E)
        row = dict(shape=f"G=1 E={E} C={C} K={K} N={N} int32-out "
                   f"(blockwise {what}, a tile of {rows} rows)", ms=ms,
                   plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=None, max_abs_err=err,
                   plan=f"{p.path} {p.bm}x{p.bn}, {p.splits} split(s), "
                   f"{p.blocks} blocks")
        report.setdefault("int8_matmul_grouped", []).append(row)
        print(f"  int8_matmul_grouped {row['shape']}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), library "
              f"null, exact; {row['plan']}, one launch, "
              f"{n_bytes / ms / 1e6:.0f} GB/s")
    return worst


def check_cnn_gemms(torch, np, timer, rng, report):
    """The GEMM at the NemoCNN's shapes (CNN_GEMMS): the convs in both
    modes (fold's int8 epilogue, intbn's and thresh's int32), the head
    int32."""
    worst = 0
    for M, K, N in CNN_GEMMS:
        for mode in (("int32",) if N == 10 else ("int8", "int32")):
            worst = max(worst, gemm_case(torch, np, timer, rng, report, M,
                                         K, N, mode, "nemo_cnn"))
    return worst


def check_grouped_gemm(torch, np, timer, rng, report):
    """The grouped form at GROUPED_SHAPES, G 1 over MOE_EXPERTS experts
    with per-(expert, channel) requant tables, against its plain
    version exactly; its time beside its bound and plain time (no one
    PyTorch call computes it: library null), and, at C > 16, the time
    of MOE_EXPERTS `torch._int_mm` calls (int32 out, no requant) as a
    note.  -> max |diff| (0)."""
    from repro_torch.core.requant import make_rqt
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )
    from repro_torch.kernels.int8_matmul import gemm_plan

    E, worst = MOE_EXPERTS, 0
    for C, K, N in GROUPED_SHAPES:
        x = torch.randint(-128, 128, (1, E, C, K), dtype=torch.int8,
                          device="cuda")
        w = torch.randint(-128, 128, (E, N, K), dtype=torch.int8,
                          device="cuda").transpose(1, 2)
        rqt = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in make_rqt(rng.uniform(1e-5, 4e-5, size=(E, N)),
                                    0.05, acc_bound=K * 127.0 * 127.0
                                    ).items()}
        got = int8_matmul_grouped(x, w, rqt)
        want = int8_matmul_grouped_plain(x, w, rqt)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.dtype != torch.int8 or err != 0:
            raise AssertionError(f"int8_matmul_grouped C={C} K={K} N={N}: "
                                 f"max err {err}")
        del want
        worst = max(worst, err)
        ms = timer(lambda: int8_matmul_grouped(x, w, rqt))
        plain = timer(lambda: int8_matmul_grouped_plain(x, w, rqt), 3)
        n_bytes = E * C * K + E * K * N + 4 * 4 * E * N + 8 + E * C * N
        bms, by = bound_ms(n_bytes, 2.0 * E * C * N * K, INT8_OPS_S)
        p = gemm_plan(C, N, K, E)
        site = "gate/up" if N == 1024 else "down"
        row = dict(shape=f"G=1 E={E} C={C} K={K} N={N} int8-out ({site})",
                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=None, max_abs_err=err,
                   plan=f"{p.path} {p.bm}x{p.bn}, {p.splits} split(s), "
                   f"{p.blocks} blocks")
        report.setdefault("int8_matmul_grouped", []).append(row)
        note = ""
        if C > 16:
            xs = [x[0, e] for e in range(E)]
            ws = [w[e] for e in range(E)]
            lib = timer(lambda: [torch._int_mm(a, b) for a, b in zip(xs, ws)])
            note = f"; {E} torch._int_mm calls (int32 out) {lib:.4f} ms"
        print(f"  int8_matmul_grouped {row['shape']}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), library "
              f"null, exact; {row['plan']}, one launch, "
              f"{n_bytes / ms / 1e6:.0f} GB/s{note}")
    return worst


def check_llama4_grouped(torch, np, timer, rng, report):
    """The grouped form at llama4's expert sites (LLAMA4_GROUPED): one
    launch over 128 experts, G 1; gate / up (K 5120, N 8192) with
    per-(expert, channel) requant tables, int8 out, and down (K 8192, N
    5120) int32 out, each 5.37 GB of int8 weights; exactly as the plain
    version, its time beside its bytes bound (library null: no one
    PyTorch call computes it).  -> max |diff| (0)."""
    from repro_torch.core.requant import make_rqt
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )
    from repro_torch.kernels.int8_matmul import gemm_plan

    E, worst = LLAMA4_EXPERTS, 0
    for C, K, N, mode in LLAMA4_GROUPED:
        x = torch.randint(-128, 128, (1, E, C, K), dtype=torch.int8,
                          device="cuda")
        w = torch.randint(-128, 128, (E, N, K), dtype=torch.int8,
                          device="cuda").transpose(1, 2)
        rqt = None
        if mode == "int8":
            rqt = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                   for k, v in make_rqt(
                       rng.uniform(1e-5, 4e-5, size=(E, N)), 0.05,
                       acc_bound=K * 127.0 * 127.0).items()}
        got = int8_matmul_grouped(x, w, rqt)
        want = int8_matmul_grouped_plain(x, w, rqt)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if str(got.dtype) != f"torch.{mode}" or err != 0:
            raise AssertionError(f"int8_matmul_grouped llama4 C={C} K={K} "
                                 f"N={N}: max err {err}")
        del want
        worst = max(worst, err)
        ms = timer(lambda: int8_matmul_grouped(x, w, rqt))
        plain = timer(lambda: int8_matmul_grouped_plain(x, w, rqt), 3)
        n_bytes = (E * C * K + E * K * N + E * C * N * (1 if rqt else 4)
                   + (4 * 4 * E * N + 8 if rqt else 0))
        bms, by = bound_ms(n_bytes, 2.0 * E * C * N * K, INT8_OPS_S)
        p = gemm_plan(C, N, K, E)
        site = "gate/up" if mode == "int8" else "down"
        row = dict(shape=f"llama4 G=1 E={E} C={C} K={K} N={N} {mode}-out "
                   f"({site})", ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, max_abs_err=err,
                   plan=f"{p.path} {p.bm}x{p.bn}, {p.splits} split(s), "
                   f"{p.blocks} blocks")
        report.setdefault("int8_matmul_grouped", []).append(row)
        print(f"  int8_matmul_grouped {row['shape']}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), library "
              f"null, exact; {row['plan']}, one launch, "
              f"{n_bytes / ms / 1e6:.0f} GB/s")
        del x, w, got
        torch.cuda.empty_cache()
    return worst


def check_grouped_attention(torch, np, timer, report):
    """The grouped form at the write-then-gather attention's two
    products (int32 out, no requant) at granite's geometry, S in
    ATTN_GROUPED_S: scores (E = B K = 64 groups, C = group S rows of q
    against T = MAX_LEN keys, K = hd 64) and P.V (the int8 image, K = T,
    against V stored (hd, T), N = hd), exactly as the plain version;
    time beside its bytes bound and the plain time (library null: torch
    has no batched int8 product on CUDA, `torch._int_mm` is 2-D).
    -> max |diff| (0)."""
    from repro_torch.kernels import (
        int8_matmul_grouped, int8_matmul_grouped_plain,
    )
    from repro_torch.kernels.int8_matmul import gemm_plan

    E, G, hd, T = N_SLOTS * 8, 4, 64, MAX_LEN
    worst = 0
    for S in ATTN_GROUPED_S:
        C = G * S
        q = torch.randint(-128, 128, (1, E, C, hd), dtype=torch.int8,
                          device="cuda")
        k = torch.randint(-128, 128, (E, T, hd), dtype=torch.int8,
                          device="cuda")
        img = torch.randint(0, 128, (1, E, C, T), dtype=torch.int8,
                            device="cuda")
        vt = torch.randint(-128, 128, (E, hd, T), dtype=torch.int8,
                           device="cuda")
        for what, x, w, K, N in (("scores", q, k.transpose(1, 2), hd, T),
                                 ("P.V", img, vt.transpose(1, 2), T, hd)):
            got = int8_matmul_grouped(x, w)
            want = int8_matmul_grouped_plain(x, w)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())
            if got.dtype != torch.int32 or err != 0:
                raise AssertionError(f"int8_matmul_grouped attention {what} "
                                     f"S={S}: max err {err}")
            del want
            worst = max(worst, err)
            ms = timer(lambda: int8_matmul_grouped(x, w))
            plain = timer(lambda: int8_matmul_grouped_plain(x, w), 3)
            n_bytes = E * C * K + E * K * N + 4 * E * C * N
            bms, by = bound_ms(n_bytes, 2.0 * E * C * N * K, INT8_OPS_S)
            p = gemm_plan(C, N, K, E)
            row = dict(shape=f"G=1 E={E} C={C} K={K} N={N} int32-out "
                       f"(attention {what}, S {S})", ms=ms, plain_ms=plain,
                       bound_ms=bms, bound_by=by, library_ms=None,
                       max_abs_err=err,
                       plan=f"{p.path} {p.bm}x{p.bn}, {p.splits} split(s), "
                       f"{p.blocks} blocks")
            report.setdefault("int8_matmul_grouped", []).append(row)
            print(f"  int8_matmul_grouped {row['shape']}: kernel {ms:.4f} "
                  f"ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
                  f"library null, exact; {row['plan']}, one launch, "
                  f"{n_bytes / ms / 1e6:.0f} GB/s")
    return worst


def host_us_per_call(torch, np, rng, report, calls=1000):
    """Host time of one int8_matmul call at K 2048, N 2048 (the wq and
    wo sites), M 8 (decode GEMV) and M 256 (chunk wgmma, which encodes
    two tensor maps): `calls` launches without synchronising, divided,
    beside the kernel's device time from the table above."""
    from repro_torch.kernels import int8_matmul

    K, N = 2048, 2048
    w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                      device="cuda").t()
    bias = torch.zeros(N, dtype=torch.int32, device="cuda")
    rq = rand_rqt(torch, np, rng, N, True, int32_out=False)
    for M, mode, rqt in ((N_SLOTS, "int8", rq), (N_SLOTS, "int32", None),
                         (N_SLOTS * CHUNK, "int32", None)):
        x = torch.randint(-128, 128, (M, K), dtype=torch.int8,
                          device="cuda")
        int8_matmul(x, w, bias, rqt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            int8_matmul(x, w, bias, rqt)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        shape = f"M={M} K={K} N={N} {mode}-out"
        dev = next(r["ms"] for r in report["int8_matmul"]
                   if r["shape"] == shape)
        print(f"  int8_matmul {shape}: host {host_us:.1f} us per call "
              f"({calls} calls, no synchronise), device {dev * 1e3:.1f} us")


def requant_tables(torch, np, rng, N, kind, ratio, *, int32_out=False,
                   zp=0, acc_bound=float(1 << 24)):
    """A requant tree on the card.  `scalar` and `channel`: the port's
    scheduler (make_rqt) for eps_in / eps_out = `ratio` (times 0.5-1.5
    per channel) and `acc_bound`; `wrap`: per-channel m in [2^28,
    2^31), s0 0, d 20, pre-clip +-2^20, so the staged product
    (q >> s0) * m wraps in int32."""
    from repro_torch.core.requant import make_rqt

    if kind == "wrap":
        m = rng.integers(1 << 28, 1 << 31, size=N)
        t = {"m": (m - (1 << 32) * (m >= 1 << 31)).astype(np.int32),
             "d": np.int32(20), "s0": np.zeros(N, np.int32),
             "lo": np.full(N, -(1 << 20), np.int32),
             "hi": np.full(N, 1 << 20, np.int32), "zp": np.int32(zp)}
    else:
        eps = ratio * (rng.uniform(0.5, 1.5, size=N) if kind == "channel"
                       else float(rng.uniform(0.5, 1.5)))
        kw = dict(qmin=-(1 << 24), qmax=1 << 24) if int32_out else {}
        t = make_rqt(eps, 1.0, zp_out=zp, acc_bound=acc_bound, **kw)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in t.items()}


def requant_cases(torch, np, rng):
    """(form, name, kernel call, plain call, bytes, operations) of every
    shape `check_requant` holds: the serving path's sites at its chunk
    (M 256) and decode (M 8) shapes first, then per-channel, int32-out
    and int32-a variants, shapes that take the scalar path (numel or N
    not a multiple of 16) and tables whose staged product wraps."""
    from repro_torch.kernels import (
        requant, requant_act, requant_act_plain, requant_add,
        requant_add_plain, requant_gate, requant_gate_plain, requant_plain,
    )

    B, H, hd, d, ff = N_SLOTS, 32, 64, 2048, 8192
    dev = "cuda"

    def i8(shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev)

    def i32(shape, amp):
        return torch.randint(-amp, amp, shape, dtype=torch.int32, device=dev)

    def tab_bytes(*rqs):
        return sum(16 * t["m"].numel() for t in rqs)

    def rqt(name, shape, kind, *, heads=False, out32=False):
        q = i32(shape, 1 << 14)
        rq = requant_tables(torch, np, rng, shape[-1], kind, 1 / 128,
                            int32_out=out32, zp=0 if out32 else 3)
        kw = dict(heads_to_rows=heads)
        if out32:
            kw.update(qmin=-(1 << 24), qmax=1 << 24, out_dtype=torch.int32)
        n = q.numel()
        return ("rqt_heads" if heads else "rqt", name,
                lambda: requant(q, rq, **kw),
                lambda: requant_plain(q, rq, **kw),
                n * (4 + (4 if out32 else 1)) + tab_bytes(rq), 10.0 * n)

    def add(name, shape, kind_a, kind_b, *, a32=False):
        a = i32(shape, 1 << 17) if a32 else i8(shape)
        b = i32(shape, 1 << 17)
        N = shape[-1]
        # the bound QAdd.deploy schedules both branches for
        kw = dict(int32_out=True, acc_bound=float(1 << 16))
        t = {"rq_a": requant_tables(torch, np, rng, N, kind_a,
                                    1e-3 if a32 else 0.5, **kw),
             "rq_b": requant_tables(torch, np, rng, N, kind_b, 1e-3, **kw),
             "zp_a": torch.tensor(5, dtype=torch.int32, device=dev),
             "zp_b": torch.tensor(-7, dtype=torch.int32, device=dev)}
        n = a.numel()
        return ("add", name, lambda: requant_add(a, b, t),
                lambda: requant_add_plain(a, b, t),
                n * (a.element_size() + 4 + 1)
                + tab_bytes(t["rq_a"], t["rq_b"]), 24.0 * n)

    def gate(name, shape, kind):
        s_pre, s_u = i8(shape), i8(shape)
        lut = i8((256,))
        zp_g = torch.tensor(-11, dtype=torch.int32, device=dev)
        rq = requant_tables(torch, np, rng, shape[-1], kind, 1 / 256, zp=2)
        n = s_pre.numel()
        return ("gate", name, lambda: requant_gate(s_pre, s_u, lut, zp_g, rq),
                lambda: requant_gate_plain(s_pre, s_u, lut, zp_g, rq),
                3 * n + 256 + tab_bytes(rq), 13.0 * n)

    def act(name, shape, kind=None):
        """The ungated MLP's activation: GELU's LUT (kind None) or
        squared ReLU with `kind` rqt2 tables (zp -128, its deploy's)."""
        s = i8(shape)
        if kind is None:
            t = {"lut": i8((256,))}
        else:
            t = {"rqt2": requant_tables(torch, np, rng, shape[-1], kind,
                                        1 / 255, zp=-128,
                                        acc_bound=float(255 ** 2))}
        n = s.numel()
        return ("act", name, lambda: requant_act(s, t),
                lambda: requant_act_plain(s, t),
                2 * n + (256 if kind is None else tab_bytes(t["rqt2"])),
                (3.0 if kind is None else 12.0) * n)

    mg, nm = 6144, 73728  # musicgen_medium's and nemotron_4_340b's d_ff
    return [
        rqt("ctx_rqt chunk", (B, H, CHUNK, hd), "scalar", heads=True),
        rqt("ctx_rqt decode", (B, H, 1, hd), "scalar", heads=True),
        gate("gate+h_rqt chunk", (B * CHUNK, ff), "scalar"),
        gate("gate+h_rqt decode", (B, ff), "scalar"),
        add("QAdd chunk", (B, CHUNK, d), "scalar", "channel"),
        add("QAdd decode", (B, 1, d), "scalar", "channel"),
        rqt("per-channel", (B * CHUNK, d), "channel"),
        rqt("int32-out per-channel", (B, CHUNK, d), "channel", out32=True),
        add("QAdd int32 a", (B, CHUNK, d), "channel", "channel", a32=True),
        rqt("tail", (3, 37, 29), "scalar"),
        rqt("heads tail", (2, 3, 5, 24), "channel", heads=True),
        add("QAdd tail", (5, 3, 100), "scalar", "channel"),
        gate("gate tail", (7, 333), "channel"),
        rqt("wrap", (B * CHUNK, d), "wrap"),
        add("QAdd wrap", (B, 1, d), "wrap", "wrap", a32=True),
        gate("gate wrap", (B, ff), "wrap"),
        act("GELU LUT chunk", (B * CHUNK, mg)),
        act("GELU LUT decode", (B, mg)),
        act("ReLU^2 chunk", (B * CHUNK, nm), "scalar"),
        act("ReLU^2 decode", (B, nm), "scalar"),
        act("ReLU^2 per-channel rqt2", (B * CHUNK, mg), "channel"),
        act("act tail", (7, 333), "channel"),
        act("GELU tail", (3, 5, 40)),
        act("ReLU^2 wrap", (B, mg), "wrap"),
        # falcon_mamba_7b's forms (d_inner 8192, d 4096) and zamba2's
        # (conv over 4224 channels, the concat's halves at d 2048), at
        # a 256-token whole prompt and a decode step of 8 rows
        rqt("falcon conv_rqt prefill", (1, 256, 8192), "scalar"),
        rqt("falcon conv_rqt decode", (B, 1, 8192), "scalar"),
        act("falcon conv LUT prefill", (1, 256, 8192)),
        act("falcon conv LUT decode", (B, 1, 8192)),
        gate("falcon gate prefill", (256, 8192), "scalar"),
        gate("falcon gate decode", (B, 8192), "scalar"),
        add("falcon QAdd prefill", (1, 256, 4096), "scalar", "channel"),
        add("falcon QAdd decode", (B, 1, 4096), "scalar", "channel"),
        rqt("zamba2 conv_rqt prefill", (1, 256, 4224), "scalar"),
        rqt("zamba2 conv_rqt decode", (B, 1, 4224), "scalar"),
        act("zamba2 conv LUT prefill", (1, 256, 4224)),
        act("zamba2 conv LUT decode", (B, 1, 4224)),
        rqt("zamba2 cat_rqt prefill", (1, 256, d), "scalar"),
        rqt("zamba2 cat_rqt decode", (B, 1, d), "scalar"),
        # internvl2_76b's sites (64 heads of 128, d_ff 28672, d 8192)
        # at its embeds cell's 2 x 1024-row prefill and 2-row decode
        rqt("internvl2 ctx_rqt prefill", (2, 64, 1024, 128), "scalar",
            heads=True),
        rqt("internvl2 ctx_rqt decode", (2, 64, 1, 128), "scalar",
            heads=True),
        gate("internvl2 gate prefill", (2048, 28672), "scalar"),
        gate("internvl2 gate decode", (2, 28672), "scalar"),
        add("internvl2 QAdd prefill", (2, 1024, 8192), "scalar", "channel"),
        add("internvl2 QAdd decode", (2, 1, 8192), "scalar", "channel"),
        # llama4's sh_rqt: the shared expert's int32 accumulator into
        # the MoE's combine space, per channel at d 5120, int32 out
        # within +-2^24, at a chunk and a decode dispatch
        rqt("llama4 sh_rqt chunk", (B, CHUNK, 5120), "channel", out32=True),
        rqt("llama4 sh_rqt decode", (B, 1, 5120), "channel", out32=True),
        # the NemoCNN's intbn requant at B 256, one per block
        rqt("nemo_cnn b0", (256, 32, 32, 16), "channel"),
        rqt("nemo_cnn b1", (256, 16, 16, 32), "channel"),
        rqt("nemo_cnn b2", (256, 8, 8, 64), "channel"),
    ]


def check_requant(torch, np, timer, rng, report):
    """Each call form of the requant kernel against its plain version,
    exactly, at `requant_cases`; each time beside its bytes bound."""
    worst = 0
    for form, name, fn, plain, n_bytes, n_ops in requant_cases(
            torch, np, rng):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.dtype != want.dtype or got.shape != want.shape or err != 0:
            raise AssertionError(f"requant {form} {name}: max err {err}")
        worst = max(worst, err)
        ms = timer(fn)
        plain_ms = timer(plain, 3)
        bms, by = bound_ms(n_bytes, n_ops, INT32_OPS_S)
        row = dict(shape=f"{form}: {name} {tuple(got.shape)}", ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=None, max_abs_err=err)
        report.setdefault("requant", []).append(row)
        print(f"  requant {row['shape']}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}), exact")
    return worst


def paged_inputs(torch, np, S, T, seed, packed=False, heads=(32, 8, 64)):
    """Seeded inputs of the paged attention at full width (`heads`: H,
    K, hd; granite_3_2b's by default), 8 slots, pages of 16:
    q, the K/V pools (int4-packed with per-head unpack operands when
    `packed`), a permuted table, positions in [0, T - S) with the last
    slot parked at INACTIVE_POS, score scale 1/2048.  -> (args, kw)."""
    from repro_torch.kernels.paged_attention import staged_unpack_rq
    from repro_torch.layers.attention import INACTIVE_POS

    B = N_SLOTS
    H, K, hd = heads
    hd_store = hd // 2 if packed else hd
    pps = T // PAGE
    n_pool = B * pps + 1
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-40, 41, (B, H, S, hd), dtype=torch.int8,
                      device="cuda", generator=g)
    lo, hi = (-128, 128) if packed else (-40, 41)  # any packed byte
    kp = torch.randint(lo, hi, (n_pool, K, PAGE, hd_store),
                       dtype=torch.int8, device="cuda", generator=g)
    vp = torch.randint(-128, 128, (n_pool, K, PAGE, hd_store),
                       dtype=torch.int8, device="cuda", generator=g)
    perm = rng.permutation(np.arange(1, n_pool)).reshape(B, pps)
    table = torch.from_numpy(perm.astype(np.int32)).cuda()
    pos_np = rng.integers(0, T - S, size=B).astype(np.int32)
    pos_np[-1] = INACTIVE_POS  # one parked row
    pos = torch.from_numpy(pos_np).cuda()
    scale = torch.tensor(1.0 / 2048.0, dtype=torch.float32, device="cuda")
    kw = dict(group=H // K)
    if packed:
        kw["k_rq"] = staged_unpack_rq(K).cuda()
        kw["v_rq"] = torch.roll(kw["k_rq"], 3, dims=1)
    return (q, kp, vp, table, pos, scale), kw


def check_paged_attention(torch, np, timer, report, ptxas, packed=False):
    """Kernel vs plain version, int8 pools or int4-packed ones (per-head
    unpack operands from `staged_unpack_rq`), at `PAGED_SHAPES` and at
    the heads of `CONFIGS`, `VARIANTS`, EMBEDS_ARCH (group 8 at hd 128)
    and LLAMA4_ARCH (group 5 at hd 128), S 32 and 1 at T 512.
    Tolerance (`check_kernel`): the kernel's int8 probability image may
    differ from the plain one by one quantum at no more than max(8, 1e-5
    of) its entries, and none by more; the int32 output must equal the
    plain P.V over the kernel's own image and the (unpacked) V view
    exactly, and the plain output itself wherever the two images agree.
    The plain version sums each row in the kernel's order, so a sound
    kernel moves none: both pool modes must move 0 quanta with max
    |diff| 0.  Prints the launch `paged_plan` took and its kernel's
    registers and spills (`ptxas`: the build's report of
    paged_attention.cu)."""
    from repro_torch.kernels import paged_attention, paged_attention_plain
    from repro_torch.kernels.paged_attention import (
        check_kernel, gathered_view, kv4_unpack, paged_plan,
    )

    name = "paged_attention_kv4" if packed else "paged_attention"
    cases = [("", S, T, (32, 8, 64), SEED + 20 + i)
             for i, (S, T) in enumerate(PAGED_SHAPES)]
    cases += [(arch + " ", S, MAX_LEN, CONFIG_HEADS[arch], SEED + 40 + i)
              for i, (arch, S) in enumerate(
                  (a, S) for a in CONFIGS + VARIANTS
                  + (EMBEDS_ARCH, LLAMA4_ARCH) for S in (CHUNK, 1))]
    worst = 0
    for label, S, T, heads, seed in cases:
        args, kw = paged_inputs(torch, np, S, T, seed, packed, heads)
        q, kp, vp, table, pos, scale = args
        B, H, _, hd = q.shape
        K, hd_store = kp.shape[1], kp.shape[3]
        group = kw["group"]
        plan = paged_plan(B, K, group, S, hd, PAGE, T // PAGE, packed)
        rt = plan.rows // 16
        fn = (f"paged_attn_mma{'_packed' if packed else ''}_kernel<{hd}, "
              f"{plan.warps // rt}, {rt}, {int(plan.logits == 'shared')}>")
        print(f"  {name} {label}S={S} T={T} group={group}: {fn}, "
              f"{plan.blocks} blocks of {plan.rows} rows ("
              f"{min(group * S, plan.rows)} filled), {plan.warps} warps, {plan.stages} ring "
              f"tiles of {plan.keys} keys, {plan.smem} B shared, logits "
              f"{plan.logits}; ptxas: {ptxas.get(fn, 'not in the report')}")
        qp = torch.empty((B, H, S, T), dtype=torch.int8, device="cuda")
        got = paged_attention(*args, qp_out=qp, **kw)
        torch.cuda.synchronize()
        what = f"{name} {label}S={S} T={T} H={H} K={K} hd={hd}"
        moved, err = check_kernel(got, qp, *args, what=what, **kw)
        if moved or err:
            raise AssertionError(f"{what}: {moved} probability quanta "
                                 f"moved, max |diff| {err} (0 required)")
        worst = max(worst, err)
        ms = timer(lambda: paged_attention(*args, **kw))
        plain = timer(lambda: paged_attention_plain(*args, **kw), 3)
        # SDPA on the gathered dense (unpacked) view: the yardstick
        k8, v8 = ((kv4_unpack(kp, kw["k_rq"]), kv4_unpack(vp, kw["v_rq"]))
                  if packed else (kp, vp))
        qf = q.to(torch.float16)
        kf = gathered_view(k8, table, group).to(torch.float16)
        vf = gathered_view(v8, table, group).to(torch.float16)
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qf, kf, vf))
        # what these inputs need: query row i of slot b sees keys
        # [0, min(T, pos[b] + i + 1)); a slot's K/V rows past its last
        # row's horizon are never needed
        pos_np = pos.cpu().numpy().astype(np.int64)
        seen = np.minimum(T, pos_np[:, None] + np.arange(1, S + 1))  # (B, S)
        n_bytes = q.numel() + 2 * int(seen[:, -1].sum()) * K * hd_store \
            + 4 * B * (T // PAGE) + 4 * B + 4 * B * H * S * hd \
            + (48 * K if packed else 0)
        n_ops = 2.0 * 2 * H * hd * float(seen.sum())
        bms, by = bound_ms(n_bytes, n_ops, INT8_OPS_S)
        row = dict(shape=f"{label}S={S} T={T} B={B} H={H} K={K} hd={hd}",
                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=lib, max_abs_err=err, quanta_moved=moved,
                   plan=f"{plan.blocks} blocks of {plan.rows} rows, "
                   f"{plan.stages} ring tiles, logits {plan.logits}")
        report.setdefault(name, []).append(row)
        print(f"  {name} {row['shape']}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), SDPA "
              f"{lib:.4f} ms, quanta moved {moved} of {qp.numel()}, "
              f"max |acc diff| {err}")
    return worst


def rank_operands(args, kw, r: int, n: int, packed: bool):
    """Rank r of n's own paged-attention operands, as a kv-sharded rank
    holds them: its K / n kv heads' pools and (6, K / n) unpack
    columns, its contiguous H / n query heads.  -> (args, kw)."""
    q, kp, vp, table, pos, scale = args
    kl, hl = kp.shape[1] // n, q.shape[1] // n
    kr = slice(r * kl, (r + 1) * kl)
    kw_r = dict(kw)
    if packed:
        kw_r.update(k_rq=kw["k_rq"][:, kr].contiguous(),
                    v_rq=kw["v_rq"][:, kr].contiguous())
    return (q[:, r * hl:(r + 1) * hl].contiguous(), kp[:, kr].contiguous(),
            vp[:, kr].contiguous(), table, pos, scale), kw_r


def check_paged_shards(torch, np, timer, report, packed=False):
    """The paged attention per kv-head range (the kv-sharded serving
    path's launch): at granite's geometry (H 32, K 8, hd 64; S 32 and
    1, T 512), for a "model" width n of 2 and 4, each rank's launch on
    its own operands (its K / n kv heads' pools and unpack columns, its
    H / n query heads: `rank_operands`), concatenated along the heads,
    must equal the whole-pool launch exactly.  Rank 0's launch at n 2
    (K 4 of 8, H 16 of 32) is timed beside its plain version, its bound
    and SDPA at that head count.
    -> the largest |diff| over every shard."""
    from repro_torch.kernels import paged_attention, paged_attention_plain
    from repro_torch.kernels.paged_attention import (
        gathered_view, kv4_unpack,
    )

    name = ("paged_attention_kv4" if packed else "paged_attention") \
        + "_shard"
    worst = 0
    for i, S in enumerate(SHARD_S):
        args, kw = paged_inputs(torch, np, S, MAX_LEN, SEED + 60 + i,
                                packed)
        q, kp, vp, table, pos, scale = args
        whole = paged_attention(*args, **kw)
        B, H, _, hd = q.shape
        K, hd_store = kp.shape[1], kp.shape[3]
        for n in SHARD_WIDTHS:
            kl = K // n
            parts = []
            for r in range(n):
                a, k = rank_operands(args, kw, r, n, packed)
                parts.append(paged_attention(*a, **k))
            torch.cuda.synchronize()
            err = int((torch.cat(parts, dim=1).to(torch.int64)
                       - whole.to(torch.int64)).abs().max())
            print(f"  {name} S={S} T={MAX_LEN} n={n}: {n} launches of "
                  f"K {kl} / H {H // n}, concatenated vs the whole-pool "
                  f"launch: max |diff| {err}")
            if err:
                raise AssertionError(f"{name} S={S} n={n}: max |diff| "
                                     f"{err} (0 required)")
            worst = max(worst, err)
        # rank 0 of n 2
        n = 2
        kl, hl = K // n, H // n
        local, kw0 = rank_operands(args, kw, 0, n, packed)
        q0, kp0, vp0 = local[:3]
        ms = timer(lambda: paged_attention(*local, **kw0))
        plain = timer(lambda: paged_attention_plain(*local, **kw0), 3)
        k8, v8 = ((kv4_unpack(kp0, kw0["k_rq"]), kv4_unpack(vp0, kw0["v_rq"]))
                  if packed else (kp0, vp0))
        qf = q0.to(torch.float16)
        kf = gathered_view(k8, table, kw["group"]).to(torch.float16)
        vf = gathered_view(v8, table, kw["group"]).to(torch.float16)
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qf, kf, vf))
        pos_np = pos.cpu().numpy().astype(np.int64)
        seen = np.minimum(MAX_LEN, pos_np[:, None] + np.arange(1, S + 1))
        n_bytes = q0.numel() + 2 * int(seen[:, -1].sum()) * kl * hd_store \
            + 4 * B * (MAX_LEN // PAGE) + 4 * B + 4 * B * hl * S * hd \
            + (48 * kl if packed else 0)
        n_ops = 2.0 * 2 * hl * hd * float(seen.sum())
        bms, by = bound_ms(n_bytes, n_ops, INT8_OPS_S)
        row = dict(shape=f"S={S} T={MAX_LEN} B={B} H={hl} of {H} K={kl} of "
                   f"{K} hd={hd} (rank 0 of 2; n "
                   + " and ".join(map(str, SHARD_WIDTHS))
                   + " concatenated exact)",
                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=lib, max_abs_err=worst)
        report.setdefault(name, []).append(row)
        print(f"  {name} {row['shape']}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), SDPA {lib:.4f} "
              "ms")
    return worst


def qfa_inputs(torch, shape, seed):
    S_q, S_kv, hd, causal, q_offset, bkv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, K = 1, 32, 8
    q, k, v = (torch.randint(-127, 128, (B, h, s, hd), dtype=torch.int8,
                             device="cuda", generator=g)
               for h, s in ((H, S_q), (K, S_kv), (K, S_kv)))
    kw = dict(score_scale=QFA_SCALE, eps_ctx=QFA_EPS, causal=causal,
              q_offset=q_offset, n_rep=H // K, bkv=bkv)
    return q, k, v, kw


def check_quant_flash_attention(torch, np, timer, report, ptxas):
    """Kernel vs plain version at full granite geometry.  Both round
    every float step once in the same order, so the int8 ctx outputs
    must be equal: `check_image`'s form on them, and then 0 quanta
    moved and max |diff| 0 required.  Prints the path `qfa_plan` took and its kernel's registers and
    spills (`ptxas`: the build's report of quant_attention.cu)."""
    from repro_torch.kernels import (
        quant_flash_attention, quant_flash_attention_plain,
    )
    from repro_torch.kernels.paged_attention import check_image
    from repro_torch.kernels.quant_attention import qfa_plan

    worst = 0
    for i, shape in enumerate(QFA_SHAPES):
        S_q, S_kv, hd, causal, q_offset, bkv = shape
        q, k, v, kw = qfa_inputs(torch, shape, SEED + 10 + i)
        plan = qfa_plan(kw["n_rep"], hd, 128, bkv, causal, QFA_SCALE)
        fn = (f"quant_attn_mma_kernel<{hd}, {bkv}>" if plan.path == "mma"
              else f"quant_attn_kernel<{hd}>")
        print(f"  path {plan.path}: {fn}, {plan.heads} heads x {plan.rows} "
              f"rows a block, {plan.smem} B shared, "
              f"ptxas: {ptxas.get(fn, 'not in the report')}")
        got = quant_flash_attention(q, k, v, **kw)
        want = quant_flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        what = (f"quant_flash_attention S_q={S_q} S_kv={S_kv} hd={hd} "
                f"causal={causal} q_offset={q_offset}")
        moved = check_image(got, want, what, unit="ctx")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if moved or err:
            raise AssertionError(f"{what}: {moved} ctx quanta moved, max "
                                 f"|diff| {err} (0 required)")
        worst = max(worst, err)
        ms = timer(lambda: quant_flash_attention(q, k, v, **kw))
        plain = timer(lambda: quant_flash_attention_plain(q, k, v, **kw), 3)
        H, K = q.shape[1], k.shape[1]
        qf = q.to(torch.float16)
        kf = k.repeat_interleave(H // K, dim=1).to(torch.float16)
        vf = v.repeat_interleave(H // K, dim=1).to(torch.float16)
        rows = q_offset + torch.arange(S_q, device="cuda")[:, None]
        mask = torch.arange(S_kv, device="cuda")[None, :] <= rows
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if not causal:
            lib = timer(lambda: sdpa(qf, kf, vf))
        elif q_offset == 0 and S_q == S_kv:
            lib = timer(lambda: sdpa(qf, kf, vf, is_causal=True))
        else:
            lib = timer(lambda: sdpa(qf, kf, vf, attn_mask=mask))
        # keys each row needs: min(S_kv, q_offset + i + 1) under causal
        r = np.arange(S_q, dtype=np.int64)
        seen = (np.minimum(S_kv, q_offset + r + 1).sum() if causal
                else S_q * S_kv)
        n_bytes = 2 * q.numel() + k.numel() + v.numel()
        n_ops = 2.0 * 2 * H * hd * float(seen)
        bms, by = bound_ms(n_bytes, n_ops, INT8_OPS_S)
        # the exact island's floor: every visible score's instructions
        # on the CUDA cores' lanes (not a bound of the tensor cores)
        island = H * float(seen) * ISLAND_INSTR / INT32_OPS_S * 1e3
        row = dict(shape=f"S_q={S_q} S_kv={S_kv} B=1 H={H} K={K} hd={hd} "
                   f"causal={causal} q_offset={q_offset} bkv={bkv}", ms=ms,
                   plain_ms=plain, bound_ms=bms, bound_by=by,
                   library_ms=lib, max_abs_err=err, quanta_moved=moved)
        report.setdefault("quant_flash_attention", []).append(row)
        print(f"  quant_flash_attention {row['shape']}: kernel {ms:.4f} ms,"
              f" plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), island "
              f"floor {island:.4f} ms, SDPA {lib:.4f} ms, ctx quanta moved "
              f"{moved} of {got.numel()}, max |diff| {err}")
    return worst


def phase_entry(torch, kernels):
    """`quant_flash_attention` through its entry point at the two full
    geometry shapes (no serving path calls it): counts set to 0 just
    before, read just after; outputs int8 of the query shape."""
    from repro_torch.kernels import quant_flash_attention

    inputs = [qfa_inputs(torch, shape, SEED + 10 + i)
              for i, shape in enumerate(QFA_SHAPES[:2])]
    kernels.reset_launch_counts()
    outs = [quant_flash_attention(q, k, v, **kw) for q, k, v, kw in inputs]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for (q, _, _, _), out in zip(inputs, outs):
        if out.shape != q.shape or out.dtype != torch.int8:
            raise AssertionError(f"ctx {tuple(out.shape)} {out.dtype}")
    if launches["quant_flash_attention"] != len(inputs):
        raise AssertionError(f"entry point launches: {launches}")
    print(f"  {len(inputs)} calls, launches {launches}")
    return launches


def phase_cnn(torch, np, kernels):
    """The paper's NemoCNN at full width: calibration card vs CPU, then
    each CNN_CELLS deploy's ID forward card vs CPU and its throughput."""
    from torch.utils import _pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.rep import Rep
    from repro_torch.models.cnn import (
        NemoCNN, image_inputs, perturb_bn_np, tables_from_numpy,
    )
    from repro_torch.models.lm import params_to_torch

    class FloatOutputs(TorchDispatchMode):
        """The ops whose output is floating."""

        def __init__(self):
            super().__init__()
            self.ops, self.seen = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen += 1
            if any(isinstance(o, torch.Tensor) and o.is_floating_point()
                   for o in _pytree.tree_leaves(out)):
                self.ops.append(str(func))
            return out

    rng = np.random.default_rng(SEED + 26)
    cnn = NemoCNN()
    p = perturb_bn_np(cnn.init_np(SEED), rng)
    shape = (cnn.img, cnn.img, cnn.in_channels)
    img = rng.integers(0, 256, size=(CNN_IMAGES,) + shape, dtype=np.uint8)
    x = {dev: image_inputs(img, dev) for dev in ("cuda", "cpu")}
    calibs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        calibs[dev] = cnn.calibrate(p, x[dev][0], device=dev)
        secs[dev] = time.perf_counter() - t0
    card, cpu = calibs["cuda"], calibs["cpu"]
    share = {n: max(abs(card.hi[n] - cpu.hi[n]), abs(card.lo[n] - cpu.lo[n]))
             / max(cpu.hi[n] - cpu.lo[n], 1e-6) for n in cpu.hi}
    worst = max(share, key=share.get)
    print(f"  calibration on {CNN_IMAGES} images: card {secs['cuda']:.2f} s,"
          f" CPU {secs['cpu']:.2f} s; largest card-vs-CPU range difference "
          f"{share[worst]:.3e} of the span ({worst}), limit {CALIB_TOL:g}; "
          "ranges " + json.dumps({n: round(card.hi[n], 4) for n in card.hi}))
    if list(card.hi) != list(cpu.hi) or share[worst] > CALIB_TOL:
        raise AssertionError(f"cnn calibration: card != CPU at {worst}")
    with torch.no_grad():
        fp = cnn.apply_float(params_to_torch(p, "cuda"), x["cuda"][0],
                             Rep.FP).double()
    timed = torch.from_numpy(rng.integers(
        0, 256, size=(CNN_TIMED,) + shape, dtype=np.int16) - 128).to(
        torch.int8).cuda()
    n_conv = len(cnn.channels)
    for mode, bits in CNN_CELLS:
        m = NemoCNN(act_bits=bits)
        t0 = time.perf_counter()
        t_np = m.deploy(p, card, bn_mode=mode)
        deploy_s = time.perf_counter() - t0
        tables = {dev: tables_from_numpy(t_np, dev) for dev in x}
        want_trace, got_trace = [], []
        want = m.apply_id(tables["cpu"], x["cpu"][1], want_trace)
        torch.cuda.synchronize()
        floats = FloatOutputs()
        kernels.reset_launch_counts()
        with floats:
            got = m.apply_id(tables["cuda"], x["cuda"][1], got_trace)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        by_shape = dict(kernels.int8_matmul.by_shape)
        what = f"{mode} at act_bits {bits}"
        if floats.ops:
            raise AssertionError(f"cnn {what}: floating outputs on the "
                                 f"card: {sorted(set(floats.ops))}")
        if counts["int8_matmul"] != n_conv + 1 or counts["requant"] != (
                n_conv if mode == "intbn" else 0) or any(
                counts[k] for k in counts
                if k not in ("int8_matmul", "requant")):
            raise AssertionError(f"cnn {what}: launches {counts}")
        if not torch.equal(got.cpu(), want) or len(got_trace) != len(
                want_trace) or not all(
                torch.equal(a.cpu(), b)
                for a, b in zip(got_trace, want_trace)):
            raise AssertionError(f"cnn {what}: card != CPU")
        idl = got.double() * t_np["meta"]["eps_logits"]
        corr = float(torch.corrcoef(torch.stack([fp.flatten(),
                                                 idl.flatten()]))[0, 1])
        agree = float((fp.argmax(-1) == idl.argmax(-1)).double().mean())
        m.apply_id(tables["cuda"], timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CNN_TIMED_RUNS):
            m.apply_id(tables["cuda"], timed)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / CNN_TIMED_RUNS
        peak = torch.cuda.max_memory_allocated() - base
        split = cnn_profile(torch, lambda: m.apply_id(tables["cuda"], timed))
        print(f"  {what}: deploy {deploy_s:.2f} s; card == CPU on "
              f"{CNN_IMAGES} images (int32 logits, {len(got_trace)} block "
              f"and pool int8 activations), no floating output in "
              f"{floats.seen} ops; launches {json.dumps(counts)}, GEMM by "
              f"(M, K, N, out) {json.dumps({str(k): v for k, v in by_shape.items()})}"
              f"; FP vs ID logits correlation {corr:.6f}, argmax agreement "
              f"{agree:.4f}; {CNN_TIMED} images a forward: {ms:.3f} ms, "
              f"{CNN_TIMED / ms * 1e3:.1f} images/s, peak device memory "
              f"over the inputs {peak / 2**20:.1f} MiB")
        busy = sum(v[0] for v in split.values())
        print(f"    profiled forward: device busy {busy:.3f} ms of "
              f"{ms:.3f} (idle share {1 - busy / ms:.3f}); by owner " +
              ", ".join(f"{k} {v[0]:.3f} ms in {v[1]}" for k, v in sorted(
                  split.items(), key=lambda kv: -kv[1][0])))


def cnn_strided_conv(torch, np, kernels) -> None:
    """`QConv2d` at stride 2 at the NemoCNN's widths (16 -> 32 channels
    over its 256 images of 32 x 32): kernel 3 under SAME (XLA's rule:
    one more pad on the high side) and kernel 2 under VALID, zp 0, the
    int32 accumulator and the int8 image fused into the epilogue, each
    through the GEMM kernel on the card (counts set to 0 just before and
    read just after: 2 launches) and its plain version on the CPU, equal
    byte for byte."""
    from repro_torch.core.requant import make_rqt
    from repro_torch.layers.conv import QConv2d

    rng = np.random.default_rng(SEED + 27)
    s = rng.integers(-128, 128, size=(CNN_IMAGES, 32, 32, 16)).astype(
        np.int8)
    for kernel, padding in ((3, "SAME"), (2, "VALID")):
        conv = QConv2d(16, 32, kernel=kernel, stride=2, padding=padding)
        ip, eps_acc = conv.deploy(conv.init_np(rng), 0.02, 0)
        rqt = make_rqt(eps_acc, 0.05, acc_bound=conv.acc_bound())
        out = {}
        for dev in ("cuda", "cpu"):
            d = conv.load(ip, dev)
            r = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in rqt.items()}
            x = torch.from_numpy(s).to(dev)
            kernels.reset_launch_counts()
            out[dev] = (conv.apply_id(d, x).cpu(), conv.apply_id(d, x, r)
                        .cpu())
            if dev == "cuda":
                n = kernels.launch_counts()
        for a, b in zip(out["cuda"], out["cpu"]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"stride-2 conv k {kernel} {padding}: "
                                     "card != CPU")
        if n["int8_matmul"] != 2 or sum(n.values()) != 2:
            raise AssertionError(f"stride-2 conv launches {n}: 2 GEMMs "
                                 "expected")
        print(f"  stride-2 conv, kernel {kernel} {padding}: "
              f"{tuple(out['cuda'][0].shape)} int32 and int8 card == CPU "
              f"byte for byte; card launches {n}")


def cnn_profile(torch, fn) -> dict:
    """One call of `fn` under torch.profiler, device activity only: ->
    {owner: (device ms, kernels)}, the owners the port's GEMM and
    requant kernels and torch's kernels by name (namespaces and template
    arguments cut)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = re.split(r"[<(]", e.key.replace("void ", "").replace(
            "at::native::", "").replace("(anonymous namespace)::", ""))[0]
        ours = re.search(r"gemm_(gemv|wgmma)_kernel", e.key)
        who = ("int8_matmul" if ours else "requant" if "requant_" in e.key
               else "torch " + name[:40])
        ms, n = split.get(who, (0.0, 0))
        split[who] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if not split:
        raise AssertionError("the profiler recorded no device time")
    return split


def make_engine(lm, tables, device, kv_bits=8, *, max_prefills=2,
                **config):
    """An engine at the main cell's geometry; `config` overrides
    `ServingConfig` fields (n_pages, policy, prefix_cache, ...)."""
    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN, paged=True, page_size=PAGE,
              n_pages=N_PAGES, device=device, kv_bits=kv_bits,
              scheduler=SchedulerConfig(prefill_chunk=CHUNK,
                                        max_prefills_per_step=max_prefills))
    kw.update(config)
    return ServingEngine(lm, tables, ServingConfig(**kw))


def serve(lm, tables, requests, device, kv_bits=8, *, telemetry=None,
          warm=False, engine=None):
    """Serve `requests` closed-loop (submit all, drain) on a fresh
    engine, or on `engine`; with `warm`, after `warmup()` and
    `reset_stats()`.  -> ({req_id: tokens}, stats, engine)."""
    import copy

    eng = engine or make_engine(lm, tables, device, kv_bits,
                                telemetry=telemetry)
    if warm:
        eng.warmup()
        eng.reset_stats()
    n0 = len(eng.completed)
    for r in requests:
        eng.submit(copy.deepcopy(r))
    done = eng.run_until_drained()[n0:]
    return {c.req_id: list(c.tokens) for c in done}, eng.stats(), eng


def exp_agreement(torch, stride=EXP_STRIDE):
    """torch.exp on the card against torch.exp on the host CPU over
    every `stride`-th float32 in [-104, 0] (the softmax's exponents;
    below -104 both give 0).  The paged attention takes `island_exp`
    instead, the same on both (`island_exp_agreement`); this count says
    why.  -> (differing, compared)."""
    lo = -(1 << 31)                                     # bits of -0.0
    hi = lo + (0xC2D00000 - 0x80000000) + 1             # bits of -104.0
    step = stride << 26
    bad = n = 0
    for a in range(lo, hi, step):
        bits = torch.arange(a, min(a + step, hi), stride, dtype=torch.int64,
                            device="cuda").to(torch.int32)
        x = bits.view(torch.float32)
        on_card = torch.exp(x).view(torch.int32).cpu()
        on_cpu = torch.exp(x.cpu()).view(torch.int32)
        bad += int((on_card != on_cpu).sum())
        n += bits.numel()
    return bad, n


def island_exp_agreement(torch, stride=61):
    """`island_exp` (the paged attention's exp, in its plain version) on
    the card against the CPU over every `stride`-th float32 in [-104,
    0]: it must agree everywhere (one rounded float32 operation a step).
    -> the number of inputs compared."""
    from repro_torch.kernels.paged_attention import island_exp

    lo = -(1 << 31)
    hi = lo + (0xC2D00000 - 0x80000000) + 1
    step = stride << 22
    n = 0
    for a in range(lo, hi, step):
        bits = torch.arange(a, min(a + step, hi), stride, dtype=torch.int64,
                            device="cuda").to(torch.int32)
        x = bits.view(torch.float32)
        on_card = island_exp(x).view(torch.int32).cpu()
        on_cpu = island_exp(x.cpu()).view(torch.int32)
        bad = int((on_card != on_cpu).sum())
        if bad:
            raise AssertionError(f"island_exp: card != CPU on {bad} inputs")
        n += x.numel()
    return n


def prefill_parity(torch, np, lm, t_np, kv_bits):
    """One unified prefill_chunk (8 rows x 32 tokens over stale random
    pools: chunks inside a page, across and on page boundaries, late in
    the arena, over PAGE_NULL holes, and a parked row) on the card and
    on the CPU: int32 logits and both K/V pools (int4-packed at kv_bits
    4) equal byte for byte."""
    from repro_torch.layers.attention import INACTIVE_POS
    from repro_torch.models.lm import tables_from_numpy

    cfg = lm.cfg
    rng = np.random.default_rng(SEED + 3 + kv_bits)
    pps = MAX_LEN // PAGE
    hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
    shape = (cfg.n_layers, N_PAGES + 1, cfg.n_kv_heads, PAGE, hd)
    k = rng.integers(-128, 128, size=shape).astype(np.int8)
    v = rng.integers(-128, 128, size=shape).astype(np.int8)
    table = rng.permutation(np.arange(1, N_PAGES + 1)).reshape(
        N_SLOTS, pps).astype(np.int32)
    table[6, 10:] = 0          # PAGE_NULL holes past the row's pages
    table[7] = 0
    pos = np.array([0, 5, 14, 16, 100, 250, 120, INACTIVE_POS], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(N_SLOTS, CHUNK)).astype(np.int32)
    last = rng.integers(0, CHUNK, size=N_SLOTS).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        caches = {"k": torch.from_numpy(k.copy()).to(dev),
                  "v": torch.from_numpy(v.copy()).to(dev),
                  "table": torch.from_numpy(table).to(dev)}
        logits = lm.prefill_chunk(
            tables_from_numpy(t_np, dev), torch.from_numpy(toks).to(dev),
            caches, torch.from_numpy(pos).to(dev),
            torch.from_numpy(last).to(dev))
        out[dev] = (logits.cpu(), caches["k"].cpu(), caches["v"].cpu())
    for name, a, b in zip(("logits", "K pool", "V pool"), out["cuda"],
                          out["cpu"]):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{cfg.name} prefill_chunk kv_bits "
                                 f"{kv_bits} {name}: card != CPU")
    print(f"  {cfg.name} prefill_chunk kv_bits {kv_bits} ({N_SLOTS} x "
          f"{CHUNK}, {cfg.n_layers} layers): int32 "
          f"logits {tuple(out['cpu'][0].shape)} and K/V pools "
          f"{tuple(out['cpu'][1].shape)} equal byte for byte")


def calibrated_2_layers(arch, n_layers: int = 2):
    """`arch` at full width cut to `n_layers` layers: -> (lm, its
    init_np float params, the entry point's calibration sample)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import calibration_sample
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(dataclasses.replace(get_config(arch), n_layers=n_layers),
                   max_seq=MAX_LEN)
    return lm, lm.init_np(SEED), calibration_sample(lm.cfg.vocab, MAX_LEN)


def fp_id_agreement(torch, lm, p_card, t_np, sample):
    """The float logits of `sample` (every position) against the int32
    logits of the deployed tables `t_np` on the card (prefill_chunk at
    position 0 over fresh pools, read out at each position in turn):
    -> (Pearson correlation over the real vocab, share of positions
    whose argmax agree)."""
    from repro_torch.models.lm import tables_from_numpy

    B, S = sample.shape
    tok = torch.from_numpy(sample).cuda()
    fp = lm.logits(p_card, lm.apply(p_card, lm.embed_in(p_card, tok)))
    tables = tables_from_numpy(t_np, "cuda")
    pps = -(-S // PAGE)
    caches = lm.init_pools(B * pps, PAGE, "cuda")
    caches["table"] = torch.arange(1, B * pps + 1, dtype=torch.int32,
                                   device="cuda").reshape(B, pps)
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    idl = torch.cat([lm.prefill_chunk(tables, tok, caches, start,
                                      torch.full_like(start, s))
                     for s in range(S)], dim=1)
    V = lm.cfg.vocab
    a, b = fp[..., :V].double(), idl[..., :V].double()
    corr = float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[
        0, 1])
    agree = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    return corr, agree


def phase_calibrate(torch, np):
    """granite_3_2b at full width over 2 layers: calibrate on the card
    and on the CPU from the same init_np params (each range within
    CALIB_TOL of the CPU's span), deploy once from the card's ranges,
    hold the float against the integer logits on the calibration
    sample (and a DEFAULT_RANGES deploy's), then the card-vs-CPU parity
    on that one table set."""
    from repro_torch.models.lm import params_to_torch

    lm, p, sample = calibrated_2_layers("granite_3_2b")
    calibs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        calibs[dev] = lm.calibrate(p, sample, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    card, cpu = calibs["cuda"], calibs["cpu"]
    if list(card.hi) != list(cpu.hi):
        raise AssertionError("card and CPU calibrations observe other names")
    share = {n: max(abs(card.hi[n] - cpu.hi[n]), abs(card.lo[n] - cpu.lo[n]))
             / max(cpu.hi[n] - cpu.lo[n], 1e-6) for n in cpu.hi}
    worst = max(share, key=share.get)
    print(f"  calibration of {sample.shape[0]} x {sample.shape[1]} tokens "
          f"(params to the device, float32 forward, {len(cpu.hi)} ranges "
          f"observed): card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s; "
          f"largest card-vs-CPU range difference {share[worst]:.3e} of the "
          f"span ({worst}), limit {CALIB_TOL:g}")
    if share[worst] > CALIB_TOL:
        raise AssertionError(f"calibration: card != CPU at {worst}")
    spans = sorted((max(abs(cpu.lo[n]), abs(cpu.hi[n])), n) for n in cpu.hi)
    print(f"  ranges (abs max) from {spans[0][0]:.4g} ({spans[0][1]}) to "
          f"{spans[-1][0]:.4g} ({spans[-1][1]})")
    t0 = time.perf_counter()
    t_np = lm.deploy(p, card)
    print(f"  deployed from the card's ranges in "
          f"{time.perf_counter() - t0:.1f} s")
    p_card = params_to_torch(p, "cuda")
    for what, tables in (("calibrated", t_np),
                         ("DEFAULT_RANGES", lm.deploy(p, None))):
        corr, agree = fp_id_agreement(torch, lm, p_card, tables, sample)
        print(f"  FP vs ID logits on the calibration sample, {what} "
              f"tables: correlation {corr:.6f}, argmax agreement "
              f"{agree:.4f}")
    del p_card
    config_parity(torch, np, "granite_3_2b", lm=lm, t_np=t_np)
    return lm, t_np


def phase_parity(torch, np):
    t0 = time.perf_counter()
    bad, total = exp_agreement(torch)
    print(f"  torch.exp on the card vs the CPU: {bad} of {total} float32 "
          f"inputs in [-104, 0] (every {EXP_STRIDE}th) differ "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n = island_exp_agreement(torch)
    print(f"  island_exp (the paged attention's exp) on the card vs the CPU:"
          f" equal on all {n} inputs compared (every 61st float32 in "
          f"[-104, 0]; {time.perf_counter() - t0:.1f} s)")
    for arch in CONFIGS:
        config_parity(torch, np, arch, n_layers=PARITY_LAYERS)


def config_parity(torch, np, arch, lm=None, t_np=None, n_layers=2):
    """`arch` at full width cut to `n_layers` layers (or `lm`'s), one
    table set (calibrated on the card, or `t_np`) on both devices, the
    card against the CPU at kv_bits 8 and 4: one prefill_chunk byte for
    byte, then the engine's tokens on 4 ragged requests."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.models.lm import tables_from_numpy

    t0 = time.perf_counter()
    if t_np is None:
        lm, p, sample = calibrated_2_layers(arch, n_layers)
        t_np = lm.deploy(p, lm.calibrate(p, sample, device="cuda"))
    cfg = lm.cfg
    reqs = ragged_requests(4, cfg.vocab, np.random.default_rng(SEED + 1),
                           prompt_lo=17, prompt_hi=80, gen=6)
    tables = {dev: tables_from_numpy(t_np, dev) for dev in ("cuda", "cpu")}
    print(f"  {arch}: {cfg.n_layers} layer(s) at full width (d "
          f"{cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_padded}): one table set "
          f"calibrated on the card, on both devices in "
          f"{time.perf_counter() - t0:.1f} s")
    for kv_bits in (8, 4):
        t0 = time.perf_counter()
        prefill_parity(torch, np, lm, t_np, kv_bits)
        gpu_tok = serve(lm, tables["cuda"], reqs, "cuda", kv_bits)[0]
        cpu_tok = serve(lm, tables["cpu"], reqs, "cpu", kv_bits)[0]
        print(f"  {arch} {cfg.n_layers}-layer full-width parity, kv_bits "
              f"{kv_bits}: "
              f"{len(reqs)} requests, "
              f"{sum(len(v) for v in gpu_tok.values())} tokens in "
              f"{time.perf_counter() - t0:.1f} s")
        if gpu_tok != cpu_tok:
            raise AssertionError(f"{arch} kv_bits {kv_bits}: card tokens "
                                 f"{gpu_tok} != CPU {cpu_tok}")
        for v in gpu_tok.values():
            if not all(0 <= t < cfg.vocab for t in v):
                raise AssertionError(f"token outside the vocab: {v}")
        print(f"  card == CPU plain versions, token for token: {gpu_tok}")
        if arch == "granite_3_2b":
            cache_parity(torch, np, lm, tables, kv_bits)


class EvictNewestDecode:
    """FCFS plus one scripted eviction: at plan call `at`, the most
    recently admitted decode with at least 2 tokens of budget left
    (so it is still decoding when the eviction runs)."""

    name = "scripted"

    def __init__(self, at: int):
        from repro_torch.serving import FCFSPolicy

        self.inner, self.at, self.calls, self.fired = FCFSPolicy(), at, 0, 0

    def plan(self, view):
        plan = self.inner.plan(view)
        if self.calls == self.at:
            live = [d for d in view.active if d.budget_left >= 2]
            if live:
                plan.preempt.append(
                    max(live, key=lambda d: (d.admit_time, d.req_id)).slot)
                self.fired += 1
        self.calls += 1
        return plan


CACHE_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_pages",
              "cow_splits", "warm_evictions", "n_preempts", "steps")


def cache_parity(torch, np, lm, tables, kv_bits):
    """A system-prompt workload (a 2-page prompt shared by three
    requests with their own suffixes, and its aligned-exact twin, whose
    last position copy-on-writes the last shared page) served with the
    prefix cache on and one scripted preemption (plan call 6), on the
    card and on the CPU: equal tokens, equal prefix and preemption
    counters, and both pools equal byte for byte after the drain."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 9)
    pre = rng.integers(0, lm.cfg.vocab, size=(2 * PAGE,))
    reqs = [Request(np.concatenate([pre, rng.integers(
        0, lm.cfg.vocab, size=(int(rng.integers(10, 40)),))]), 8)
        for _ in range(3)] + [Request(pre.copy(), 8)]
    out = {}
    for dev in ("cuda", "cpu"):
        pol = EvictNewestDecode(6)
        eng = make_engine(lm, tables[dev], dev, kv_bits, policy=pol,
                          prefix_cache=True, cache_keep_pages=16)
        tok, s, _ = serve(lm, tables[dev], reqs, dev, engine=eng)
        out[dev] = (tok, {k: s[k] for k in CACHE_KEYS}, pol.fired,
                    [eng.arena.caches[kv].cpu() for kv in ("k", "v")],
                    eng.arena)
    (gt, gs, gf, gp, ga), (ct, cs, cf, cp, _) = out["cuda"], out["cpu"]
    if gt != ct or gs != cs or gf != cf:
        raise AssertionError(f"kv_bits {kv_bits} prefix cache + preemption: "
                             f"card {gt} {gs} != CPU {ct} {cs}")
    if not (gs["cow_splits"] >= 1 and gs["n_preempts"] == gf == 1
            and gs["prefix_hit_pages"] >= 4 and gs["prefix_hits"] >= 2):
        raise AssertionError(f"kv_bits {kv_bits}: the workload did not "
                             f"split, preempt and hit: {gs}")
    for name, a, b in zip(("K pool", "V pool"), gp, cp):
        if not torch.equal(a, b):
            raise AssertionError(f"kv_bits {kv_bits} prefix cache: {name} "
                                 "card != CPU after the drain")
    if int((ga.refcount != 0).sum()) or ga.committed_pages:
        raise AssertionError("prefix cache: the card's arena is not clean")
    print(f"  granite_3_2b kv_bits {kv_bits} prefix cache + scripted "
          f"preemption: card == CPU in tokens, counters {gs} and both pools "
          f"byte for byte")


def phase_main(torch, np, kernels):
    """-> (launches of run 1 by kernel, the granite lm and tables, the 8
    requests, run 1's tokens by kv_bits)."""
    from repro_torch.launch.serve import deploy_model, ragged_requests

    t0 = time.perf_counter()
    lm, tables = deploy_model("granite_3_2b", reduced=False,
                              max_seq=MAX_LEN, seed=SEED, device="cuda",
                              n_layers=MAIN_LAYERS)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    print(f"  calibrated and deployed granite_3_2b ({lm.cfg.n_layers} of 40 "
          f"layers, d {lm.cfg.d_model}, vocab {lm.cfg.vocab_padded}) layer "
          f"by layer in {deploy_s:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reqs = ragged_requests(8, lm.cfg.vocab, np.random.default_rng(SEED + 2),
                           prompt_lo=17, prompt_hi=300, gen=16)
    launches, tok8, s2 = serve_twice(torch, kernels, lm, tables, reqs, 8)
    profile_run(torch, lm, tables, reqs, s2["wall_s"])
    print("  the same requests and tables over int4-packed pools "
          "(kv_bits 4):")
    launches4, tok4, s2 = serve_twice(torch, kernels, lm, tables, reqs, 4)
    profile_run(torch, lm, tables, reqs, s2["wall_s"], kv_bits=4)
    launches["paged_attention_kv4"] = launches4["paged_attention_kv4"]
    same = sum(a == b for r in tok8 for a, b in zip(tok8[r], tok4[r]))
    total = sum(len(v) for v in tok8.values())
    print(f"  kv_bits 4 tokens equal to the int8 run's at {same} of {total}"
          f" positions ({same / total:.3f}; lossy by design: int4 K/V on "
          "the calibrated per-kv-head ranges)")
    return launches, lm, tables, reqs, {8: tok8, 4: tok4}


def print_stats(what: str, s: dict) -> None:
    """An engine's full stats(): the latency roll-up in ms, then every
    other key."""
    ms = {k: round(v * 1e3, 3) for k, v in s.items() if k.endswith("_s")
          and k not in ("wall_s", "throughput_tok_s")}
    print(f"  {what} stats (ms): {json.dumps(ms)}")
    print(f"  {what} stats: " + json.dumps(
        {k: v for k, v in s.items() if k not in ms}))


def phase_open_loop(torch, np, kernels, lm, tables):
    """The granite engine under open-loop load: OPEN_LOOP_N ragged
    requests served closed-loop on a warmed engine (its requests per
    second set the rate), then, after `reset_stats()`, the same
    requests arriving by `poisson_arrivals` at OPEN_LOOP_RATE times
    that rate through `run_open_loop` with the TTFT and ITL SLOs.
    Every request's tokens must equal its closed-loop tokens.  -> (the
    requests, their closed-loop tokens in order, the closed loop's
    req/s)."""
    import copy

    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving import poisson_arrivals, run_open_loop

    reqs = ragged_requests(OPEN_LOOP_N, lm.cfg.vocab,
                           np.random.default_rng(SEED + 5), prompt_lo=17,
                           prompt_hi=300, gen=16)
    closed, sc, eng = serve(lm, tables, reqs, "cuda", warm=True)
    rps = sc["n_completed"] / sc["wall_s"]
    print(f"  closed loop: {sc['n_completed']} requests in "
          f"{sc['wall_s']:.3f} s = {rps:.3f} req/s, {sc['steps']} steps, "
          f"p99 TTFT {sc['p99_ttft_s'] * 1e3:.1f} ms, p99 ITL "
          f"{sc['p99_itl_s'] * 1e3:.1f} ms")
    eng.reset_stats()
    rate = OPEN_LOOP_RATE * rps
    arrivals = poisson_arrivals(OPEN_LOOP_N, rate,
                                np.random.default_rng(SEED + 6))
    kernels.reset_launch_counts()
    res = run_open_loop(eng, copy.deepcopy(reqs), arrivals,
                        slo_ttft_s=SLO_TTFT_S, slo_itl_s=SLO_ITL_S)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"  open loop at {rate:.3f} req/s offered ({OPEN_LOOP_RATE} x "
          f"the closed loop), SLOs TTFT {SLO_TTFT_S} s / ITL {SLO_ITL_S} "
          f"s: " + json.dumps(res.to_dict()))
    print_stats("open loop", eng.stats())
    print(f"  open loop launches {launches}")
    first = min(closed)
    opened = {c.req_id: list(c.tokens) for c in res.completions}
    if res.n_completed != OPEN_LOOP_N or sorted(opened) != list(
            range(first + OPEN_LOOP_N, first + 2 * OPEN_LOOP_N)):
        raise AssertionError(f"open loop completed {sorted(opened)}")
    for i in range(OPEN_LOOP_N):
        if opened[first + OPEN_LOOP_N + i] != closed[first + i]:
            raise AssertionError(f"open-loop request {i}: tokens differ "
                                 "from the closed loop's")
    if launches["int8_matmul"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"open loop launched {launches}")
    print(f"  open-loop tokens equal the closed loop's for all "
          f"{OPEN_LOOP_N} requests")
    return reqs, [closed[first + i] for i in range(OPEN_LOOP_N)], rps


def check_path_launches(launches: dict, kv_bits: int, what: str) -> None:
    """Every kernel of the kv_bits path launched, and no other."""
    path = PATH_KERNELS[kv_bits]
    if any(launches[n] == 0 for n in path) or any(
            c for n, c in launches.items() if n not in path):
        raise AssertionError(f"{what}: launches {launches} are not the "
                             f"path's {path}")


def phase_prefix(torch, np, kernels, lm, tables):
    """The shared-prefix-vs-cold lane at the main geometry: 3 x N_SLOTS
    requests sharing one PREFIX_LEN-token system prompt, each with its
    own SUFFIX_LEN-token suffix and 16 new tokens, over a pool that
    holds two cold requests and 2 pages; served cold, then with the
    prefix cache (keep = the pool), each on a fresh warmed engine that
    may admit every request in one step.  Tokens must be equal request
    by request, the cache must serve pages, and the arena must be clean
    after the drain."""
    from repro_torch.serving import shared_prefix_workload

    n, gen = PREFIX_PER_SLOT * N_SLOTS, 16
    n_pages = 2 * -(-(PREFIX_LEN + SUFFIX_LEN + gen - 1) // PAGE) + 2
    reqs = shared_prefix_workload(
        n, lm.cfg.vocab, np.random.default_rng(SEED + 7),
        prefix_len=PREFIX_LEN, suffix_len=SUFFIX_LEN, max_new_tokens=gen)
    lanes = {}
    for lane, kw in (("cold", {}), ("shared", dict(
            prefix_cache=True, cache_keep_pages=n_pages))):
        eng = make_engine(lm, tables, "cuda", n_pages=n_pages,
                          max_prefills=n, **kw)
        eng.warmup()
        eng.reset_stats()
        kernels.reset_launch_counts()
        tok, s, _ = serve(lm, tables, reqs, "cuda", engine=eng)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_path_launches(launches, 8, lane)
        print(f"  {lane} launches {launches}")
        if sorted(tok) != list(range(n)) or any(
                len(v) != gen for v in tok.values()):
            raise AssertionError(f"{lane}: not every request finished")
        lanes[lane] = (tok, s, eng.arena)
        print_stats(f"prefix {lane}", s)
    (ct, cs, _), (st, ss, arena) = lanes["cold"], lanes["shared"]
    if st != ct:
        bad = [i for i in range(n) if st[i] != ct[i]]
        raise AssertionError(f"shared tokens differ from cold at {bad}")
    if ss["prefix_hit_pages"] <= 0:
        raise AssertionError("the shared lane never hit the cache")
    if int((arena.refcount != 0).sum()) or arena.committed_pages:
        raise AssertionError("shared lane: refcounts or commitments left "
                             "after the drain")
    print(f"  {n} requests, {PREFIX_LEN}-token system prompt, {n_pages} "
          f"pages: mean TTFT cold {cs['mean_ttft_s'] * 1e3:.1f} ms / shared "
          f"{ss['mean_ttft_s'] * 1e3:.1f} ms (ttft_uplift "
          f"{cs['mean_ttft_s'] / ss['mean_ttft_s']:.3f}), max_active cold "
          f"{cs['max_active']} / shared {ss['max_active']} "
          f"(concurrency_uplift {ss['max_active'] / cs['max_active']:.3f}), "
          f"steps {cs['steps']} / {ss['steps']}, tok/s "
          f"{cs['throughput_tok_s']:.2f} / {ss['throughput_tok_s']:.2f}; "
          f"prefix hits {ss['prefix_hits']}, hit pages "
          f"{ss['prefix_hit_pages']}, cow splits {ss['cow_splits']}")
    print(f"  shared tokens equal cold for all {n} requests")


def phase_preempt(torch, np, kernels, lm, tables, reqs, run1, kv_bits,
                  depth=0):
    """`PrioritySLOPolicy(preempt=True)`: the main phase's requests at
    class 0; once all of them decode, N_URGENT class-1 requests, each
    of which evicts a class-0 decode.  Every class-0 request must end
    with its main run 1 tokens (every resume passes the engine's
    resume-parity oracle, which raises otherwise).  `depth` is the
    engine's dispatch depth.  -> ({req_id: tokens}, stats)."""
    import copy

    from repro_torch.launch.serve import ragged_requests
    from repro_torch.serving import PrioritySLOPolicy

    eng = make_engine(lm, tables, "cuda", kv_bits, dispatch_depth=depth,
                      policy=PrioritySLOPolicy(preempt=True))
    kernels.reset_launch_counts()
    for r in reqs:
        eng.submit(copy.deepcopy(r))
    while len(eng.active) < len(reqs):
        eng.step()
        if eng.completed or eng.stats()["steps"] > 100:
            raise AssertionError("a class-0 request finished before all "
                                 "of them decoded")
    urgent = ragged_requests(N_URGENT, lm.cfg.vocab,
                             np.random.default_rng(SEED + 8), prompt_lo=17,
                             prompt_hi=300, gen=16)
    for r in urgent:
        r.priority = 1
        eng.submit(r)
    done = {c.req_id: c for c in eng.run_until_drained()}
    torch.cuda.synchronize()
    s = eng.stats()
    launches = kernels.launch_counts()
    what = f"preempt kv_bits {kv_bits} depth {depth}"
    check_path_launches(launches, kv_bits, what)
    print(f"  {what} launches {launches}")
    if s["n_preempts"] < N_URGENT:
        raise AssertionError(f"only {s['n_preempts']} preemptions")
    for rid, tokens in run1.items():
        if list(done[rid].tokens) != tokens:
            raise AssertionError(f"kv_bits {kv_bits} class-0 request {rid}:"
                                 " tokens differ from main run 1")
    if len(done) != len(reqs) + N_URGENT or any(
            c.n_generated != 16 for c in done.values()):
        raise AssertionError("preempt: not every request finished")
    print(f"  {what}: {s['n_preempts']} preemptions, evicted "
          f"requests {sorted(r for r, c in done.items() if c.n_preempts)}, "
          f"{s['steps']} steps, {s['throughput_tok_s']:.2f} tok/s; class-0 "
          f"tokens equal main run 1 for all {len(reqs)}")
    print_stats(what, s)
    return {r: list(c.tokens) for r, c in done.items()}, s


def phase_async(torch, np, kernels, lm, tables, reqs, run1, preempt0):
    """Dispatch depth 1 on the main granite tables.  The 8-request cell
    at kv_bits 8 with depth 0 and depth 1 in turns (0, 1, 1, 0: the
    host's speed drifts over a run), and at kv_bits 4 at depth 1 (its
    depth 0 is main run 2, the same setup), each run on a fresh warmed
    engine with telemetry on and the counts set to 0 just before and
    read just after (every kernel of the path launched); then the
    preempt cell at kv_bits 8 at depth 1.  Tokens must equal depth 0's
    request by request (main run 1; the depth-0 preempt cell).  Each
    run prints tok/s and the host's ms per step in the admission,
    harvest and dispatch phases."""
    from repro_torch.serving import Telemetry

    for kv_bits, depths in ((8, (0, 1, 1, 0)), (4, (1,))):
        rate = {0: [], 1: []}
        for depth in depths:
            tel = Telemetry()
            eng = make_engine(lm, tables, "cuda", kv_bits, telemetry=tel,
                              dispatch_depth=depth)
            kernels.reset_launch_counts()
            tok, s, _ = serve(lm, tables, reqs, "cuda", engine=eng,
                              warm=True)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            what = f"depth {depth} kv_bits {kv_bits}"
            check_path_launches(launches, kv_bits, what)
            if tok != run1[kv_bits]:
                raise AssertionError(f"{what}: tokens differ from main "
                                     "run 1's (depth 0)")
            if s["dispatch_depth"] != depth or eng.queue.pending:
                raise AssertionError(f"{what}: a step left in flight")
            ph = tel.metrics()["phase_mean_s"]
            rate[depth].append(s["throughput_tok_s"])
            print(f"  {what} (warmed, telemetry on): "
                  f"{s['throughput_tok_s']:.2f} tok/s, {s['steps']} steps "
                  f"in {s['wall_s']:.3f} s; host ms per step: " + ", ".join(
                      f"{k} {ph.get(k, 0.0) * 1e3:.3f}" for k in (
                          "admission", "harvest", "plan_chunks",
                          "unified_dispatch"))
                  + f"; launches {launches}")
        print(f"  kv_bits {kv_bits}: tokens equal main run 1's in all "
              f"{len(depths)} runs; tok/s depth 0 {rate[0]}, depth 1 "
              f"{rate[1]}")
    tok, _ = phase_preempt(torch, np, kernels, lm, tables, reqs, run1[8], 8,
                           depth=1)
    if tok != preempt0:
        raise AssertionError("preempt cell: depth 1 tokens differ from "
                             "depth 0's")
    print(f"  preempt cell depth 1 tokens equal depth 0's for all "
          f"{len(tok)} requests")


def slot_parity(torch, np, lm, t_np, what, reqs, **config):
    """One table set on both devices over `SlotArena` (`config` picks
    the mode): the engine's tokens, and both slot pools after the drain
    (every page, the trash page included), equal byte for byte.  -> the
    tokens."""
    from repro_torch.models.lm import tables_from_numpy

    out = {}
    for dev in ("cuda", "cpu"):
        t = tables_from_numpy(t_np, dev)
        tok, _, eng = serve(lm, t, reqs, dev, engine=make_engine(
            lm, t, dev, paged=False, **config))
        out[dev] = (tok, eng.arena.caches["k"].cpu(),
                    eng.arena.caches["v"].cpu())
        del eng, t
    if out["cuda"][0] != out["cpu"][0]:
        raise AssertionError(f"{what}: card tokens {out['cuda'][0]} != CPU "
                             f"{out['cpu'][0]}")
    for name, a, b in zip(("K", "V"), out["cuda"][1:], out["cpu"][1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} slot pool card != CPU")
    print(f"  {what}: {len(reqs)} requests, "
          f"{sum(len(v) for v in out['cuda'][0].values())} tokens equal on "
          f"the card and the CPU; slot pools {tuple(out['cuda'][1].shape)} "
          "equal byte for byte")
    return out["cuda"][0]


def phase_whole_prompt(torch, np, kernels, lm, tables, reqs, run1, lm2,
                       t2_np):
    """The reference's default arena (`SlotArena`) and whole-prompt
    serving on granite_3_2b: the calibrate phase's 2-layer tables card
    vs CPU (chunked and bucketed), the main tables over `SlotArena`
    chunked and bucketed with tokens equal to main run 1's (paged), and
    `serve_batch` equal to the engine."""
    from repro_torch.launch.serve import ragged_requests, serve_batch
    from repro_torch.serving import SchedulerConfig

    small = ragged_requests(4, lm2.cfg.vocab, np.random.default_rng(SEED + 1),
                            prompt_lo=17, prompt_hi=80, gen=6)
    for chunk in (CHUNK, 0):
        slot_parity(torch, np, lm2, t2_np,
                    f"granite 2-layer SlotArena prefill_chunk {chunk}", small,
                    scheduler=SchedulerConfig(prefill_chunk=chunk,
                                              prefill_bucket=BUCKET))
    for chunk in (CHUNK, 0):
        what = f"SlotArena prefill_chunk {chunk}"
        eng = make_engine(lm, tables, "cuda", paged=False,
                          scheduler=SchedulerConfig(prefill_chunk=chunk,
                                                    prefill_bucket=BUCKET))
        kernels.reset_launch_counts()
        tok, s, _ = serve(lm, tables, reqs, "cuda", engine=eng)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_path_launches(launches, 8, what)
        if tok != run1:
            raise AssertionError(f"{what}: tokens differ from main run 1's")
        print(f"  {what} ({eng._prefill_mode}): {s['steps']} steps, "
              f"{s['throughput_tok_s']:.2f} tok/s, p50 TTFT "
              f"{s['p50_ttft_s'] * 1e3:.1f} ms, p50 ITL "
              f"{s['p50_itl_s'] * 1e3:.1f} ms, arena {s['arena']} "
              f"({s['arena_positions']} positions); launches {launches}; "
              "tokens equal main run 1's (paged)")
        del eng
    n, gen = N_SLOTS, 16
    prompts = np.random.default_rng(SEED + 8).integers(
        0, lm.cfg.vocab, size=(n, BATCH_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    want = serve_batch(lm, tables, prompts, gen).cpu()
    t_batch = time.perf_counter() - t0
    eng = make_engine(lm, tables, "cuda", paged=False,
                      max_len=BATCH_PROMPT + gen, max_prefills=n)
    ids = [eng.submit(prompts[i], max_new_tokens=gen) for i in range(n)]
    done = {c.req_id: c.tokens for c in eng.run_until_drained()}
    for i, rid in enumerate(ids):
        if done[rid] != want[i].tolist():
            raise AssertionError(f"serve_batch row {i} != the engine's")
    print(f"  serve_batch ({n} x {BATCH_PROMPT} prompts, {gen} tokens in "
          f"lockstep, {t_batch:.2f} s) equals the engine's tokens")


def phase_olmoe(torch, np, kernels):
    """olmoe_1b_7b: MOE_PARITY_LAYERS at full width card vs CPU, then the model
    at full width over MOE_LAYERS layers served as the 8-request cell
    over `SlotArena` (run 1 counted, run 2 warmed with telemetry on)
    and over the paged arena.  -> run 1's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import (
        calibration_sample, deploy_model, ragged_requests,
    )
    from repro_torch.models.lm import DecoderLM, tables_from_numpy
    from repro_torch.serving import Telemetry

    t0 = time.perf_counter()
    lm2 = DecoderLM(dataclasses.replace(get_config(MOE_ARCH),
                                        n_layers=MOE_PARITY_LAYERS),
                    max_seq=MAX_LEN)
    p = lm2.init_np(SEED)
    t_np = lm2.deploy(p, lm2.calibrate(
        p, calibration_sample(lm2.cfg.vocab, MAX_LEN), device="cuda"))
    del p
    cfg = lm2.cfg
    print(f"  {cfg.n_layers} layer(s) at full width (d {cfg.d_model}, "
          f"{cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, hd {cfg.hd}, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}) "
          f"calibrated on the card and deployed in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 9)
    prompt = rng.integers(0, cfg.vocab, size=(1, 200)).astype(np.int32)
    xs = {"prefill group": rng.integers(-128, 128, size=(1, 254, cfg.d_model)),
          "decode group": rng.integers(-128, 128, size=(1, N_SLOTS,
                                                        cfg.d_model))}
    moe = lm2.block()._subs()["moe"]
    out = {}
    for dev in ("cuda", "cpu"):
        t = tables_from_numpy(t_np, dev)
        caches = lm2.init_caches(1, MAX_LEN, device=dev)
        logits = lm2.prefill(t, torch.from_numpy(prompt).to(dev), caches)
        routes = [moe.route_id(t["layers"][0]["moe"], torch.from_numpy(
            x.astype(np.int8)).to(dev))[:2] for x in xs.values()]
        out[dev] = ([logits.cpu(), caches["k"].cpu(), caches["v"].cpu()]
                    + [r.cpu() for pair in routes for r in pair])
    names = ["prefill logits", "K pool", "V pool"] + [
        f"{g} {w}" for g in xs for w in ("gate images", "expert picks")]
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"olmoe parity {name}: card != CPU")
    print(f"  olmoe {cfg.n_layers}-layer: a 200-token exact prefill's "
          f"int32 logits and slot pools, and layer 0's gate images and "
          f"expert picks at a 254-token and an {N_SLOTS}-token group, "
          "equal on the card and the CPU")
    small = ragged_requests(4, cfg.vocab, np.random.default_rng(SEED + 1),
                            prompt_lo=17, prompt_hi=200, gen=6)
    slot_parity(torch, np, lm2, t_np, f"olmoe {cfg.n_layers}-layer exact "
                "mode", small)
    del t_np, lm2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm, tables = deploy_model(MOE_ARCH, reduced=False, max_seq=MAX_LEN,
                              seed=SEED, device="cuda", n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    cfg = lm.cfg
    print(f"  calibrated and deployed {MOE_ARCH} ({cfg.n_layers} layers, "
          f"{cfg.param_count()} parameters of which "
          f"{cfg.active_param_count()} active a token) layer by layer in "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reqs = ragged_requests(8, cfg.vocab, np.random.default_rng(SEED + 2),
                           prompt_lo=17, prompt_hi=300, gen=16)
    kernels.reset_launch_counts()
    tok1, s1, eng = serve(lm, tables, reqs, "cuda",
                          engine=make_engine(lm, tables, "cuda", paged=False))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if len(tok1) != len(reqs) or any(len(v) != 16 for v in tok1.values()):
        raise AssertionError(f"olmoe: not every request finished: {tok1}")
    if not all(0 <= t < cfg.vocab for v in tok1.values() for t in v):
        raise AssertionError("olmoe: a token outside the vocab")
    check_path_launches(launches, "moe", "olmoe run 1")
    # every dispatch (a decode, or a B=1 prefill) runs the head GEMM once
    # and each layer's three expert GEMMs once each
    dispatches = sum(n for (_, _, N, _), n in
                     kernels.int8_matmul.by_shape.items()
                     if N == cfg.vocab_padded)
    if launches["int8_matmul_grouped"] != 3 * cfg.n_layers * dispatches:
        raise AssertionError(f"grouped launches {launches} are not 3 a "
                             f"layer in each of {dispatches} dispatches")
    print(f"  olmoe run 1 (SlotArena, exact prefill): prompts "
          f"{[r.prompt_len for r in reqs]}, {s1['steps']} steps, "
          f"launches {launches} = " + ", ".join(
              f"{k} {v / s1['steps']:.1f}" for k, v in launches.items() if v)
          + " a step; grouped GEMM launches by (groups, C, K, N): "
          + json.dumps({str(k): v for k, v in sorted(
              kernels.int8_matmul_grouped.by_shape.items())})
          + f"; {dispatches} dispatches")
    print(f"  olmoe run 1: {s1['n_generated']} tokens in {s1['wall_s']:.3f} s"
          f" = {s1['throughput_tok_s']:.2f} tok/s, p50 TTFT "
          f"{s1['p50_ttft_s'] * 1e3:.1f} ms, p50 ITL "
          f"{s1['p50_itl_s'] * 1e3:.1f} ms")
    del eng
    tel = Telemetry()
    tok2, s2, _ = serve(lm, tables, reqs, "cuda", warm=True, engine=make_engine(
        lm, tables, "cuda", paged=False, telemetry=tel))
    if tok2 != tok1:
        raise AssertionError("olmoe run 2 (telemetry on) gave other tokens")
    m = tel.metrics()
    print_stats("olmoe run 2 (warmed, telemetry on)", s2)
    print("  olmoe run 2 host ms per step phase (mean over the steps it ran "
          "in; total): " + ", ".join(
              f"{ph} {m['phase_mean_s'][ph] * 1e3:.2f} "
              f"({m['phase_total_s'][ph] * 1e3:.1f})"
              for ph in m["phase_mean_s"])
          + f"; step wall {sum(st['wall_s'] for st in m['steps']) * 1e3:.1f} "
          f"over {m['n_steps']} steps")
    tok3, s3, _ = serve(lm, tables, reqs, "cuda")
    if tok3 != tok1:
        raise AssertionError("olmoe over the paged arena gave other tokens")
    print(f"  olmoe over the paged arena (exact prefill): {s3['steps']} "
          f"steps, {s3['throughput_tok_s']:.2f} tok/s, tokens equal "
          f"SlotArena's; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  olmoe tokens: {tok1}")
    return launches


def ssm_state_parity(torch, np, lm2, t_np):
    """SSM_ARCH at SSM_PARITY_LAYERS: one SSM_PREFILL-token prefill and a
    decode step after it, card vs CPU: int32 logits and the conv and h
    state leaves byte for byte."""
    from repro_torch.models.lm import tables_from_numpy

    rng = np.random.default_rng(SEED + 11)
    prompt = rng.integers(0, lm2.cfg.vocab, size=(1, SSM_PREFILL))
    out = {}
    for dev in ("cuda", "cpu"):
        t = tables_from_numpy(t_np, dev)
        caches = lm2.init_caches(1, MAX_LEN, device=dev)
        tok = torch.from_numpy(prompt.astype(np.int32)).to(dev)
        logits = lm2.prefill(t, tok, caches)
        # copies: on the CPU .cpu() is the tensor itself, which the
        # decode step then advances in place
        state = [caches["conv"].cpu().clone(), caches["h"].cpu().clone()]
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
        logits2 = lm2.decode_step(t, nxt, caches, torch.full(
            (1,), SSM_PREFILL, dtype=torch.int32, device=dev))
        out[dev] = [logits.cpu(), *state, logits2.cpu(), caches["conv"].cpu(),
                    caches["h"].cpu()]
        del t, caches
    names = ["prefill logits", "prefill conv", "prefill h", "decode logits",
             "decode conv", "decode h"]
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        if a.dtype != b.dtype or not torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b):
            raise AssertionError(f"ssm parity {name}: card != CPU")
    print(f"  ssm parity: a {SSM_PREFILL}-token prefill (one scan chunk) "
          "and a decode step after it: int32 logits, the conv state and "
          f"the float32 h state {tuple(out['cpu'][2].shape)} equal on the "
          "card and the CPU bit for bit")


def ssm_engine_parity(torch, np, lm2, t_np, reqs):
    """The 2-layer table set served on both devices over `SlotArena` and
    the paged arena: tokens, and the arenas' conv and h state after the
    drain, equal byte for byte.  -> the tokens."""
    from repro_torch.models.lm import tables_from_numpy

    toks = None
    for paged in (False, True):
        out = {}
        for dev in ("cuda", "cpu"):
            t = tables_from_numpy(t_np, dev)
            tok, _, eng = serve(lm2, t, reqs, dev, engine=make_engine(
                lm2, t, dev, paged=paged))
            out[dev] = (tok, eng.arena.caches["conv"].cpu(),
                        eng.arena.caches["h"].cpu().view(torch.int32))
            del eng, t
        what = ("ssm parity over "
                + ("the paged arena" if paged else "SlotArena"))
        if out["cuda"][0] != out["cpu"][0]:
            raise AssertionError(f"{what}: card tokens {out['cuda'][0]} != "
                                 f"CPU {out['cpu'][0]}")
        for name, a, b in zip(("conv", "h"), out["cuda"][1:],
                              out["cpu"][1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} state card != CPU")
        if toks is not None and out["cuda"][0] != toks:
            raise AssertionError(f"{what}: tokens differ from SlotArena's")
        toks = out["cuda"][0]
        print(f"  {what}: {len(reqs)} requests (prompts "
              f"{[r.prompt_len for r in reqs]}), "
              f"{sum(len(v) for v in toks.values())} tokens equal on the "
              "card and the CPU; conv state "
              f"{tuple(out['cpu'][1].shape)} and h state "
              f"{tuple(out['cpu'][2].shape)} equal bit for bit")
    return toks


def requant_forms_ssm(kernels, cfg, dispatches: int, total: int) -> None:
    """An ssm run's requant launches by form: per layer and dispatch the
    conv's requant (rqt) and SiLU LUT (act), the gate and the Add."""
    by = kernels.requant.by_form
    n = cfg.n_layers * dispatches
    want = {"rqt": n, "act": n, "gate": n, "add": n}
    print("  requant launches by form: " + ", ".join(
        f"{k} {v}" for k, v in sorted(by.items())))
    if by != want or total != 4 * n:
        raise AssertionError(f"requant launches {by} (total {total}) are "
                             f"not {want}")


def bf16_island_parity(torch, np, lm, t_np, what, chunk):
    """The bf16 scan island (``ssm_island_dtype="bf16"``) card vs CPU on
    `lm`'s tables under ``ssm_chunk=chunk``: a one-chunk prefill (the
    bf16 branch) with int32 logits and the conv and h state bit for bit
    (on the card h apart from the float32 island's), then a two-chunk
    prompt served at its exact length over `SlotArena`: tokens and the
    arena's state bit for bit."""
    from repro_torch.launch import variants
    from repro_torch.launch.serve import serve_scenario
    from repro_torch.models.lm import tables_from_numpy

    t0 = time.perf_counter()
    n_pre, n_prompt = chunk, 2 * chunk
    rng = np.random.default_rng(SEED + 13)
    prompt = rng.integers(0, lm.cfg.vocab, size=(1, n_pre)).astype(
        np.int32)
    isl = dict(ssm_island_dtype="bf16", ssm_chunk=chunk)
    sc = dict(config=dict(n_slots=2, max_len=MAX_LEN),
              variants=isl,
              requests=[(rng.integers(0, lm.cfg.vocab,
                                      size=(n_prompt,)).tolist(),
                         SSM_PARITY_GEN)])
    out = {}
    for dev in ("cuda", "cpu"):
        t = tables_from_numpy(t_np, dev)
        res = {}
        for dtype in ("bf16", "f32") if dev == "cuda" else ("bf16",):
            caches = lm.init_caches(1, MAX_LEN, device=dev)
            with variants.use_variants(**dict(isl, ssm_island_dtype=dtype)):
                logits = lm.prefill(t, torch.from_numpy(prompt).to(dev),
                                    caches)
            res[dtype] = [logits.cpu(), caches["conv"].cpu(),
                          caches["h"].cpu().view(torch.int32)]
        out[dev] = (res, serve_scenario(lm, t, sc, device=dev))
        del t, caches
    (rc, sc_card), (rh, sc_cpu) = out["cuda"], out["cpu"]
    for name, a, b in zip(("logits", "conv", "h"), rc["bf16"], rh["bf16"]):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} bf16 island prefill {name}: card "
                                 "!= CPU")
    n_h = int((rc["bf16"][2] != rc["f32"][2]).sum())
    if n_h == 0:
        raise AssertionError(f"{what}: the bf16 island's h equals the "
                             "float32 island's")
    if sc_card["tokens"] != sc_cpu["tokens"]:
        raise AssertionError(f"{what} bf16 island serve: card tokens "
                             f"{sc_card['tokens']} != CPU {sc_cpu['tokens']}")
    for k in ("conv", "h"):
        if not torch.equal(sc_card["pools"][k], sc_cpu["pools"][k]):
            raise AssertionError(f"{what} bf16 island serve: {k} state "
                                 "card != CPU")
    print(f"  {what} bf16 island: a {n_pre}-token prefill's logits, "
          f"conv and h {tuple(rh['bf16'][2].shape)} equal on the card and "
          f"the CPU bit for bit ({n_h} h entries apart from the float32 "
          f"island's); a {n_prompt}-token prompt served at its exact "
          f"length: tokens {sc_card['tokens']} and the arena's state equal "
          f"on the card and the CPU ({time.perf_counter() - t0:.1f} s)")


def phase_ssm(torch, np, kernels):
    """SSM_ARCH: SSM_PARITY_LAYERS at full width card vs CPU (a
    one-chunk prefill and a decode step; the engine over both arenas),
    then the model at
    full width over SSM_LAYERS layers served as the 8-request cell over
    `SlotArena` (warmed; counts set to 0 just before and read just
    after) and over the paged arena."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import (
        calibration_sample, deploy_model, ragged_requests,
    )
    from repro_torch.layers.ssm import QMamba1
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serving import Telemetry

    t0 = time.perf_counter()
    lm2 = DecoderLM(dataclasses.replace(get_config(SSM_ARCH),
                                        n_layers=SSM_PARITY_LAYERS),
                    max_seq=MAX_LEN)
    p = lm2.init_np(SEED)
    t_np = lm2.deploy(p, lm2.calibrate(
        p, calibration_sample(lm2.cfg.vocab, MAX_LEN), device="cuda"))
    del p
    cfg = lm2.cfg
    print(f"  {cfg.n_layers} layer(s) at full width (d {cfg.d_model}, d_inner "
          f"{cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, rank "
          f"{-(-cfg.d_model // 16)}, vocab {cfg.vocab_padded}) calibrated on "
          f"the card and deployed in {time.perf_counter() - t0:.1f} s")
    ssm_state_parity(torch, np, lm2, t_np)
    small = ragged_requests(3, cfg.vocab, np.random.default_rng(SEED + 1),
                            prompt_lo=9, prompt_hi=40, gen=SSM_PARITY_GEN)
    ssm_engine_parity(torch, np, lm2, t_np, small)
    bf16_island_parity(torch, np, lm2, t_np, "ssm", chunk=BF16_CHECK_CHUNK)
    del t_np, lm2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm, tables = deploy_model(SSM_ARCH, reduced=False, max_seq=MAX_LEN,
                              seed=SEED, device="cuda", n_layers=SSM_LAYERS)
    torch.cuda.synchronize()
    cfg = lm.cfg
    full = get_config(SSM_ARCH)
    print(f"  calibrated and deployed {SSM_ARCH} at full width, its first "
          f"{cfg.n_layers} of {full.n_layers} layers ({cfg.param_count()} of "
          f"{full.param_count()} parameters), layer by layer in "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reqs = ragged_requests(8, cfg.vocab, np.random.default_rng(SEED + 2),
                           prompt_lo=17, prompt_hi=300, gen=16)
    eng = make_engine(lm, tables, "cuda", paged=False)
    eng.warmup()
    eng.reset_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tok1, s1, _ = serve(lm, tables, reqs, "cuda", engine=eng)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if len(tok1) != len(reqs) or any(len(v) != 16 for v in tok1.values()):
        raise AssertionError(f"ssm: not every request finished: {tok1}")
    if not all(0 <= t < cfg.vocab for v in tok1.values() for t in v):
        raise AssertionError("ssm: a token outside the vocab")
    check_path_launches(launches, "ssm", "ssm run 1")
    sites = ssm_gemm_sites(cfg)
    by = kernels.int8_matmul.by_shape
    dispatches = sum(n for (_, K, N, _), n in by.items()
                     if N == cfg.vocab_padded)
    if (any((K, N, mode) not in sites for (_, K, N, mode) in by)
            or launches["int8_matmul"] != (4 * cfg.n_layers + 1) * dispatches):
        raise AssertionError(f"GEMM launches {by} are not 4 a layer and "
                             f"the head in each of {dispatches} dispatches")
    print(f"  ssm run 1 (SlotArena, exact prefill, warmed): prompts "
          f"{[r.prompt_len for r in reqs]}, {s1['steps']} steps, "
          f"{dispatches} dispatches, launches {launches}; int8_matmul by "
          "site and path: " + ", ".join(
              f"{sites[(K, N, mode)]} M{M} "
              f"({'decode' if M <= 16 else 'prefill'}) {n}"
              for (M, K, N, mode), n in sorted(by.items())))
    requant_forms_ssm(kernels, cfg, dispatches, launches["requant"])
    print_stats("ssm run 1", s1)
    tel = Telemetry()
    tok2, s2, eng2 = serve(lm, tables, reqs, "cuda", warm=True,
                           engine=make_engine(lm, tables, "cuda", paged=False,
                                              telemetry=tel))
    if tok2 != tok1:
        raise AssertionError("ssm run 2 (telemetry on) gave other tokens")
    m = tel.metrics()
    print("  ssm run 2 (SlotArena, warmed, telemetry on) host ms per step "
          "phase (mean over the steps it ran in; total): " + ", ".join(
              f"{ph} {m['phase_mean_s'][ph] * 1e3:.2f} "
              f"({m['phase_total_s'][ph] * 1e3:.1f})"
              for ph in m["phase_mean_s"])
          + f"; step wall {sum(st['wall_s'] for st in m['steps']) * 1e3:.1f}"
          f" over {m['n_steps']} steps")
    ops, island_ops, ms = decode_ops(torch, np, eng2, QMamba1)
    print(f"  ssm decode dispatch ({N_SLOTS} rows, {cfg.n_layers} layers): "
          f"{ops} aten ops, {island_ops} of them in the scan island "
          f"({island_ops / cfg.n_layers:.0f} a layer); {ms:.2f} ms by CUDA "
          "events")
    del eng2
    tok3, s3, _ = serve(lm, tables, reqs, "cuda", warm=True)
    if tok3 != tok1:
        raise AssertionError("ssm over the paged arena gave other tokens")
    for what, s in (("SlotArena", s1), ("SlotArena run 2", s2),
                    ("paged arena", s3)):
        print(f"  ssm over {what}: {s['n_generated']} tokens in "
              f"{s['wall_s']:.3f} s = {s['throughput_tok_s']:.2f} tok/s, "
              f"p50 / p99 TTFT {s['p50_ttft_s'] * 1e3:.1f} / "
              f"{s['p99_ttft_s'] * 1e3:.1f} ms, p50 / p99 ITL "
              f"{s['p50_itl_s'] * 1e3:.1f} / {s['p99_itl_s'] * 1e3:.1f} ms")
    print(f"  ssm: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; tokens "
          f"{tok1}")


def phase_overload(torch, np, kernels, lm, tables, reqs, closed, rps):
    """The open-loop phase's requests at classes i % 2 under
    `PrioritySLOPolicy(preempt=True, slo_ttft_s=SLO_TTFT_S)`, arriving
    by the open-loop phase's draw at OPEN_LOOP_RATE times the closed
    loop's req/s: all complete with their closed-loop tokens; p99 TTFT
    per class from the completions."""
    import copy

    from repro_torch.serving import (
        PrioritySLOPolicy, poisson_arrivals, run_open_loop,
    )

    eng = make_engine(lm, tables, "cuda", policy=PrioritySLOPolicy(
        preempt=True, slo_ttft_s=SLO_TTFT_S))
    eng.warmup()
    classed = copy.deepcopy(list(reqs))
    for i, r in enumerate(classed):
        r.priority = i % 2
    rate = OPEN_LOOP_RATE * rps
    arrivals = poisson_arrivals(OPEN_LOOP_N, rate,
                                np.random.default_rng(SEED + 6))
    kernels.reset_launch_counts()
    res = run_open_loop(eng, classed, arrivals, slo_ttft_s=SLO_TTFT_S,
                        slo_itl_s=SLO_ITL_S)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_path_launches(launches, 8, "overload")
    print(f"  overload launches {launches}")
    got = {c.req_id: c for c in res.completions}
    if sorted(got) != list(range(OPEN_LOOP_N)):
        raise AssertionError(f"overload completed {sorted(got)}")
    for i in range(OPEN_LOOP_N):
        if list(got[i].tokens) != closed[i]:
            raise AssertionError(f"overload request {i}: tokens differ from "
                                 "the closed loop's")
    p99 = {k: float(np.percentile([got[i].ttft for i in got if i % 2 == k],
                                  99)) for k in (0, 1)}
    print(f"  overload at {rate:.3f} req/s asked, PrioritySLOPolicy "
          f"(preempt, aging at {SLO_TTFT_S} s): " + json.dumps(res.to_dict()))
    print(f"  overload n_preempts {res.n_preempts}; p99 TTFT class 0 "
          f"{p99[0] * 1e3:.1f} ms, class 1 {p99[1] * 1e3:.1f} ms")
    print_stats("overload", eng.stats())
    print(f"  overload tokens equal the closed loop's for all {OPEN_LOOP_N} "
          "requests")


def phase_configs(torch, np, kernels):
    """Each of CONFIGS at full width over its first CONFIG_LAYERS layers,
    served once on the card:
    8 ragged requests (prompts 17-300, 16 new tokens), kv_bits 8, after
    `warmup()`; the counts are set to 0 just before the run and read
    just after, and every kernel of the path must have launched."""
    from repro_torch.launch.serve import deploy_model, ragged_requests

    out = {}
    for arch in CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm, tables = deploy_model(arch, reduced=False, max_seq=MAX_LEN,
                                  seed=SEED, device="cuda",
                                  n_layers=CONFIG_LAYERS)
        torch.cuda.synchronize()
        cfg = lm.cfg
        print(f"  deployed {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_padded}) layer by layer in "
              f"{time.perf_counter() - t0:.1f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        reqs = ragged_requests(8, cfg.vocab, np.random.default_rng(SEED + 2),
                               prompt_lo=17, prompt_hi=300, gen=16)
        eng = serve(lm, tables, [], "cuda", warm=True)[2]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tok, s = serve(lm, tables, reqs, "cuda", engine=eng)[:2]
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"  {arch}: prompts {[r.prompt_len for r in reqs]}, "
              f"{s['steps']} steps, launches {launches}, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if len(tok) != len(reqs) or any(len(v) != 16 for v in tok.values()):
            raise AssertionError(f"{arch}: not every request finished: {tok}")
        if not all(0 <= t < cfg.vocab for v in tok.values() for t in v):
            raise AssertionError(f"{arch}: a token outside the vocab")
        check_path_launches(launches, 8, arch)
        gemm_site_launches(kernels, cfg, s["steps"], launches["int8_matmul"])
        requant_form_launches(kernels, cfg, s["steps"], launches["requant"])
        print_stats(arch, s)
        print(f"  {arch} tokens: {tok}")
        out[arch] = launches
        del lm, tables, eng
    return out


def phase_musicgen(torch, np, kernels):
    """musicgen_medium: the 2-layer full-width card-vs-CPU parity at
    kv_bits 8 and 4, then the model at full width over its first
    MUSICGEN_LAYERS layers calibrated and deployed by `deploy_model` and
    served as the main phase's 8-request cell (`serve_twice`: run 1
    counted, run 2 warmed with telemetry on) at kv_bits 8 and 4.  ->
    run 1's launches at kv_bits 8."""
    from repro_torch.launch.serve import deploy_model, ragged_requests

    config_parity(torch, np, "musicgen_medium")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm, tables = deploy_model("musicgen_medium", reduced=False,
                              max_seq=MAX_LEN, seed=SEED, device="cuda",
                              n_layers=MUSICGEN_LAYERS)
    torch.cuda.synchronize()
    cfg = lm.cfg
    print(f"  calibrated and deployed musicgen_medium ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}, norm "
          f"{cfg.norm}, act {cfg.act}, gated {cfg.gated}) layer by layer "
          f"in {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reqs = ragged_requests(8, cfg.vocab, np.random.default_rng(SEED + 2),
                           prompt_lo=17, prompt_hi=300, gen=16)
    launches, tok8, _ = serve_twice(torch, kernels, lm, tables, reqs, 8)
    print("  the same requests and tables over int4-packed pools:")
    tok4 = serve_twice(torch, kernels, lm, tables, reqs, 4)[1]
    same = sum(a == b for r in tok8 for a, b in zip(tok8[r], tok4[r]))
    total = sum(len(v) for v in tok8.values())
    print(f"  kv_bits 4 tokens equal to the int8 run's at {same} of "
          f"{total} positions")
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_nemotron(torch, np):
    """One nemotron_4_340b decoder layer at full width, card against
    CPU (`layer_card_vs_cpu`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import DecoderLM

    print("  host memory (free -g):\n" + subprocess.run(
        ["free", "-g"], capture_output=True, text=True,
        timeout=60).stdout.rstrip())
    cfg = dataclasses.replace(get_config("nemotron_4_340b"), n_layers=1)
    layer_card_vs_cpu(torch, np, DecoderLM(cfg, max_seq=MAX_LEN), 0,
                      "nemotron layer")


def layer_card_vs_cpu(torch, np, lm, i: int, what: str) -> None:
    """Block i of `lm` at its width, card against CPU: its float weights
    (`init_layer_np`), calibrated on the card on its own float input
    (CALIB_BATCH x 64 rows at the embedding's init scale), deployed,
    then `DenseBlock.apply_id` on both devices over a paged arena: a
    chunk dispatch (NEMO_SLOTS slots x NEMO_CHUNK tokens of the input's
    int8 image, at positions 0 and 5) and a decode dispatch after it
    (one more token each); outputs and both pools equal byte for byte,
    at kv_bits 8 and 4."""
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.layers.common import DeployCtx
    from repro_torch.models.lm import (
        load_layer, params_to_torch, tree_to_torch,
    )

    cfg = lm.cfg
    blk = lm.block(i)
    t0 = time.perf_counter()
    p = lm.init_layer_np(SEED, i)
    n_par = sum(v.size for sub in p.values() for leaf in sub.values()
                for v in (leaf.values() if isinstance(leaf, dict)
                          else [leaf]))
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    x = rng.standard_normal((4, 64, cfg.d_model), dtype=np.float32)
    x *= np.float32(0.02)  # the embedding's init scale
    eps_in = 2.0 * max(float(np.max(np.abs(x))), 1e-8) / 255.0
    calib = Calibrator()
    scope = lm.layer_scope(i)
    p_card = params_to_torch(p, "cuda")
    blk.apply_float(p_card, torch.from_numpy(x).cuda(), calib, scope)
    torch.cuda.synchronize()
    del p_card
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    t_np, _ = blk.deploy(DeployCtx(calib=calib), scope, p, eps_in)
    del p
    t3 = time.perf_counter()
    print(f"  {what}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads at hd {cfg.hd}, d_ff {cfg.d_ff} ({cfg.act}, gated "
          f"{cfg.gated}, norm {cfg.norm}), {n_par} parameters; float draw "
          f"{t1 - t0:.1f} s, params to the card and calibration there "
          f"{t2 - t1:.1f} s "
          f"({len(calib.hi)} ranges), host deploy {t3 - t2:.1f} s")
    tabs = {dev: load_layer(tree_to_torch(t_np, dev))
            for dev in ("cuda", "cpu")}
    del t_np
    s_in = np.clip(np.floor(x / eps_in), -128, 127).astype(np.int8)
    chunk = np.ascontiguousarray(s_in[:NEMO_SLOTS, :NEMO_CHUNK])
    step = np.ascontiguousarray(s_in[:NEMO_SLOTS, NEMO_CHUNK:NEMO_CHUNK + 1])
    pos0 = np.array([0, 5][:NEMO_SLOTS], np.int32)
    pps = -(-(5 + NEMO_CHUNK + 1) // PAGE)
    table = (np.arange(NEMO_SLOTS * pps, dtype=np.int32)[::-1] + 1).reshape(
        NEMO_SLOTS, pps).copy()
    for kv_bits in (8, 4):
        hd = cfg.hd // 2 if kv_bits == 4 else cfg.hd
        shape = (NEMO_SLOTS * pps + 1, cfg.n_kv_heads, PAGE, hd)
        stale = rng.integers(-128, 128, size=shape).astype(np.int8)
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            cache = {"k": torch.from_numpy(stale.copy()).to(dev),
                     "v": torch.from_numpy(stale[::-1].copy()).to(dev),
                     "table": torch.from_numpy(table).to(dev)}
            pos = torch.from_numpy(pos0).to(dev)
            y1 = blk.apply_id(tabs[dev], torch.from_numpy(chunk).to(dev),
                              cache, pos)
            y2 = blk.apply_id(tabs[dev], torch.from_numpy(step).to(dev),
                              cache, pos + NEMO_CHUNK)
            out[dev] = [y1.cpu(), y2.cpu(), cache["k"].cpu(),
                        cache["v"].cpu()]
            if dev == "cuda":
                torch.cuda.synchronize()
            print(f"  kv_bits {kv_bits} {dev}: chunk {tuple(chunk.shape)} "
                  f"and decode {tuple(step.shape)} dispatches in "
                  f"{time.perf_counter() - t0:.2f} s")
        for name, a, b in zip(("chunk output", "decode output", "K pool",
                               "V pool"), out["cuda"], out["cpu"]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"{what} kv_bits {kv_bits} "
                                     f"{name}: card != CPU")
        y1 = out["cuda"][0]
        print(f"  kv_bits {kv_bits}: chunk and decode outputs "
              f"{tuple(y1.shape)} {y1.dtype} (int8 values "
              f"{int(y1.min())}..{int(y1.max())}) and both pools "
              f"{tuple(out['cuda'][2].shape)} equal byte for byte")
    del tabs


def _llama4_sample(vocab: int):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream

    B, S = LLAMA4_SAMPLE
    return SyntheticStream(SyntheticConfig(
        vocab=vocab, seq_len=S, global_batch=B)).batch(0)[:, :S]


def llama4_packed_dispatch(torch, np, lm, tables) -> None:
    """The reduced llama4's pair over int4-packed pools (kv_bits 4; the
    engine refuses the MoE family's exact-length prefill there, as the
    reference does): one `prefill_chunk` of 3 slots x 8 tokens (a
    parked row) and a decode dispatch after it through a permuted page
    table, card vs CPU: int32 logits and both pools byte for byte."""
    from repro_torch.layers.attention import INACTIVE_POS

    cfg = lm.cfg
    rng = np.random.default_rng(SEED + 34)
    B, C, pps = 3, 8, LLAMA4_MAX_LEN // PAGE
    n_pages = B * pps
    pools = lm.init_pools(n_pages, PAGE, device="cpu", kv_bits=4)
    stale = {k: torch.from_numpy(rng.integers(
        -128, 128, size=tuple(v.shape)).astype(np.int8))
        for k, v in pools.items()}
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages + 1))
                             .reshape(B, pps).astype(np.int32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, C))
                            .astype(np.int32))
    pos = torch.tensor([0, 9, INACTIVE_POS], dtype=torch.int32)
    last = torch.tensor([C - 1, 3, 0], dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        caches = {k: v.clone().to(dev) for k, v in stale.items()}
        caches["table"] = table.to(dev)
        t = tables[dev]
        l1 = lm.prefill_chunk(t, toks.to(dev), caches, pos.to(dev),
                              last.to(dev))
        tok = torch.argmax(l1[:, 0], dim=-1).to(torch.int32)[:, None]
        l2 = lm.decode_step(t, tok, caches, (pos + C).to(dev))
        out[dev] = [l1.cpu(), l2.cpu(), caches["k"].cpu(), caches["v"].cpu()]
    for name, a, b in zip(("chunk logits", "decode logits", "K pools",
                           "V pools"), out["cuda"], out["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"llama4 kv_bits 4 {name}: card != CPU")
    print(f"  reduced kv_bits 4 (prefill_chunk over packed pools "
          f"{tuple(out['cuda'][2].shape)}): a {B} x {C} chunk and a decode "
          "dispatch, logits and both pools card == CPU byte for byte")


def phase_llama4(torch, np, kernels) -> dict:
    """LLAMA4_ARCH: (i) the dense half of a pair at full width, card vs
    CPU (`layer_card_vs_cpu`, kv_bits 8 and 4); (ii) the reduced model
    calibrated on the card and the CPU on the LLAMA4_SAMPLE tokens
    (ranges within CALIB_TOL of the span), deployed once from the card's
    ranges and served as the 8-request cell over `SlotArena` and the
    paged arena on the card (counts set to 0 just before and read just
    after: every kernel of PATH_KERNELS["llama4"], sh_rqt on the
    requant's rqt form once a MoE block and dispatch) and on the CPU,
    tokens and finish reasons equal; its pair over int4-packed pools
    (`llama4_packed_dispatch`); (iii) its FQ loss and gradients card vs
    CPU on LLAMA4_TRAIN tokens.  -> the card runs' launches by kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve_scenario
    from repro_torch.models.lm import DecoderLM, tables_from_numpy

    t0 = time.perf_counter()
    full = DecoderLM(dataclasses.replace(get_config(LLAMA4_ARCH),
                                         n_layers=2), max_seq=MAX_LEN)
    layer_card_vs_cpu(torch, np, full, 0, "llama4 dense half of a pair")
    t0 = phase_done("llama4 (i) dense half", t0)
    lm = DecoderLM(get_config(LLAMA4_ARCH).reduced(), max_seq=LLAMA4_MAX_LEN)
    p = lm.init_np(SEED)
    sample = _llama4_sample(lm.cfg.vocab)
    cal = {dev: lm.calibrate(p, sample, device=dev)
           for dev in ("cuda", "cpu")}
    worst = max(abs(getattr(cal["cuda"], e)[n] - getattr(cal["cpu"], e)[n])
                / max(cal["cpu"].hi[n] - cal["cpu"].lo[n], 1e-6)
                for n in cal["cpu"].hi for e in ("hi", "lo"))
    if worst > CALIB_TOL:
        raise AssertionError(f"llama4 calibration card vs CPU {worst:.3e} "
                             "of the span")
    t_np = lm.deploy(p, cal["cuda"])
    tables = {dev: tables_from_numpy(t_np, dev) for dev in ("cuda", "cpu")}
    print(f"  reduced {lm.cfg.name}: {lm.cfg.n_layers} layers as "
          f"{lm.plan()[0][2]} pair, {lm.cfg.n_experts} experts top-"
          f"{lm.cfg.top_k} and the shared MLP, calibrated on "
          f"{LLAMA4_SAMPLE[0]} x {LLAMA4_SAMPLE[1]} tokens on the card and "
          f"the CPU ({len(cal['cpu'].hi)} ranges, worst {worst:.2e} of the "
          "span), deployed from the card's")
    rng = np.random.default_rng(SEED + 35)
    reqs = [(rng.integers(0, lm.cfg.vocab, size=(n,)), LLAMA4_GEN)
            for n in LLAMA4_PROMPTS]
    launches = {}
    for paged in (False, True):
        arena = "the paged arena" if paged else "SlotArena"
        sc = {"config": dict(n_slots=N_SLOTS, max_len=LLAMA4_MAX_LEN,
                             paged=paged, page_size=PAGE),
              "requests": reqs, "count_launches": True}
        res = {dev: serve_scenario(lm, tables[dev], sc, device=dev)
               for dev in ("cuda", "cpu")}
        card, cpu = res["cuda"], res["cpu"]
        if (card["tokens"], card["finish"]) != (cpu["tokens"],
                                                cpu["finish"]):
            raise AssertionError(f"llama4 over {arena}: card tokens "
                                 f"{card['tokens']} != CPU {cpu['tokens']}")
        got = card["launches"]
        steps = card["stats"]["steps"]
        missing = [k for k in PATH_KERNELS["llama4"] if not got.get(k)]
        if missing:
            raise AssertionError(f"llama4 over {arena}: {missing} never "
                                 f"launched ({got})")
        rqt = card["requant_by_form"].get("rqt", 0)
        if rqt < steps:
            raise AssertionError(f"llama4 over {arena}: {rqt} rqt launches "
                                 f"(sh_rqt) for {steps} steps")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"  reduced over {arena}, {len(reqs)} requests (prompts "
              f"{LLAMA4_PROMPTS}, {LLAMA4_GEN} new tokens): card == CPU "
              f"tokens and finish reasons in {steps} steps; card launches "
              f"{got}, requant by form {card['requant_by_form']}; "
              f"{card['stats']['throughput_tok_s']:.2f} tok/s on the card")
    llama4_packed_dispatch(torch, np, lm, tables)
    print(f"  tokens {card['tokens']}")
    del tables
    t0 = phase_done("llama4 (ii) reduced served", t0)
    train_family_card_vs_cpu(torch, np, LLAMA4_ARCH, None, *LLAMA4_TRAIN,
                             reduced=True)
    phase_done("llama4 (iii) FQ step", t0)
    return launches


def gemm_sites(cfg) -> dict:
    """(K, N, output type) of each QLinear site of the serving path ->
    its name (sites of one shape share it: wk and wv, gate and up, and
    MHA's wq with them)."""
    d, hd = cfg.d_model, cfg.hd
    sites = {}
    for key, name in (((d, cfg.n_heads * hd, "int8"), "wq"),
                      ((d, cfg.n_kv_heads * hd, "int8"), "wk+wv"),
                      ((cfg.n_heads * hd, d, "int32"), "wo"),
                      ((d, cfg.d_ff, "int8"),
                       "gate+up" if cfg.gated else "up"),
                      ((cfg.d_ff, d, "int32"), "down"),
                      ((d, cfg.vocab_padded, "int32"), "head")):
        sites[key] = sites[key] + "+" + name if key in sites else name
    return sites


def gemm_site_launches(kernels, cfg, steps: int, total: int) -> None:
    """Print the main run's GEMM launches by site and path (M <= 16:
    decode GEMV; larger M: chunk wgmma) from `int8_matmul.by_shape`;
    they must add up to the GEMM's count, 7 per layer (6 ungated) and 1
    for the head in every step."""
    sites = gemm_sites(cfg)
    by = kernels.int8_matmul.by_shape
    parts = []
    for (M, K, N, mode), n in sorted(by.items()):
        path = "decode" if M <= 16 else "chunk"
        parts.append(f"{sites.get((K, N, mode), f'K{K} N{N} {mode}')} "
                     f"M{M} ({path}) {n}")
    per_step = (7 if cfg.gated else 6) * cfg.n_layers + 1
    print(f"  int8_matmul launches by site and path: {', '.join(parts)}; "
          f"sum {sum(by.values())} = {sum(by.values()) / steps:.0f} per "
          f"step")
    if sum(by.values()) != total or total != per_step * steps:
        raise AssertionError(f"GEMM launches {by} do not add up to {total} "
                             f"= {per_step} x {steps} steps")
    if any((K, N, mode) not in sites for (_, K, N, mode) in by):
        raise AssertionError(f"a GEMM launch off the serving sites: {by}")


def requant_form_launches(kernels, cfg, steps: int, total: int) -> None:
    """Print the main run's requant launches by form
    (`requant.by_form`): per layer and step one heads-to-rows ctx_rqt,
    one gate (the ungated MLP: one act, none for ReLU) and two QAdds,
    and nothing else."""
    by = kernels.requant.by_form
    L = cfg.n_layers * steps
    want = {"rqt_heads": L, "add": 2 * L}
    if cfg.gated:
        want["gate"] = L
    elif cfg.act != "relu":
        want["act"] = L
    print("  requant launches by form: " + ", ".join(
        f"{k} {n}" for k, n in sorted(by.items()))
        + f"; sum {sum(by.values())} = {sum(by.values()) / steps:.0f} per "
        "step")
    if by != want or total != sum(want.values()):
        raise AssertionError(f"requant launches {by} (total {total}) are "
                             f"not {want}")


def serve_twice(torch, kernels, lm, tables, reqs, kv_bits):
    """Two runs of the main path at `kv_bits`: the counts are set to 0
    just before run 1 and read just after; every kernel of the path
    must have launched and no kernel of the other pool mode.  Run 2 is
    a fresh engine with telemetry on, after `warmup()` and
    `reset_stats()`: its tokens must equal run 1's (telemetry is
    bit-neutral on the card), and it prints its full stats() and the
    host's mean time per step phase.  -> (launches, tokens, run 2
    stats)."""
    from repro_torch.serving import Telemetry

    kernels.reset_launch_counts()
    tok1, s1, _ = serve(lm, tables, reqs, "cuda", kv_bits)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if len(tok1) != len(reqs) or any(len(v) != 16 for v in tok1.values()):
        raise AssertionError(f"not every request finished 16 tokens: {tok1}")
    check_path_launches(launches, kv_bits, f"kv_bits {kv_bits} run 1")
    gemm_site_launches(kernels, lm.cfg, s1["steps"],
                       launches["int8_matmul"])
    requant_form_launches(kernels, lm.cfg, s1["steps"], launches["requant"])
    tel = Telemetry()
    tok2, s2, _ = serve(lm, tables, reqs, "cuda", kv_bits, telemetry=tel,
                        warm=True)
    if tok1 != tok2:
        raise AssertionError(f"kv_bits {kv_bits}: the telemetry run gave "
                             "other tokens")
    m = tel.metrics()
    if m["n_steps"] != s2["steps"] or m["compile_misses"] != 0:
        raise AssertionError(f"telemetry run: {m['n_steps']} step records "
                             f"for {s2['steps']} steps, "
                             f"{m['compile_misses']} unwarmed shapes")
    print(f"  kv_bits {kv_bits}: prompts {[r.prompt_len for r in reqs]}, "
          f"{s1['steps']} steps, launches {launches}, pool bytes "
          f"{s1['pool_bytes']}")
    for i, s in enumerate((s1, s2), 1):
        print(f"  kv_bits {kv_bits} run {i}: {s['n_generated']} tokens in "
              f"{s['wall_s']:.3f} s = {s['throughput_tok_s']:.2f} tok/s, "
              f"p50 TTFT {s['p50_ttft_s'] * 1e3:.1f} ms, p50 ITL "
              f"{s['p50_itl_s'] * 1e3:.1f} ms")
    print_stats(f"kv_bits {kv_bits} run 2 (telemetry on, warmed)", s2)
    wall = sum(st["wall_s"] for st in m["steps"])
    print(f"  kv_bits {kv_bits} run 2 host ms per step phase (mean over "
          f"the steps it ran in; total): " + ", ".join(
              f"{ph} {m['phase_mean_s'][ph] * 1e3:.2f} "
              f"({m['phase_total_s'][ph] * 1e3:.1f})"
              for ph in m["phase_mean_s"])
          + f"; step wall {wall / max(m['n_steps'], 1) * 1e3:.2f} "
          f"({wall * 1e3:.1f}); {len(tel.events)} events, dispatch "
          f"shapes {m['compile_hits']} hits / {m['compile_misses']} misses")
    print(f"  kv_bits {kv_bits} run 2 tokens equal run 1: {tok1}")
    return launches, tok1, s2


def profile_run(torch, lm, tables, reqs, wall_unprofiled, kv_bits=8):
    """A third run of the main path under torch.profiler: device time by
    kernel, split into the port's kernels and torch's glue, and the
    device's idle share of the unprofiled run 2's wall time (the
    profiler slows the host, so its own wall time overstates idleness).
    Only device activity is recorded: host ops' rows would count their
    kernels twice, and recording them makes the profiled run and the
    event post-processing several times slower.  The engine runs with
    `profile_annotations` on, so each dispatch sits in a
    `record_function` range (ANNOTATION); where the device-only trace
    carries those ranges, their device time is printed beside the busy
    time (and kept out of it), else that it carries none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Telemetry

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, stats, _ = serve(lm, tables, reqs, "cuda", kv_bits,
                            telemetry=Telemetry(profile_annotations=True))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    ranges = [e for e in events if e.key.startswith(ANNOTATION)]
    rows = [e for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith(ANNOTATION)]
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    busy_us = sum(e.self_device_time_total for e in rows)
    owner = {"gemm_wgmma_kernel": "int8_matmul",
             "gemm_gemv_kernel": "int8_matmul",
             **{k: "requant" for k in REQUANT_KERNELS},
             "paged_attn_mma_kernel": "paged_attention",
             "paged_attn_mma_packed_kernel": "paged_attention_kv4"}
    gemm_path = {"gemm_wgmma_kernel": "chunk (wgmma)",
                 "gemm_gemv_kernel": "decode (GEMV)"}
    split, by_path, by_form = {}, {}, {}
    for e in rows:
        who = next((v for k, v in owner.items() if k in e.key), "torch ops")
        split[who] = split.get(who, 0.0) + e.self_device_time_total / 1e3
        for table, names in ((by_path, gemm_path),
                             (by_form, REQUANT_KERNELS)):
            for k, v in names.items():
                if k in e.key:
                    ms, n = table.get(v, (0.0, 0))
                    table[v] = (ms + e.self_device_time_total / 1e3,
                                n + e.count)
    print(f"  profile (kv_bits {kv_bits} run 3): device busy "
          f"{busy_us / 1e3:.1f} ms; wall "
          f"{wall * 1e3:.1f} ms under the profiler, "
          f"{wall_unprofiled * 1e3:.1f} ms unprofiled (run 2): idle share "
          f"{1 - busy_us / 1e6 / wall_unprofiled:.3f} of run 2")
    if ranges:
        print("  record_function ranges in the device-only trace: " + ", ".join(
            f"{e.key} x{e.count}: device {e.device_time_total / 1e3:.1f} ms"
            f" ({e.device_type})" for e in ranges) + f" of {busy_us / 1e3:.1f}"
            " ms busy")
    else:
        print("  record_function ranges in the device-only trace: none")
    n_kernels = sum(e.count for e in rows)
    print(f"  {n_kernels} device kernels and copies in {stats['steps']} "
          f"steps: {n_kernels / stats['steps']:.0f} per step")
    print("  device ms by owner: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(split.items(), key=lambda x: -x[1])))
    for what, table in (("int8_matmul device ms by path", by_path),
                        ("requant device ms by kernel (form)", by_form)):
        print(f"  {what}: " + ", ".join(
            f"{k} {ms:.1f} in {n} launches ({ms / n * 1e3:.1f} us each)"
            for k, (ms, n) in sorted(table.items())))
    ms, n = (sum(x) for x in zip(*by_form.values())) if by_form else (0, 0)
    print(f"  requant: {ms:.1f} ms in {n} launches "
          f"({ms / max(n, 1) * 1e3:.2f} us each)")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:6d} calls  {e.key[:90]}")


def granite_2_layers():
    """The calibrate phase's table set, made the same way when that
    phase is skipped: -> (lm, its numpy tables)."""
    from repro_torch.launch.serve import calibration_sample

    lm2, p, _ = calibrated_2_layers("granite_3_2b")
    return lm2, lm2.deploy(p, lm2.calibrate(p, calibration_sample(
        lm2.cfg.vocab, MAX_LEN), device="cuda"))


def int_softmax_card_vs_cpu(torch, np, timer, lm2, t2_np):
    """`int_softmax` on the card against the CPU, byte for byte: the CPU
    test's cells (int32 products that wrap, negative shifts, a fully
    masked row), then one chunk's scores at granite's attention (8 x 32
    x 32 x 512, amplitude 127 * 127 * 64, causal mask) with the 2-layer
    table set's layer-0 tables; the latter timed."""
    from repro_torch.core.intsoftmax import (
        int_softmax, make_int_softmax_tables,
    )
    from repro_torch.layers.attention import _bool_mask

    def overflow(s, mask, m_ln2):
        s = np.where(mask, s, -(2 ** 30)).astype(np.int64)
        t_c = np.maximum(s - s.max(-1, keepdims=True), -(2 ** 26))
        prod = -t_c * int(m_ln2)
        return int(((prod > 2 ** 31 - 1) | (prod < -(2 ** 31))).sum())

    cases = []
    for eps_s, amp, masked, T in INT_SOFTMAX_CASES:
        rng = np.random.default_rng(int(eps_s * 1e7) + T)
        s = rng.integers(-amp, amp, size=(2, 4, 5, T)).astype(np.int32)
        mask = rng.random((2, 1, 5, T)) >= masked
        mask[1, 0, 2, :] = False
        tabs = {k: torch.from_numpy(np.array(v)) for k, v in
                make_int_softmax_tables(eps_s).items()}
        cases.append((f"eps_s {eps_s:g} T {T}", s, torch.from_numpy(mask),
                      tabs))
    sm = {k: torch.from_numpy(np.array(v[0])) for k, v in
          t2_np["segments"][0]["attn"]["sm_tabs"].items()}
    rng = np.random.default_rng(SEED + 27)
    amp = 127 * 127 * 64
    s = rng.integers(-amp, amp, size=(N_SLOTS, 32, CHUNK, MAX_LEN)).astype(
        np.int32)
    pos = torch.from_numpy(rng.integers(0, MAX_LEN - CHUNK, size=N_SLOTS)
                           .astype(np.int32))
    cases.append(("granite chunk 8x32x32x512", s,
                  _bool_mask(CHUNK, MAX_LEN, pos), sm))
    lanes = total = 0
    for what, s, mask, tabs in cases:
        card = {k: v.cuda() for k, v in tabs.items()}
        sc, mc = torch.from_numpy(s).cuda(), mask.cuda()
        got = int_softmax(sc, card, mask=mc).cpu()
        want = int_softmax(torch.from_numpy(s), tabs, mask=mask)
        if not torch.equal(got, want):
            raise AssertionError(f"int_softmax {what}: card != CPU on "
                                 f"{int((got != want).sum())} entries")
        lanes += overflow(s, mask.numpy(), tabs["m_ln2"])
        total += s.size
    ms = timer(lambda: int_softmax(sc, card, mask=mc))
    print(f"  int_softmax card == CPU byte for byte on {total} scores in "
          f"{len(cases)} cells, {lanes} of them int32-overflow lanes; the "
          f"granite chunk (m_ln2 {int(sm['m_ln2'])}, ln2_img "
          f"{int(sm['ln2_img'])}) {ms:.4f} ms on the card")


def int_engine_cells(torch, np, lm2, t2_np):
    """The 2-layer full-width table set under `attn_softmax="int"` in
    the CPU test's five engine cells (slot arena chunked and bucketed,
    paged chunked and bucketed at kv_bits 8, paged chunked at 4): the
    card's tokens equal the CPU's."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.launch.variants import use_variants
    from repro_torch.models.lm import tables_from_numpy
    from repro_torch.serving import SchedulerConfig

    t0 = time.perf_counter()
    reqs = ragged_requests(3, lm2.cfg.vocab, np.random.default_rng(SEED + 1),
                           prompt_lo=9, prompt_hi=40, gen=3)
    bucketed = SchedulerConfig(prefill_chunk=0, prefill_bucket=BUCKET)
    cells = (("SlotArena chunked", dict(paged=False)),
             ("SlotArena bucketed", dict(paged=False, scheduler=bucketed)),
             ("paged chunked kv_bits 8", {}),
             ("paged bucketed kv_bits 8", dict(scheduler=bucketed)),
             ("paged chunked kv_bits 4", dict(kv_bits=4)))
    tables = {dev: tables_from_numpy(t2_np, dev) for dev in ("cuda", "cpu")}
    with use_variants(attn_softmax="int"):
        for what, config in cells:
            tok = {dev: serve(lm2, tables[dev], reqs, dev,
                              engine=make_engine(lm2, tables[dev], dev,
                                                 **config))[0]
                   for dev in ("cuda", "cpu")}
            if tok["cuda"] != tok["cpu"]:
                raise AssertionError(f"int softmax {what}: card {tok['cuda']}"
                                     f" != CPU {tok['cpu']}")
    print(f"  granite 2-layer int softmax, {len(cells)} cells "
          f"({', '.join(c for c, _ in cells)}): {len(reqs)} requests each, "
          f"card == CPU token for token ({time.perf_counter() - t0:.1f} s)")


def attention_float_ops(torch, np, lm, eng):
    """One unified dispatch (8 rows x CHUNK tokens at offset 0 over the
    drained engine's arena) under a TorchDispatchMode: -> ({op: count}
    with a floating output inside `QAttention.apply_id`, the same
    outside it, ops seen inside)."""
    from torch.utils import _pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.layers.attention import QAttention

    class Scoped(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.inside, self.outside, self.depth, self.seen = {}, {}, 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen += self.depth > 0
            if any(isinstance(o, torch.Tensor) and o.is_floating_point()
                   for o in _pytree.tree_leaves(out)):
                d = self.inside if self.depth else self.outside
                d[str(func)] = d.get(str(func), 0) + 1
            return out

    mode, apply_id = Scoped(), QAttention.apply_id

    def scoped(self, *a, **kw):
        mode.depth += 1
        try:
            return apply_id(self, *a, **kw)
        finally:
            mode.depth -= 1

    toks = np.random.default_rng(SEED + 28).integers(
        0, lm.cfg.vocab, size=(N_SLOTS, CHUNK)).astype(np.int32)
    zeros = np.zeros((N_SLOTS,), np.int32)
    QAttention.apply_id = scoped
    try:
        with mode:
            eng._unified(toks, zeros, zeros + CHUNK - 1)
            torch.cuda.synchronize()
    finally:
        QAttention.apply_id = apply_id
    return mode.inside, mode.outside, mode.seen


def gather_equals_kernel(torch, np, lm, tables):
    """One unified prefill_chunk of the full model (8 rows x CHUNK over
    stale random pools, rows at offsets 0-400 and a parked row), then
    one decode dispatch after it, through the paged kernel and through
    the gather path under the float island, each on its own copy of
    the pools: int32 logits and both pools equal byte for byte."""
    from repro_torch.launch.variants import use_variants
    from repro_torch.layers.attention import INACTIVE_POS

    t0 = time.perf_counter()
    cfg = lm.cfg
    rng = np.random.default_rng(SEED + 29)
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    pools = lm.init_pools(N_PAGES, PAGE, "cuda")
    for kv in ("k", "v"):
        pools[kv].random_(-128, 128, generator=g)
    table = torch.from_numpy(rng.permutation(np.arange(1, N_PAGES + 1))
                             .reshape(N_SLOTS, -1).astype(np.int32)).cuda()
    pos = np.array([0, 7, 16, 100, 255, 300, 400, INACTIVE_POS], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(N_SLOTS, CHUNK)).astype(np.int32)
    last = rng.integers(0, CHUNK, size=N_SLOTS).astype(np.int32)
    out = {}
    for mode in ("kernel", "gather"):
        caches = {"k": pools["k"].clone(), "v": pools["v"].clone(),
                  "table": table}
        with use_variants(paged_decode=mode):
            a = lm.prefill_chunk(tables, torch.from_numpy(toks).cuda(),
                                 caches, torch.from_numpy(pos).cuda(),
                                 torch.from_numpy(last).cuda())
            dpos = np.where(pos == INACTIVE_POS, pos, pos + CHUNK).astype(
                np.int32)
            b = lm.decode_step(tables, torch.from_numpy(toks[:, :1]).cuda(),
                               caches, torch.from_numpy(dpos).cuda())
        out[mode] = (a, b, caches["k"], caches["v"])
    for name, x, y in zip(("chunk logits", "decode logits", "K pools",
                           "V pools"), out["kernel"], out["gather"]):
        if not torch.equal(x, y):
            raise AssertionError(f"full-width {name}: the gather path != "
                                 "the paged kernel")
    picks = {int(t) for x in out["kernel"][:2] for t in x.argmax(-1).flatten()}
    print(f"  granite {cfg.n_layers} layers, float island: one chunk "
          f"({N_SLOTS} x {CHUNK}) and one decode dispatch through the "
          f"gather path equal the paged kernel's int32 logits and pools "
          f"byte for byte ({time.perf_counter() - t0:.1f} s; "
          f"{len(picks)} distinct argmax tokens over the "
          f"{2 * N_SLOTS} rows)")
    del out, pools


def int_full_width(torch, np, kernels, lm, tables, reqs, run1):
    """The main tables (MAIN_LAYERS) under `attn_softmax="int"` on the
    paged arena at kv_bits 8 and 4, the 8-request cell (counts set to 0
    just before and read just after): no paged attention launch, the
    grouped GEMM two launches a layer and dispatch (by shape); tok/s,
    p50 TTFT and ITL; at kv_bits 8 the dispatch-mode check of one
    dispatch (no floating output in the attention, asserted; the
    step's others printed).  Then the float island with
    `paged_kernel=False`: tokens equal main run 1's (the kernel)."""
    from repro_torch.launch.variants import use_variants

    L = lm.cfg.n_layers
    gather_equals_kernel(torch, np, lm, tables)
    for kv_bits in (8, 4):
        with use_variants(attn_softmax="int"):
            kernels.reset_launch_counts()
            tok, s, eng = serve(lm, tables, reqs, "cuda", kv_bits)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            by = dict(kernels.int8_matmul_grouped.by_shape)
            check_path_launches(launches, "gather", f"int kv_bits {kv_bits}")
            n = launches["int8_matmul_grouped"]
            if sum(by.values()) != n or n % (2 * L):
                raise AssertionError(f"grouped GEMM launches {by}, {n}: "
                                     f"not two a layer and dispatch")
            same = sum(a == b for r in tok for a, b in zip(tok[r],
                                                           run1[kv_bits][r]))
            print(f"  int softmax kv_bits {kv_bits}: {s['n_generated']} "
                  f"tokens in {s['wall_s']:.3f} s = "
                  f"{s['throughput_tok_s']:.2f} tok/s, {s['steps']} steps, "
                  f"p50 TTFT {s['p50_ttft_s'] * 1e3:.1f} ms, p50 ITL "
                  f"{s['p50_itl_s'] * 1e3:.1f} ms; launches {launches}; "
                  f"grouped GEMM (groups, C, K, N) " + ", ".join(
                      f"{k[:4]} {v}" for k, v in sorted(by.items()))
                  + f"; tokens equal the float island's (main run 1) at "
                  f"{same} of {sum(len(v) for v in tok.values())} positions")
            if any(len(v) != 16 or not all(0 <= t < lm.cfg.vocab for t in v)
                   for v in tok.values()):
                raise AssertionError(f"int softmax tokens: {tok}")
            if kv_bits == 8:
                inside, outside, seen = attention_float_ops(
                    torch, np, lm, eng)
                if inside or seen < L:
                    raise AssertionError(f"floating outputs in the "
                                         f"attention: {inside} ({seen} ops)")
                print(f"  one dispatch under a TorchDispatchMode: {seen} ops "
                      f"in the attention ({L} layers), none with a floating "
                      f"output; outside it: {outside or 'none'}")
        del eng
    kernels.reset_launch_counts()
    tok, s, _ = serve(lm, tables, reqs, "cuda", engine=make_engine(
        lm, tables, "cuda", paged_kernel=False))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_path_launches(launches, "gather", "float paged_kernel=False")
    if tok != run1[8]:
        raise AssertionError("float island, paged_kernel=False: tokens "
                             "differ from main run 1's (the kernel)")
    print(f"  float island over the gather path (paged_kernel=False): "
          f"{s['throughput_tok_s']:.2f} tok/s, p50 TTFT "
          f"{s['p50_ttft_s'] * 1e3:.1f} ms, p50 ITL "
          f"{s['p50_itl_s'] * 1e3:.1f} ms; tokens equal main run 1's (the "
          f"paged kernel) for all {len(tok)} requests; launches {launches}")


def phase_int_softmax(torch, np, kernels, timer, lm, tables, reqs, run1,
                      lm2, t2_np):
    """Integer-only attention (`attn_softmax="int"`) and the
    write-then-gather path on the card."""
    t0 = time.perf_counter()
    int_softmax_card_vs_cpu(torch, np, timer, lm2, t2_np)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    int_engine_cells(torch, np, lm2, t2_np)
    t0 = time.perf_counter()
    int_full_width(torch, np, kernels, lm, tables, reqs, run1)
    print(f"  (full width: {time.perf_counter() - t0:.1f} s)")


def pool_bytes(pools: dict) -> int:
    return sum(t.numel() * t.element_size() for t in pools.values())


def phase_sharded(torch, np, kernels, lm2, t2_np, reqs, device="cuda"):
    """Kv-head-sharded serving: granite at full width on the calibrate
    phase's 2-layer tables (saved once, loaded by each rank) serves the
    8-request cell over `SlotArena` at kv_bits 8 and over the paged arena
    at kv_bits 8 and 4, unsharded here and then by SHARD_RANKS ranks on
    a (1, SHARD_RANKS) mesh with `kv_shard`, which share the one card
    over "gloo" (collectives staged through the host).  Tokens, finish
    reasons and the ranks' pools concatenated along K must equal the
    unsharded engine's; each rank's kernel counts (set to 0 before its
    cell, read after) must show the cell's path.  Then one rank on a
    world-size-1 "nccl" mesh with `kv_shard`: a "model" width of 1
    keeps every kv head on the rank, so this runs the unsharded path
    with the mesh attached and no collective (the nccl all-gather needs
    two cards and is not exercised here).  -> the sharded cells'
    launches by kernel, summed over the ranks."""
    from repro_torch.launch.serve import run_sharded, serve_scenario
    from repro_torch.models.lm import tables_from_numpy

    tables = tables_from_numpy(t2_np, device)
    geo = dict(n_slots=N_SLOTS, max_len=MAX_LEN)
    pg = dict(geo, paged=True, page_size=PAGE, n_pages=N_PAGES)
    cells = {"SlotArena kv8": (geo, 8), "paged kv8": (pg, 8),
             "paged kv4": (dict(pg, kv_bits=4), 4)}
    req_list = [(r.prompt.tolist(), r.max_new_tokens) for r in reqs]
    scs = [dict(config=c, requests=req_list, count_launches=True,
                scheduler=dict(prefill_chunk=CHUNK, max_prefills_per_step=2))
           for c, _ in cells.values()]
    t0 = time.perf_counter()
    single = [serve_scenario(lm2, tables, sc, device=device) for sc in scs]
    print(f"  unsharded engine, {len(scs)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ranks = run_sharded(lm2, tables, scs, SHARD_RANKS, device=device,
                        backend="gloo")
    print(f"  {SHARD_RANKS} gloo ranks on one card, {len(scs)} cells each, "
          f"in {time.perf_counter() - t0:.1f} s (spawn and table loads "
          "included)")
    totals = {}
    for i, (name, (_, kv_bits)) in enumerate(cells.items()):
        one = single[i]
        for r, res in enumerate(r[i] for r in ranks):
            if res["tokens"] != one["tokens"] or res["finish"] != one[
                    "finish"]:
                raise AssertionError(f"sharded {name} rank {r}: tokens "
                                     "differ from the unsharded engine's")
            check_path_launches(res["launches"], kv_bits,
                                f"sharded {name} rank {r}")
            for k, n in res["launches"].items():
                totals[k] = totals.get(k, 0) + n
        for k in ("k", "v"):
            got = torch.cat([r[i]["pools"][k] for r in ranks], dim=2)
            if not torch.equal(got, one["pools"][k]):
                raise AssertionError(f"sharded {name}: the ranks' {k} pools "
                                     "concatenated along K != unsharded")
        st = [r[i]["stats"] for r in ranks]
        if st[0]["pool_bytes_total"] != pool_bytes(one["pools"]) or any(
                x["pool_bytes"] != pool_bytes(r[i]["pools"])
                for x, r in zip(st, ranks)):
            raise AssertionError(f"sharded {name}: pool bytes {st}")
        steps = [r[i]["step_ms"] for r in ranks]
        print(f"  sharded {name}: {sum(map(len, one['tokens']))} tokens "
              f"equal the unsharded engine's on both ranks; pools per rank "
              f"{[x['pool_bytes'] for x in st]} B (K {st[0]['kv_heads']} of "
              f"{lm2.cfg.n_kv_heads}), total {st[0]['pool_bytes_total']} B, "
              f"unsharded {pool_bytes(one['pools'])} B; launches rank 0 "
              f"{ranks[0][i]['launches']}, requant by form "
              f"{ranks[0][i]['requant_by_form']}")
        print(f"    step ms (gloo-staged on one card, not a multi-GPU "
              f"figure): rank medians "
              + ", ".join(f"{float(np.median(x)):.2f}" for x in steps)
              + f" over {len(steps[0])} steps, totals "
              + ", ".join(f"{sum(x):.1f}" for x in steps)
              + f"; unsharded median {float(np.median(one['step_ms'])):.2f}"
              f", total {sum(one['step_ms']):.1f}")
    t0 = time.perf_counter()
    (solo,) = run_sharded(lm2, tables, scs[:2], 1, device=device,
                          backend="nccl")
    for res, one, name in zip(solo, single, cells):
        if res["tokens"] != one["tokens"]:
            raise AssertionError(f"nccl world-size-1 {name}: tokens differ")
        if res["stats"]["mesh_devices"] != 1 or not res["stats"]["kv_shard"]:
            raise AssertionError(f"nccl {name}: stats {res['stats']}")
    print(f"  one nccl rank on a (1, 1) mesh with kv_shard (width 1: "
          f"every head, no collective): {', '.join(list(cells)[:2])} "
          f"tokens equal the unsharded engine's "
          f"({time.perf_counter() - t0:.1f} s)")
    return totals


def greedy_after_prefill(torch, lm, t, prompt, max_len, dev, n_tokens):
    """One whole-prompt prefill of `prompt` (1, P) over a fresh
    contiguous cache, then greedy decode steps: -> (prefill logits,
    tokens, the cache after the prefill (host copies of the leaves),
    the cache after the decodes)."""
    caches = lm.init_caches(1, max_len, device=dev)
    tok = torch.from_numpy(prompt).to(dev)
    logits = lm.prefill(t, tok, caches)
    after = {k: v.cpu().clone() for k, v in caches.items()
             if isinstance(v, torch.Tensor)}
    toks = [int(torch.argmax(logits[0, 0]))]
    P = prompt.shape[1]
    for i in range(n_tokens - 1):
        nxt = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
        lg = lm.decode_step(t, nxt, caches, torch.full(
            (1,), P + i, dtype=torch.int32, device=dev))
        toks.append(int(torch.argmax(lg[0, 0])))
    return logits.cpu(), toks, after, caches


def _first_layers(tree, n: int):
    """A layer-stacked numpy table tree cut to its first n layers."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_blockwise(torch, np, kernels, lm2, t2_np):
    """granite_3_2b at full width, the first BLOCKWISE_LAYERS of the
    calibrate phase's 2-layer tables (its final norm and head kept),
    over a contiguous cache of BLOCKWISE_LEN positions: each
    prompt of BLOCKWISE_PROMPTS (above 4096 rows the attention streams
    over key blocks) prefilled whole on the card (counted, timed, peak
    memory) and on the CPU, then greedy decode steps: int32 logits, K/V
    bytes and the first BLOCKWISE_TOKENS tokens equal."""
    from repro_torch.models.lm import DecoderLM, tables_from_numpy

    lm = DecoderLM(dataclasses.replace(lm2.cfg, n_layers=BLOCKWISE_LAYERS),
                   max_seq=BLOCKWISE_LEN)
    t2_np = {**t2_np, "segments": [_first_layers(t2_np["segments"][0],
                                                 BLOCKWISE_LAYERS)]}
    rng = np.random.default_rng(SEED + 21)
    tc, tg = (tables_from_numpy(t2_np, d) for d in ("cuda", "cpu"))
    for P in BLOCKWISE_PROMPTS:
        prompt = rng.integers(0, lm.cfg.vocab, size=(1, P)).astype(np.int32)
        # the card's prefill alone, counted and timed (a first call
        # warms the allocator and the kernels' plans)
        caches = lm.init_caches(1, BLOCKWISE_LEN, device="cuda")
        lm.prefill(tc, torch.from_numpy(prompt).cuda(), caches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        lm.prefill(tc, torch.from_numpy(prompt).cuda(), caches)
        t1.record()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        by = dict(sorted(kernels.int8_matmul_grouped.by_shape.items()))
        check_path_launches(launches, "blockwise", f"blockwise {P}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        del caches
        card = greedy_after_prefill(torch, lm, tc, prompt, BLOCKWISE_LEN,
                                    "cuda", BLOCKWISE_TOKENS)
        t_cpu = time.perf_counter()
        host = greedy_after_prefill(torch, lm, tg, prompt, BLOCKWISE_LEN,
                                    "cpu", BLOCKWISE_TOKENS)
        t_cpu = time.perf_counter() - t_cpu
        if not torch.equal(card[0], host[0]):
            raise AssertionError(f"blockwise {P}: prefill logits card != CPU")
        for kv in ("k", "v"):
            if not torch.equal(card[2][kv], host[2][kv]):
                raise AssertionError(f"blockwise {P}: {kv} card != CPU")
        if card[1] != host[1]:
            raise AssertionError(f"blockwise {P}: tokens card {card[1]} != "
                                 f"CPU {host[1]}")
        print(f"  blockwise prompt {P} over {BLOCKWISE_LEN} positions "
              f"({lm.cfg.n_layers} layers): prefill {t0.elapsed_time(t1):.1f}"
              f" ms on the card (CUDA events), peak {peak:.2f} GiB above "
              f"the tables; launches {launches}, grouped GEMM by shape "
              f"{by}; logits, K/V bytes and tokens "
              f"{card[1]} equal on the card and the CPU (CPU {t_cpu:.1f} s)")
        del card, host
        torch.cuda.empty_cache()
    del tc, tg


def hybrid_parity(torch, np, lm8, t_np):
    """HYBRID_PARITY_LAYERS layers at full width, card vs CPU: a
    128-token prefill and 3 decode steps (logits, conv, h bit for bit,
    the shared pools), then 3 requests over both arenas (tokens, the
    arenas' state).  -> the tokens."""
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.models.lm import tables_from_numpy

    prompt = np.random.default_rng(SEED + 31).integers(
        0, lm8.cfg.vocab, size=(1, SSM_PREFILL)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        t = tables_from_numpy(t_np, dev)
        logits, toks, after, caches = greedy_after_prefill(
            torch, lm8, t, prompt, MAX_LEN, dev, 4)
        final = {k: caches[k].cpu() for k in ("conv", "h", "k", "v")}
        for leaves in (after, final):  # h compared as its bits
            leaves["h"] = leaves["h"].view(torch.int32)
        out[dev] = (logits, toks, after, final)
        del t, caches
    c, h = out["cuda"], out["cpu"]
    if not torch.equal(c[0], h[0]) or c[1] != h[1]:
        raise AssertionError("hybrid prefill logits or tokens card != CPU")
    for when, a, b in (("prefill", c[2], h[2]), ("decodes", c[3], h[3])):
        for k in ("conv", "h", "k", "v"):
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"hybrid {k} after the {when}: "
                                     "card != CPU")
    print(f"  hybrid {lm8.cfg.n_layers}-layer: a {SSM_PREFILL}-token prefill "
          f"and 3 decode steps: int32 logits, tokens {c[1]}, the conv "
          f"state {tuple(h[2]['conv'].shape)}, h {tuple(h[2]['h'].shape)} "
          f"bit for bit and the shared pools {tuple(h[2]['k'].shape)} "
          "equal on the card and the CPU")
    reqs = ragged_requests(3, lm8.cfg.vocab, np.random.default_rng(SEED + 1),
                           prompt_lo=9, prompt_hi=40, gen=HYBRID_PARITY_GEN)
    toks = None
    for paged in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            t = tables_from_numpy(t_np, dev)
            tok, _, eng = serve(lm8, t, reqs, dev, engine=make_engine(
                lm8, t, dev, paged=paged, n_slots=HYBRID_PARITY_SLOTS))
            res[dev] = (tok, {k: eng.arena.caches[k].cpu() for k in
                              ("conv", "h")})
            del eng, t
        what = f"hybrid over {'the paged arena' if paged else 'SlotArena'}"
        if res["cuda"][0] != res["cpu"][0]:
            raise AssertionError(f"{what}: card tokens {res['cuda'][0]} != "
                                 f"CPU {res['cpu'][0]}")
        for k in ("conv", "h"):
            a, b = res["cuda"][1][k], res["cpu"][1][k]
            if not torch.equal(a.view(torch.int32) if k == "h" else a,
                               b.view(torch.int32) if k == "h" else b):
                raise AssertionError(f"{what}: {k} state card != CPU")
        if toks is not None and res["cuda"][0] != toks:
            raise AssertionError(f"{what}: tokens differ from SlotArena's")
        toks = res["cuda"][0]
        print(f"  {what}: {len(reqs)} requests (prompts "
              f"{[r.prompt_len for r in reqs]}), "
              f"{sum(len(v) for v in toks.values())} tokens and the arena's "
              "conv and h state equal on the card and the CPU")
    return toks


def decode_ops(torch, np, eng, cls):
    """One fused decode dispatch of a drained engine (every slot row at
    token 0) under a TorchDispatchMode counting aten ops, those inside
    `cls.island` apart; then the same dispatch timed by CUDA events
    (median of 5).  -> (ops, island ops, ms)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.island = self.depth = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.island += self.depth > 0
            return func(*args, **(kwargs or {}))

    mode, island = Count(), cls.island

    def scoped(self, *a, **kw):
        mode.depth += 1
        try:
            return island(self, *a, **kw)
        finally:
            mode.depth -= 1

    toks = np.zeros((N_SLOTS, 1), np.int32)
    pos = np.zeros((N_SLOTS,), np.int32)
    cls.island = scoped
    try:
        with mode:
            eng._decode(toks, pos)
            torch.cuda.synchronize()
    finally:
        cls.island = island
    times = []
    for _ in range(5):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        eng._decode(toks, pos)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return mode.ops, mode.island, float(np.median(times))


def phase_hybrid(torch, np, kernels):
    """HYBRID_ARCH: HYBRID_PARITY_LAYERS layers at full width card vs
    CPU (`hybrid_parity`), then HYBRID_LAYERS layers served as the
    8-request cell over `SlotArena` (warmed; counts set to 0 just
    before and read just after) and over the paged arena."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import calibration_sample, deploy_model
    from repro_torch.layers.ssm import QMamba2
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serving import Request

    t0 = time.perf_counter()
    lm8 = DecoderLM(dataclasses.replace(get_config(HYBRID_ARCH),
                                        n_layers=HYBRID_PARITY_LAYERS),
                    max_seq=MAX_LEN)
    p = lm8.init_np(SEED)
    t_np = lm8.deploy(p, lm8.calibrate(
        p, calibration_sample(lm8.cfg.vocab, MAX_LEN), device="cuda"))
    del p
    print(f"  {HYBRID_PARITY_LAYERS} layers at full width ({lm8.plan()[0][2]} "
          f"group and a {lm8.cfg.n_layers % lm8.cfg.shared_attn_every}-block "
          f"tail) calibrated on the card and deployed in "
          f"{time.perf_counter() - t0:.1f} s")
    hybrid_parity(torch, np, lm8, t_np)
    bf16_island_parity(torch, np, lm8, t_np, "hybrid",
                       chunk=BF16_CHECK_CHUNK)
    del t_np, lm8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lm, tables = deploy_model(HYBRID_ARCH, reduced=False, max_seq=MAX_LEN,
                              seed=SEED, device="cuda", n_layers=HYBRID_LAYERS)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    cfg, full = lm.cfg, get_config(HYBRID_ARCH)
    resident = (torch.cuda.memory_allocated() - base) / 2**30
    print(f"  calibrated and deployed {HYBRID_ARCH} at full width, "
          f"{cfg.n_layers} of {full.n_layers} layers ({lm.groups} shared "
          f"applications; {cfg.param_count()} of {full.param_count()} "
          f"parameters), layer by layer in {deploy_s:.1f} s; tables "
          f"resident {resident:.2f} GiB")
    rng = np.random.default_rng(SEED + 2)
    reqs = [Request(rng.integers(0, cfg.vocab, size=(P,)), max_new_tokens=16)
            for P in HYBRID_PROMPTS]
    eng = make_engine(lm, tables, "cuda", paged=False)
    eng.warmup()
    eng.reset_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tok1, s1, _ = serve(lm, tables, reqs, "cuda", engine=eng)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if len(tok1) != len(reqs) or any(len(v) != 16 for v in tok1.values()):
        raise AssertionError(f"hybrid: not every request finished: {tok1}")
    if not all(0 <= t < cfg.vocab for v in tok1.values() for t in v):
        raise AssertionError("hybrid: a token outside the vocab")
    check_path_launches(launches, "hybrid", "hybrid run 1")
    sites = hybrid_gemm_sites(cfg)
    by = kernels.int8_matmul.by_shape
    if any((K, N, mode) not in sites for (_, K, N, mode) in by):
        raise AssertionError(f"hybrid GEMM launches {by} off its sites")
    # a dispatch: each Mamba-2 block's conv requant, conv LUT and Add,
    # each shared application's two concat requants, ctx_rqt and Add
    D = sum(n for (_, K, N, _), n in by.items() if N == cfg.vocab_padded)
    L, G = cfg.n_layers, lm.groups
    want = {"rqt": D * (L + 2 * G), "act": D * L, "add": D * (L + G),
            "rqt_heads": D * G}
    if kernels.requant.by_form != want:
        raise AssertionError(f"hybrid requant launches "
                             f"{kernels.requant.by_form} are not {want}")
    print(f"  hybrid run 1 (SlotArena, exact prefill, warmed): prompts "
          f"{[r.prompt_len for r in reqs]}, {s1['steps']} steps, launches "
          f"{launches}; int8_matmul by site and path: " + ", ".join(
              f"{sites[(K, N, mode)]} M{M} "
              f"({'decode' if M <= 16 else 'prefill'}) {n}"
              for (M, K, N, mode), n in sorted(by.items()))
          + "; requant by form: " + ", ".join(
              f"{k} {v}" for k, v in sorted(kernels.requant.by_form.items())))
    print_stats("hybrid run 1", s1)
    ops, island_ops, ms = decode_ops(torch, np, eng, QMamba2)
    print(f"  hybrid decode dispatch ({N_SLOTS} rows, {cfg.n_layers} blocks, "
          f"{lm.groups} shared applications): {ops} aten ops, {island_ops} "
          f"of them in the Mamba-2 island ({island_ops / cfg.n_layers:.0f} a "
          f"block); {ms:.2f} ms by CUDA events")
    del eng
    tok2, s2, _ = serve(lm, tables, reqs, "cuda", warm=True)
    if tok2 != tok1:
        raise AssertionError("hybrid over the paged arena gave other tokens")
    for what, s in (("SlotArena", s1), ("the paged arena", s2)):
        print(f"  hybrid over {what}: {s['n_generated']} tokens in "
              f"{s['wall_s']:.3f} s = {s['throughput_tok_s']:.2f} tok/s, "
              f"p50 / p99 TTFT {s['p50_ttft_s'] * 1e3:.1f} / "
              f"{s['p99_ttft_s'] * 1e3:.1f} ms, p50 / p99 ITL "
              f"{s['p50_itl_s'] * 1e3:.1f} / {s['p99_itl_s'] * 1e3:.1f} ms")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"  hybrid: deploy {deploy_s:.1f} s, tables resident "
          f"{resident:.2f} GiB, peak {peak:.2f} GiB above what the phase "
          f"found; tokens {tok1}")


def mamba2_groups_parity(torch, np) -> None:
    """`QMamba2` at n_groups 2, the reduced zamba2 block's width (d 128,
    8 heads of 32, state 16; each group's B / C over 4 heads): seeded
    init_np weights calibrated on the card on 2 x 128 float rows,
    deployed, then `apply_id` of 2 x 128 int8 rows from a seeded state on
    the card and the CPU, in the float32 and the bf16 island: out_proj's
    accumulator, the conv window and h bit for bit."""
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.launch import variants
    from repro_torch.layers.common import DeployCtx
    from repro_torch.layers.ssm import QMamba2
    from repro_torch.models.lm import params_to_torch, tree_to_torch

    m = QMamba2(128, d_state=16, expand=2, head_dim=32, n_groups=2)
    rng = np.random.default_rng(SEED + 36)
    p = m.init_np(rng)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    calib = Calibrator()
    m.apply_float(params_to_torch(p, "cuda"), torch.from_numpy(x).cuda(),
                  calib, "s.")
    t_np, _ = m.deploy(DeployCtx(calib=calib), "s.", p, 0.05, 0)
    s_x = rng.integers(-128, 128, (2, 128, 128)).astype(np.int8)
    conv = rng.integers(-128, 128, (2, 3, m.d_conv_in)).astype(np.int8)
    h0 = (rng.standard_normal((2, 8, 32, 16)) * 0.1).astype(np.float32)
    for island in ("float32", "bf16"):
        var = {"ssm_island_dtype": "bf16"} if island == "bf16" else {}
        out = {}
        for dev in ("cuda", "cpu"):
            cache = {"conv": torch.from_numpy(conv).to(dev),
                     "h": torch.from_numpy(h0).to(dev)}
            with variants.use_variants(**var):
                acc, new = m.apply_id(tree_to_torch(t_np, dev),
                                      torch.from_numpy(s_x).to(dev), cache)
            out[dev] = (acc.cpu(), new["conv"].cpu(),
                        new["h"].cpu().view(torch.int32))
        for name, a, b in zip(("out_proj acc", "conv", "h"), out["cuda"],
                              out["cpu"]):
            if not torch.equal(a, b):
                raise AssertionError(f"QMamba2 n_groups 2 {island} {name}: "
                                     "card != CPU")
        print(f"  QMamba2 n_groups 2 ({island} island, L 128 from a state): "
              "out_proj's accumulator, the conv window and h card == CPU "
              "bit for bit")


def bit_length_host_cost(torch, calls: int = 1000) -> None:
    """Host time of one `core.intmath.bit_length` call on the card (the
    integer shift-and-compare version) beside the float64 `frexp` one
    it replaced, at a decode's (8, 1) and a chunk's (256, 1) int32
    operand: `calls` calls without synchronising, divided; and the
    bit lengths equal on 2^20 values.  A QNorm takes two a call (the
    isqrt seed and the reciprocal), so a granite dispatch 162."""
    from repro_torch.core.intmath import bit_length

    def frexp_bits(n):
        return torch.frexp(n.to(torch.float64)).exponent.to(torch.int32)

    n = torch.randint(0, 1 << 31, (1 << 20,), dtype=torch.int32,
                      device="cuda")
    if not torch.equal(bit_length(n), frexp_bits(n)):
        raise AssertionError("bit_length: the integer and frexp versions "
                             "differ on the card")
    out = []
    for rows in (N_SLOTS, N_SLOTS * CHUNK):
        x = torch.randint(1, 1 << 30, (rows, 1), dtype=torch.int32,
                          device="cuda")
        for name, fn in (("integer", bit_length), ("frexp", frexp_bits)):
            fn(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(x)
            us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            out.append(f"{name} ({rows}, 1) {us:.1f} us")
    print("  bit_length host us per call (no synchronise): "
          + ", ".join(out) + f"; x 162 a granite dispatch")


def phase_embeds(torch, np, kernels):
    """EMBEDS_ARCH (no embedding table: the model takes int8 embedding
    rows at meta["eps_in"]) at full width over its first EMBEDS_LAYERS
    layers: seeded init_np weights calibrated on the card on a seeded
    float (CALIB_BATCH, 64, d) sample and deployed on the host; card vs
    CPU, a prefill of 2 x EMBEDS_PARITY rows and 3 decode steps: int32
    logits and the K/V bytes equal; then the card alone: a prefill of 2
    x EMBEDS_PROMPT rows and EMBEDS_DECODES decodes, counted (the
    kv_bits 8 path's kernels), timed (CUDA events) and its peak memory.
    The engine refuses the model, as the reference's does."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import CALIB_BATCH
    from repro_torch.models.lm import DecoderLM, tables_from_numpy
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = dataclasses.replace(get_config(EMBEDS_ARCH),
                              n_layers=EMBEDS_LAYERS)
    lm = DecoderLM(cfg, max_seq=EMBEDS_MAX)
    t0 = time.perf_counter()
    p = lm.init_np(SEED)
    n_par = sum(int(np.prod(np.shape(v))) for v in _np_leaves(p))
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    sample = rng.standard_normal((CALIB_BATCH, 64, cfg.d_model),
                                 dtype=np.float32)
    calib = lm.calibrate(p, sample, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    t_np = lm.deploy(p, calib)
    del p
    t3 = time.perf_counter()
    eps_in = float(t_np["meta"]["eps_in"])
    print(f"  {EMBEDS_ARCH}: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads at hd {cfg.hd} (group {cfg.n_heads // cfg.n_kv_heads}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {EMBEDS_LAYERS} of 80 layers, "
          f"{n_par} parameters, no embedding table; float draw "
          f"{t1 - t0:.1f} s, calibration on the card {t2 - t1:.1f} s "
          f"({len(calib.hi)} ranges), host deploy {t3 - t2:.1f} s; eps_in "
          f"{eps_in:.6g}")
    tabs = {dev: tables_from_numpy(t_np, dev) for dev in ("cuda", "cpu")}
    del t_np
    try:
        ServingEngine(lm, tabs["cuda"], ServingConfig())
        raise AssertionError("the engine served an embeds model")
    except ValueError as e:
        print(f"  ServingEngine refuses it: {e}")
    x = rng.standard_normal((2, EMBEDS_MAX, cfg.d_model), dtype=np.float32)
    rows = torch.from_numpy(
        np.clip(np.round(x / eps_in), -128, 127).astype(np.int8))
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        caches = lm.init_caches(2, EMBEDS_PARITY + PAGE, device=dev)
        logs = [lm.prefill(tabs[dev], rows[:, :EMBEDS_PARITY].to(dev),
                           caches)]
        for i in range(3):
            pos = torch.full((2,), EMBEDS_PARITY + i, dtype=torch.int32,
                             device=dev)
            row = rows[:, EMBEDS_PARITY + i:EMBEDS_PARITY + i + 1]
            logs.append(lm.decode_step(tabs[dev], row.to(dev), caches, pos))
        out[dev] = [t.cpu() for t in logs + [caches["k"], caches["v"]]]
        print(f"  {dev}: a prefill of 2 x {EMBEDS_PARITY} int8 rows and 3 "
              f"decodes in {time.perf_counter() - t0:.2f} s")
    for name, a, b in zip(("prefill logits", "decode 1", "decode 2",
                           "decode 3", "K pool", "V pool"), out["cuda"],
                          out["cpu"]):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"embeds {name}: card != CPU")
    print(f"  card == CPU: int32 logits {tuple(out['cuda'][0].shape)} "
          f"(values {int(out['cuda'][0].min())}..{int(out['cuda'][0].max())})"
          f", 3 decodes' logits and the K/V pools "
          f"{tuple(out['cuda'][4].shape)} byte for byte")
    del out, tabs["cpu"]
    tc = tabs["cuda"]
    prompt = rows[:, :EMBEDS_PROMPT].cuda()
    lm.prefill(tc, prompt, lm.init_caches(2, EMBEDS_MAX, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    caches = lm.init_caches(2, EMBEDS_MAX, device="cuda")
    kernels.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 * (EMBEDS_DECODES + 1))]
    ev[0].record()
    lm.prefill(tc, prompt, caches)
    ev[1].record()
    for i in range(EMBEDS_DECODES):
        pos = torch.full((2,), EMBEDS_PROMPT + i, dtype=torch.int32,
                         device="cuda")
        row = rows[:, EMBEDS_PROMPT + i:EMBEDS_PROMPT + i + 1].cuda()
        ev[2 * i + 2].record()
        lm.decode_step(tc, row, caches, pos)
        ev[2 * i + 3].record()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_path_launches(launches, 8, "embeds")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    dec = sorted(ev[2 * i + 2].elapsed_time(ev[2 * i + 3])
                 for i in range(EMBEDS_DECODES))
    per = {k: v / (EMBEDS_DECODES + 1) for k, v in launches.items() if v}
    print(f"  card: prefill of 2 x {EMBEDS_PROMPT} rows "
          f"{ev[0].elapsed_time(ev[1]):.2f} ms, a decode step (median of "
          f"{EMBEDS_DECODES}) {dec[len(dec) // 2]:.3f} ms (min {dec[0]:.3f}, "
          f"max {dec[-1]:.3f}), peak {peak:.3f} GiB above the tables "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB resident); "
          f"launches {launches} ({per} a dispatch)")
    del tc, tabs, caches
    torch.cuda.empty_cache()


def _np_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _np_leaves(v)
    else:
        yield tree


def _rel_l2(want, got) -> float:
    den = float(want.double().norm())
    diff = float((want.double() - got.double()).norm())
    return diff / den if den else float(diff > 0)


def train_card_vs_cpu(torch, np):
    """granite_3_2b at full width, 2 layers: the FQ loss and every
    gradient leaf of one step's batch (2 x 64) on the card and the CPU
    from the same init_np params and init_qstate clips."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.rep import Rep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import DecoderLM, params_to_torch

    cfg = dataclasses.replace(get_config("granite_3_2b"), n_layers=2)
    lm = DecoderLM(cfg, max_seq=65)
    p = lm.init_np(SEED)
    tok = SyntheticStream(SyntheticConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=2)).batch(0)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = {"params": params_to_torch(p, dev),
              "qstate": lm.init_qstate(dev)}
        t0 = time.perf_counter()
        loss, g = value_and_grad(lambda t, x: lm.loss_fn(
            t["params"], t["qstate"], x, Rep.FQ), tr,
            torch.from_numpy(tok).to(dev))
        loss = float(loss)
        secs = time.perf_counter() - t0
        res[dev] = (loss, [x.cpu() for x in tree_leaves(g)])
        print(f"  {dev}: FQ loss {loss:.6f}, value and gradient in "
              f"{secs:.2f} s")
        del tr, g
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    errs = [_rel_l2(b, a) for a, b in zip(res["cuda"][1], res["cpu"][1])]
    print(f"  card vs CPU: loss {rel:.3e} relative (limit {TRAIN_LOSS_TOL}), "
          f"gradients {len(errs)} leaves, worst {max(errs):.3e} relative L2 "
          f"(limit {TRAIN_GRAD_TOL}), median "
          f"{sorted(errs)[len(errs) // 2]:.3e}")
    if rel > TRAIN_LOSS_TOL or max(errs) > TRAIN_GRAD_TOL:
        raise AssertionError("train: the card's loss or gradients are off "
                             "the CPU's")
    torch.cuda.empty_cache()


def train_supervised(torch, np, kernels):
    """`launch.train.build` on the card at full width over TRAIN_LAYERS
    layers and `TrainSupervisor`: TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens with a checkpoint every TRAIN_CKPT (and at the
    end), then the last checkpoint removed and the run restarted from
    TRAIN_CKPT: the resumed losses within TRAIN_RESUME_TOL of the
    uninterrupted run's, and the loss falls (the mean of the last 5
    steps below the first 5's).  ms a step, tokens/s, peak memory and
    the model FLOP/s share at 6 N D over the dense bf16 peak."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch.elastic import TrainSupervisor
    from repro_torch.launch.train import build

    t0 = time.perf_counter()
    lm, tr, opt, step, stream = build(
        "granite_3_2b", reduced=False, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        device="cuda", n_layers=TRAIN_LAYERS)
    n_par = lm.cfg.param_count()
    print(f"  granite_3_2b at full width, {TRAIN_LAYERS} of 40 layers, "
          f"{n_par} parameters (param_count), built in "
          f"{time.perf_counter() - t0:.1f} s")
    times = []

    def timed(t, o, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(t, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    def sup(d):
        return TrainSupervisor(
            train_step=timed, ckpt_dir=d, ckpt_every=TRAIN_CKPT,
            make_batch=lambda s: torch.from_numpy(stream.batch(s)).cuda())

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        full = sup(d).run(tr, opt, n_steps=TRAIN_STEPS)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps_s = times[1:]
        shutil.rmtree(Path(d) / f"step_{TRAIN_STEPS:08d}")
        if ckpt.latest_step(d) != TRAIN_CKPT:
            raise AssertionError("train: no checkpoint at "
                                 f"{TRAIN_CKPT}")
        t0 = time.perf_counter()
        resumed = sup(d).run(tr, opt, n_steps=TRAIN_STEPS)
        wall2 = time.perf_counter() - t0
    batch = torch.from_numpy(stream.batch(0)).cuda()
    split = cnn_profile(torch, lambda: step(tr, opt, batch))
    busy = sum(ms for ms, _ in split.values())
    a, b = full["losses"][TRAIN_CKPT:], resumed["losses"]
    worst = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    ms = 1e3 * float(np.median(steps_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6.0 * n_par * tokens / (ms / 1e3) / BF16_FLOPS_S
    ls = full["losses"]
    print(f"  {TRAIN_STEPS} steps in {wall:.1f} s (checkpoints at "
          f"{TRAIN_CKPT} and {TRAIN_STEPS} included): losses {ls[0]:.4f} "
          f"-> {ls[-1]:.4f} (first five mean {np.mean(ls[:5]):.4f}, last "
          f"five {np.mean(ls[-5:]):.4f}); a step {ms:.1f} ms (median of "
          f"{len(steps_s)}, min {1e3 * min(steps_s):.1f}), "
          f"{tokens / (ms / 1e3):.0f} tokens/s, model FLOP/s share "
          f"{share:.4f} (6 N D over {BF16_FLOPS_S / 1e12:.1f} TFLOP/s), "
          f"peak {peak:.2f} GiB; hand-written kernel launches {launches} "
          "(the FQ path's products are bf16 matmuls)")
    top = sorted(split.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"  one step under torch.profiler: device busy {busy:.1f} ms, idle "
          f"share {1 - busy / ms:.3f} of the unprofiled step; by kernel: "
          + ", ".join(f"{k} {v[0]:.1f} ms x{v[1]}" for k, v in top))
    print(f"  restart from step {TRAIN_CKPT}: {len(b)} steps in "
          f"{wall2:.1f} s, losses within {worst:.3e} relative of the "
          f"uninterrupted run's (limit {TRAIN_RESUME_TOL})")
    if len(b) != TRAIN_STEPS - TRAIN_CKPT or worst > TRAIN_RESUME_TOL:
        raise AssertionError("train: the resumed losses are off")
    if not np.mean(ls[-5:]) < np.mean(ls[:5]):
        raise AssertionError("train: the loss does not fall")
    if any(launches.values()):
        raise AssertionError(f"train: integer kernels launched {launches}")
    del tr, opt
    torch.cuda.empty_cache()


def train_embeds_step(torch, np):
    """EMBEDS_ARCH at full width, 1 layer: one loss_fn_embeds value and
    gradient on seeded float rows (1 x 64 x d) and targets, the clips
    set to cut into the SiLU outputs (alpha -0.25, beta 2; at init's
    [-1, 6) no output reaches them): a finite loss and a nonzero
    gradient on every leaf."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.rep import Rep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import DecoderLM, params_to_torch

    cfg = dataclasses.replace(get_config(EMBEDS_ARCH), n_layers=1)
    lm = DecoderLM(cfg, max_seq=65)
    t0 = time.perf_counter()
    tr = {"params": params_to_torch(lm.init_np(SEED), "cuda"),
          "qstate": {"segments": [{"mlp": {
              "alpha": torch.full((1,), -0.25, device="cuda"),
              "beta": torch.full((1,), 2.0, device="cuda")}}]}}
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    emb = torch.randn((1, 64, cfg.d_model), generator=g, device="cuda")
    tgt = torch.randint(0, cfg.vocab, (1, 64), generator=g, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = value_and_grad(lambda t, e, y: lm.loss_fn_embeds(
        t["params"], t["qstate"], e, y, Rep.FQ), tr, emb, tgt)
    loss = float(loss)
    leaves = tree_leaves(grads)
    zero = [i for i, x in enumerate(leaves) if not bool(x.abs().max() > 0)]
    finite = all(bool(torch.isfinite(x).all()) for x in leaves)
    print(f"  {EMBEDS_ARCH} at full width, 1 layer: params drawn in "
          f"{t1 - t0:.1f} s; loss_fn_embeds {loss:.4f} and its gradient in "
          f"{time.perf_counter() - t1:.2f} s, {len(leaves)} leaves, "
          f"{len(zero)} all zero, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(loss) or zero or not finite:
        raise AssertionError(f"train embeds: loss {loss}, zero leaves "
                             f"{zero}, finite {finite}")
    del tr, grads, leaves
    torch.cuda.empty_cache()


def _record_routes(cls):
    """Wrap `cls._route` to record each call's expert picks; -> (the
    list, a function that restores `_route`)."""
    orig, seen = cls._route, []

    def rec(self, logits, *a, **kw):
        out = orig(self, logits, *a, **kw)
        seen.append(out[1].cpu())
        return out

    cls._route = rec
    return seen, lambda: setattr(cls, "_route", orig)


def train_family_card_vs_cpu(torch, np, arch, layers, batch, seq, *,
                             reduced=False):
    """`arch` at full width over `layers` layers (or its reduced config,
    all its layers): the FQ loss (with the MoE's 0.01 aux) and every
    gradient leaf of one batch on the card and the CPU from the same
    init_np params and init_qstate clips; for the MoE, the (token,
    expert) choices of a forward on each, counted where they
    differ."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.rep import Rep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.layers.moe import QMoE
    from repro_torch.models.lm import DecoderLM, params_to_torch

    cfg = (get_config(arch).reduced() if reduced else
           dataclasses.replace(get_config(arch), n_layers=layers))
    lm = DecoderLM(cfg, max_seq=seq + 1)
    t0 = time.perf_counter()
    p = lm.init_np(SEED)
    tok = SyntheticStream(SyntheticConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch(0)
    print(f"  {arch} {'reduced' if reduced else 'at full width'}, "
          f"{cfg.n_layers} layer(s), batch {batch} x {seq}: params drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    res = {}
    for dev in ("cuda", "cpu"):
        tr = {"params": params_to_torch(p, dev),
              "qstate": lm.init_qstate(dev)}
        x = torch.from_numpy(tok).to(dev)
        t0 = time.perf_counter()
        loss, g = value_and_grad(lambda t, b: lm.loss_fn(
            t["params"], t["qstate"], b, Rep.FQ), tr, x)
        loss = float(loss)
        secs = time.perf_counter() - t0
        routes = []
        if cfg.family == "moe":
            routes, restore = _record_routes(QMoE)
            with torch.no_grad():
                lm.loss_fn(tr["params"], tr["qstate"], x, Rep.FQ)
            restore()
        res[dev] = (loss, [v.cpu() for v in tree_leaves(g)], routes)
        print(f"  {dev}: FQ loss {loss:.6f}, value and gradient in "
              f"{secs:.2f} s")
        del tr, g
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    errs = [_rel_l2(b, a) for a, b in zip(res["cuda"][1], res["cpu"][1])]
    if any(not bool(torch.isfinite(v).all()) for v in res["cuda"][1]):
        raise AssertionError(f"train {arch}: a gradient is not finite")
    note = ""
    if cfg.family == "moe":
        ra, rb = res["cuda"][2], res["cpu"][2]
        differ = sum(int((a != b).sum()) for a, b in zip(ra, rb))
        total = sum(a.numel() for a in ra)
        note = (f"; (token, expert) choices differing card vs CPU: {differ} "
                f"of {total} in {len(ra)} layer(s)")
    grad_tol = TRAIN_FAMILY_GRAD_TOL[cfg.family]
    print(f"  {arch} card vs CPU: loss {rel:.3e} relative (limit "
          f"{TRAIN_LOSS_TOL}), gradients {len(errs)} leaves, worst "
          f"{max(errs):.3e} relative L2 (limit {grad_tol}), median "
          f"{sorted(errs)[len(errs) // 2]:.3e}{note}")
    if rel > TRAIN_LOSS_TOL or max(errs) > grad_tol:
        raise AssertionError(f"train {arch}: the card's loss or gradients "
                             "are off the CPU's")
    torch.cuda.empty_cache()


def train_family_step(torch, np, kernels, arch, layers, batch, seq):
    """`launch.train.build`'s train step for `arch` on the card at full
    width over `layers` layers: TRAIN_FAMILY_WARM warm-up steps, then
    TRAIN_FAMILY_TIMED timed ones: ms a step (median), tokens/s, peak
    memory and the model FLOP/s share at 6 N D over the bf16 peak (for
    the MoE at N total and N active); every loss finite, no integer
    kernel launched."""
    from repro_torch.launch.train import build

    t0 = time.perf_counter()
    lm, tr, opt, step, stream = build(arch, reduced=False, seq=seq,
                                      batch=batch, device="cuda",
                                      n_layers=layers)
    cfg = lm.cfg
    built = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for s in range(TRAIN_FAMILY_WARM + TRAIN_FAMILY_TIMED):
        b = torch.from_numpy(stream.batch(s)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tr, opt = step(tr, opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = 1e3 * float(np.median(times[TRAIN_FAMILY_WARM:]))
    tokens = batch * seq
    n_par = cfg.param_count()
    share = 6.0 * n_par * tokens / (ms / 1e3) / BF16_FLOPS_S
    shares = f"model FLOP/s share {share:.4f} at N {n_par} (param_count)"
    if cfg.family == "moe":
        n_act = cfg.active_param_count()
        act = 6.0 * n_act * tokens / (ms / 1e3) / BF16_FLOPS_S
        shares = (f"model FLOP/s share {share:.4f} at N {n_par} (all "
                  f"parameters), {act:.4f} at N {n_act} (active a token)")
    print(f"  {arch} trainer, {layers} layer(s) at full width, batch "
          f"{batch} x {seq} (built in {built:.1f} s): losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; a step {ms:.1f} ms (median of {TRAIN_FAMILY_TIMED} after "
          f"{TRAIN_FAMILY_WARM} warm-up, min "
          f"{1e3 * min(times[TRAIN_FAMILY_WARM:]):.1f}), "
          f"{tokens / (ms / 1e3):.0f} tokens/s, {shares} over "
          f"{BF16_FLOPS_S / 1e12:.1f} TFLOP/s, peak {peak:.2f} GiB; "
          f"hand-written kernel launches {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {arch}: a loss is not finite")
    if any(launches.values()):
        raise AssertionError(f"train {arch}: integer kernels launched "
                             f"{launches}")
    del tr, opt
    torch.cuda.empty_cache()


def phase_train(torch, np, kernels):
    from repro_torch.launch import variants

    train_card_vs_cpu(torch, np)
    train_supervised(torch, np, kernels)
    train_embeds_step(torch, np)
    for arch, cl, cb, cs, tl, tb, ts in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        train_family_card_vs_cpu(torch, np, arch, cl, cb, cs)
        train_family_step(torch, np, kernels, arch, tl, tb, ts)
        print(f"  ({arch}: {time.perf_counter() - t0:.1f} s)")
    # the bf16 scan island: card vs CPU over two chunks of the batch's
    # TRAIN_BF16_SEQ tokens (chunk TRAIN_BF16_SEQ / 2), then the trainer
    arch, cl, cb, cs, tl, tb, ts = TRAIN_FAMILIES[1]
    t0 = time.perf_counter()
    print(f"  {arch} with the bf16 scan island:")
    with variants.use_variants(ssm_island_dtype="bf16",
                               ssm_chunk=TRAIN_BF16_SEQ // 2):
        train_family_card_vs_cpu(torch, np, arch, cl, cb, TRAIN_BF16_SEQ)
    with variants.use_variants(ssm_island_dtype="bf16"):
        train_family_step(torch, np, kernels, arch, tl, tb, ts)
    print(f"  ({arch} bf16: {time.perf_counter() - t0:.1f} s)")


def _sharded_train_lm(max_seq=SHARDED_TRAIN_SEQ + 1):
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(dataclasses.replace(get_config("granite_3_2b"),
                                         n_layers=SHARDED_TRAIN_LAYERS),
                     max_seq=max_seq)


def _sharded_train_state(torch, lm, dev):
    """The seeded (trainable, opt state, batch) on `dev`."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
    from repro_torch.models.lm import params_to_torch
    from repro_torch.optim.adamw import adamw_init

    tr = {"params": params_to_torch(lm.init_np(SEED), dev),
          "qstate": lm.init_qstate(dev)}
    tok = SyntheticStream(SyntheticConfig(
        vocab=lm.cfg.vocab, seq_len=SHARDED_TRAIN_SEQ,
        global_batch=SHARDED_TRAIN_BATCH)).batch(0)
    return tr, adamw_init(tr), {"tokens": torch.from_numpy(tok).to(dev)}


def _timed_steps(torch, step, *args) -> list:
    out = []
    for _ in range(SHARDED_TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def train_sharded_rank(rank, out_dir, ckpt_dir, meshes):
    """One rank of the train_sharded phase: the seeded state, the
    unsharded FQ step on the card (timed), then for each mesh shape the
    state placed by `launch.steps.train_shardings` (its bytes and what
    its placements say), one sharded step gathered back and held
    against the unsharded one (bit-equal where the mesh does not split
    the batch, else within SHARDED_TRAIN_TOL), SHARDED_TRAIN_TIMED timed
    steps; the (1, 2) step's result saved as a checkpoint, restored onto
    (2, 1) and held against it.  Writes a JSON report a rank."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_train_step, train_shardings
    from repro_torch.sharding import place
    from repro_torch.sharding.rules import local_shape

    lm = _sharded_train_lm()
    tr, opt, batch = _sharded_train_state(torch, lm, "cuda")
    step = build_train_step(lm)
    loss, ntr, nopt = step(tr, opt, batch)
    want = [loss] + tree_leaves(ntr) + tree_leaves(nopt)
    n_tr = len(tree_leaves(ntr))
    kinds = ["loss"] + ["trainable"] * n_tr + ["moments"] * (
        len(want) - 1 - n_tr)
    report = {"unsharded": {"loss": float(loss), "bytes": sum(
        x.numel() * x.element_size() for x in tree_leaves(tr)
        + tree_leaves(opt)), "ms": _timed_steps(torch, step, tr, opt, batch)}}
    del step, ntr, nopt
    kept = None
    for shape in meshes:
        shape = tuple(shape)
        mesh = make_mesh(shape, ("data", "model"), device_type="cuda")
        (tr_sh, opt_sh, _), _, _ = train_shardings(lm, mesh, "train_4k")
        dtr, dopt = place.distribute(tr, tr_sh), place.distribute(opt, opt_sh)
        need = sum(int(np.prod(local_shape(tuple(x.shape), sh.spec, mesh),
                               dtype=np.int64)) * x.element_size()
                   for t, shs in ((tr, tr_sh), (opt, opt_sh))
                   for x, sh in zip(tree_leaves(t), tree_leaves(shs)))
        have = place.local_bytes(dtr) + place.local_bytes(dopt)
        sstep = build_train_step(lm, mesh=mesh)
        loss, ntr, nopt = sstep(dtr, dopt, batch)
        got = [loss] + [place.gather(x) for x in tree_leaves(ntr)
                        + tree_leaves(nopt)]
        equal = all(g.shape == w.shape and g.dtype == w.dtype
                    and torch.equal(_bits(torch, g), _bits(torch, w))
                    for g, w in zip(got, want))
        worst = dict.fromkeys(SHARDED_TRAIN_TOL, 0.0)
        for g, w, kind in zip(got, want, kinds):
            worst[kind] = max(worst[kind], float(
                (g.double() - w.double()).abs().max()
                / w.double().abs().max().clamp(min=1e-30)))
        if shape == (1, 2):
            kept = got[1:]
        del got
        report[f"{shape[0]}x{shape[1]}"] = {
            "loss": float(loss), "bytes": [have, need], "equal": equal,
            "worst": worst,
            "ms": _timed_steps(torch, sstep, dtr, dopt, batch)}
        if shape == (1, 2):
            ckpt.save(ckpt_dir, 1, {"trainable": ntr, "opt": nopt}, keep=1)
        if shape == (2, 1):
            back = ckpt.restore(ckpt_dir, 1, {"trainable": dtr, "opt": dopt},
                                shardings={"trainable": tr_sh,
                                           "opt": opt_sh})
            leaves = (tree_leaves(back["trainable"])
                      + tree_leaves(back["opt"]))
            report["restored"] = {
                "placed": all(place.is_placed(x) for x in leaves),
                "equal": all(torch.equal(place.gather(x), k)
                             for x, k in zip(leaves, kept)),
                "n": len(leaves)}
            del back, leaves
        del dtr, dopt, ntr, nopt, sstep
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}_{len(meshes)}.json").write_text(
        json.dumps(report))


def _bits(torch, t):
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8, 8: torch.int64}
    return t.reshape(-1).view(ints[t.element_size()])


def phase_train_sharded(torch, np):
    """The training shardings on the card (see the constants above), in
    spawned ranks: two gloo ranks sharing the card on (1, 2) (bit-equal
    to the unsharded card step) and (2, 1) (within SHARDED_TRAIN_TOL),
    each rank's bytes against its placements, the (1, 2) checkpoint
    restored onto (2, 1); one nccl rank on (1, 1) (bit-equal); then the
    float forward's cache, card vs CPU."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        spawn(train_sharded_rank, 2, (d, str(Path(d) / "ck"),
                                      [(1, 2), (2, 1)]),
              device="cuda", backend="gloo")
        gloo_s = time.perf_counter() - t0
        reports = [json.loads((Path(d) / f"rank{r}_2.json").read_text())
                   for r in range(2)]
        t0 = time.perf_counter()
        # the world of one nccl rank is this process (no spawn to pay)
        dist.init_process_group("nccl", init_method="file://" + str(
            Path(d) / "rendezvous"), world_size=1, rank=0)
        try:
            train_sharded_rank(0, d, str(Path(d) / "ck1"), [(1, 1)])
        finally:
            dist.destroy_process_group()
        nccl_s = time.perf_counter() - t0
        solo = json.loads((Path(d) / "rank0_1.json").read_text())
    one = reports[0]["unsharded"]
    print(f"  granite_3_2b at full width, {SHARDED_TRAIN_LAYERS} layers, "
          f"batch {SHARDED_TRAIN_BATCH} x {SHARDED_TRAIN_SEQ}: the unsharded "
          f"FQ step on the card, loss {one['loss']:.6f}; params, qstate "
          f"and moments {one['bytes']} B")
    for shape, rows in (("1x2", reports), ("2x1", reports),
                        ("1x1", [solo])):
        by = [r[shape]["bytes"] for r in rows]
        if any(h != n for h, n in by):
            raise AssertionError(f"train_sharded {shape}: rank bytes {by} "
                                 "are not their placements'")
        worst = {k: max(r[shape]["worst"][k] for r in rows)
                 for k in SHARDED_TRAIN_TOL}
        if shape != "2x1" and not all(r[shape]["equal"] for r in rows):
            raise AssertionError(f"train_sharded {shape}: not bit-equal to "
                                 f"the unsharded step ({worst})")
        if shape == "2x1" and any(worst[k] > SHARDED_TRAIN_TOL[k]
                                  for k in worst):
            raise AssertionError(f"train_sharded (2, 1): {worst} over "
                                 f"{SHARDED_TRAIN_TOL}")
        what = ("nccl rank" if shape == "1x1" else "gloo ranks on the card")
        print(f"  ({shape[0]}, {shape[2]}) mesh, {len(rows)} {what}: loss "
              f"{rows[0][shape]['loss']:.6f}, "
              + ("loss and every leaf bit-equal to the unsharded step"
                 if shape != "2x1" else
                 "max |diff| / max |value| by kind "
                 + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                 + f" (limits {SHARDED_TRAIN_TOL})")
              + "; params, qstate and moments a rank "
              + " and ".join(str(b[0]) for b in by)
              + f" B = their placements' (unsharded {one['bytes']} B)")
    res = [r["restored"] for r in reports]
    if not all(x["placed"] and x["equal"] for x in res):
        raise AssertionError(f"train_sharded: the (1, 2) checkpoint "
                             f"restored onto (2, 1): {res}")
    print(f"  the (1, 2) step's checkpoint restored onto (2, 1): "
          f"{res[0]['n']} leaves equal on both ranks, each holding its "
          "shards")
    print(f"  step ms (median of {SHARDED_TRAIN_TIMED}; gloo-staged on one "
          f"card, not a multi-GPU figure): unsharded "
          f"{float(np.median(one['ms'])):.1f}; (1, 2) ranks "
          + ", ".join(f"{float(np.median(r['1x2']['ms'])):.1f}"
                      for r in reports)
          + "; (2, 1) ranks "
          + ", ".join(f"{float(np.median(r['2x1']['ms'])):.1f}"
                      for r in reports)
          + f"; nccl (1, 1) {float(np.median(solo['1x1']['ms'])):.1f} "
          f"(gloo spawn {gloo_s:.1f} s, nccl rank {nccl_s:.1f} s)")
    float_cache_card_vs_cpu(torch, np)


def float_cache_card_vs_cpu(torch, np):
    """The 2-layer model's float forward through `init_caches(rep=FP)`
    on the card and the CPU (see FLOAT_CACHE_*), and each step against
    the no-cache forward over the sequence so far."""
    from repro_torch.core.rep import Rep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.lm import params_to_torch

    P, D = FLOAT_CACHE_PREFILL, FLOAT_CACHE_DECODES
    lm = _sharded_train_lm(max_seq=P + D)
    p = lm.init_np(SEED)
    tok = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, lm.cfg.vocab, size=(2, P + D)).astype(np.int32))
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pt = params_to_torch(p, dev)
        tk = tok.to(dev)
        with torch.no_grad():
            caches = lm.init_caches(2, P + D, Rep.FP, device=dev)
            x, caches = lm.apply(pt, lm.embed_in(pt, tk[:, :P]),
                                 caches=caches, pos=0)
            steps = [lm.logits(pt, x)[:, -1].cpu()]
            for d in range(D):
                x, caches = lm.apply(pt, lm.embed_in(pt, tk[:, P + d:P + d + 1]),
                                     caches=caches, pos=P + d)
                steps.append(lm.logits(pt, x)[:, -1].cpu())
            nocache = [lm.logits(pt, lm.apply(pt, lm.embed_in(
                pt, tk[:, :P + d])))[:, -1].cpu() for d in range(D + 1)]
        res[dev] = (steps, nocache, [c.cpu() for c in tree_leaves(caches)])
        res[dev + "_s"] = time.perf_counter() - t0
        del pt, caches
    (sc, nc, cc), (sh, nh, ch) = res["cuda"], res["cpu"]

    def rel(a, b):
        return float((a - b).abs().max() / (b.max() - b.min()))

    card_cpu = max(rel(a, b) for a, b in zip(sc, sh))
    vs_full = max(rel(a, b) for a, b in zip(sc + sh, nc + nh))
    flips = max(float((_bits(torch, a) != _bits(torch, b)).float().mean())
                for a, b in zip(cc, ch))
    print(f"  float cache, {SHARDED_TRAIN_LAYERS} layers at full width: a "
          f"{P}-token prefill and {D} decodes through init_caches(rep=FP) "
          f"(bfloat16 K/V {tuple(cc[0].shape)}): logits card vs CPU within "
          f"{card_cpu:.3e} of their span (limit {FLOAT_CACHE_TOL}); the "
          f"bfloat16 cache cells card vs CPU differing at most {flips:.4f}; "
          f"each step vs the no-cache forward within {vs_full:.3e} (limit "
          f"{FLOAT_NOCACHE_TOL}); card {res['cuda_s']:.1f} s, CPU "
          f"{res['cpu_s']:.1f} s")
    if card_cpu > FLOAT_CACHE_TOL or vs_full > FLOAT_NOCACHE_TOL:
        raise AssertionError("float cache: the card's logits are off")
    if not all(bool(torch.isfinite(a).all()) for a in sc):
        raise AssertionError("float cache: a logit is not finite")


def phase_done(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"  ({name}: {t - t0:.1f} s)")
    return t


SKIPPABLE = ("entry", "cnn", "calibrate", "parity", "open-loop", "prefix",
             "preempt", "async", "whole_prompt", "int_softmax", "sharded",
             "configs", "musicgen", "olmoe", "llama4", "ssm", "nemotron",
             "blockwise", "hybrid", "embeds", "train", "train_sharded")


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run on one GPU")
    ap.add_argument("--skip", default="",
                    help="comma-separated phases to leave out (a short "
                    "development run; no result line): "
                    + ", ".join(SKIPPABLE))
    skip = set(filter(None, ap.parse_args().skip.split(",")))
    if skip - set(SKIPPABLE):
        ap.error(f"unknown phases {sorted(skip - set(SKIPPABLE))}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"[build] {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, rep in reports.items():
        ptxas[name] = ptxas_summary(rep)
        for fn, info in ptxas[name].items():
            print(f"  {name} {fn}: {info}")
    rng = np.random.default_rng(SEED)
    report, errs = {}, {}
    timer = Timer(torch)
    t0 = time.perf_counter()
    print("[kernels] each kernel vs its plain version on the card")
    errs["int8_matmul"] = max(
        check_int8_matmul(torch, np, timer, rng, report),
        check_config_gemms(torch, np, timer, rng, report),
        check_ssm_gemms(torch, np, timer, rng, report),
        check_hybrid_gemms(torch, np, timer, rng, report),
        check_cnn_gemms(torch, np, timer, rng, report))
    errs["int8_matmul_grouped"] = max(
        check_grouped_gemm(torch, np, timer, rng, report),
        check_llama4_grouped(torch, np, timer, rng, report),
        check_grouped_attention(torch, np, timer, report),
        check_blockwise_products(torch, np, timer, report))
    errs["requant"] = check_requant(torch, np, timer, rng, report)
    errs["paged_attention"] = check_paged_attention(
        torch, np, timer, report, ptxas["paged_attention"])
    errs["paged_attention_kv4"] = check_paged_attention(
        torch, np, timer, report, ptxas["paged_attention"], packed=True)
    for packed in (False, True):
        name = ("paged_attention_kv4" if packed else "paged_attention")
        errs[name + "_shard"] = check_paged_shards(torch, np, timer, report,
                                                   packed)
    errs["quant_flash_attention"] = check_quant_flash_attention(
        torch, np, timer, report, ptxas["quant_attention"])
    bit_length_host_cost(torch)
    t0 = phase_done("kernels", t0)
    entry = {}
    if "entry" not in skip:
        print("[entry] quant_flash_attention through its entry point")
        entry = phase_entry(torch, kernels)
        t0 = phase_done("entry", t0)
    if "cnn" not in skip:
        print("[cnn] NemoCNN at full width: calibrate on the card and the "
              "CPU, the ID forward in every BN mode, card vs CPU")
        phase_cnn(torch, np, kernels)
        cnn_strided_conv(torch, np, kernels)
        t0 = phase_done("cnn", t0)
    lm2 = t2_np = None
    if "calibrate" not in skip:
        print("[calibrate] granite_3_2b at full width, 2 layers: calibrate "
              "on the card and the CPU, deploy once, card vs CPU")
        lm2, t2_np = phase_calibrate(torch, np)
        t0 = phase_done("calibrate", t0)
    if "parity" not in skip:
        print(f"[parity] {PARITY_LAYERS}-layer full width, calibrated, card "
              "vs CPU: "
              + ", ".join(CONFIGS))
        phase_parity(torch, np)
        t0 = phase_done("parity", t0)
    print("[main] full granite_3_2b on the card")
    launches, lm, tables, reqs, run1 = phase_main(torch, np, kernels)
    t0 = phase_done("main", t0)
    if "open-loop" not in skip:
        print("[open-loop] granite_3_2b under Poisson arrivals")
        ol_reqs, closed, rps = phase_open_loop(torch, np, kernels, lm,
                                               tables)
        t0 = phase_done("open-loop", t0)
    if "prefix" not in skip:
        print("[prefix] granite_3_2b system-prompt workload, cold vs "
              "shared")
        phase_prefix(torch, np, kernels, lm, tables)
        t0 = phase_done("prefix", t0)
    if "preempt" not in skip:
        print("[preempt] granite_3_2b under PrioritySLOPolicy")
        preempt0 = {kv_bits: phase_preempt(torch, np, kernels, lm, tables,
                                           reqs, run1[kv_bits], kv_bits)[0]
                    for kv_bits in (8, 4)}
        if "open-loop" not in skip:
            phase_overload(torch, np, kernels, lm, tables, ol_reqs, closed,
                           rps)
        t0 = phase_done("preempt", t0)
        if "async" not in skip:
            print("[async] granite_3_2b at dispatch depth 1")
            phase_async(torch, np, kernels, lm, tables, reqs, run1,
                        preempt0[8])
            t0 = phase_done("async", t0)
    if "whole_prompt" not in skip:
        print("[whole_prompt] granite_3_2b over SlotArena (the reference's "
              "default arena), chunked and bucketed; serve_batch")
        if lm2 is None:
            lm2, t2_np = granite_2_layers()
        phase_whole_prompt(torch, np, kernels, lm, tables, reqs, run1[8],
                           lm2, t2_np)
        t0 = phase_done("whole_prompt", t0)
    if "int_softmax" not in skip:
        print("[int_softmax] integer-only attention and the write-then-"
              "gather path: card vs CPU, then granite_3_2b at full width")
        if lm2 is None:
            lm2, t2_np = granite_2_layers()
        phase_int_softmax(torch, np, kernels, timer, lm, tables, reqs, run1,
                          lm2, t2_np)
        t0 = phase_done("int_softmax", t0)
    del lm, tables
    shard_launches = None
    if "sharded" not in skip:
        print(f"[sharded] granite_3_2b at full width, 2 layers, kv heads "
              f"split over {SHARD_RANKS} ranks sharing the card (gloo), "
              "then one nccl rank")
        if lm2 is None:
            lm2, t2_np = granite_2_layers()
        shard_launches = phase_sharded(torch, np, kernels, lm2, t2_np, reqs)
        t0 = phase_done("sharded", t0)
    if "blockwise" not in skip:
        print(f"[blockwise] granite_3_2b at full width, {BLOCKWISE_LAYERS} "
              f"layers: whole prompts of {BLOCKWISE_PROMPTS} tokens over "
              f"{BLOCKWISE_LEN} positions, card vs CPU")
        if lm2 is None:
            lm2, t2_np = granite_2_layers()
        phase_blockwise(torch, np, kernels, lm2, t2_np)
        t0 = phase_done("blockwise", t0)
    del lm2, t2_np
    if "configs" not in skip:
        print("[configs] " + " and ".join(CONFIGS) + f" at full width, "
              f"{CONFIG_LAYERS} layers")
        phase_configs(torch, np, kernels)
        t0 = phase_done("configs", t0)
    if "musicgen" not in skip:
        print("[musicgen] musicgen_medium: 2-layer parity, then full width "
              f"on the card, {MUSICGEN_LAYERS} of 48 layers")
        phase_musicgen(torch, np, kernels)
        t0 = phase_done("musicgen", t0)
    if "olmoe" not in skip:
        print(f"[olmoe] {MOE_ARCH}: {MOE_PARITY_LAYERS}-layer parity, then "
              "full width on the "
              "card")
        launches["int8_matmul_grouped"] = phase_olmoe(
            torch, np, kernels)["int8_matmul_grouped"]
        t0 = phase_done("olmoe", t0)
    else:  # the grouped GEMM's path launches are the olmoe phase's
        launches["int8_matmul_grouped"] = None
    if "llama4" not in skip:
        print(f"[llama4] {LLAMA4_ARCH}: the dense half of a pair at full "
              "width, card vs CPU; the reduced model served over both "
              "arenas and its FQ step, card vs CPU")
        phase_llama4(torch, np, kernels)
        t0 = phase_done("llama4", t0)
    if "ssm" not in skip:
        print(f"[ssm] {SSM_ARCH}: {SSM_PARITY_LAYERS}-layer parity, then "
              "full width on the "
              "card")
        phase_ssm(torch, np, kernels)
        t0 = phase_done("ssm", t0)
    if "hybrid" not in skip:
        print(f"[hybrid] {HYBRID_ARCH}: {HYBRID_PARITY_LAYERS}-layer parity, "
              f"then full width on the card, {HYBRID_LAYERS} of 38 layers")
        phase_hybrid(torch, np, kernels)
        mamba2_groups_parity(torch, np)
        t0 = phase_done("hybrid", t0)
    if "nemotron" not in skip:
        print("[nemotron] one nemotron_4_340b layer at full width, card vs "
              "CPU")
        phase_nemotron(torch, np)
        t0 = phase_done("nemotron", t0)
    if "embeds" not in skip:
        print(f"[embeds] {EMBEDS_ARCH} at full width, {EMBEDS_LAYERS} of 80 "
              "layers, served from int8 embedding rows: card vs CPU, then "
              "the card")
        phase_embeds(torch, np, kernels)
        t0 = phase_done("embeds", t0)
    if "train" not in skip:
        print("[train] FakeQuantized training: granite_3_2b card vs CPU, "
              f"the trainer over {TRAIN_LAYERS} layers with a restart, "
              f"{EMBEDS_ARCH}'s loss_fn_embeds; then "
              + ", ".join(f[0] for f in TRAIN_FAMILIES)
              + ": card vs CPU and the trainer")
        phase_train(torch, np, kernels)
        t0 = phase_done("train", t0)
    if "train_sharded" not in skip:
        print(f"[train_sharded] granite_3_2b at full width, "
              f"{SHARDED_TRAIN_LAYERS} layers: the FQ step on (1, 2) and "
              "(2, 1) meshes of gloo ranks sharing the card and on one nccl "
              "rank, a checkpoint re-sharded; the float forward's cache")
        phase_train_sharded(torch, np)
        phase_done("train_sharded", t0)
    if skip:
        print(f"skipped phases {sorted(skip)}: the rows of their kernels "
              "carry launches null")
    launches["quant_flash_attention"] = entry.get("quant_flash_attention")
    rep_shape = {"int8_matmul": 8, "int8_matmul_grouped": 0, "requant": 4,
                 "paged_attention": 0, "paged_attention_kv4": 0,
                 "quant_flash_attention": 0}
    rows = []
    for name in kernels.KERNELS:
        r = report[name][rep_shape[name]]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
    # the paged attention per head range: launches of the sharded phase
    for name in ("paged_attention", "paged_attention_kv4"):
        r = report[name + "_shard"][0]
        rows.append({
            "name": name + "_shard", "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": (None if shard_launches is None
                         else shard_launches[name]),
            "max_abs_err": errs[name + "_shard"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
