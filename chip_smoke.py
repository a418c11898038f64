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
            chatglm3_6b (M 8 and 256), with the plan `gemm_plan` took;
            the requant's three forms (apply_rqt, heads-to-rows for
            ctx_rqt; the whole QAdd; the MLP's LUT, gate product and
            h_rqt) exactly at the chunk and decode shapes, per-channel,
            scalar-path and wrapping tables; the paged attention in both
            pool modes
            (int8, and int4-packed with per-head unpack operands) at S
            32 and 1, T 512 and 4096, on its tensor-core kernel (with
            the launch `paged_plan` took and its registers and spills),
            and at the new configs' heads (hd 128; group 3 with 8 kv
            heads, group 16 with 2; S 32 and 1 at T 512), equal to its
            plain version: 0 quanta moved and max |diff| 0; the
            quantized flash
            attention at full granite geometry (S 8192 x 8192 with bkv
            128 and 64 on the tensor-core kernel and bkv 256 on the
            CUDA-core one, and 128 queries at offset 8064 over 8192
            keys) and at hd 128 / 192, equal to its plain version (0
            quanta moved), with the kernel path `qfa_plan` took and its
            registers and spills; times beside bounds and the island
            floor
  entry     `quant_flash_attention` driven through its entry point (no
            serving path calls it), counts read around it
  parity    granite_3_2b, llama3_2_3b and chatglm3_6b at full width,
            each cut to 2 layers, the card against the CPU (plain
            versions), at kv_bits 8 and 4: one prefill_chunk must give
            equal int32 logits and K/V pools (packed at 4) byte for
            byte, and the engine equal greedy tokens on the same ragged
            requests; torch.exp of the two devices is compared over
            [-104, 0] first
  main      full granite_3_2b (40 layers, random seeded weights deployed
            layer by layer without calibration): 8 ragged requests
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
  configs   llama3_2_3b and chatglm3_6b at full width and depth, each
            served once (8 ragged requests, kv_bits 8, after
            `warmup()`): deploy time, device memory, launches by kernel
            (counts set to 0 just before the run), GEMM launches by site
            and path, the full `stats()`

Then a `kernels` JSON line, the card line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout (no src/repro_torch beside it), it exits non-zero at once.
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
    "requant": "src/repro/kernels/requant_kernel.py:47",
    "paged_attention": "src/repro/kernels/paged_attention.py:238",
    "paged_attention_kv4": "src/repro/kernels/paged_attention.py:238",
    "quant_flash_attention": "src/repro/kernels/quant_attention.py:101",
}
SOURCES = {
    "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
    "requant": "src/repro_torch/kernels/csrc/requant.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_kv4": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "quant_flash_attention":
        "src/repro_torch/kernels/csrc/quant_attention.cu",
}
# the __global__ functions of csrc/*.cu
KERNEL_NAMES = ("gemm_gemv_kernel", "gemm_wgmma_kernel", "requant_kernel",
                "requant_add_kernel", "requant_gate_kernel",
                "paged_attn_mma_kernel", "paged_attn_mma_packed_kernel",
                "quant_attn_mma_kernel", "quant_attn_kernel")
# the requant kernel's __global__ functions -> the call forms each serves
REQUANT_KERNELS = {"requant_kernel": "rqt, rqt_heads",
                   "requant_add_kernel": "add",
                   "requant_gate_kernel": "gate"}
# the kernels each serving path launches
PATH_KERNELS = {8: ("int8_matmul", "requant", "paged_attention"),
                4: ("int8_matmul", "requant", "paged_attention_kv4")}
# main-path engine settings
N_SLOTS, PAGE, MAX_LEN, N_PAGES, CHUNK = 8, 16, 512, 256, 32
# paged attention at full granite geometry (B 8, H 32, K 8, hd 64,
# pages of 16): (S, T), a prefill chunk and a decode step over the main
# cell's 512 positions and over 4096
PAGED_SHAPES = ((CHUNK, MAX_LEN), (1, MAX_LEN), (CHUNK, 4096), (1, 4096))
# the configs served beside granite_3_2b, and the geometry each gives
# the paged attention: (H, K, hd), GQA group 3 and group 16
CONFIGS = ("llama3_2_3b", "chatglm3_6b")
CONFIG_HEADS = {"llama3_2_3b": (24, 8, 128), "chatglm3_6b": (32, 2, 128)}
# open-loop phase: requests, their arrival rate over the closed loop's
# requests per second, and the SLOs of the goodput roll-up (seconds)
OPEN_LOOP_N, OPEN_LOOP_RATE, SLO_TTFT_S, SLO_ITL_S = 16, 2.0, 2.0, 0.25
# the engine's record_function range around each dispatch
ANNOTATION = "repro_torch.serving/"
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
    if mode == "int32" and M > 16:
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
    granite_3_2b (`gemm_sites`), decode (M 8) and chunk (M 256)."""
    from repro_torch.configs.base import get_config

    worst = 0
    for arch in CONFIGS:
        for (K, N, mode), site in gemm_sites(get_config(arch)).items():
            for M in (N_SLOTS, N_SLOTS * CHUNK):
                worst = max(worst, gemm_case(torch, np, timer, rng, report,
                                             M, K, N, mode,
                                             f"{arch} {site}"))
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
        requant, requant_add, requant_add_plain, requant_gate,
        requant_gate_plain, requant_plain,
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
    the heads of `CONFIGS` (S 32 and 1 at T 512).  Tolerance (`check_kernel`): the kernel's int8 probability image may
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
                  (a, S) for a in CONFIGS for S in (CHUNK, 1))]
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


def serve(lm, tables, requests, device, kv_bits=8, *, telemetry=None,
          warm=False, engine=None):
    """Serve `requests` closed-loop (submit all, drain) on a fresh
    engine, or on `engine`; with `warm`, after `warmup()` and
    `reset_stats()`.  -> ({req_id: tokens}, stats, engine)."""
    import copy

    from repro_torch.serving import (
        SchedulerConfig, ServingConfig, ServingEngine,
    )

    eng = engine or ServingEngine(lm, tables, ServingConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PAGE, n_pages=N_PAGES,
        device=device, kv_bits=kv_bits, telemetry=telemetry,
        scheduler=SchedulerConfig(prefill_chunk=CHUNK)))
    if warm:
        eng.warmup()
        eng.reset_stats()
    n0 = len(eng.completed)
    for r in requests:
        eng.submit(copy.deepcopy(r))
    done = eng.run_until_drained()[n0:]
    return {c.req_id: list(c.tokens) for c in done}, eng.stats(), eng


def exp_agreement(torch):
    """torch.exp on the card against torch.exp on the host CPU over
    every float32 in [-104, 0] (the softmax's exponents; below -104 both
    give 0).  The attention's only float work is the softmax, so these
    two are what card-vs-CPU parity rests on.  -> (differing, total)."""
    lo = -(1 << 31)                                     # bits of -0.0
    hi = lo + (0xC2D00000 - 0x80000000) + 1             # bits of -104.0
    step = 1 << 26
    bad = 0
    for a in range(lo, hi, step):
        bits = torch.arange(a, min(a + step, hi), dtype=torch.int64,
                            device="cuda").to(torch.int32)
        x = bits.view(torch.float32)
        on_card = torch.exp(x).view(torch.int32).cpu()
        on_cpu = torch.exp(x.cpu()).view(torch.int32)
        bad += int((on_card != on_cpu).sum())
    return bad, hi - lo


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
          f"{CHUNK}, 2 layers): int32 "
          f"logits {tuple(out['cpu'][0].shape)} and K/V pools "
          f"{tuple(out['cpu'][1].shape)} equal byte for byte")


def phase_parity(torch, np):
    t0 = time.perf_counter()
    bad, total = exp_agreement(torch)
    print(f"  exp on the card vs the CPU: {bad} of {total} float32 inputs "
          f"in [-104, 0] differ ({time.perf_counter() - t0:.1f} s)")
    for arch in ("granite_3_2b",) + CONFIGS:
        config_parity(torch, np, arch)


def config_parity(torch, np, arch):
    """`arch` at full width cut to 2 layers, the card against the CPU at
    kv_bits 8 and 4: one prefill_chunk byte for byte, then the engine's
    tokens on 4 ragged requests."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import ragged_requests
    from repro_torch.models.lm import DecoderLM, tables_from_numpy

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    lm = DecoderLM(cfg, max_seq=MAX_LEN)
    t_np = lm.deploy(lm.init_np(SEED))
    reqs = ragged_requests(4, cfg.vocab, np.random.default_rng(SEED + 1),
                           prompt_lo=17, prompt_hi=80, gen=6)
    tables = {dev: tables_from_numpy(t_np, dev) for dev in ("cuda", "cpu")}
    print(f"  {arch}: 2 layers at full width (d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_padded}) deployed in "
          f"{time.perf_counter() - t0:.1f} s")
    for kv_bits in (8, 4):
        t0 = time.perf_counter()
        prefill_parity(torch, np, lm, t_np, kv_bits)
        gpu_tok = serve(lm, tables["cuda"], reqs, "cuda", kv_bits)[0]
        cpu_tok = serve(lm, tables["cpu"], reqs, "cpu", kv_bits)[0]
        print(f"  {arch} 2-layer full-width parity, kv_bits {kv_bits}: "
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


def phase_main(torch, np, kernels):
    """-> (launches of run 1 by kernel, the granite lm and tables)."""
    from repro_torch.launch.serve import deploy_model, ragged_requests

    t0 = time.perf_counter()
    lm, tables = deploy_model("granite_3_2b", reduced=False,
                              max_seq=MAX_LEN, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    print(f"  deployed granite_3_2b ({lm.cfg.n_layers} layers, d "
          f"{lm.cfg.d_model}, vocab {lm.cfg.vocab_padded}) layer by layer "
          f"in {deploy_s:.1f} s; device memory "
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
          f" positions ({same / total:.3f}; lossy by design, uncalibrated "
          "tables)")
    return launches, lm, tables


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
    Every request's tokens must equal its closed-loop tokens."""
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


def phase_configs(torch, np, kernels):
    """Each of CONFIGS at full width and depth, served once on the card:
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
                                  seed=SEED, device="cuda")
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
        path = PATH_KERNELS[8]
        if any(launches[n] == 0 for n in path) or any(
                c for n, c in launches.items() if n not in path):
            raise AssertionError(f"{arch}: launches {launches} are not the "
                                 f"path's {path}")
        gemm_site_launches(kernels, cfg, s["steps"], launches["int8_matmul"])
        requant_form_launches(kernels, cfg, s["steps"], launches["requant"])
        print_stats(arch, s)
        print(f"  {arch} tokens: {tok}")
        out[arch] = launches
        del lm, tables, eng
    return out


def gemm_sites(cfg) -> dict:
    """(K, N, output type) of each QLinear site of the serving path ->
    its name (wk and wv, gate and up share a shape)."""
    d, hd = cfg.d_model, cfg.hd
    return {(d, cfg.n_heads * hd, "int8"): "wq",
            (d, cfg.n_kv_heads * hd, "int8"): "wk+wv",
            (cfg.n_heads * hd, d, "int32"): "wo",
            (d, cfg.d_ff, "int8"): "gate+up",
            (cfg.d_ff, d, "int32"): "down",
            (d, cfg.vocab_padded, "int32"): "head"}


def gemm_site_launches(kernels, cfg, steps: int, total: int) -> None:
    """Print the main run's GEMM launches by site and path (M <= 16:
    decode GEMV; larger M: chunk wgmma) from `int8_matmul.by_shape`;
    they must add up to the GEMM's count, 7 per layer and 1 for the
    head in every step."""
    sites = gemm_sites(cfg)
    by = kernels.int8_matmul.by_shape
    parts = []
    for (M, K, N, mode), n in sorted(by.items()):
        path = "decode" if M <= 16 else "chunk"
        parts.append(f"{sites.get((K, N, mode), f'K{K} N{N} {mode}')} "
                     f"M{M} ({path}) {n}")
    per_step = 7 * cfg.n_layers + 1
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
    one gate and two QAdds, and nothing else."""
    by = kernels.requant.by_form
    L = cfg.n_layers * steps
    want = {"rqt_heads": L, "gate": L, "add": 2 * L}
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
    path = PATH_KERNELS[kv_bits]
    if any(launches[n] == 0 for n in path):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    off_path = [n for n, c in launches.items() if c and n not in path]
    if off_path:
        raise AssertionError(f"kernels off the path launched: {launches}")
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


def phase_done(name: str, t0: float) -> float:
    t = time.perf_counter()
    print(f"  ({name}: {t - t0:.1f} s)")
    return t


def main() -> int:
    argparse.ArgumentParser(description="smoke run on one GPU").parse_args()
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
        check_config_gemms(torch, np, timer, rng, report))
    errs["requant"] = check_requant(torch, np, timer, rng, report)
    errs["paged_attention"] = check_paged_attention(
        torch, np, timer, report, ptxas["paged_attention"])
    errs["paged_attention_kv4"] = check_paged_attention(
        torch, np, timer, report, ptxas["paged_attention"], packed=True)
    errs["quant_flash_attention"] = check_quant_flash_attention(
        torch, np, timer, report, ptxas["quant_attention"])
    t0 = phase_done("kernels", t0)
    print("[entry] quant_flash_attention through its entry point")
    entry = phase_entry(torch, kernels)
    print("[parity] 2-layer full width, card vs CPU: " + ", ".join(
        ("granite_3_2b",) + CONFIGS))
    phase_parity(torch, np)
    t0 = phase_done("entry and parity", t0)
    print("[main] full granite_3_2b on the card")
    launches, lm, tables = phase_main(torch, np, kernels)
    t0 = phase_done("main", t0)
    print("[open-loop] granite_3_2b under Poisson arrivals")
    phase_open_loop(torch, np, kernels, lm, tables)
    del lm, tables
    t0 = phase_done("open-loop", t0)
    print("[configs] " + " and ".join(CONFIGS) + " at full width and depth")
    phase_configs(torch, np, kernels)
    phase_done("configs", t0)
    launches["quant_flash_attention"] = entry["quant_flash_attention"]
    rep_shape = {"int8_matmul": 8, "requant": 4, "paged_attention": 0,
                 "paged_attention_kv4": 0, "quant_flash_attention": 0}
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
