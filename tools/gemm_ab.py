#!/usr/bin/env python3
"""A/B timing of the port's int8 GEMM in two checkouts, on one card.

    python3 tools/gemm_ab.py --base DIR
    python3 tools/gemm_ab.py --sweep

Times `repro_torch.kernels.int8_matmul` of the checkout at DIR and of
this one at the 12 shapes `chip_smoke.py` checks (M 8 and 256 at every
GEMM site of granite_3_2b's serving path), in turns: base, this, this,
base, each in a process of its own that builds its own kernel.  Each
time is `chip_smoke.Timer`'s median of 10 launches with the L2 flushed
before each; both trees get the same seeded inputs.  Beside the device
time, the host time of one call: 1,000 calls without synchronising,
divided.  Prints the card's name and power limit, then one line per
shape.

`--sweep` times, in this checkout only, every launch plan the kernel
takes (each tile or GEMV width with 1 to 16 splits of K) at the same
shapes, each checked against the plain version, and prints them
fastest first beside the plan `gemm_plan` picks.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(M, K, N, mode) for M in (8, 256)
          for K, N, mode in ((2048, 2048, "int8"), (2048, 512, "int8"),
                             (2048, 8192, "int8"), (2048, 2048, "int32"),
                             (8192, 2048, "int32"), (2048, 49408, "int32"))]


def time_tree(tree: str) -> None:
    """Child: time this tree's int8_matmul at SHAPES, print JSON."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import Timer, rand_rqt
    from repro_torch.kernels import int8_matmul

    timer = Timer(torch)
    out = {}
    for i, (M, K, N, mode) in enumerate(SHAPES):
        g = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randint(-128, 128, (M, K), dtype=torch.int8,
                          device="cuda", generator=g)
        w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=g).t()
        bias = torch.randint(-(1 << 20), 1 << 20, (N,), dtype=torch.int32,
                             device="cuda", generator=g)
        rqt = (rand_rqt(torch, np, np.random.default_rng(i), N, True,
                        int32_out=False) if mode == "int8" else None)
        ms = timer(lambda: int8_matmul(x, w, bias, rqt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            int8_matmul(x, w, bias, rqt)
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out[f"M={M} K={K} N={N} {mode}-out"] = (ms, host_us)
    print(json.dumps(out))


def sweep() -> None:
    """Time every plan at SHAPES (this checkout), fastest first."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import Timer, rand_rqt
    from repro_torch.kernels import int8_matmul, int8_matmul_plain
    mod = sys.modules["repro_torch.kernels.int8_matmul"]

    timer = Timer(torch)
    chosen = mod.gemm_plan
    for i, (M, K, N, mode) in enumerate(SHAPES):
        g = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randint(-128, 128, (M, K), dtype=torch.int8,
                          device="cuda", generator=g)
        w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=g).t()
        bias = torch.randint(-(1 << 20), 1 << 20, (N,), dtype=torch.int32,
                             device="cuda", generator=g)
        rqt = (rand_rqt(torch, np, np.random.default_rng(i), N, True,
                        int32_out=False) if mode == "int8" else None)
        want = int8_matmul_plain(x, w, bias, rqt)
        gemv = M <= 16
        bk = mod.GEMV_BK if gemv else mod.WGMMA_BK
        ksteps = -(-K // bk)
        tiles = ([(chosen(M, N, K).bm, bn) for bn in mod.GEMV_COLS] if gemv
                 else list(mod.WGMMA_TILES))
        plans = set()
        for bm, bn in tiles:
            for s in (1, 2, 3, 4, 6, 8, 16):
                sps = -(-ksteps // min(s, ksteps))
                splits = -(-ksteps // sps)
                n = (1 if gemv else -(-M // bm)) * -(-N // bn)
                plans.add(mod.GemmPlan("gemv" if gemv else "wgmma", bm, bn,
                                       bk, splits, sps * bk, n * splits))
        rows = []
        for p in sorted(plans):
            mod.gemm_plan = lambda *a, p=p: p
            if not torch.equal(int8_matmul(x, w, bias, rqt), want):
                raise AssertionError(f"plan {p} is wrong")
            rows.append((timer(lambda: int8_matmul(x, w, bias, rqt)), p))
        mod.gemm_plan = chosen
        rows.sort()
        c = chosen(M, N, K)
        print(f"  M={M} K={K} N={N} {mode}-out, picked {c.bm}x{c.bn} "
              f"s{c.splits}: " + ", ".join(
                  f"{p.bm}x{p.bn} s{p.splits} ({p.blocks} blocks) {t:.4f}"
                  for t, p in rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan in this checkout")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        time_tree(args.tree)
        return 0
    if not args.sweep and not args.base:
        ap.error("give --base DIR or --sweep")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}")
    if args.sweep:
        sweep()
        return 0
    runs = []
    for label, tree in (("base", args.base), ("this", ROOT), ("this", ROOT),
                        ("base", args.base)):
        res = subprocess.run(
            [sys.executable, __file__, "--base", args.base, "--tree",
             str(tree)], check=True, capture_output=True, text=True)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for shape in runs[0][1]:
        base = [r[shape] for label, r in runs if label == "base"]
        this = [r[shape] for label, r in runs if label == "this"]
        print(f"  {shape}: base {base[0][0]:.4f} / {base[1][0]:.4f} ms, "
              f"this {this[0][0]:.4f} / {this[1][0]:.4f} ms, "
              f"{min(b[0] for b in base) / max(t[0] for t in this):.1f}x "
              f"or more; host us per call: base {base[0][1]:.1f} / "
              f"{base[1][1]:.1f}, this {this[0][1]:.1f} / {this[1][1]:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
