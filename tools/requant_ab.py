#!/usr/bin/env python3
"""A/B timing of the port's requant sites in two checkouts, on one card.

    python3 tools/requant_ab.py --base DIR
    python3 tools/requant_ab.py --sweep

Times each standalone requant site of the serving path, as the checkout
at DIR and this one implement it, at the main path's chunk (8 slots x
32 tokens) and decode (8 slots) shapes of granite_3_2b, and the bare
`requant` at two more shapes, in turns: base, this, this, base, each in
a process of its own that builds its own kernels.  A site is the whole
of what the layer does there: where a tree has `requant_add` /
`requant_gate` / heads-to-rows, one launch; where it has only
`requant`, the torch glue and requant launches its layer ran before
(`QAdd.apply_id`; the MLP's LUT, gate product and h_rqt; ctx_rqt and
the heads-to-rows copy).  Both trees get the same seeded inputs and
tables; each time is `chip_smoke.Timer`'s median of 10 calls with the
L2 flushed before each.  Each process hashes its outputs, so the line
says whether the two trees wrote the same bytes.

`--sweep` times this checkout's three forms at the main path's shapes
under every launch plan (threads a block, vectors a thread), marking
the one `requant_plan` picks; each plan's output must equal the chosen
plan's.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SLOTS, CHUNK, H, HD, D, FF = 8, 32, 32, 64, 2048, 8192
# (site, shape of its input); M 256 a chunk step, M 8 a decode step
SITES = (("ctx_rqt", (SLOTS, H, CHUNK, HD)), ("ctx_rqt", (SLOTS, H, 1, HD)),
         ("gate", (SLOTS * CHUNK, FF)), ("gate", (SLOTS, FF)),
         ("add", (SLOTS, CHUNK, D)), ("add", (SLOTS, 1, D)),
         ("rqt per-channel", (SLOTS * CHUNK, D)),
         ("rqt int32-out", (SLOTS, CHUNK, D)))
PLAN_THREADS = (64, 128, 256, 512)
PLAN_PER_THREAD = (1, 2, 4)


def site_call(torch, np, site, shape, seed):
    """-> a call of `site` on seeded inputs, as the imported tree
    implements it."""
    from repro_torch import kernels
    from repro_torch.core.intmath import apply_lut
    from repro_torch.core.requant import make_rqt

    rng = np.random.default_rng(seed)
    N = shape[-1]

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def rqt(ratio, per_channel, **kw):
        eps = ratio * (rng.uniform(0.5, 1.5, size=N) if per_channel
                       else float(rng.uniform(0.5, 1.5)))
        return {k: card(v) for k, v in make_rqt(eps, 1.0, **kw).items()}

    def ints(lo, hi, dtype):
        return card(rng.integers(lo, hi, size=shape).astype(dtype))

    requant = kernels.requant
    branch = dict(qmin=-(1 << 24), qmax=1 << 24)
    if site == "ctx_rqt":
        q, rq = ints(-(1 << 14), 1 << 14, np.int32), rqt(1 / 128, False)
        B, _, S, _ = shape
        if hasattr(kernels, "requant_add"):
            return lambda: requant(q, rq, heads_to_rows=True).view(
                B, S, H * HD)
        return lambda: requant(q, rq).permute(0, 2, 1, 3).reshape(
            B, S, H * HD)
    if site == "gate":
        s_pre, s_u = ints(-128, 128, np.int8), ints(-128, 128, np.int8)
        lut = card(rng.integers(-128, 128, size=256).astype(np.int8))
        zp_g = card(np.int32(-11))
        h_rqt = rqt(1 / 256, False, zp_out=2)
        if hasattr(kernels, "requant_gate"):
            return lambda: kernels.requant_gate(s_pre, s_u, lut, zp_g, h_rqt)

        def gate():
            s_g = apply_lut(s_pre, lut, qmin=-128)
            prod = (s_g.to(torch.int32) - zp_g.to(torch.int32)) * s_u.to(
                torch.int32)
            return requant(prod.contiguous(), h_rqt)
        return gate
    if site == "add":
        a, b = ints(-128, 128, np.int8), ints(-(1 << 17), 1 << 17, np.int32)
        kw = dict(acc_bound=float(1 << 16), **branch)
        t = {"rq_a": rqt(0.5, False, **kw), "rq_b": rqt(1e-3, True, **kw),
             "zp_a": card(np.int32(5)), "zp_b": card(np.int32(-7))}
        if hasattr(kernels, "requant_add"):
            return lambda: kernels.requant_add(a, b, t)

        def add():
            qa = (a.to(torch.int32) - t["zp_a"].to(torch.int32)).contiguous()
            qb = (b.to(torch.int32) - t["zp_b"].to(torch.int32)).contiguous()
            ya = requant(qa, t["rq_a"], out_dtype=torch.int32, **branch)
            yb = requant(qb, t["rq_b"], out_dtype=torch.int32, **branch)
            return (ya + yb).clamp(-128, 127).to(torch.int8)
        return add
    q = ints(-(1 << 14), 1 << 14, np.int32)
    if site == "rqt per-channel":
        rq = rqt(1 / 128, True, zp_out=3)
        return lambda: requant(q, rq)
    rq = rqt(1 / 128, True, **branch)
    return lambda: requant(q, rq, out_dtype=torch.int32, **branch)


def time_tree(tree: str) -> None:
    """Child: time this tree's sites, print JSON."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import SEED, Timer

    timer = Timer(torch)
    out = {}
    for i, (site, shape) in enumerate(SITES):
        fn = site_call(torch, np, site, shape, SEED + 30 + i)
        res = fn()
        digest = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()
        out[f"{site} {shape}"] = (timer(fn), digest[:12])
    print(json.dumps(out))


def sweep() -> None:
    """Time every launch plan of this checkout's requant forms."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import SEED, Timer
    rk = importlib.import_module("repro_torch.kernels.requant_kernel")

    timer = Timer(torch)
    chosen = rk.requant_plan
    for i, (site, shape) in enumerate(SITES[:6]):
        fn = site_call(torch, np, site, shape, SEED + 30 + i)
        want = fn()
        cells = []
        for threads, per in itertools.product(PLAN_THREADS, PLAN_PER_THREAD):
            rk.requant_plan = (lambda n, vec, t=threads, p=per:
                               chosen(n, vec, t, p))
            try:
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{threads}x{per}: another output")
                ms = timer(fn)
            finally:
                rk.requant_plan = chosen
            mark = "*" if (threads, per) == (rk.THREADS,
                                              rk.PER_THREAD) else ""
            cells.append(f"{threads}t/{per}v {ms:.4f}{mark}")
        print(f"  {site} {shape}: " + ", ".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan of this checkout")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        time_tree(args.tree)
        return 0
    if not (args.sweep or args.base):
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
            [sys.executable, __file__, "--tree", str(tree)],
            check=True, capture_output=True, text=True)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for key in runs[0][1]:
        base = [r[key] for label, r in runs if label == "base"]
        this = [r[key] for label, r in runs if label == "this"]
        same = len({x[1] for x in base + this}) == 1
        print(f"  {key}: base {base[0][0]:.4f} / {base[1][0]:.4f} ms, "
              f"this {this[0][0]:.4f} / {this[1][0]:.4f} ms, "
              f"{min(b[0] for b in base) / max(t[0] for t in this):.2f}x "
              f"or more; outputs {'equal' if same else 'DIFFER'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
