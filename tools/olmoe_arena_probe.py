#!/usr/bin/env python3
"""olmoe_1b_7b's tokens by arena, on the card and the CPU.

    python3 tools/olmoe_arena_probe.py [--layers 8]

Deploys olmoe_1b_7b at full width over its first `--layers` layers on
the card (`deploy_model`, the entry point's calibration, chip_smoke's
seed) and serves chip_smoke's 8-request olmoe cell (prompts 17-300, 16
new tokens, 8 slots, exact-length prefill) over `SlotArena` and over
the paged arena, on the card and, with the same tables, on the CPU.
It prints each run's tokens, whether the card's equal the CPU's on
each arena, where the two arenas' tokens first part, and the MoE's
capacity drops: (token, expert) choices whose slot was full, counted
over the decode dispatches' rows and split into active and parked rows
(a parked row is a slot with no request, token 0 at INACTIVE_POS,
which routes and takes capacity as the reference's does).  It exits 1
when the card and the CPU differ on an arena.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import (
        MAX_LEN, N_SLOTS, SEED, card_line, make_engine, serve,
    )
    from repro_torch.launch.serve import deploy_model, ragged_requests
    from repro_torch.layers.attention import INACTIVE_POS
    from repro_torch.layers.moe import QMoE
    from repro_torch.models.blocks import DenseBlock
    from repro_torch.models.lm import tables_to

    if not torch.cuda.is_available():
        print("olmoe_arena_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    lm, tables = deploy_model("olmoe_1b_7b", reduced=False, max_seq=MAX_LEN,
                              seed=SEED, device="cuda", n_layers=args.layers)
    print(f"deployed olmoe_1b_7b, {lm.cfg.n_layers} of 16 layers at full "
          f"width, in {time.perf_counter() - t0:.1f} s")
    reqs = ragged_requests(8, lm.cfg.vocab, np.random.default_rng(SEED + 2),
                           prompt_lo=17, prompt_hi=300, gen=16)
    print(f"prompts {[r.prompt_len for r in reqs]}")
    drops, parked = {}, {}
    route, block_id = QMoE._route, DenseBlock.apply_id

    def block(self, t, s_x, cache, pos):
        parked["rows"] = (pos.reshape(-1) == INACTIVE_POS).cpu().numpy()
        return block_id(self, t, s_x, cache, pos)

    def counting(self, logits, *a, **kw):
        out = route(self, logits, *a, **kw)
        G, Gs = logits.shape[:2]
        rows = parked.get("rows")
        if G == 1 and Gs == N_SLOTS and rows is not None and len(
                rows) == Gs:                      # a decode dispatch
            dropped = (out[0] == 0).sum(dim=-1)[0].cpu().numpy()
            d = drops.setdefault(key, [0, 0, 0])
            d[0] += int(dropped[~rows].sum())
            d[1] += int(dropped[rows].sum())
            d[2] += 1
        return out

    QMoE._route, DenseBlock.apply_id = counting, block
    runs = {}
    for dev in ("cuda", "cpu"):
        t = tables if dev == "cuda" else tables_to(tables, "cpu")
        for paged in (False, True):
            key = (dev, "paged" if paged else "slot")
            t0 = time.perf_counter()
            tok, stats, _ = serve(lm, t, reqs, dev, engine=make_engine(
                lm, t, dev, paged=paged))
            runs[key] = tok
            d = drops.get(key, [0, 0, 0])
            print(f"{key[0]} {key[1]}: {stats['steps']} steps in "
                  f"{time.perf_counter() - t0:.1f} s; capacity drops in "
                  f"{d[2]} decode groups: {d[0]} of active rows' "
                  f"choices, {d[1]} of parked rows'")
            print(f"  tokens {tok}")
    QMoE._route, DenseBlock.apply_id = route, block_id
    bad = 0
    for arena in ("slot", "paged"):
        same = runs[("cuda", arena)] == runs[("cpu", arena)]
        bad += not same
        print(f"{arena}: card {'==' if same else '!='} CPU")
    for dev in ("cuda", "cpu"):
        a, b = runs[(dev, "slot")], runs[(dev, "paged")]
        first = [(rid, next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                            if x != y)) for rid in a if a[rid] != b[rid]]
        print(f"{dev}: slot vs paged tokens "
              + ("equal" if not first else
                 f"differ in {len(first)} requests, first at (request, "
                 f"token) {first}"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
