#!/usr/bin/env python3
"""A/B timing of the port's attention kernels in two checkouts, on one
card.

    python3 tools/attn_ab.py --base DIR
    python3 tools/attn_ab.py --base DIR --paged [--packed]
    python3 tools/attn_ab.py --sweep [--packed]
    python3 tools/attn_ab.py --sass

Times `repro_torch.kernels.quant_flash_attention` of the checkout at DIR
and of this one at `chip_smoke.QFA_SHAPES` (full granite_3_2b geometry:
B 1, 32 query heads, 8 kv heads), or with `--paged` the int8 paged
attention `repro_torch.kernels.paged_attention` at
`chip_smoke.PAGED_SHAPES` (8 slots, 32 query heads, 8 kv heads, hd 64,
pages of 16; S 32 and 1, T 512 and 4096), over int4-packed pools with
`--packed`, in turns: base, this, this, base, each in a process of its
own that builds its own kernels.  Both trees get the same seeded
inputs (`chip_smoke.qfa_inputs`, `chip_smoke.paged_inputs`, its
`packed` pools and unpack operands with `--packed`); each time is
`chip_smoke.Timer`'s median of
10 launches with the L2 flushed before each.  Each process also hashes
its outputs, so the line says whether the two trees wrote the same
bytes.  Prints the card's name and power limit, then one line per
shape.

`--sweep` times the int8 paged attention of this checkout (with
`--packed`, over int4-packed pools) at `chip_smoke.PAGED_SHAPES` under
every launch plan its kernel takes (the logits kept in shared memory,
"s", or recomputed, "r"; 8 warps on 16 rows or on 32; a ring of 2, 3
or 4 tiles; where it fits shared memory), marking the one `paged_plan`
picks; each plan's output must equal the chosen plan's.

`--sass` builds this checkout's quant_attention.cu and paged_attention.cu
and prints, for each tensor-core kernel, its static SASS instruction
count by opcode (`cuobjdump -sass` of the toolkit beside nvcc): what the
float island compiles to.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def time_tree(tree: str, paged: bool, packed: bool) -> None:
    """Child: time this tree's quant_flash_attention (or its paged
    attention, over int8 or int4-packed pools), print JSON."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import (
        PAGED_SHAPES, QFA_SHAPES, SEED, Timer, paged_inputs, qfa_inputs,
    )
    from repro_torch.kernels import paged_attention, quant_flash_attention

    timer = Timer(torch)
    out = {}
    for i, shape in enumerate(PAGED_SHAPES if paged else QFA_SHAPES):
        if paged:
            args, kw = paged_inputs(torch, np, *shape, SEED + 20 + i,
                                    packed)
            fn = lambda: paged_attention(*args, **kw)  # noqa: E731
        else:
            q, k, v, kw = qfa_inputs(torch, shape, SEED + 10 + i)
            fn = lambda: quant_flash_attention(q, k, v, **kw)  # noqa: E731
        res = fn()
        digest = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()
        ms = timer(fn)
        out[" ".join(map(str, shape))] = (ms, digest[:12])
    print(json.dumps(out))


def sweep(packed: bool) -> None:
    """Time every launch plan of the paged attention (int8 or packed
    pools)."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import PAGED_SHAPES, SEED, Timer, paged_inputs
    from repro_torch.kernels import paged_attention
    # the module (the package exports its function under the same name)
    pa = sys.modules["repro_torch.kernels.paged_attention"]

    timer = Timer(torch)
    chosen = pa.paged_plan
    for i, (S, T) in enumerate(PAGED_SHAPES):
        args, kw = paged_inputs(torch, np, S, T, SEED + 20 + i, packed)
        q, kp = args[0], args[1]
        shape = (q.shape[0], kp.shape[1], kw["group"], S, q.shape[3],
                 kp.shape[2], T // kp.shape[2])
        pick = chosen(*shape, packed)
        want = paged_attention(*args, **kw)
        cells = []
        for logits, (warps, rows), stages in itertools.product(
                ("shared", "recomputed"), pa.MMA_SHAPES, (2, 3, 4)):
            smem = pa._mma_smem(shape[4], warps, rows, stages,
                                shape[2] * S, T, shape[6],
                                logits == "shared", packed)
            if smem > pa._SMEM_LIMIT:
                continue
            plan = pick._replace(warps=warps, rows=rows,
                                 keys=32 * warps * 16 // rows, stages=stages,
                                 smem=smem, logits=logits)
            pa.paged_plan = lambda *a, plan=plan, **k: plan
            try:
                if not torch.equal(paged_attention(*args, **kw), want):
                    raise AssertionError(f"{plan}: another output")
                ms = timer(lambda: paged_attention(*args, **kw))
            finally:
                pa.paged_plan = chosen
            mark = "*" if (logits, warps, rows, stages) == (
                pick.logits, pick.warps, pick.rows, pick.stages) else ""
            cells.append(f"{logits[0]} {warps}w{rows}r/{stages}s "
                         f"{ms:.4f}{mark}")
        print(f"  S={S} T={T}: " + ", ".join(cells))


def sass() -> None:
    """Static SASS opcode counts of each tensor-core kernel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    build.build_all(["quant_attention", "paged_attention"])
    for src, kernel in (("quant_attention", "quant_attn_mma_kernel"),
                        ("paged_attention", "paged_attn_mma_kernel")):
        lib = build._target(src)[1]
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              check=True, capture_output=True,
                              text=True).stdout
        for sec in text.split("Function : ")[1:]:
            m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", sec)
            if not m:
                continue
            args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(1)))
            ops = collections.Counter(
                op.split(".")[0] for op in re.findall(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)", sec))
            print(f"  {kernel}<{args}>: "
                  f"{sum(ops.values())} instructions; " + " ".join(
                      f"{k} {v}" for k, v in ops.most_common()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout")
    ap.add_argument("--sass", action="store_true",
                    help="SASS opcode counts of this checkout's kernels")
    ap.add_argument("--paged", action="store_true",
                    help="A/B the int8 paged attention instead")
    ap.add_argument("--packed", action="store_true",
                    help="the paged attention over int4-packed pools "
                    "(with --paged or --sweep)")
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan of the paged attention")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        time_tree(args.tree, args.paged, args.packed)
        return 0
    if not (args.sass or args.sweep or args.base):
        ap.error("give --base DIR, --sweep or --sass")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}")
    if args.sass or args.sweep:
        if args.sweep:
            sweep(args.packed)
        if args.sass:
            sass()
        return 0
    runs = []
    for label, tree in (("base", args.base), ("this", ROOT), ("this", ROOT),
                        ("base", args.base)):
        res = subprocess.run(
            [sys.executable, __file__, "--base", args.base, "--tree",
             str(tree)] + (["--paged"] if args.paged else [])
            + (["--packed"] if args.packed else []),
            check=True, capture_output=True, text=True)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    print("  shape (S T)" if args.paged
          else "  shape (S_q S_kv hd causal q_offset bkv)")
    for shape in runs[0][1]:
        base = [r[shape] for label, r in runs if label == "base"]
        this = [r[shape] for label, r in runs if label == "this"]
        same = len({x[1] for x in base + this}) == 1
        print(f"  {shape}: base {base[0][0]:.4f} / {base[1][0]:.4f} ms, "
              f"this {this[0][0]:.4f} / {this[1][0]:.4f} ms, "
              f"{min(b[0] for b in base) / max(t[0] for t in this):.1f}x "
              f"or more; outputs {'equal' if same else 'DIFFER'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
