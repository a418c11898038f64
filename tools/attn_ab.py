#!/usr/bin/env python3
"""A/B timing of the port's quantized flash attention in two checkouts,
on one card.

    python3 tools/attn_ab.py --base DIR
    python3 tools/attn_ab.py --sass

Times `repro_torch.kernels.quant_flash_attention` of the checkout at DIR
and of this one at `chip_smoke.QFA_SHAPES` (full granite_3_2b geometry:
B 1, 32 query heads, 8 kv heads), in turns: base, this, this, base,
each in a process of its own that builds its own kernels.  Both trees
get the same seeded inputs (`chip_smoke.qfa_inputs`); each time is
`chip_smoke.Timer`'s median of 10 launches with the L2 flushed before
each.  Each process also hashes its outputs, so the line says whether
the two trees wrote the same bytes.  Prints the card's name and power
limit, then one line per shape.

`--sass` builds this checkout's quant_attention.cu and prints, for each
tensor-core kernel, its static SASS instruction count by opcode
(`cuobjdump -sass` of the toolkit beside nvcc): what the float island
compiles to, against the island floor's estimate in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def time_tree(tree: str) -> None:
    """Child: time this tree's quant_flash_attention, print JSON."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import QFA_SHAPES, SEED, Timer, qfa_inputs
    from repro_torch.kernels import quant_flash_attention

    timer = Timer(torch)
    out = {}
    for i, shape in enumerate(QFA_SHAPES):
        q, k, v, kw = qfa_inputs(torch, shape, SEED + 10 + i)
        ctx = quant_flash_attention(q, k, v, **kw)
        digest = hashlib.sha256(ctx.cpu().numpy().tobytes()).hexdigest()
        ms = timer(lambda: quant_flash_attention(q, k, v, **kw))
        out[" ".join(map(str, shape))] = (ms, digest[:12])
    print(json.dumps(out))


def sass() -> None:
    """Static SASS opcode counts of each tensor-core kernel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build_all(["quant_attention"])
    lib = build._target("quant_attention")[1]
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for sec in text.split("Function : ")[1:]:
        m = re.search(r"quant_attn_mma_kernelILi(\d+)ELi(\d+)E", sec)
        if not m:
            continue
        ops = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                sec))
        print(f"  quant_attn_mma_kernel<{m.group(1)}, {m.group(2)}>: "
              f"{sum(ops.values())} instructions; " + " ".join(
                  f"{k} {v}" for k, v in ops.most_common()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout")
    ap.add_argument("--sass", action="store_true",
                    help="SASS opcode counts of this checkout's kernels")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        time_tree(args.tree)
        return 0
    if not args.sass and not args.base:
        ap.error("give --base DIR or --sass")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}")
    if args.sass:
        sass()
        return 0
    runs = []
    for label, tree in (("base", args.base), ("this", ROOT), ("this", ROOT),
                        ("base", args.base)):
        res = subprocess.run(
            [sys.executable, __file__, "--base", args.base, "--tree",
             str(tree)], check=True, capture_output=True, text=True)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    print("  shape (S_q S_kv hd causal q_offset bkv)")
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
