"""Integer-only serving entry point of the port (port of
`repro.launch.serve`: `deploy_model` and the CLI, cut to the flags of
the dense paged/chunked/FCFS path).

`deploy_model` draws the float params from numpy (seeded) and deploys
them WITHOUT calibration (`DEFAULT_RANGES`, as the reference's
full-size dry runs deploy) LAYER BY LAYER: each layer's floats are
drawn, deployed and moved to the device before they are dropped, so
the host never holds all the model's float weights at once (about
10 GB of float32 for granite_3_2b).  The float draw of the next layer
runs in a thread while the current one deploys, so the host holds at
most two layers' floats.

Example (on the card; add --reduced --device cpu for a CPU smoke run,
--kv-bits 4 for int4-packed KV pools):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --requests 8 --slots 8 --prompt-len 300 --gen 16 --max-len 512 \\
      --ragged
"""
from __future__ import annotations

import argparse
import concurrent.futures
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.layers.common import DeployCtx
from repro_torch.models.lm import DecoderLM, load_layer, tree_to_torch
from repro_torch.serving import (
    Request, SchedulerConfig, ServingConfig, ServingEngine,
)


def deploy_model(arch: str, *, reduced: bool, max_seq: int, seed: int = 0,
                 device="cuda"):
    """-> (lm, tables on `device`), equal to
    `tables_from_numpy(lm.deploy(lm.init_np(seed)), device)`."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    lm = DecoderLM(cfg, max_seq=max_seq)
    ctx = DeployCtx(calib=None)
    t_embed, eps_x = lm.deploy_embed(ctx, lm.init_embed_np(seed))
    tables = {
        "meta": {"eps_in": eps_x},
        "embed": tree_to_torch(t_embed, device),
        "layers": [],
    }
    del t_embed
    # layers deploy in order (each one's tables need the previous
    # layer's output quantum); the next layer's floats are drawn
    # meanwhile, and each layer's floats are dropped once deployed
    n = cfg.n_layers
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        ahead = pool.submit(lm.init_layer_np, seed, 0)
        for i in range(n):
            p_i = ahead.result()
            if i + 1 < n:
                ahead = pool.submit(lm.init_layer_np, seed, i + 1)
            t_i, eps_x = lm.deploy_layer(ctx, i, p_i, eps_x)
            del p_i
            tables["layers"].append(load_layer(tree_to_torch(t_i, device)))
    p_norm, p_head = lm.init_head_np(seed)
    tn, th, eps_logits = lm.deploy_head(ctx, p_norm, p_head, eps_x)
    tables["norm_f"] = tree_to_torch(tn, device)
    tables["head"] = tree_to_torch(th, device)
    tables["meta"]["eps_logits"] = eps_logits
    return lm, tables


def ragged_requests(n: int, vocab: int, rng: np.random.Generator, *,
                    prompt_lo: int, prompt_hi: int, gen: int):
    """n requests with prompt lengths uniform in [prompt_lo, prompt_hi]
    and `gen` new tokens each."""
    return [
        Request(rng.integers(0, vocab, size=(int(
            rng.integers(prompt_lo, prompt_hi + 1)),)), max_new_tokens=gen)
        for _ in range(n)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="arena sequence capacity (0: prompt-len + gen)")
    ap.add_argument("--ragged", action="store_true",
                    help="prompt lengths uniform in [prompt-len/16, "
                    "prompt-len]")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page pool size (0: slots*max_len/page_size)")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(8, 4),
                    help="KV storage width: 8 = int8 KV images; 4 = two "
                    "int4 nibbles per pool cell (half the pool bytes, "
                    "lossy against int8 KV)")
    args = ap.parse_args(argv)

    max_len = args.max_len or (args.prompt_len + args.gen)
    t0 = time.perf_counter()
    lm, tables = deploy_model(args.arch, reduced=args.reduced,
                              max_seq=max_len, seed=args.seed,
                              device=args.device)
    print(f"deployed {lm.cfg.name} ({lm.cfg.n_layers} layers) on "
          f"{args.device} in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(lm, tables, ServingConfig(
        n_slots=args.slots, max_len=max_len, page_size=args.page_size,
        n_pages=args.pages or None, device=args.device,
        kv_bits=args.kv_bits,
        scheduler=SchedulerConfig(prefill_chunk=args.prefill_chunk)))
    rng = np.random.default_rng(args.seed)
    lo = max(1, args.prompt_len // 16) if args.ragged else args.prompt_len
    for req in ragged_requests(args.requests, lm.cfg.vocab, rng,
                               prompt_lo=lo, prompt_hi=args.prompt_len,
                               gen=args.gen):
        engine.submit(req)
    completions = engine.run_until_drained()
    s = engine.stats()
    print(f"drained {s['n_completed']} requests / {s['n_generated']} tokens "
          f"in {s['wall_s']:.2f} s ({s['throughput_tok_s']:.1f} tok/s, "
          f"p50 TTFT {s['p50_ttft_s'] * 1e3:.0f} ms, "
          f"peak {s['max_pages_in_use']}/{s['n_pages']} pages, "
          f"kv_bits {s['kv_bits']}, {s['pool_bytes']} pool bytes)")
    for c in completions[:4]:
        print(f"  req {c.req_id}: P={c.prompt_len} -> {c.n_generated} toks "
              f"[{c.finish_reason}] {np.asarray(c.tokens)[:8]}")


if __name__ == "__main__":
    main()
