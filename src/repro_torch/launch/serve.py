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

The CLI warms the engine (`ServingEngine.warmup`) before its measured
window, then serves the requests closed-loop (submit everything, drain)
or, with `--arrival-rate QPS`, open-loop: Poisson arrivals at that
rate, rolled up against `--slo-ttft-p99` / `--slo-itl-p99` (seconds)
into goodput and the sustained verdict (`serving.loadgen`).
`--trace-out`, `--metrics-out` and `--profile-annotations` each turn
telemetry on: the JSONL request trace, the per-step phase metrics, and
`torch.profiler.record_function` ranges around each dispatch.
`--shared-prefix N` gives every request the same N-token prefix (the
workload's shape only: the port has no prefix cache yet).

Example (on the card; add --reduced --device cpu for a CPU smoke run,
--kv-bits 4 for int4-packed KV pools):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --requests 8 --slots 8 --prompt-len 300 --gen 16 --max-len 512 \\
      --ragged --arrival-rate 4 --slo-ttft-p99 2 --slo-itl-p99 0.2
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import time

import numpy as np

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.layers.common import DeployCtx
from repro_torch.models.lm import DecoderLM, load_layer, tree_to_torch
from repro_torch.serving import (
    Request, SchedulerConfig, ServingConfig, ServingEngine, Telemetry,
    poisson_arrivals, run_open_loop, shared_prefix_workload,
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
    ap.add_argument("--arch", default="granite_3_2b", choices=ARCH_IDS)
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
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the SAME random prefix of "
                    "this many tokens (a system-prompt workload; 0: "
                    "independent prompts)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in requests/s "
                    "(0: closed loop, submit everything and drain)")
    ap.add_argument("--slo-ttft-p99", type=float, default=0.0,
                    help="TTFT SLO in seconds for the open-loop goodput "
                    "roll-up (0: none)")
    ap.add_argument("--slo-itl-p99", type=float, default=0.0,
                    help="inter-token-latency SLO in seconds for the "
                    "open-loop goodput roll-up (0: none)")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace as JSONL here "
                    "(enables telemetry; tools/trace_summary.py reads it)")
    ap.add_argument("--metrics-out", default="",
                    help="write the per-step phase metrics as JSON here "
                    "(enables telemetry)")
    ap.add_argument("--profile-annotations", action="store_true",
                    help="wrap each dispatch in torch.profiler."
                    "record_function (enables telemetry)")
    args = ap.parse_args(argv)

    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.shared_prefix > args.prompt_len:
        ap.error("--shared-prefix must be <= --prompt-len")
    t0 = time.perf_counter()
    lm, tables = deploy_model(args.arch, reduced=args.reduced,
                              max_seq=max_len, seed=args.seed,
                              device=args.device)
    print(f"deployed {lm.cfg.name} ({lm.cfg.n_layers} layers) on "
          f"{args.device} in {time.perf_counter() - t0:.1f} s")
    tel = None
    if args.trace_out or args.metrics_out or args.profile_annotations:
        tel = Telemetry(profile_annotations=args.profile_annotations)
    engine = ServingEngine(lm, tables, ServingConfig(
        n_slots=args.slots, max_len=max_len, page_size=args.page_size,
        n_pages=args.pages or None, device=args.device,
        kv_bits=args.kv_bits, telemetry=tel,
        scheduler=SchedulerConfig(prefill_chunk=args.prefill_chunk)))
    engine.warmup()  # both dispatch widths, before the measured window
    rng = np.random.default_rng(args.seed)
    if args.shared_prefix:
        requests = shared_prefix_workload(
            args.requests, lm.cfg.vocab, rng, prefix_len=args.shared_prefix,
            suffix_len=args.prompt_len - args.shared_prefix,
            max_new_tokens=args.gen)
    else:
        lo = (max(1, args.prompt_len // 16) if args.ragged
              else args.prompt_len)
        requests = ragged_requests(args.requests, lm.cfg.vocab, rng,
                                   prompt_lo=lo, prompt_hi=args.prompt_len,
                                   gen=args.gen)
    open_loop = None
    if args.arrival_rate > 0:
        open_loop = run_open_loop(
            engine, requests,
            poisson_arrivals(len(requests), args.arrival_rate, rng),
            slo_ttft_s=args.slo_ttft_p99 or None,
            slo_itl_s=args.slo_itl_p99 or None)
        completions = open_loop.completions
    else:
        for req in requests:
            engine.submit(req)
        completions = engine.run_until_drained()
    s = engine.stats()
    print(f"drained {s['n_completed']} requests / {s['n_generated']} tokens "
          f"in {s['wall_s']:.2f} s ({s['throughput_tok_s']:.1f} tok/s, "
          f"peak {s['max_pages_in_use']}/{s['n_pages']} pages, "
          f"peak concurrency {s['max_active']}, "
          f"kv_bits {s['kv_bits']}, {s['pool_bytes']} pool bytes)")
    print(f"  TTFT mean/p50/p95/p99/max {s['mean_ttft_s'] * 1e3:.0f}/"
          f"{s['p50_ttft_s'] * 1e3:.0f}/{s['p95_ttft_s'] * 1e3:.0f}/"
          f"{s['p99_ttft_s'] * 1e3:.0f}/{s['max_ttft_s'] * 1e3:.0f} ms, "
          f"ITL mean/p50/p95/p99 {s['mean_itl_s'] * 1e3:.1f}/"
          f"{s['p50_itl_s'] * 1e3:.1f}/{s['p95_itl_s'] * 1e3:.1f}/"
          f"{s['p99_itl_s'] * 1e3:.1f} ms")
    print(f"  breakdown: queued {s['mean_queued_s'] * 1e3:.0f} ms, "
          f"prefill {s['mean_prefill_s'] * 1e3:.0f} ms, "
          f"decode {s['mean_decode_s'] * 1e3:.0f} ms "
          f"(admit rejects {s['admit_rejects']}, occupancy "
          f"{s['mean_occupancy']:.2f}, policy {s['policy']})")
    if open_loop is not None:
        o = open_loop
        print(f"  open loop: offered {o.offered_qps:.2f} req/s, goodput "
              f"{o.goodput_qps:.2f} req/s (SLO attainment "
              f"{o.slo_attainment:.0%}"
              + (f", sustained={o.sustained}" if o.sustained is not None
                 else "") + ")")
    print("  stats: " + json.dumps(s))
    for c in completions[:4]:
        print(f"  req {c.req_id}: P={c.prompt_len} -> {c.n_generated} toks "
              f"[{c.finish_reason}] {np.asarray(c.tokens)[:8]}")
    if tel is not None:
        if args.trace_out:
            tel.export_trace(args.trace_out)
            print(f"  trace: {len(tel.events)} events -> {args.trace_out}")
        if args.metrics_out:
            tel.export_metrics(args.metrics_out)
            print(f"  metrics: {len(tel.steps)} step records -> "
                  f"{args.metrics_out}")


if __name__ == "__main__":
    main()
