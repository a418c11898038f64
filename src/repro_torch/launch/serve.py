"""Integer-only serving entry point of the port (port of
`repro.launch.serve`: `deploy_model`, `serve_batch` and the CLI).

`deploy_model` does what the reference's does: init -> calibrate ->
deploy.  It draws the float params from numpy (seeded), runs the
FullPrecision forward of a calibration sample (`calibration_sample`:
`SyntheticStream` batch 0, 4 x min(64, max_seq - 1) tokens) in
float32 on `device`, observing every activation range, and deploys
the integer tables from those ranges.  It goes LAYER BY LAYER: each
layer's floats are drawn, moved to the device, run on the running
activation (observing), deployed from the ranges just observed and
dropped, so the host never holds all the model's float weights at
once (about 10 GB of float32 for granite_3_2b).  This equals the
whole-model `lm.deploy(p, lm.calibrate(p, sample))`: layer i's
observations depend only on the forward up to layer i, and its deploy
reads only its own.  The float draw of the next layer runs in a thread
while the current one calibrates and deploys, so the host holds at
most two layers' floats.  The calibration-free deploy stays
`lm.deploy(p, None)` (DEFAULT_RANGES).

The CLI warms the engine (`ServingEngine.warmup`) before its measured
window, then serves the requests closed-loop (submit everything, drain)
or, with `--arrival-rate QPS`, open-loop: Poisson arrivals at that
rate, rolled up against `--slo-ttft-p99` / `--slo-itl-p99` (seconds)
into goodput and the sustained verdict (`serving.loadgen`).
`--trace-out`, `--metrics-out` and `--profile-annotations` each turn
telemetry on: the JSONL request trace, the per-step phase metrics, and
`torch.profiler.record_function` ranges around each dispatch.
`--shared-prefix N` gives every request the same N-token prefix (a
system-prompt workload), which `--prefix-cache` shares page by page
(`--cache-keep-pages` keeps released prefix pages warm).  `--policy
priority` serves by `Request.priority` with preemption
(`PrioritySLOPolicy`; with `--slo-ttft-p99 S` pending requests older
than S jump the order).  `--dispatch-depth 1` leaves one step in
flight on the device while the host plans the next (same tokens).
`--paged-gather` serves through the write-then-gather attention path
(`ServingConfig.paged_kernel` False), the reference's parity oracle,
instead of the paged attention kernel (same tokens).

Multi-device serving (the reference's DESIGN.md §Serving
¶Multi-device): `--mesh N` deploys once, then spawns N ranks
(`launch.mesh.spawn`: "gloo" on `--device cpu`, "nccl" and one GPU a
rank on the card; fewer GPUs than N raise), each serving the same
requests on a ("data", "model") = (1, N) mesh; `--kv-shard` splits the
KV arena's kv heads over it (it needs `--mesh`).  Every rank gets the
same tokens; rank 0 prints.  `serve_scenario` runs one engine over a
list of requests (submitted one a step, then drained) and returns its
tokens, stats, step times and pools; `run_sharded` runs a list of such
scenarios on every rank of a spawned mesh (`serve_sharded`, the rank
function) and returns each rank's results.

The arena is the reference's default, `SlotArena`, unless `--paged`
asks for the paged one (`--page-size`, `--pages`; kv_bits 4 and the
prefix cache need it).  `--prefill-chunk 0` prefills each prompt whole
at batch 1, padded to a `--prefill-bucket` multiple; the MoE family
(`--arch olmoe_1b_7b`), the ssm family (`--arch falcon_mamba_7b`) and
the hybrid (`--arch zamba2_1_2b`) always prefill whole prompts at their
exact length.

`serve_batch` is the reference's lockstep loop, kept as the parity
oracle: B prompts prefilled together at position 0, then decoded at
one shared position over contiguous caches.

Example (on the card; add --reduced --device cpu for a CPU smoke run,
--paged --kv-bits 4 for int4-packed KV pools, --mesh 2 --kv-shard for
two kv-sharded ranks):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --requests 8 --slots 8 --prompt-len 300 --gen 16 \\
      --max-len 512 --ragged --arrival-rate 4 --slo-ttft-p99 2 \\
      --slo-itl-p99 0.2
"""
from __future__ import annotations

import argparse
import builtins
import concurrent.futures
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import SERVE_ARCH_IDS, get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch import kernels
from repro_torch.data.synthetic import SyntheticConfig, SyntheticStream
from repro_torch.launch import variants
from repro_torch.layers.common import DeployCtx
from repro_torch.models.lm import (
    DecoderLM, load_layer, params_to_torch, tree_to_torch,
)
from repro_torch.serving import (
    Request, SchedulerConfig, ServingConfig, ServingEngine, Telemetry,
    make_policy, poisson_arrivals, run_open_loop, shared_prefix_workload,
)


CALIB_BATCH = 4  # calibration rows, as the reference entry point's


def check_tokens(cfg) -> None:
    """`deploy_model` and `serve_batch` feed token ids: an embeds model
    (internvl2_76b) is served through `DecoderLM.prefill` /
    `decode_step` on int8 rows instead, as in the reference."""
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} takes embeddings (input_mode={cfg.input_mode!r}), "
            "not token ids: serve it through DecoderLM.prefill / "
            "decode_step on int8 rows")


def calibration_sample(vocab: int, max_seq: int) -> np.ndarray:
    """The reference entry point's calibration tokens: `SyntheticStream`
    batch 0 of CALIB_BATCH rows, min(64, max_seq - 1) tokens each."""
    stream = SyntheticStream(SyntheticConfig(
        vocab=vocab, seq_len=min(64, max_seq - 1), global_batch=CALIB_BATCH))
    return stream.batch(0)[:, :-1]


def build_lm(arch: str, *, reduced: bool, max_seq: int,
             n_layers: Optional[int] = None) -> DecoderLM:
    """The served `DecoderLM` of `arch` (reduced, or cut to its first
    `n_layers` layers at full width)."""
    cfg = get_config(arch)
    check_tokens(cfg)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return DecoderLM(cfg, max_seq=max_seq)


def deploy_model(arch: str, *, reduced: bool, max_seq: int, seed: int = 0,
                 device="cuda", n_layers: Optional[int] = None):
    """-> (lm, tables on `device`), equal to
    `tables_from_numpy(lm.deploy(p, lm.calibrate(p, sample, device)),
    device)` with p = `lm.init_np(seed)` and sample =
    `calibration_sample(vocab, max_seq)`: the float forward runs on
    `device`.  `n_layers` cuts the depth (the first n layers of the
    config, at its full width; None: all of them)."""
    lm = build_lm(arch, reduced=reduced, max_seq=max_seq, n_layers=n_layers)
    cfg = lm.cfg
    calib = Calibrator()
    ctx = DeployCtx(calib=calib)
    sample = calibration_sample(cfg.vocab, max_seq)
    p_embed = lm.init_embed_np(seed)
    x = lm.embed_in({"embed": params_to_torch(p_embed, device)},
                    torch.from_numpy(sample).to(device), calib=calib)
    t_embed, eps_x = lm.deploy_embed(ctx, p_embed)
    tables = {
        "meta": {"eps_in": eps_x},
        "embed": tree_to_torch(t_embed, device),
        "layers": [],
    }
    del t_embed, p_embed
    # layers calibrate and deploy in order (each one's float input is
    # the previous layer's output, and its tables need the previous
    # layer's output quantum); the next layer's floats are drawn
    # meanwhile, and each layer's floats are dropped once deployed.  The
    # hybrid's shared block (one float weight set) runs and deploys
    # after each group, over concat(x, x0) with x0 the embedding's
    # output, with tables of its own at each application
    n = cfg.n_layers
    x0, eps_in = x, eps_x
    p_shared_np = lm.init_shared_np(seed) if lm.groups else None
    p_shared = (params_to_torch(p_shared_np, device) if lm.groups
                else None)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        ahead = pool.submit(lm.init_layer_np, seed, 0)
        for kind, i in lm.steps():
            if kind == "shared":
                x = lm.apply_shared(p_shared, i, x, x0, calib)
                t_i, eps_x = lm.deploy_shared(ctx, i, p_shared_np, eps_x,
                                              eps_in)
                tables.setdefault("shared", []).append(
                    load_layer(tree_to_torch(t_i, device)))
                continue
            p_i = ahead.result()
            if i + 1 < n:
                ahead = pool.submit(lm.init_layer_np, seed, i + 1)
            x = lm.apply_layer(params_to_torch(p_i, device), i, x, calib)
            t_i, eps_x = lm.deploy_layer(ctx, i, p_i, eps_x)
            del p_i
            tables["layers"].append(load_layer(tree_to_torch(t_i, device)))
    del x0, p_shared, p_shared_np
    p_norm, p_head = lm.init_head_np(seed)
    lm.logits({"norm_f": params_to_torch(p_norm, device),
               "head": params_to_torch(p_head, device)}, x, calib=calib)
    del x
    tn, th, eps_logits = lm.deploy_head(ctx, p_norm, p_head, eps_x)
    tables["norm_f"] = tree_to_torch(tn, device)
    tables["head"] = tree_to_torch(th, device)
    tables["meta"]["eps_logits"] = eps_logits
    return lm, tables


def serve_batch(lm, tables, prompts, gen_len: int) -> torch.Tensor:
    """Lockstep reference: prompts (B, P) int32 -> (B, gen_len) int32.

    All rows prefill together at position 0 and advance in lockstep at
    one shared position over contiguous caches of P + gen_len positions
    (`DecoderLM.init_caches`), on the tables' device."""
    check_tokens(lm.cfg)
    device = tables["head"]["w_q"].device
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
    B, P = prompts.shape
    caches = lm.init_caches(B, P + gen_len, device=device)
    logits = lm.prefill(tables, prompts, caches)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(gen_len - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
        logits = lm.decode_step(tables, tok, caches, pos)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def serve_scenario(lm, tables, sc: dict, *, device="cuda", mesh=None,
                   kv_shard: bool = False) -> dict:
    """One engine over one scenario: ``sc["config"]`` (`ServingConfig`
    keywords but the device, mesh and scheduler), ``sc["scheduler"]``
    (`SchedulerConfig` keywords), ``sc["variants"]`` (around every
    step, `launch.variants.use_variants`) and ``sc["requests"]``
    [(prompt, max_new_tokens)], each submitted then stepped once, then
    drained.
    -> {"tokens", "finish" (in submission order), "stats", "step_ms"
    (each step's host wall time), "pools" (the arena's caches on the
    CPU), and with ``sc["count_launches"]`` "launches" (the kernels'
    launch counts, set to 0 before the first step)}."""
    eng = ServingEngine(lm, tables, ServingConfig(
        device=device, mesh=mesh, kv_shard=kv_shard,
        scheduler=SchedulerConfig(**sc.get("scheduler", {})),
        **sc["config"]))
    step_ms = []

    def step():
        t0 = time.perf_counter()
        with variants.use_variants(**sc.get("variants", {})):
            eng.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    if sc.get("count_launches"):
        kernels.reset_launch_counts()
    ids = []
    for prompt, gen in sc["requests"]:
        ids.append(eng.submit(np.asarray(prompt, np.int32),
                              max_new_tokens=gen))
        step()
    while eng._busy():
        step()
        if len(step_ms) > 10_000:
            raise RuntimeError("not drained after 10000 steps")
    done = {c.req_id: c for c in eng.completed}
    pools = {k: v.cpu() for k, v in eng.arena.caches.items()
             if isinstance(v, torch.Tensor) and k != "table"}
    out = {"tokens": [list(map(int, done[i].tokens)) for i in ids],
           "finish": [done[i].finish_reason for i in ids],
           "stats": eng.stats(), "step_ms": step_ms, "pools": pools}
    if sc.get("count_launches"):
        out["launches"] = kernels.launch_counts()
        out["requant_by_form"] = dict(kernels.requant.by_form)
    return out


def _rank_device(device: str) -> str:
    """A rank's device: "cuda" is the card `launch.mesh.spawn` gave it."""
    return (f"cuda:{torch.cuda.current_device()}" if device == "cuda"
            else device)


def serve_sharded(rank: int, spec: dict) -> None:
    """The rank function of `run_sharded`: the model of ``spec["cfg"]``,
    the saved tables loaded onto this rank's device, the (1, n) serving
    mesh, and every scenario run kv-sharded, the results saved to
    ``{out}.{rank}``."""
    from repro_torch.launch.mesh import make_serving_mesh

    device = _rank_device(spec["device"])
    lm = DecoderLM(spec["cfg"], max_seq=spec["max_seq"])
    tables = torch.load(spec["tables"], map_location=device,
                        weights_only=False)
    mesh = make_serving_mesh(spec["n_model"])
    out = [serve_scenario(lm, tables, sc, device=device, mesh=mesh,
                          kv_shard=True) for sc in spec["scenarios"]]
    torch.save(out, f"{spec['out']}.{rank}")


def run_sharded(lm, tables, scenarios: List[dict], n_model: int, *,
                device: str = "cuda", backend: Optional[str] = None
                ) -> List[List[dict]]:
    """`scenarios` (see `serve_scenario`) served kv-sharded by
    `n_model` spawned ranks on a (1, n_model) mesh (`launch.mesh.spawn`;
    ``backend`` "gloo" lets ranks share one card), from `tables` saved
    once.  -> each rank's results, rank-major."""
    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tables.pt")
        torch.save(tables, path)
        spec = {"cfg": lm.cfg, "max_seq": lm.max_seq, "tables": path,
                "device": device, "n_model": n_model,
                "scenarios": scenarios, "out": os.path.join(tmp, "out")}
        spawn(serve_sharded, n_model, (spec,), device=device,
              backend=backend)
        return [torch.load(f"{spec['out']}.{r}", weights_only=False)
                for r in range(n_model)]


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
    ap.add_argument("--arch", default="granite_3_2b",
                    choices=SERVE_ARCH_IDS)
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
    ap.add_argument("--prefill-bucket", type=int, default=16,
                    help="whole-prompt shape bucket (--prefill-chunk 0)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill chunk size (dense family); 0: "
                    "whole-prompt bucketed prefill")
    ap.add_argument("--paged", action="store_true",
                    help="the paged KV arena (page budgets instead of "
                    "worst-case slot rows)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page pool size (0: slots*max_len/page_size)")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(8, 4),
                    help="KV storage width: 8 = int8 KV images; 4 = two "
                    "int4 nibbles per pool cell (half the pool bytes, "
                    "lossy against int8 KV; needs --paged)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prefix caching with copy-on-write "
                    "page sharing (needs --paged)")
    ap.add_argument("--cache-keep-pages", type=int, default=0,
                    help="warm-page budget: registered pages kept after "
                    "their last reference drops, evicted LRU under "
                    "pressure (0: evict at once; needs --prefix-cache)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the SAME random prefix of "
                    "this many tokens (a system-prompt workload, what "
                    "--prefix-cache shares; 0: independent prompts)")
    ap.add_argument("--paged-gather", action="store_true",
                    help="attention through the write-then-gather path "
                    "instead of the paged attention kernel (parity "
                    "debugging)")
    ap.add_argument("--dispatch-depth", type=int, default=0, choices=(0, 1),
                    help="dispatch queue depth: 1 plans each step while "
                    "the previous one runs on the device (0: "
                    "synchronous)")
    ap.add_argument("--policy", default="fcfs", choices=("fcfs", "priority"),
                    help="scheduling policy: fcfs serves in arrival "
                    "order; priority ranks admission by request class "
                    "and preempts lower-class work")
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
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks on the serving mesh's model dim, one "
                    "process each (0: one process, no mesh)")
    ap.add_argument("--kv-shard", action="store_true",
                    help="split the KV arena's kv heads over the mesh's "
                    "model dim (needs --mesh)")
    args = ap.parse_args(argv)
    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.shared_prefix > args.prompt_len:
        ap.error("--shared-prefix must be <= --prompt-len")
    if args.kv_shard and not args.mesh:
        ap.error("--kv-shard needs --mesh N")
    t0 = time.perf_counter()
    lm, tables = deploy_model(args.arch, reduced=args.reduced,
                              max_seq=max_len, seed=args.seed,
                              device=args.device)
    print(f"deployed {lm.cfg.name} ({lm.cfg.n_layers} layers) on "
          f"{args.device} in {time.perf_counter() - t0:.1f} s")
    if not args.mesh:
        return _serve(args, lm, tables)
    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tables.pt")
        torch.save(tables, path)
        del tables
        spawn(_cli_rank, args.mesh, (args, path), device=args.device)


def _cli_rank(rank: int, args: argparse.Namespace, path: str) -> None:
    """One rank of `--mesh N`: the deployed tables loaded onto its
    device, the (1, N) mesh, the same requests; rank 0 prints."""
    from repro_torch.launch.mesh import make_serving_mesh

    device = _rank_device(args.device)
    lm = build_lm(args.arch, reduced=args.reduced,
                  max_seq=args.max_len or (args.prompt_len + args.gen))
    tables = torch.load(path, map_location=device, weights_only=False)
    _serve(args, lm, tables, device=device,
           mesh=make_serving_mesh(args.mesh), quiet=rank != 0)


def _serve(args, lm, tables, *, device=None, mesh=None, quiet=False):
    """The CLI's engine, requests and report."""
    def print(*a, **k):  # noqa: A001 - rank 0 reports
        if not quiet:
            builtins.print(*a, **k)

    max_len = args.max_len or (args.prompt_len + args.gen)
    tel = None
    if args.trace_out or args.metrics_out or args.profile_annotations:
        tel = Telemetry(profile_annotations=args.profile_annotations)
    engine = ServingEngine(lm, tables, ServingConfig(
        n_slots=args.slots, max_len=max_len, paged=args.paged,
        page_size=args.page_size,
        n_pages=args.pages or None, device=device or args.device,
        mesh=mesh, kv_shard=args.kv_shard,
        paged_kernel=not args.paged_gather,
        kv_bits=args.kv_bits, dispatch_depth=args.dispatch_depth,
        telemetry=tel,
        prefix_cache=args.prefix_cache,
        cache_keep_pages=args.cache_keep_pages,
        policy=make_policy(
            args.policy,
            **({"slo_ttft_s": args.slo_ttft_p99}
               if args.policy == "priority" and args.slo_ttft_p99 else {})),
        scheduler=SchedulerConfig(prefill_bucket=args.prefill_bucket,
                                  prefill_chunk=args.prefill_chunk)))
    engine.warmup()  # every step shape, before the measured window
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
    arena = (f"peak {s['max_pages_in_use']}/{s['n_pages']} pages, "
             f"kv_bits {s['kv_bits']}, {s['pool_bytes']} pool bytes"
             if s["arena"] == "paged" else
             f"slot arena of {s['arena_positions']} positions")
    print(f"drained {s['n_completed']} requests / {s['n_generated']} tokens "
          f"in {s['wall_s']:.2f} s ({s['throughput_tok_s']:.1f} tok/s, "
          f"{arena}, peak concurrency {s['max_active']}, "
          f"dispatch_depth {s['dispatch_depth']})")
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
          f"{s['mean_occupancy']:.2f}, policy {s['policy']}, preempts "
          f"{s['n_preempts']})")
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
    if tel is not None and not quiet:
        if args.trace_out:
            tel.export_trace(args.trace_out)
            print(f"  trace: {len(tel.events)} events -> {args.trace_out}")
        if args.metrics_out:
            tel.export_metrics(args.metrics_out)
            print(f"  metrics: {len(tel.steps)} step records -> "
                  f"{args.metrics_out}")


if __name__ == "__main__":
    main()
