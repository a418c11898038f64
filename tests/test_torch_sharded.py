"""Kv-head-sharded serving in the port against the JAX reference's
sharded engine, on the CPU (two gloo ranks, one process each).

Held at tolerance 0:

  - the arena rules: `arena_leaf_spec` and `kv_head_axis` against the
    reference's on every leaf of both reference arenas placed on its
    (data 4, model 2) host mesh, for reduced granite_3_2b and
    zamba2_1_2b (the reference's `test_arena_rules_hit_every_kv_leaf`
    cases), the spec each leaf was placed with among them; each rank's
    part of the split leaves; a "model" width that does not divide the
    kv heads replicates; `sanitize_spec` and `cache_spec`;
  - reduced granite_3_2b (K 2, H 4) served by two ranks on a (1, 2)
    mesh with `kv_shard`, every scenario in one spawn: the slot and
    paged arenas, kv_bits 8 and 4, dispatch depth 0 and 1, the
    write-then-gather path, the integer softmax and the whole-prompt
    path.  Tokens, finish reasons and each rank's pools concatenated
    along K equal the port's unsharded engine; every rank's tokens are
    rank 0's; each rank's pools hold K / 2 heads; `stats()` reports
    `mesh_devices` 2 and `kv_shard`; tokens equal the reference's
    engine on `make_serving_mesh(2, n_data=4)` with kv_shard and
    `paged_kernel=False` (its sharded paged kernel does not run under
    this jax: `pl.load` is missing) over both arenas and at kv_bits 4;
  - reduced zamba2_1_2b (its shared attention, K 2) served by two
    kv-sharded ranks over both arenas: tokens, h state and pools equal
    the unsharded engine's;
  - the CLI's `--mesh 2 --kv-shard` on the CPU: rank 0's report equals
    the unsharded run's tokens, with `mesh_devices` 2 and `kv_shard`;
  - the refusals: `kv_shard` without a mesh, a mesh without a "model"
    dim, a world smaller or larger than the mesh, no process group, and
    the CLI's `--kv-shard` without `--mesh`.

Not here: the blockwise branch above 4096 query rows sharded (it takes
the same head range; the card's `sharded` phase and the per-head-range
kernel checks hold the kernel side).
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as j_get_config
from repro.launch.mesh import make_serving_mesh as j_make_serving_mesh
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    PagedArena as JPagedArena, SchedulerConfig as JSchedulerConfig,
    ServingConfig as JServingConfig, ServingEngine as JServingEngine,
    SlotArena as JSlotArena,
)
from repro.sharding.rules import (
    arena_leaf_spec as j_arena_leaf_spec, cache_spec as j_cache_spec,
    kv_head_axis as j_kv_head_axis, sanitize_spec as j_sanitize_spec,
)
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.serve import (
    calibration_sample, main as serve_main, run_sharded, serve_scenario,
)
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import ServingConfig
from repro_torch.sharding.rules import (
    arena_leaf_spec, arena_shardings, cache_spec, kv_head_axis,
    kv_head_range, sanitize_spec,
)

ARCH = "granite_3_2b"
MAX_LEN = 28
SIZES = {"data": 4, "model": 2}
# the reference's sharded workload: (prompt length, new tokens)
WORKLOAD = [(5, 6), (12, 4), (9, 8), (3, 3), (16, 6), (12, 7), (5, 2)]
SCHED = dict(max_prefills_per_step=2, prefill_bucket=8, prefill_chunk=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Reduced-model products are too small for torch's thread pool,
    which only contends with the ranks and the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(ps):
    return tuple(ps)


# -- the rules -----------------------------------------------------------------
@pytest.fixture(scope="module")
def jmesh():
    return j_make_serving_mesh(2, n_data=4)


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_1_2b"])
@pytest.mark.parametrize("paged", [False, True])
def test_arena_rules_equal_reference_on_every_leaf(jmesh, arch, paged):
    lm = JLM(j_get_config(arch).reduced(), max_seq=16)
    if paged:
        arena = JPagedArena(lm, n_slots=2, max_len=16, page_size=4,
                            n_pages=8, mesh=jmesh, kv_shard=True)
    else:
        arena = JSlotArena(lm, 2, 16, mesh=jmesh, kv_shard=True)
    leaves = jax.tree.leaves(arena.caches)
    shapes = [x.shape for x in leaves]
    n_kv = 0
    for leaf, b, s in zip(leaves, arena._batch_axes, arena._seq_axes):
        assert kv_head_axis(b, s) == j_kv_head_axis(b, s)
        want = _spec(j_arena_leaf_spec(leaf.shape, b, s, jmesh))
        got = arena_leaf_spec(leaf.shape, b, s, SIZES)
        assert got == want
        assert got == _spec(leaf.sharding.spec)
        n_kv += "model" in got
    assert n_kv > 0
    specs = arena_shardings(SIZES, shapes, arena._batch_axes,
                            arena._seq_axes)
    assert specs == [_spec(x.sharding.spec) for x in leaves]
    for spec, shape in zip(specs, shapes):
        if "model" not in spec:
            continue
        K = shape[spec.index("model")]
        for r in (0, 1):
            kr = kv_head_range(K, SIZES, rank=r)
            assert (kr.start, kr.stop) == (r * K // 2, (r + 1) * K // 2)


def test_indivisible_heads_replicate_and_the_other_rules():
    wide = {"data": 1, "model": 8}
    assert arena_leaf_spec((2, 4, 2, 16, 8), 1, 3, SIZES)[2] == "model"
    assert all(ax is None
               for ax in arena_leaf_spec((2, 4, 2, 16, 8), 1, 3, wide))
    jwide = j_make_serving_mesh(8, n_data=1)
    assert all(ax is None for ax in j_arena_leaf_spec(
        (2, 4, 2, 16, 8), 1, 3, jwide))
    jm = j_make_serving_mesh(2, n_data=4)
    for spec, shape in [((None, "model", "data"), (3, 4, 8)),
                        (("data", None, "model"), (6, 5, 3)),
                        ((("data", "model"), None), (16, 2))]:
        from jax.sharding import PartitionSpec as P
        assert sanitize_spec(spec, shape, SIZES) == _spec(
            j_sanitize_spec(P(*spec), shape, jm))
    for nd in (4, 5):
        assert cache_spec(SIZES, nd) == _spec(j_cache_spec(jm, nd))
    K = get_config(ARCH).reduced().n_kv_heads
    assert kv_head_range(K, SIZES) == slice(0, K // 2)
    assert kv_head_range(K, SIZES, rank=1) == slice(K // 2, K)
    assert kv_head_range(K, wide) is None
    assert kv_head_range(K, None) is None
    assert kv_head_range(K, {"data": 8, "model": 1}) is None


# -- the engines ---------------------------------------------------------------
SCENARIOS = {
    "slot": dict(config=dict(n_slots=3, max_len=MAX_LEN)),
    "paged": dict(config=dict(n_slots=3, max_len=MAX_LEN, paged=True,
                              page_size=8)),
    "paged_kv4": dict(config=dict(n_slots=3, max_len=MAX_LEN, paged=True,
                                  page_size=8, kv_bits=4)),
    "slot_depth1": dict(config=dict(n_slots=3, max_len=MAX_LEN,
                                    dispatch_depth=1)),
    "paged_kv4_depth1": dict(config=dict(
        n_slots=3, max_len=MAX_LEN, paged=True, page_size=8, kv_bits=4,
        dispatch_depth=1)),
    "paged_gather": dict(config=dict(n_slots=3, max_len=MAX_LEN, paged=True,
                                     page_size=8, paged_kernel=False)),
    "int_softmax": dict(config=dict(n_slots=3, max_len=MAX_LEN, paged=True,
                                    page_size=8),
                        variants=dict(attn_softmax="int")),
    "whole_prompt": dict(config=dict(n_slots=3, max_len=MAX_LEN),
                         scheduler=dict(SCHED, prefill_chunk=0)),
}


@pytest.fixture(scope="module")
def served():
    """The port's calibrated deploy of reduced granite (the same numpy
    tables on both sides), every scenario served unsharded here and by
    two spawned kv-sharded ranks."""
    lm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    p = lm.init_np(0)
    t_np = lm.deploy(p, lm.calibrate(p, calibration_sample(
        lm.cfg.vocab, MAX_LEN), device="cpu"))
    tables = tables_from_numpy(t_np, device="cpu")
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, lm.cfg.vocab, size=(n,)).tolist(), g)
            for n, g in WORKLOAD]
    scs = []
    for name, sc in SCENARIOS.items():
        sc = copy.deepcopy(sc)
        sc.setdefault("scheduler", dict(SCHED))
        sc["requests"] = reqs
        scs.append(sc)
    single = [serve_scenario(lm, tables, sc, device="cpu") for sc in scs]
    ranks = run_sharded(lm, tables, scs, 2, device="cpu")
    return dict(lm=lm, t_np=t_np, reqs=reqs, names=list(SCENARIOS),
                single=dict(zip(SCENARIOS, single)),
                ranks=[dict(zip(SCENARIOS, r)) for r in ranks])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_engine_equals_unsharded(served, name):
    one = served["single"][name]
    r0, r1 = (r[name] for r in served["ranks"])
    assert len(one["tokens"]) == len(WORKLOAD)
    for r in (r0, r1):
        assert r["tokens"] == one["tokens"]
        assert r["finish"] == one["finish"]
        assert r["stats"]["mesh_devices"] == 2 and r["stats"]["kv_shard"]
        assert r["stats"]["steps"] == one["stats"]["steps"]
    for key in ("k", "v"):
        full = one["pools"][key]
        assert r0["pools"][key].shape[2] == full.shape[2] // 2 == 1
        assert torch.equal(torch.cat([r0["pools"][key], r1["pools"][key]],
                                     dim=2), full)
    whole = sum(t.numel() for t in one["pools"].values())
    half = sum(r0["pools"][k].numel() for k in ("k", "v"))
    assert r0["stats"]["pool_bytes_total"] == whole == 2 * half
    assert r0["stats"]["pool_bytes"] == half
    assert r0["stats"]["kv_heads"] == 1


@pytest.mark.parametrize("name,paged,kv_bits", [
    ("slot", False, 8), ("paged_gather", True, 8), ("paged_kv4", True, 4)])
def test_tokens_equal_reference_sharded_engine(served, jmesh, name, paged,
                                               kv_bits):
    """The reference's kv-sharded engine on its (4, 2) host mesh, the
    write-then-gather path, against the port's ranks."""
    jlm = JLM(j_get_config(ARCH).reduced(), max_seq=MAX_LEN)
    jt = jax.tree.map(jnp.asarray, served["t_np"])
    eng = JServingEngine(jlm, jt, JServingConfig(
        n_slots=3, max_len=MAX_LEN, paged=paged, page_size=8,
        kv_bits=kv_bits, paged_kernel=False if paged else None,
        mesh=jmesh, kv_shard=True, scheduler=JSchedulerConfig(**SCHED)))
    ids = []
    for prompt, g in served["reqs"]:
        ids.append(eng.submit(np.asarray(prompt), max_new_tokens=g))
        eng.step()
    done = {c.req_id: c for c in eng.run_until_drained()}
    want = [list(map(int, done[i].tokens)) for i in ids]
    assert served["ranks"][0][name]["tokens"] == want
    assert eng.stats()["mesh_devices"] == 8


def test_hybrid_shared_attention_sharded_equals_unsharded():
    """Reduced zamba2_1_2b (its shared attention: K 2, H 4) served by two
    kv-sharded gloo ranks over both arenas, exact-length prefills: the
    shared attention takes the sharded path (each rank's pools hold one
    kv head), the Mamba-2 state replicates.  Tokens, finish reasons and
    the rank's h state equal the unsharded engine's; the ranks' pools
    concatenated along K equal its pools."""
    lm = DecoderLM(get_config("zamba2_1_2b").reduced(), max_seq=MAX_LEN)
    p = lm.init_np(0)
    t_np = lm.deploy(p, lm.calibrate(p, calibration_sample(
        lm.cfg.vocab, MAX_LEN), device="cpu"))
    tables = tables_from_numpy(t_np, device="cpu")
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, lm.cfg.vocab, size=(n,)).tolist(), g)
            for n, g in WORKLOAD[:4]]
    scs = [dict(config=dict(n_slots=2, max_len=MAX_LEN, **c),
                scheduler=dict(SCHED), requests=reqs)
           for c in (dict(), dict(paged=True, page_size=8))]
    single = [serve_scenario(lm, tables, sc, device="cpu") for sc in scs]
    ranks = run_sharded(lm, tables, scs, 2, device="cpu")
    for i, one in enumerate(single):
        r0, r1 = ranks[0][i], ranks[1][i]
        for r in (r0, r1):
            assert r["tokens"] == one["tokens"]
            assert r["finish"] == one["finish"]
            assert r["stats"]["kv_heads"] == 1
            assert torch.equal(r["pools"]["h"], one["pools"]["h"])
        for key in ("k", "v"):
            assert torch.equal(torch.cat([r0["pools"][key],
                                          r1["pools"][key]], dim=2),
                               one["pools"][key])


def test_cli_mesh_kv_shard_equals_unsharded(capfd):
    """`--reduced --device cpu --mesh 2 --kv-shard` spawns two gloo
    ranks; rank 0 alone reports, with `mesh_devices` 2, `kv_shard` and
    the requests' tokens of the unsharded CLI run."""
    argv = ["--reduced", "--device", "cpu", "--paged", "--requests", "4",
            "--slots", "2", "--prompt-len", "12", "--gen", "4",
            "--max-len", "20", "--ragged"]

    def report(out):
        lines = out.splitlines()
        stats = [json.loads(x.split("stats: ", 1)[1]) for x in lines
                 if x.startswith("  stats: ")]
        return stats, [x for x in lines if x.startswith("  req ")]

    serve_main(argv)
    (one,), want = report(capfd.readouterr().out)
    serve_main(argv + ["--mesh", "2", "--kv-shard"])
    stats, got = report(capfd.readouterr().out)
    assert len(stats) == 1  # rank 0 alone prints
    assert stats[0]["mesh_devices"] == 2 and stats[0]["kv_shard"]
    assert stats[0]["pool_bytes_total"] == one["pool_bytes"]
    assert len(want) == 4 and got == want


# -- the refusals ----------------------------------------------------------------
def test_refusals(tmp_path, capsys):
    with pytest.raises(ValueError, match="kv_shard=True needs a mesh"):
        ServingConfig(kv_shard=True, device="cpu")

    class NoModel:
        mesh_dim_names = ("data",)

    with pytest.raises(ValueError, match='"model" dim'):
        ServingConfig(mesh=NoModel(), device="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_serving_mesh(2)
    store = dist.FileStore(os.fspath(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_serving_mesh(2)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_serving_mesh(1, n_data=2)
        mesh = make_serving_mesh(1)
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {
            "data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
    with pytest.raises(SystemExit):
        serve_main(["--reduced", "--device", "cpu", "--kv-shard"])
    assert "--kv-shard needs --mesh" in capsys.readouterr().err
