"""The training shardings of the port (`sharding.rules`' training half,
`launch.steps`' sharded FQ step, the elastic re-shard of
`checkpoint.manager`), against the JAX reference and against the
port's unsharded step.

  - The rules at tolerance 0: `spec_for_path`, `params_sharding` (with
    and without weight_stationary), `caches_sharding` and `batch_spec`
    equal the reference's on every leaf of the float params, the
    qstate, both Adam moments (the same paths) and the ID tables of
    every ported config at full width (the reference's trees from
    `jax.eval_shape` and its `launch.specs`, the port's from its own
    meta specs), on duck-typed pod (16, 16) and multipod (2, 16, 16)
    meshes that hold no devices; and once more at reduced size on the
    reference's real (2, 4) mesh of the 8 host devices `conftest.py`
    forces (`NamedSharding.spec`).  `to_placements` against DTensor:
    a (2, 2, 2) fake-process-group mesh places ("pod", "data") on one
    tensor dim pod-major, as JAX does.
  - The step on gloo ranks: reduced granite_3_2b and olmoe_1b_7b
    (batch 4 x 32), one FQ step on (1, 2), (2, 1) and (2, 2) ("data",
    "model") meshes from the same initial state, gathered back: on
    (1, 2) the loss and every leaf of the new trainable and moments
    bit-equal to the unsharded port step; on the meshes that split the
    batch within SHARD_TOL (MEASURED below); each rank's local bytes
    are its placements' (`local_shape`); `microbatches` 2 on granite
    (bit-equal on (1, 2)); the unsharded port step held to the
    reference's `build_train_step` (its loss within LOSS_TOL, granite's
    gradients within GRAD_TOL, as `test_torch_train.py` holds them).
  - The elastic re-shard: a checkpoint saved on (1, 2) restores onto
    (2, 1) with equal leaves, and on one process, unsharded.
  - The refusals: `make_production_mesh` in a world of 2 ranks, and an
    MoE step whose rank's microbatch would split a group.

The ranks of each mesh are spawned once, in the module fixture.

MEASURED (on the CPU): on (2, 1) and (2, 2) the loss within 8.0e-8 of
the unsharded step's (granite; olmoe 7.9e-8), the new params bit-equal
(AdamW's first step moves each by lr times the sign of its gradient),
the moments within 4.6e-3 (mu) and 7.7e-3 (nu) of each leaf's largest
magnitude (olmoe 4.5e-3 and 8.3e-3): a bfloat16 product's weight
gradient is rounded to bfloat16 once, over each rank's rows on the
mesh and over all rows unsharded, 2^-8 apart (SHARD_TOL).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_mesh, make_production_mesh, spawn
from repro_torch.launch.steps import build_train_step, train_shardings
from repro_torch.models.lm import DecoderLM, params_to_torch
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding import place
from repro_torch.sharding.rules import (
    batch_spec, caches_sharding, local_shape, params_sharding,
    spec_for_path, tree_map_with_path,
)

ARCHS = ("granite_3_2b", "olmoe_1b_7b")
MESHES = ((1, 2), (2, 1), (2, 2))
SEQ, BATCH = 32, 4
LOSS_TOL = 1e-3
GRAD_TOL = 2e-2
# meshes that split the batch, each leaf's max |diff| over its max |value|
SHARD_TOL = {"loss": 1e-6, "trainable": 1e-6, "moments": 2e-2}
LM_ARCHS = [a for a in ARCH_IDS if a != "nemo_cnn"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the rules --------------------------------------------------------------
def _duck(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


DUCKS = {"pod": ((16, 16), ("data", "model")),
         "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _jpath(path) -> str:
    from repro.sharding.rules import _path_str

    return _path_str(path)


def _ref_specs(tree, mesh, ws=False):
    """{path: spec} of the reference's rules (its `params_sharding`
    without the NamedSharding: a duck mesh holds no devices)."""
    import jax
    from repro.sharding.rules import spec_for_path as j_spec

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(j_spec(path, leaf, mesh))
        if ws:
            spec = tuple(None if a == "data" else a for a in spec)
        out[_jpath(path)] = spec
    return out


def _port_specs(shardings) -> dict:
    out = {}
    tree_map_with_path(lambda p, s: out.__setitem__(
        "/".join(str(x) for x in p), tuple(s.spec)), shardings)
    return out


def _ref_trees(arch):
    import jax
    from repro.configs.base import get_config as j_get_config
    from repro.launch import specs as j_specs
    from repro.models.lm import DecoderLM as JLM

    jlm = JLM(j_get_config(arch), max_seq=4096)
    params = j_specs.float_param_specs(jlm)
    return {"params": params, "qstate": jax.eval_shape(jlm.init_qstate),
            "tables": j_specs.deploy_specs(jlm)}


def _port_trees(arch):
    lm = DecoderLM(get_config(arch), max_seq=4096)
    return {"params": specs_mod.float_param_specs(lm),
            "qstate": specs_mod.qstate_specs(lm),
            "tables": specs_mod.deploy_specs(lm)}


@pytest.mark.parametrize("mesh_kind", sorted(DUCKS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rules_equal_reference_at_full_width(arch, mesh_kind):
    mesh = _duck(*DUCKS[mesh_kind])
    ref, got = _ref_trees(arch), _port_trees(arch)
    for part in ("params", "qstate", "tables"):
        for ws in (False, True):
            want = _ref_specs(ref[part], mesh, ws)
            have = _port_specs(params_sharding(got[part], mesh,
                                               weight_stationary=ws))
            assert want == have, (part, ws, {k: (want.get(k), have.get(k))
                                              for k in set(want) | set(have)
                                              if want.get(k) != have.get(k)})
    # the moments reuse the params' paths: {"mu", "nu"} over trainable
    tr = {"params": got["params"], "qstate": got["qstate"]}
    opt = adamw_init(tr)
    jtr = {"params": ref["params"], "qstate": ref["qstate"]}
    assert _port_specs(params_sharding(opt["mu"], mesh)) == _ref_specs(
        jtr, mesh)
    # spec_for_path itself on every leaf
    direct = {}
    tree_map_with_path(lambda p, x: direct.__setitem__(
        "/".join(str(v) for v in p), spec_for_path(p, x, mesh)), got["params"])
    assert direct == _ref_specs(ref["params"], mesh)


@pytest.mark.parametrize("mesh_kind", sorted(DUCKS))
def test_caches_and_batch_rules_equal_reference(mesh_kind):
    import jax
    from repro.configs.base import get_config as j_get_config
    from repro.core.rep import Rep as JRep
    from repro.models.lm import DecoderLM as JLM
    from repro.sharding.rules import (
        batch_spec as j_batch_spec, caches_sharding as j_caches_sharding,
    )

    mesh = _duck(*DUCKS[mesh_kind])
    for arch in ("granite_3_2b", "falcon_mamba_7b", "zamba2_1_2b",
                 "nemotron_4_340b"):
        jlm = JLM(j_get_config(arch), max_seq=32768)
        lm = DecoderLM(get_config(arch), max_seq=32768)
        for rep, jrep in ((Rep.ID, JRep.ID), (Rep.FP, JRep.FP)):
            ref = jax.eval_shape(lambda: jlm.init_caches(128, 32768, jrep))
            # the port's rule on the reference's leaves ...
            meta = jax.tree.map(lambda s: torch.empty(
                s.shape, device="meta"), ref)
            want = {_jpath(path): sh.spec for path, sh in
                    jax.tree_util.tree_flatten_with_path(_with_mesh_specs(
                        j_caches_sharding, ref, mesh))[0]}
            assert _port_specs(caches_sharding(meta, mesh)) == want
            # ... and the port's float caches are the reference's leaves
            if rep is Rep.FP:
                got = specs_mod.cache_specs(lm, 128, 32768, Rep.FP)
                assert _port_specs(caches_sharding(got, mesh)) == want
    for nd, shape in ((2, (256, 4097)), (3, (256, 4096, 8192)),
                      (2, (1, 524288)), (3, (32, 1, 8192))):
        for ax in range(nd):
            assert batch_spec(mesh, nd, ax) == tuple(
                j_batch_spec(mesh, nd, ax))
        assert batch_spec(mesh, nd, shape=shape) == tuple(
            j_batch_spec(mesh, nd, shape=shape))


def _with_mesh_specs(j_caches_sharding, ref, mesh):
    """The reference's `caches_sharding` specs on a duck mesh (its
    NamedSharding needs devices: the specs are taken before it)."""
    import jax
    import repro.sharding.rules as jr

    real = jr.NamedSharding
    jr.NamedSharding = lambda m, spec: types.SimpleNamespace(
        spec=tuple(spec))
    try:
        return j_caches_sharding(ref, mesh)
    finally:
        jr.NamedSharding = real


def test_rules_equal_reference_on_the_host_mesh():
    """At reduced size on the reference's real (2, 4) mesh of the host
    devices: `params_sharding` / `caches_sharding` specs leaf for leaf,
    the port's on a mapping of the same sizes."""
    import jax
    from repro.configs.base import get_config as j_get_config
    from repro.core.rep import Rep as JRep
    from repro.launch import specs as j_specs
    from repro.models.lm import DecoderLM as JLM
    from repro.sharding.rules import (
        caches_sharding as j_caches_sharding,
        params_sharding as j_params_sharding,
    )

    jmesh = jax.make_mesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    for arch in ("granite_3_2b", "olmoe_1b_7b", "zamba2_1_2b"):
        jlm = JLM(j_get_config(arch).reduced(), max_seq=64)
        lm = DecoderLM(get_config(arch).reduced(), max_seq=64)
        for jt, t in ((j_specs.float_param_specs(jlm),
                       specs_mod.float_param_specs(lm)),
                      (j_specs.deploy_specs(jlm), specs_mod.deploy_specs(lm))):
            for ws in (False, True):
                want = {_jpath(p): tuple(s.spec) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            j_params_sharding(jt, jmesh,
                                              weight_stationary=ws))[0]}
                assert _port_specs(params_sharding(
                    t, sizes, weight_stationary=ws)) == want
        jc = jax.eval_shape(lambda: jlm.init_caches(8, 64, JRep.FP))
        want = {_jpath(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    j_caches_sharding(jc, jmesh))[0]}
        got = specs_mod.cache_specs(lm, 8, 64, Rep.FP)
        assert _port_specs(caches_sharding(got, sizes)) == want


def test_to_placements_is_pod_major():
    """`to_placements` of ("pod", "data") on one dim and DTensor's own
    split agree with the reference's pod-major order: on a fake
    process group of 8 ranks, every rank's local offset (DTensor's
    `compute_local_shape_and_global_offset`, the rank set by the fake
    store) equals `shard_index`'s."""
    import subprocess
    import sys

    code = r'''
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from repro_torch.sharding.rules import shard_index, to_placements
out = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), world_size=8,
                            rank=rank)
    m = init_device_mesh("cpu", (2, 2, 2),
                         mesh_dim_names=("pod", "data", "model"))
    spec = (("pod", "data"), "model")
    pl = to_placements(spec, m)
    shape, off = compute_local_shape_and_global_offset((16, 4), m, pl)
    coords = dict(zip(m.mesh_dim_names, m.get_coordinate()))
    idx = shard_index((16, 4), spec, m, coords)
    out.append((tuple(shape), tuple(off),
                tuple(i.stop - i.start for i in idx),
                tuple(i.start for i in idx)))
    dist.destroy_process_group()
print(repr(out))
'''
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stderr[-2000:]
    rows = eval(res.stdout.strip().splitlines()[-1])
    for rank, (shape, off, w, start) in enumerate(rows):
        assert shape == w == (4, 2) and off == start
        p, d, m = rank // 4, (rank // 2) % 2, rank % 2
        assert off == ((p * 2 + d) * 4, m * 2)


# -- the sharded step on gloo ranks -----------------------------------------
def _model(arch):
    return DecoderLM(get_config(arch).reduced(), max_seq=SEQ + 1)


def _state(arch):
    """The seeded initial (trainable, opt) of the port and its batch."""
    lm = _model(arch)
    tr = {"params": params_to_torch(lm.init_np(0), "cpu"),
          "qstate": lm.init_qstate("cpu")}
    tok = np.random.default_rng(3).integers(
        0, lm.cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return lm, tr, adamw_init(tr), {"tokens": torch.from_numpy(tok)}


def _save(path, loss, tr, opt):
    leaves = [torch.as_tensor(loss)] + tree_leaves(tr) + tree_leaves(opt)
    torch.save([x.detach().clone() for x in leaves], path)


def _expected_bytes(tree, shardings, mesh) -> int:
    n = 0
    for x, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        shp = local_shape(tuple(x.shape), s.spec, mesh)
        n += int(np.prod(shp, dtype=np.int64)) * x.element_size()
    return n


def _rank_main(rank, shape, out_dir, ckpt_dir):
    from repro_torch.checkpoint import manager as ckpt

    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    report = {}
    for arch in ARCHS:
        lm, tr, opt, batch = _state(arch)
        (tr_sh, opt_sh, _), _, _ = train_shardings(lm, mesh, "train_4k")
        dtr, dopt = place.distribute(tr, tr_sh), place.distribute(opt, opt_sh)
        report[f"{arch}_bytes"] = [
            place.local_bytes(dtr) + place.local_bytes(dopt),
            _expected_bytes(tr, tr_sh, mesh) + _expected_bytes(
                opt, opt_sh, mesh)]
        loss, ntr, nopt = build_train_step(lm, mesh=mesh)(dtr, dopt, batch)
        full = (tree_map(place.gather, ntr), tree_map(place.gather, nopt))
        if rank == 0:
            _save(os.path.join(out_dir, f"{arch}_{shape}.pt"), loss, *full)
        if arch == "granite_3_2b":
            loss2, ntr2, nopt2 = build_train_step(
                lm, microbatches=2, mesh=mesh)(dtr, dopt, batch)
            full2 = (tree_map(place.gather, ntr2),
                     tree_map(place.gather, nopt2))
            if rank == 0:
                _save(os.path.join(out_dir, f"mb_{shape}.pt"), loss2, *full2)
            if shape == (1, 2):
                ckpt.save(ckpt_dir, 1, {"trainable": ntr, "opt": nopt})
            if shape == (2, 1):
                back = ckpt.restore(ckpt_dir, 1, {"trainable": dtr,
                                                  "opt": dopt},
                                    shardings={"trainable": tr_sh,
                                               "opt": opt_sh})
                report["restored_placed"] = all(
                    place.is_placed(x) for x in tree_leaves(back))
                report["restored_bytes"] = place.local_bytes(back)
                if rank == 0:
                    g = tree_map(place.gather, back)
                    _save(os.path.join(out_dir, "restored.pt"), 0.0,
                          g["trainable"], g["opt"])
                else:
                    tree_map(place.gather, back)
        elif shape[0] > 1:
            try:
                build_train_step(lm, microbatches=2, mesh=mesh)(
                    dtr, dopt, batch)
                report["moe_refused"] = False
            except ValueError as e:
                report["moe_refused"] = "MoE groups" in str(e)
    try:
        make_production_mesh()
        report["world_refused"] = False
    except ValueError as e:
        report["world_refused"] = "needs 256 ranks" in str(e)
    with open(os.path.join(out_dir, f"report_{shape}_{rank}.json"),
              "w") as f:
        json.dump(report, f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    ck = str(tmp_path_factory.mktemp("ckpt"))
    for shape in MESHES:
        spawn(_rank_main, shape[0] * shape[1], (shape, out, ck),
              device="cpu")
    reports = {}
    for shape in MESHES:
        for r in range(shape[0] * shape[1]):
            with open(os.path.join(out, f"report_{shape}_{r}.json")) as f:
                reports[(shape, r)] = json.load(f)
    return out, ck, reports


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for arch in ARCHS:
        lm, tr, opt, batch = _state(arch)
        out[arch] = build_train_step(lm)(tr, opt, batch)
    lm, tr, opt, batch = _state("granite_3_2b")
    out["mb"] = build_train_step(lm, microbatches=2)(tr, opt, batch)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8, 8: torch.int64}
    return t.reshape(-1).view(ints[t.element_size()])


def _rel(g: torch.Tensor, w: torch.Tensor) -> float:
    """max |g - w| over max |w|."""
    g, w = g.double(), w.double()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def _flat(res):
    loss, tr, opt = res
    return [torch.as_tensor(loss)] + tree_leaves(tr) + tree_leaves(opt)


@pytest.mark.parametrize("arch", ARCHS + ("mb",))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_equals_unsharded(sharded, unsharded, arch, shape):
    out, _, _ = sharded
    got = torch.load(os.path.join(out, f"{arch}_{shape}.pt"))
    want = _flat(unsharded[arch])
    assert len(got) == len(want)
    n_tr = len(tree_leaves(unsharded[arch][1]))
    kinds = ["loss"] + ["trainable"] * n_tr + ["moments"] * (
        len(want) - 1 - n_tr)
    for g, w, kind in zip(got, want, kinds):
        assert g.shape == w.shape and g.dtype == w.dtype
        if shape[0] == 1:  # the batch is not split: bit for bit
            assert torch.equal(_bits(g), _bits(w)), (arch, shape)
        else:
            assert _rel(g, w) <= SHARD_TOL[kind], (arch, shape, kind)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_its_placements_bytes(sharded, shape):
    _, _, reports = sharded
    for r in range(shape[0] * shape[1]):
        rep = reports[(shape, r)]
        for arch in ARCHS:
            have, want = rep[f"{arch}_bytes"]
            assert have == want, (shape, r, arch)
    full = sum(x.numel() * x.element_size() for x in
               tree_leaves(list(_state("granite_3_2b")[1:3])))
    assert reports[(shape, 0)]["granite_3_2b_bytes"][0] < full


def test_checkpoint_reshards_across_meshes(sharded, tmp_path):
    from repro_torch.checkpoint import manager as ckpt

    out, ck, reports = sharded
    saved = torch.load(os.path.join(out, "granite_3_2b_(1, 2).pt"))[1:]
    back = torch.load(os.path.join(out, "restored.pt"))[1:]
    for a, b in zip(saved, back):
        assert torch.equal(a, b)
    for r in range(2):
        assert reports[((2, 1), r)]["restored_placed"]
    # and on one process, unsharded
    _, tr, opt, _ = _state("granite_3_2b")
    one = ckpt.restore(ck, 1, {"trainable": tr, "opt": opt})
    for a, b in zip(saved, tree_leaves(one["trainable"]) +
                    tree_leaves(one["opt"])):
        assert torch.equal(a, b)


def test_refusals(sharded):
    _, _, reports = sharded
    for key, rep in reports.items():
        assert rep["world_refused"], key
    for shape in ((2, 1), (2, 2)):
        assert reports[(shape, 0)]["moe_refused"]


def test_unsharded_step_holds_to_the_reference(unsharded):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as j_get_config
    from repro.core.rep import Rep as JRep
    from repro.launch.steps import build_train_step as j_build_train_step
    from repro.models.lm import DecoderLM as JLM
    from repro.optim.adamw import adamw_init as j_adamw_init
    from repro_torch.launch.steps import value_and_grad

    for arch in ARCHS:
        lm, tr, opt, batch = _state(arch)
        jlm = JLM(j_get_config(arch).reduced(), max_seq=SEQ + 1)
        jtr = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tr)
        jloss, _, _ = jax.jit(j_build_train_step(jlm))(
            jtr, j_adamw_init(jtr), {"tokens": jnp.asarray(
                batch["tokens"].numpy())})
        loss = float(unsharded[arch][0])
        assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
        if arch != "granite_3_2b":
            continue
        _, jg = jax.jit(jax.value_and_grad(lambda t: jlm.loss_fn(
            t["params"], t["qstate"], jnp.asarray(batch["tokens"].numpy()),
            JRep.FQ)))(jtr)
        _, tg = value_and_grad(lambda t, b: lm.loss_fn(
            t["params"], t["qstate"], b, Rep.FQ), tr, batch["tokens"])
        for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
            a = np.asarray(a, np.float64)
            b = b.numpy().astype(np.float64)
            den = np.linalg.norm(a)
            assert (np.linalg.norm(a - b) / den if den else
                    np.linalg.norm(b)) <= GRAD_TOL
