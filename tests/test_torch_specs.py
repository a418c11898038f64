"""The dry run's shape-and-dtype stand-ins (`launch.specs`) and the torch
dry run (`launch.dryrun`), against the port's real trees and the JAX
reference.

  - `deploy_specs` equals the port's real deploy ("meta" stripped) and
    the reference's `deploy_specs`, paths, shapes and dtypes, on every
    reduced family `tests/test_dryrun_specs.py` lists (internvl2_76b's
    embeds model and llama4_maverick's pairs too), and full-width
    llama4_maverick's specs the reference's;
  - `float_param_specs` equals `init_np` and the reference's
    `float_param_specs`; `qstate_specs` and `cache_specs` (ID and FP)
    equal `init_qstate` and `init_caches`;
  - `cache_specs` of full nemotron_4_340b at B 128, T 32768 holds more
    than 1 TB of meta tensors: nothing was allocated;
  - the dry run of every ported arch x shape on the pod mesh, one child
    process on a fake process group of 256 ranks: every cell's record
    (the reference's keys; the XLA-only fields null, each with a
    reason), its `argument_bytes_per_dev` equal to the sum of shard
    bytes that the REFERENCE's rules give: on a train cell the
    reference's own leaves (`jax.eval_shape` of its init, qstate,
    moments and batch), on a serve cell the reference's tables and
    inputs and the port's ID cache leaves (a trash page and the slot
    table beside the reference's layout, ROADMAP §3) under the
    reference's `caches_sharding`.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.models.lm import DecoderLM as JLM
from repro_torch.configs.base import ArchConfig, LM_ARCH_IDS, get_config
from repro_torch.core.rep import Rep
from repro_torch.launch import specs
from repro_torch.launch.steps import SHAPES, cell_supported
from repro_torch.models.lm import DecoderLM
from repro_torch.sharding.rules import tree_map_with_path

FAMILIES = ["granite_3_2b", "olmoe_1b_7b", "falcon_mamba_7b", "zamba2_1_2b",
            "nemotron_4_340b", "musicgen_medium", "internvl2_76b",
            "llama4_maverick_400b_a17b"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_map(tree) -> dict:
    """{path: (shape, dtype name)} of a torch / numpy tree."""
    out = {}

    def one(p, x):
        dt = (str(x.dtype).replace("torch.", "") if isinstance(
            x, torch.Tensor) else str(np.asarray(x).dtype))
        out["/".join(str(v) for v in p)] = (tuple(np.shape(x)) if not
                                            isinstance(x, torch.Tensor) else
                                            tuple(x.shape), dt)
    tree_map_with_path(one, tree)
    return out


def _ref_map(tree) -> dict:
    from repro.sharding.rules import _path_str

    return {_path_str(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _all_meta(tree) -> bool:
    return all(x.device.type == "meta" for x in jax.tree.leaves(
        tree, is_leaf=lambda v: isinstance(v, torch.Tensor))
        if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", FAMILIES)
def test_deploy_specs_match_real_deploy_and_reference(arch):
    lm = DecoderLM(get_config(arch).reduced(), max_seq=32)
    real = lm.deploy(lm.init_np(0), None)
    real.pop("meta")
    spec = specs.deploy_specs(lm)
    assert _all_meta(spec)
    assert _port_map(spec) == _port_map(real)
    jlm = JLM(j_get_config(arch).reduced(), max_seq=32)
    assert _port_map(spec) == _ref_map(j_specs.deploy_specs(jlm))


def test_llama4_is_not_ported():
    """llama4_maverick is ported: at full width its deploy specs (the
    pair's dense "a" and MoE "b" blocks, 24 of each, the shared MLP and
    `sh_rqt` in "b"), float params and qstate equal the reference's,
    paths, shapes and dtypes, and allocate nothing."""
    arch = "llama4_maverick_400b_a17b"
    lm = DecoderLM(get_config(arch), max_seq=4096)
    jlm = JLM(j_get_config(arch), max_seq=4096)
    spec = specs.deploy_specs(lm)
    assert _all_meta(spec)
    assert _port_map(spec) == _ref_map(j_specs.deploy_specs(jlm))
    seg = spec["segments"][0]
    assert set(seg) == {"a", "b"} and "moe" not in seg["a"]
    assert tuple(seg["b"]["sh_rqt"]["m"].shape) == (24, 5120)
    assert tuple(seg["b"]["moe"]["wg_q"].shape) == (24, 128, 5120, 8192)
    assert _port_map(specs.float_param_specs(lm)) == _ref_map(
        j_specs.float_param_specs(jlm))
    assert _port_map(specs.qstate_specs(lm)) == _ref_map(
        jax.eval_shape(jlm.init_qstate))


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_qstate_and_cache_specs_match(arch):
    lm = DecoderLM(get_config(arch).reduced(), max_seq=32)
    fp = specs.float_param_specs(lm)
    assert _all_meta(fp)
    assert _port_map(fp) == _port_map(lm.init_np(0))
    jlm = JLM(j_get_config(arch).reduced(), max_seq=32)
    assert _port_map(fp) == _ref_map(j_specs.float_param_specs(jlm))
    assert _port_map(specs.qstate_specs(lm)) == _port_map(
        lm.init_qstate("cpu"))
    for rep in (Rep.ID, Rep.FP):
        got = specs.cache_specs(lm, 2, 16, rep)
        want = lm.init_caches(2, 16, rep, device="cpu")
        assert _port_map(got) == _port_map(want)


def test_cache_specs_allocate_nothing():
    lm = DecoderLM(get_config("nemotron_4_340b"), max_seq=32768)
    for rep in (Rep.ID, Rep.FP):
        cs = specs.cache_specs(lm, 128, 32768, rep)
        leaves = [x for x in jax.tree.leaves(
            cs, is_leaf=lambda v: isinstance(v, torch.Tensor))
            if isinstance(x, torch.Tensor)]
        assert all(x.device.type == "meta" for x in leaves)
        total = sum(x.numel() * x.element_size() for x in leaves)
        assert total > 1e12


# -- the dry run ------------------------------------------------------------
POD = types.SimpleNamespace(axis_names=("data", "model"),
                            devices=np.empty((16, 16)))


def _shard_bytes(tree, specs_of) -> int:
    """Sum over the leaves of their shard-shape bytes, spec by
    `specs_of(path, leaf)` (a tuple, one entry a dim)."""
    sizes = dict(zip(POD.axis_names, POD.devices.shape))
    n = 0
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        shape = list(x.shape)
        for i, ax in enumerate(specs_of(path, x)):
            for a in (() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))):
                shape[i] //= sizes[a]
        n += int(np.prod(shape, dtype=np.int64)) * np.dtype(x.dtype).itemsize
    return n


def _ref_param_spec(path, x):
    from repro.sharding.rules import spec_for_path

    return tuple(spec_for_path(path, x, POD))


def _ref_batch_spec(path, x):
    from repro.sharding.rules import batch_spec

    return tuple(batch_spec(POD, len(x.shape), shape=x.shape))


def _ref_cache_specs(caches) -> dict:
    import repro.sharding.rules as jr

    real = jr.NamedSharding
    jr.NamedSharding = lambda m, spec: types.SimpleNamespace(
        spec=tuple(spec))
    try:
        sh = jr.caches_sharding(caches, POD)
    finally:
        jr.NamedSharding = real
    return sh


def _ref_argument_bytes(arch, shape) -> int:
    from repro.launch.steps import train_input_specs, train_state_specs

    s = SHAPES[shape]
    if s["kind"] == "train":
        jlm = JLM(j_get_config(arch), max_seq=s["seq"] + 1)
        trainable, opt = train_state_specs(jlm)
        batch = train_input_specs(jlm, shape)
        return (_shard_bytes(trainable, _ref_param_spec)
                + _shard_bytes(opt["mu"], _ref_param_spec)
                + _shard_bytes(opt["nu"], _ref_param_spec)
                + 4 + _shard_bytes(batch, _ref_batch_spec))
    jlm = JLM(j_get_config(arch), max_seq=s["seq"])
    B, S = s["batch"], s["seq"]
    n = _shard_bytes(j_specs.deploy_specs(jlm), _ref_param_spec)
    cols = S if s["kind"] == "prefill" else 1
    x = (jax.ShapeDtypeStruct((B, cols, jlm.cfg.d_model), jnp.int8)
         if jlm.cfg.input_mode == "embeds" else
         jax.ShapeDtypeStruct((B, cols), jnp.int32))
    n += _shard_bytes({"x": x}, _ref_batch_spec)
    if s["kind"] == "decode":
        n += 4  # pos, replicated
    # the port's ID cache leaves under the reference's rule
    lm = DecoderLM(get_config(arch), max_seq=s["seq"])
    port = specs.cache_specs(lm, B, S)
    caches = {k: jax.ShapeDtypeStruct(
        tuple(v.shape), {torch.int8: jnp.int8, torch.int32: jnp.int32,
                         torch.float32: jnp.float32}[v.dtype])
        for k, v in port.items() if isinstance(v, torch.Tensor)}
    sh = _ref_cache_specs(caches)
    return n + _shard_bytes(caches, lambda p, x: sh[p[0].key].spec)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "pod", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = {}
    for arch in LM_ARCH_IDS:
        for shape in SHAPES:
            with open(out / f"{arch}__{shape}__pod.json") as f:
                recs[(arch, shape)] = json.load(f)
    return recs


CELLS = [(a, s) for a in LM_ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_record_matches_reference_rules(dryrun, arch, shape):
    rec = dryrun[(arch, shape)]
    if cell_supported(get_config(arch), shape):
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes_per_dev"] == _ref_argument_bytes(arch, shape)
    assert mem["output_bytes_per_dev"] > 0
    for key in ("temp_bytes_per_dev", "code_bytes"):
        assert mem[key] is None and rec["null_reasons"][key]
    assert rec["lower_s"] is None and rec["compile_s"] is None
    assert rec["cost"] == {"flops": None, "bytes_accessed": None}
    rl = rec["roofline"]
    assert rl["model_flops"] > 0 and rl["hlo_flops"] is None
    assert rl["dominant"] in ("compute", "memory", "collective")
    coll = rec["collectives"]
    assert coll["counts"]["all-gather"] > 0
    if SHAPES[shape]["kind"] == "train":
        assert coll["counts"]["all-reduce"] > 0
