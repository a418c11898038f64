"""The bfloat16 scan island (``ssm_island_dtype="bf16"``) in the port
against the JAX reference with the variant set on both sides.

Only the chunked branch changes (a prefill of a multiple of the chunk,
128): the chunk's a, u and incoming state go to bfloat16, the scan runs
in bfloat16, the carry returns to float32 and y reads the bfloat16 h.
Shorter spans and decode steps stay float32.

Held at tolerance 0 (reduced falcon_mamba_7b and zamba2_1_2b, the
port's seeded params, calibration and deploy carried to the reference
as numpy tables):

  - layer 0's `QMamba1.apply_id` and group 0's first `QMamba2.apply_id`
    at L 128 and 256, with and without a cached state: out_proj's int32
    accumulator and h bit for bit against the reference's jitted
    `apply_id` under the variant, and h apart from the float32
    island's (the variant takes effect);
  - one served engine a family in exact mode, lockstep with the
    reference's (`SlotArena` for falcon_mamba_7b, the paged arena with
    `paged_kernel=False` for zamba2_1_2b) on prompts of 256, 128 and 9
    tokens: tokens, finish reasons, steps and the arena's h state bit
    for bit after the drain;
  - `QMamba2` at n_groups 2 (8 heads, each group's B / C over 4 of
    them; the reference's params and calibrator): the float forward
    within 1e-5 of max |ref| and its ranges within 1e-5 of the span, the
    deploy leaf for leaf, and `apply_id` at L 128 from a state in the
    float32 and the bf16 island at tolerance 0 (accumulator, conv
    window, h bit for bit).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch import variants as j_variants
from repro.layers.ssm import QMamba1 as JQMamba1, QMamba2 as JQMamba2
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import get_config
from repro_torch.launch import variants
from repro_torch.launch.serve import calibration_sample
from repro_torch.layers.ssm import QMamba1, QMamba2, load_core
from repro_torch.models.lm import DecoderLM, tables_from_numpy, tree_to_torch
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine,
)

MAX_LEN = 384
F32 = np.float32
BF16 = dict(ssm_island_dtype="bf16")
# (prompt length, new tokens): two chunked prefills and a short one
WORK = [(256, 4), (128, 5), (9, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The scan island is thousands of small torch ops; beside the
    suite's other workers intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits_differ(a, b) -> int:
    a = np.ascontiguousarray(np.asarray(a, F32))
    b = np.ascontiguousarray(np.asarray(b, F32))
    assert a.shape == b.shape
    return int((a.view(np.int32) != b.view(np.int32)).sum())


_MODELS = {}


def _models(arch):
    """-> (reference lm, its tables, port lm, its tables): the port's
    calibration and deploy of seeded params, the same numpy tables on
    both sides (once a module)."""
    if arch not in _MODELS:
        tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
        p = tlm.init_np(0)
        calib = tlm.calibrate(p, calibration_sample(tlm.cfg.vocab, 64),
                              device="cpu")
        t_np = tlm.deploy(p, calib)
        jlm = JLM(j_get_config(arch).reduced(), max_seq=MAX_LEN)
        _MODELS[arch] = (jlm, jax.tree.map(jnp.asarray, t_np), tlm,
                         tables_from_numpy(t_np, device="cpu"), t_np)
    return _MODELS[arch]


def _core(arch):
    """-> (reference layer, port layer, numpy tables, port tables, h
    shape less the batch) of the first mamba core."""
    *_, t_np = _models(arch)
    if arch == "falcon_mamba_7b":
        t = jax.tree.map(lambda a: a[0], t_np["segments"][0]["core"])
        return (JQMamba1(128, d_state=16), QMamba1(128, d_state=16), t,
                load_core(tree_to_torch(t, "cpu")), (256, 16))
    t = jax.tree.map(lambda a: a[0][0], t_np["segments"][0]["m"])["core"]
    kw = dict(d_state=16, expand=2, head_dim=32)
    return (JQMamba2(128, **kw), QMamba2(128, **kw), t,
            tree_to_torch(t, "cpu"), (8, 32, 16))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1_2b"])
@pytest.mark.parametrize("L,cached", [(128, False), (256, True)])
def test_apply_id_equals_reference(arch, L, cached):
    jm, tm, t_np, tt, hshape = _core(arch)
    rng = np.random.default_rng(L + cached)
    s_x = rng.integers(-128, 128, (2, L, 128)).astype(np.int8)
    cache = None
    if cached:
        conv_w = tm.d_conv_in if arch == "zamba2_1_2b" else tm.d_inner
        cache = {"conv": rng.integers(-128, 128, (2, 3, conv_w)
                                      ).astype(np.int8),
                 "h": (rng.standard_normal((2, *hshape)) * 0.1).astype(F32)}
    with j_variants.use_variants(**BF16):
        jo, jc = jax.jit(lambda t, s, c: jm.apply_id(t, s, cache=c))(
            t_np, s_x, cache)
    tcache = (None if cache is None
              else {k: torch.from_numpy(v) for k, v in cache.items()})
    if cache is None:  # h_last through a zero cache
        tcache = tm.init_cache(2, device="cpu")
        tcache["conv"].zero_()
    with variants.use_variants(**BF16):
        to, tc = tm.apply_id(tt, torch.from_numpy(s_x),
                             tcache if cached else None)
        _, th = tm.apply_id(tt, torch.from_numpy(s_x), tcache)
    _, th32 = tm.apply_id(tt, torch.from_numpy(s_x), tcache)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if cached:
        np.testing.assert_array_equal(tc["conv"].numpy(),
                                      np.asarray(jc["conv"]))
        assert _bits_differ(tc["h"].numpy(), jc["h"]) == 0
    assert _bits_differ(th["h"].numpy(), th32["h"].numpy()) > 0


def _lockstep(j, t):
    """Submit every request, then step both engines together to the
    drain. -> (reference, port) completions."""
    rng = np.random.default_rng(0)
    for n, g in WORK:
        prompt = rng.integers(0, 256, size=(n,))
        for eng in (j, t):
            eng.submit(copy.deepcopy(prompt), max_new_tokens=g)
    steps = 0
    while (j.sched.n_pending or j.active or j.queue.pending
           or t.sched.n_pending or t.active or t.queue.pending):
        with j_variants.use_variants(**BF16):
            rj = j.step()
        with variants.use_variants(**BF16):
            rt = t.step()
        assert rt == rj
        steps += 1
        assert steps < 100
    return [[(c.req_id, list(map(int, c.tokens)), c.finish_reason)
             for c in eng.completed] for eng in (j, t)]


@pytest.mark.parametrize("arch,paged", [("falcon_mamba_7b", False),
                                        ("zamba2_1_2b", True)])
def test_engine_tokens_and_state_equal_reference(arch, paged):
    jlm, jt, tlm, tt, _ = _models(arch)
    kw = dict(n_slots=2, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, page_size=16)
    j = JServingEngine(jlm, jt, JServingConfig(
        paged_kernel=False if paged else None, scheduler=JSchedulerConfig(),
        **kw))
    t = ServingEngine(tlm, tt, ServingConfig(
        device="cpu", scheduler=SchedulerConfig(), **kw))
    assert t._prefill_mode == j._prefill_mode == "exact"
    res = _lockstep(j, t)
    assert res[1] == res[0]
    assert sorted(len(toks) for _, toks, _ in res[1]) == sorted(
        g for _, g in WORK)
    assert t.stats()["steps"] == j.stats()["steps"]
    jc = _np(j.arena.caches)
    if paged:  # the hybrid tree: the groups' blocks in order, the tail
        G, k = jc[0]["m"]["h"].shape[:2]
        want = {key: np.concatenate(
            [jc[0]["m"][key].reshape(G * k, *jc[0]["m"][key].shape[2:])]
            + [seg[key] for seg in jc[1:]]) for key in ("conv", "h")}
    else:
        want = jc[0]
    np.testing.assert_array_equal(t.arena.caches["conv"].numpy(),
                                  want["conv"])
    assert _bits_differ(t.arena.caches["h"].numpy(), want["h"]) == 0


# -- QMamba2 at n_groups 2 ----------------------------------------------------
_GROUPS = {}


def _two_groups():
    """The reference's QMamba2 at n_groups 2 (8 heads, 4 a group):
    params from PRNGKey(5), its calibrator on a 2 x 64 input, its
    deploy; the port's layer and tables from the same."""
    if not _GROUPS:
        from repro.core.calibrate import Calibrator as JCalibrator
        from repro.core.rep import Rep as JRep
        from repro.layers.common import DeployCtx as JDeployCtx

        kw = dict(d_state=16, expand=2, head_dim=32, n_groups=2)
        jm, tm = JQMamba2(128, **kw), QMamba2(128, **kw)
        p = _np(jm.init(jax.random.PRNGKey(5)))
        x = np.random.default_rng(5).standard_normal((2, 64, 128)).astype(F32)
        jc = JCalibrator()
        y, _ = jm.apply_float(p, jnp.asarray(x), JRep.FP, calib=jc,
                              scope="s.")
        t_np, _ = jm.deploy(JDeployCtx(calib=jc), "s.", p, 0.05, 0)
        _GROUPS.update(jm=jm, tm=tm, p=p, x=x, jc=jc, y=np.asarray(y),
                       t_np=_np(t_np))
    return _GROUPS


def test_mamba2_two_groups_float_and_deploy_equal_reference():
    """The float forward within 1e-5 of max |ref| (its observed ranges
    within 1e-5 of the span), the deploy from the reference's ranges
    leaf for leaf: d_conv_in 256 + 2 * 2 * 16."""
    from repro_torch.core.calibrate import Calibrator
    from repro_torch.layers.common import DeployCtx
    from repro_torch.models.lm import params_to_torch

    g = _two_groups()
    tm = g["tm"]
    assert tm.d_conv_in == 256 + 64 and g["p"]["conv_w"].shape == (4, 320)
    tc = Calibrator()
    y, _ = tm.apply_float(params_to_torch(g["p"], "cpu"),
                          torch.from_numpy(g["x"]), tc, "s.")
    assert float(np.abs(y.numpy() - g["y"]).max()) <= 1e-5 * float(
        np.abs(g["y"]).max())
    for n in g["jc"].hi:
        span = max(g["jc"].hi[n] - g["jc"].lo[n], 1e-6)
        assert abs(tc.hi[n] - g["jc"].hi[n]) <= 1e-5 * span, n
        assert abs(tc.lo[n] - g["jc"].lo[n]) <= 1e-5 * span, n
    t, _ = tm.deploy(DeployCtx(calib=g["jc"]), "s.", g["p"], 0.05, 0)
    flat_j = jax.tree_util.tree_flatten_with_path(g["t_np"])[0]
    assert len(flat_j) == len(jax.tree.leaves(t))
    for path, a in flat_j:
        b = t
        for k in path:
            b = b[k.key]
        assert np.asarray(b).dtype == a.dtype, path
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


@pytest.mark.parametrize("island", ["f32", "bf16"])
def test_mamba2_two_groups_apply_id_equals_reference(island):
    """`apply_id` at L 128 (one chunk) from a state, each group's B / C
    repeated over its four heads in the float32 and the bf16 island:
    out_proj's accumulator and the conv window equal, h bit for bit."""
    g = _two_groups()
    jm, tm = g["jm"], g["tm"]
    var = BF16 if island == "bf16" else {}
    rng = np.random.default_rng(17)
    s_x = rng.integers(-128, 128, (2, 128, 128)).astype(np.int8)
    cache = {"conv": rng.integers(-128, 128, (2, 3, tm.d_conv_in)
                                  ).astype(np.int8),
             "h": (rng.standard_normal((2, 8, 32, 16)) * 0.1).astype(F32)}
    with j_variants.use_variants(**var):
        jo, jc = jax.jit(lambda t, s, c: jm.apply_id(t, s, cache=c))(
            g["t_np"], s_x, cache)
    with variants.use_variants(**var):
        to, tc = tm.apply_id(tree_to_torch(g["t_np"], "cpu"),
                             torch.from_numpy(s_x),
                             {k: torch.from_numpy(v) for k, v in
                              cache.items()})
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    assert _bits_differ(tc["h"].numpy(), jc["h"]) == 0
