"""The embeds model (internvl2_76b: a dense backbone fed precomputed
embeddings, no embedding table) in the port, against the JAX
reference, on the reduced config (2 layers, d 128, 4/2 heads of 32,
d_ff 256, vocab 256).

One reference init, calibration (a seeded float (2, 16, 128) sample)
and deploy serve every test (module fixture).  Held here:

  - the config, `param_count` and the float param tree (no "embed");
  - the FullPrecision forward (`apply` then `logits`) on the same float
    embeddings within 1e-5 of the largest logit, and the port's own
    calibration within 1e-5 of each range's span;
  - deploy from the reference's calibration carried across, leaf for
    leaf, `meta["eps_in"]` included, at the default eps_in (2 * 8 /
    255) and an explicit one;
  - `prefill` over `init_caches` (2 rows of 16 int8 rows each, at the
    last column and at a ragged `last_index`) and 3 `decode_step`s:
    int32 logits and the K/V bytes equal at tolerance 0;
  - the serving engine, `deploy_model` and `serve_batch` refuse the
    embeds config (the engine as the reference's does).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.rep import Rep as JRep
from repro.models.lm import DecoderLM as JLM
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import SERVE_ARCH_IDS, get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.launch.serve import deploy_model, serve_batch
from repro_torch.models.lm import (
    DecoderLM, params_to_torch, tables_from_numpy,
)
from repro_torch.serving import ServingConfig, ServingEngine

ARCH = "internvl2_76b"
MAX_LEN = 24
B, S = 2, 16
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rows(x, eps_in):
    """A frontend's int8 rows: the float embeddings' image at eps_in."""
    return np.clip(np.round(x / eps_in), -128, 127).astype(np.int8)


@pytest.fixture(scope="module")
def ref():
    jlm = JLM(j_get_config(ARCH).reduced(), max_seq=MAX_LEN)
    p = jlm.init(jax.random.PRNGKey(3))
    x = (np.random.default_rng(7).standard_normal((B, S, 128)) * 0.5
         ).astype(np.float32)
    jc = jlm.calibrate(p, jnp.asarray(x))
    tlm = DecoderLM(get_config(ARCH).reduced(), max_seq=MAX_LEN)
    return {"jlm": jlm, "p": p, "x": x, "jc": jc, "tlm": tlm,
            "jt": _np(jlm.deploy(p, jc))}


def _compare(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            _compare(want[k], got[k], f"{path}/{k}")
        return
    if isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _compare(a, b, f"{path}/{i}")
        return
    a, b = np.asarray(want), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def test_config_param_count_and_float_tree_equal_reference(ref):
    j, t = j_get_config(ARCH), get_config(ARCH)
    assert t.input_mode == "embeds" and ARCH not in SERVE_ARCH_IDS
    assert t.param_count() == j.param_count()  # 2 V d counted, as there
    assert t.active_param_count() == j.active_param_count()
    p_t = ref["tlm"].init_np(0)
    assert "embed" not in p_t
    shapes = jax.tree.map(np.shape, _np(ref["p"]))
    assert jax.tree.map(np.shape, p_t) == shapes


def test_float_forward_and_calibration_equal_reference(ref):
    jlm, tlm, p, x = ref["jlm"], ref["tlm"], ref["p"], ref["x"]
    h, _, _ = jlm.apply(p, jnp.asarray(x), JRep.FP)
    want = np.asarray(jlm.logits(p, h, JRep.FP), np.float64)
    pt = params_to_torch(_np(p), "cpu")
    xt = tlm.embed_in(pt, torch.from_numpy(x))
    got = tlm.logits(pt, tlm.apply(pt, xt)).numpy().astype(np.float64)
    assert np.abs(want - got).max() <= TOL * np.abs(want).max()
    jc, tc = ref["jc"], tlm.calibrate(_np(p), x, device="cpu")
    assert list(tc.hi) == list(jc.hi) and "embed" not in tc.hi
    for n in jc.hi:
        span = max(jc.hi[n] - jc.lo[n], 1e-6)
        assert abs(tc.hi[n] - jc.hi[n]) <= TOL * span, n
        assert abs(tc.lo[n] - jc.lo[n]) <= TOL * span, n


@pytest.mark.parametrize("eps_in", [None, 0.05])
def test_deploy_equals_reference_leaf_for_leaf(ref, eps_in):
    jlm, p = ref["jlm"], ref["p"]
    want = ref["jt"] if eps_in is None else _np(
        jlm.deploy(p, ref["jc"], eps_in=eps_in))
    calib = Calibrator.from_state(ref["jc"].state_dict())
    got = ref["tlm"].deploy(_np(p), calib, eps_in=eps_in)
    assert "embed" not in got
    assert got["meta"]["eps_in"] == (eps_in or 2.0 * 8.0 / 255.0)
    _compare(want, got)


def test_prefill_and_decode_equal_reference(ref):
    jlm, tlm, jt = ref["jlm"], ref["tlm"], ref["jt"]
    eps_in = float(jt["meta"]["eps_in"])
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((B, S + 3, 128)) * 0.5).astype(np.float32)
    rows = _rows(x, eps_in)
    tt = tables_from_numpy(jt, device="cpu")
    assert "embed" not in tt

    @functools.partial(jax.jit, static_argnames="last_index")
    def j_prefill(t, batch, caches, last_index=None):
        return jlm.prefill(t, batch, caches, last_index=last_index)

    j_decode = jax.jit(jlm.decode_step)
    for last in (None, 9):
        jcache = jlm.init_caches(B, MAX_LEN, JRep.ID)
        jlog, jcache = j_prefill(jt, jnp.asarray(rows[:, :S]), jcache,
                                 last_index=last)
        tcache = tlm.init_caches(B, MAX_LEN, device="cpu")
        tlog = tlm.prefill(tt, torch.from_numpy(rows[:, :S]), tcache,
                           last_index=last)
        assert tlog.dtype == torch.int32
        np.testing.assert_array_equal(tlog.numpy(), np.asarray(jlog))
    # the decodes continue from the second prefill's caches
    for i in range(3):
        tok = rows[:, S + i:S + i + 1]
        jlog, jcache = j_decode(jt, jnp.asarray(tok), jcache,
                                jnp.int32(S + i))
        tlog = tlm.decode_step(tt, torch.from_numpy(tok), tcache,
                               torch.full((B,), S + i, dtype=torch.int32))
        np.testing.assert_array_equal(tlog.numpy(), np.asarray(jlog))
    for kv in ("k", "v"):
        want = np.asarray(jcache[0][kv])           # (L, B, K, T, hd)
        np.testing.assert_array_equal(tcache[kv][:, 1:].numpy(), want,
                                      err_msg=kv)


def test_serving_entry_points_refuse_embeds(ref):
    jlm, tlm, jt = ref["jlm"], ref["tlm"], ref["jt"]
    with pytest.raises(ValueError, match="serves token LMs") as je:
        JServingEngine(jlm, jt)
    tt = tables_from_numpy(jt, device="cpu")
    with pytest.raises(ValueError, match="serves token LMs") as te:
        ServingEngine(tlm, tt, ServingConfig(device="cpu"))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="int8 rows"):
        deploy_model(ARCH, reduced=True, max_seq=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="int8 rows"):
        serve_batch(tlm, tt, np.zeros((1, 4), np.int32), 2)
