"""The port's host-side deploy against the JAX reference's.

From the same float params and the same calibrator state, the port's
`DecoderLM.deploy` must equal `repro`'s leaf for leaf (dtype, shape and
value), the per-kv-head `kv4` and the integer softmax's `sm_tabs`
tables included.  `tables_from_numpy`
must keep every dtype (int32 stays int32 — torch would promote int32 x
int64 to int64 and hide the wraps — int8 stays int8, the f32
score_scale stays f32), and the layer-by-layer `deploy_model` (which
calibrates each layer just before it deploys it) must equal the
whole-tree calibrate -> deploy at tolerance 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.synthetic import SyntheticConfig, SyntheticStream
from repro.models.lm import DecoderLM as JLM
from repro_torch.configs.base import get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.launch.serve import calibration_sample, deploy_model
from repro_torch.models.lm import DecoderLM, tables_from_numpy


@pytest.fixture(scope="module")
def reference():
    cfg = j_get_config("granite_3_2b").reduced()
    lm = JLM(cfg, max_seq=64)
    p = lm.init(jax.random.PRNGKey(0))
    stream = SyntheticStream(SyntheticConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4))
    calib = lm.calibrate(p, jnp.asarray(stream.batch(0))[:, :-1])
    p_np = jax.tree.map(np.asarray, p)
    return {
        "p_np": p_np,
        "calib_state": calib.state_dict(),
        "tables": jax.tree.map(np.asarray, lm.deploy(p, calib)),
        "tables_default": jax.tree.map(np.asarray, lm.deploy(p, None)),
    }


def _port_lm():
    return DecoderLM(get_config("granite_3_2b").reduced(), max_seq=64)


def _compare(ref, got, path="", seen=None):
    if isinstance(ref, dict):
        extra = set(got) - set(ref)
        assert not extra, f"{path}: port-only keys {extra}"
        for k, v in ref.items():
            _compare(v, got[k], f"{path}/{k}", seen)
        return
    if isinstance(ref, list):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _compare(a, b, f"{path}/{i}", seen)
        return
    a, b = np.asarray(ref), np.asarray(got)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)
    if seen is not None:
        seen.append(path)


def test_deploy_from_reference_calibration_equals_reference(reference):
    calib = Calibrator.from_state(reference["calib_state"])
    got = _port_lm().deploy(reference["p_np"], calib)
    seen = []
    _compare(reference["tables"], got, seen=seen)
    assert len(seen) > 80  # every int table of both layers was compared


def test_deploy_with_default_ranges_equals_reference(reference):
    """calib=None: the DEFAULT_RANGES deploy the full-size path uses."""
    got = _port_lm().deploy(reference["p_np"], None)
    _compare(reference["tables_default"], got)


def test_tables_from_numpy_keeps_every_dtype(reference):
    t_np = reference["tables"]
    st = tables_from_numpy(t_np, device="cpu")
    seg = t_np["segments"][0]
    assert len(st["layers"]) == 2

    def walk(ref, got, path, layer=None):
        if isinstance(ref, dict):
            for k, v in ref.items():
                walk(v, got[k], f"{path}/{k}", layer)
            return
        want = np.asarray(ref) if layer is None else np.asarray(ref)[layer]
        assert isinstance(got, torch.Tensor), path
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)

    for i in range(2):
        walk(seg, st["layers"][i], f"layers/{i}", layer=i)
    for k in ("embed", "norm_f", "head"):
        walk(t_np[k], st[k], k)
    assert st["layers"][0]["attn"]["score_scale"].dtype == torch.float32
    assert st["layers"][1]["mlp"]["wd"]["b_q"].dtype == torch.int32
    # GEMM weights: logical (K, N), stored (N, K) contiguous
    w = st["layers"][1]["attn"]["wq"]["w_q"]
    assert w.shape == (128, 128) and w.stride() == (1, 128)
    assert st["head"]["w_q"].t().is_contiguous()


def test_layer_by_layer_deploy_model_equals_whole_tree():
    lm = _port_lm()
    p = lm.init_np(5)
    calib = lm.calibrate(p, calibration_sample(lm.cfg.vocab, 64),
                         device="cpu")
    whole = tables_from_numpy(lm.deploy(p, calib), device="cpu")
    _, streamed = deploy_model("granite_3_2b", reduced=True, max_seq=64,
                               seed=5, device="cpu")

    def eq(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                eq(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.stride() == b.stride(), path
            assert torch.equal(a, b), path
        else:
            assert a == pytest.approx(b, rel=0, abs=0), path

    eq(whole, streamed)


def test_deploy_model_depth_cut_keeps_the_first_layers():
    """`n_layers` serves the config's first layers at its full width:
    layer 0's tables equal the uncut deploy's, and the cut model has
    one layer."""
    lm, cut = deploy_model("granite_3_2b", reduced=True, max_seq=64, seed=5,
                           device="cpu", n_layers=1)
    _, full = deploy_model("granite_3_2b", reduced=True, max_seq=64, seed=5,
                           device="cpu")
    assert lm.cfg.n_layers == 1 and len(cut["layers"]) == 1
    assert lm.cfg.d_model == _port_lm().cfg.d_model

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{path}/{k}")
        else:
            yield path, t

    for (pa, a), (pb, b) in zip(leaves(cut["layers"][0]),
                                leaves(full["layers"][0])):
        assert pa == pb
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for (_, a), (_, b) in zip(leaves(cut["embed"]), leaves(full["embed"])):
        assert torch.equal(a, b)


def test_numpy_init_has_the_reference_shapes_and_scales(reference):
    p = _port_lm().init_np(0)
    ref = reference["p_np"]

    def shapes(t):
        return jax.tree.map(lambda x: np.asarray(x).shape, t)

    assert shapes(p) == shapes(ref)
    wq, wq_ref = p["segments"][0]["attn"]["wq"]["w"], \
        ref["segments"][0]["attn"]["wq"]["w"]
    assert wq.dtype == np.float32
    assert np.std(wq) == pytest.approx(np.std(wq_ref), rel=0.1)
    assert np.std(p["embed"]["table"]) == pytest.approx(0.02, rel=0.05)
