"""The float forward's cache branch in the port, against the JAX
reference.

Reduced granite_3_2b (dense), falcon_mamba_7b (ssm), zamba2_1_2b
(hybrid: one group of two Mamba-2 blocks and the shared attention, then
one tail block), musicgen_medium (LayerNorm, MHA, GELU) and
llama4_maverick_400b_a17b (a pair: its caches (n, 2, B, ...)), at
FullPrecision and FakeQuantized (the reference's clips carried across),
with the reference's params: a prefill of P tokens at position 0 into
`init_caches(B, T, Rep.FP)`, then D single-token decodes, each step's
logits and every cache leaf held to the reference's `apply(...,
caches=, pos=)` + `logits` (jitted: its scan path), each as a fraction of the
reference's span, within LIMITS: the logits, the float32 leaves (SSM
h, and the conv window, which the float32 input promotes) and the
bfloat16 K/V leaves, whose cells are mostly bit-equal (the share that
differs at all is held too).

Why not bit-equal: XLA's float32 matmuls and torch's sum in other
orders, so the float32 K / V differ in their last bits, and where one
sits next to a bfloat16 rounding boundary the stored values are one
bfloat16 ulp apart (about 2^-8 relative), which later layers and steps
read; at FQ the weight grids add the reference's own 1e-3-level
difference (`test_torch_train.py`).  The decodes run at a
shared int position and at per-row positions (the rows' prompts of
different lengths), and through the port's paged float pools (the
reference's contiguous cache on the other side).  The hybrid under a
calibrator returns no cache for its hybrid segment (the reference's
eager walk raises there, which the last test records).

MEASURED (on the CPU, this file's cases; max over archs, modes and
steps, fractions of the span): FP logits 1.1e-4, float32 leaves 2.0e-4,
bfloat16 leaves 2.2e-3 with 0.87% of their cells differing; FQ 2.0e-4,
7.6e-4, 2.2e-3 and 3.0%.  llama4 alone: logits 1.5e-6 (FP) and 3.1e-6
(FQ), bfloat16 leaves 8.8e-6 / 7.1e-5 with 0.04% of cells differing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.calibrate import Calibrator as JCalibrator
from repro.core.rep import Rep as JRep
from repro.models.lm import DecoderLM as JLM
from repro_torch.configs.base import get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.core.rep import Rep
from repro_torch.core.tree import tree_leaves
from repro_torch.models.lm import DecoderLM, params_to_torch

ARCHS = ("granite_3_2b", "falcon_mamba_7b", "zamba2_1_2b",
         "musicgen_medium", "llama4_maverick_400b_a17b")
B, P, D, T = 2, 12, 4, 20
TOL = 1e-5
# the limits of each rep (fractions of the reference's span, and the
# share of bfloat16 cells that differ at all), about twice MEASURED
LIMITS = {Rep.FP: dict(logits=2.5e-4, f32=4e-4, bf16=5e-3, flips=0.02),
          Rep.FQ: dict(logits=4e-4, f32=1.5e-3, bf16=5e-3, flips=0.06)}
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tn(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


# (arch, mode): the ssm family keeps no K/V to page; llama4's pairs
# stack their blocks' K/V (n, 2, B, ...), which `_paged` does not page
CASES = [(a, m) for a in ARCHS for m in ("int", "vec", "paged")
         if not (a in ("falcon_mamba_7b", "llama4_maverick_400b_a17b")
                 and m == "paged")]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jlm = JLM(j_get_config(arch).reduced(), max_seq=64)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=64)
    p = jlm.init(jax.random.PRNGKey(0))
    qs = jlm.init_qstate()
    toks = np.random.default_rng(1).integers(
        0, jlm.cfg.vocab, (B, P + D)).astype(np.int32)
    return arch, jlm, tlm, p, qs, toks


_REF = {}


def _ref_run(arch, jlm, p, qs, toks, rep, pos_mode):
    """The reference, jitted (its scan path, one compile for the
    prefill and one for the decodes): prefill then D decodes -> (logits
    a step, caches a step); memoised by (arch, rep, pos_mode), which
    the paged mode shares with "vec"."""
    key = (arch, rep, pos_mode)
    if key in _REF:
        return _REF[key]
    jrep = JRep.FQ if rep is Rep.FQ else JRep.FP
    q = qs if rep is Rep.FQ else None

    @jax.jit
    def step(tok, caches, pos):
        x = jlm.embed_in(p, tok, jrep)
        x, caches, _ = jlm.apply(p, x, jrep, qstate=q, caches=caches,
                                 pos=pos)
        return jlm.logits(p, x, jrep)[:, -1], caches

    caches = jlm.init_caches(B, T, JRep.FP)
    logit, caches = step(jnp.asarray(toks[:, :P]), caches, jnp.int32(0))
    logits, states = [logit], [caches]
    for d in range(D):
        pos = (jnp.int32(P + d) if pos_mode == "int" else
               jnp.full((B,), P + d, jnp.int32))
        logit, caches = step(jnp.asarray(toks[:, P + d:P + d + 1]), caches,
                             pos)
        logits.append(logit)
        states.append(caches)
    _REF[key] = ([np.asarray(v) for v in logits], [_np(c) for c in states])
    return _REF[key]


def _paged(tlm, caches):
    """The float layout with every K/V leaf as pools of PAGE positions
    read through a per-layer table (pages handed out in reverse)."""
    pps = T // PAGE
    out = []
    for seg in caches:
        def conv(tree):
            if "k" not in tree:
                return {k: conv(v) if isinstance(v, dict) else v
                        for k, v in tree.items()}
            n, Bk, K, _, hd = tree["k"].shape
            pool = torch.zeros((n, Bk * pps + 1, K, PAGE, hd),
                               dtype=tree["k"].dtype)
            table = torch.arange(Bk * pps, 0, -1, dtype=torch.int32)
            table = table.reshape(Bk, pps)[None].repeat(n, 1, 1)
            return {"k": pool, "v": pool.clone(), "table": table}
        out.append(conv(seg))
    return out


def _unpage(seg_k, table):
    """(n, n_pages + 1, K, ps, hd) pools through (n, B, pps) -> (n, B,
    K, T, hd)."""
    n, Bk, pps = table.shape
    x = seg_k[torch.arange(n)[:, None, None], table.to(torch.int64)]
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, Bk, x.shape[3], pps * PAGE, x.shape[-1])


def _port_run(tlm, p_t, qs_t, toks, rep, pos_mode, paged=False):
    q = qs_t if rep is Rep.FQ else None
    caches = tlm.init_caches(B, T, Rep.FP, device="cpu")
    if paged:
        caches = _paged(tlm, caches)
    tok = torch.from_numpy(toks)
    with torch.no_grad():
        x = tlm.embed_in(p_t, tok[:, :P], rep)
        pos0 = (torch.zeros(B, dtype=torch.int32)
                if paged or pos_mode == "vec" else 0)
        x, caches = tlm.apply(p_t, x, rep, qstate=q, caches=caches,
                              pos=pos0)
        logits = [tlm.logits(p_t, x, rep)[:, -1]]
        states = [_clone(caches)]
        for d in range(D):
            x = tlm.embed_in(p_t, tok[:, P + d:P + d + 1], rep)
            pos = (P + d if pos_mode == "int" and not paged else
                   torch.full((B,), P + d, dtype=torch.int32))
            x, caches = tlm.apply(p_t, x, rep, qstate=q, caches=caches,
                                  pos=pos)
            logits.append(tlm.logits(p_t, x, rep)[:, -1])
            states.append(_clone(caches))
    return [v.numpy() for v in logits], states


def _clone(tree):
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _rel(g, r) -> float:
    """max |g - r| over the reference's span."""
    g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
    if not r.size:
        return 0.0
    return float(np.abs(g - r).max() / max(float(r.max() - r.min()), 1e-6))


def _hold(rep, what: str, value: float):
    assert value <= LIMITS[rep][what], (what, value, LIMITS[rep][what])


def _check_caches(ref, got, paged, rep):
    if paged:
        got = _unpaged_tree(got)
    rl, gl = jax.tree.leaves(ref), tree_leaves(got)
    assert len(rl) == len(gl)
    for r, g in zip(rl, gl):
        g = _tn(g)
        assert r.shape == g.shape and r.dtype == g.dtype, (
            r.shape, g.shape, r.dtype, g.dtype)
        if r.dtype == jnp.bfloat16:
            _hold(rep, "flips", float((_bits(g) != _bits(r)).mean()))
            _hold(rep, "bf16", _rel(g, r))
        else:
            _hold(rep, "f32", _rel(g, r))


def _unpaged_tree(tree):
    if isinstance(tree, list):
        return [_unpaged_tree(v) for v in tree]
    if "table" in tree:
        return {"k": _unpage(tree["k"], tree["table"]),
                "v": _unpage(tree["v"], tree["table"])}
    return {k: _unpaged_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


@pytest.mark.parametrize("rep", [Rep.FP, Rep.FQ], ids=["fp", "fq"])
@pytest.mark.parametrize("pair,mode", CASES, indirect=["pair"])
def test_float_cache_matches_reference(pair, mode, rep):
    arch, jlm, tlm, p, qs, toks = pair
    ref_logits, ref_caches = _ref_run(arch, jlm, p, qs, toks, rep,
                                      "int" if mode == "int" else "vec")
    p_t = params_to_torch(_np(p), "cpu")
    qs_t = params_to_torch(_np(qs), "cpu")
    logits, caches = _port_run(tlm, p_t, qs_t, toks, rep, mode,
                               paged=(mode == "paged"))
    for step, (r, g) in enumerate(zip(ref_logits, logits)):
        assert np.all(np.isfinite(g)), step
        _hold(rep, "logits", _rel(g, r))
    for r, g in zip(ref_caches, caches):
        _check_caches(r, g, mode == "paged", rep)


# the no-cache forward routes all B x (P + d) tokens as one MoE group,
# a decode its B tokens: capacity keeps other (token, expert) choices,
# so llama4's decodes are held to the reference's only (above)
DECODE_ARCHS = [a for a in ARCHS if a != "llama4_maverick_400b_a17b"]


@pytest.mark.parametrize("pair", DECODE_ARCHS, indirect=True)
def test_decode_equals_no_cache_forward(pair):
    """Each decode's logits against the no-cache forward over the whole
    sequence so far (the K/V rounded to bfloat16 in the cache are the
    one difference)."""
    arch, jlm, tlm, p, qs, toks = pair
    p_t = params_to_torch(_np(p), "cpu")
    logits, _ = _port_run(tlm, p_t, None, toks, Rep.FP, "int")
    tok = torch.from_numpy(toks)
    with torch.no_grad():
        for d in range(D + 1):
            x = tlm.embed_in(p_t, tok[:, :P + d])
            full = tlm.logits(p_t, tlm.apply(p_t, x))[:, -1].numpy()
            np.testing.assert_allclose(logits[d], full, rtol=0, atol=5e-2,
                                       err_msg=f"{arch} step {d}")


def test_init_caches_float_layout(pair):
    """`init_caches(rep=FP)` is the reference's tree: structure, shapes
    and dtypes (bfloat16 K/V and conv, float32 h), and the ID layout is
    unchanged."""
    arch, jlm, tlm, *_ = pair
    ref = jax.eval_shape(lambda: jlm.init_caches(B, T, JRep.FP))
    got = tlm.init_caches(B, T, Rep.FP, device="cpu")
    rl, gl = jax.tree.leaves(ref), tree_leaves(got)
    assert jax.tree.structure(ref).num_leaves == len(gl)
    for r, g in zip(rl, gl):
        assert tuple(r.shape) == tuple(g.shape)
        assert str(r.dtype) == str(g.dtype).replace("torch.", "")
    ids = tlm.init_caches(B, T, device="cpu")
    assert isinstance(ids, dict)
    if tlm.has_kv:
        assert ids["k"].dtype == torch.int8 and ids["contiguous"]


def test_hybrid_under_calibrator_returns_no_cache():
    jlm = JLM(j_get_config("zamba2_1_2b").reduced(), max_seq=64)
    tlm = DecoderLM(get_config("zamba2_1_2b").reduced(), max_seq=64)
    p = jlm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, 256, (B, P)).astype(
        np.int32)
    p_t = params_to_torch(_np(p), "cpu")
    with torch.no_grad():
        x = tlm.embed_in(p_t, torch.from_numpy(toks))
        want, caches = tlm.apply(p_t, x, caches=tlm.init_caches(
            B, T, Rep.FP, device="cpu"), pos=0)
        calib = Calibrator()
        got, c_cal = tlm.apply(p_t, x, calib=calib, caches=tlm.init_caches(
            B, T, Rep.FP, device="cpu"), pos=0)
    assert c_cal[0] is None and caches[0] is not None
    assert c_cal[1] is not None  # the tail's Mamba-2 block keeps its cache
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any(k.startswith("S0.L0.sh.") for k in calib.hi)
    # the reference's eager walk reads the group's cache under the
    # wrong keys: it raises where it means to return None
    x_j = jlm.embed_in(p, jnp.asarray(toks), JRep.FP)
    with pytest.raises(KeyError):
        jlm.apply(p, x_j, JRep.FP, caches=jlm.init_caches(B, T, JRep.FP),
                  pos=0, calib=JCalibrator())
