"""The port's llama3_2_3b and chatglm3_6b against the JAX reference's.

Both configs are the reference's values (GQA 24/8 with rope_base
500000; near-MQA 32/2 with rotary on half of each head).  Reduced, the
port's deploy must equal the reference's leaf for leaf and its engine
the reference engine's (`paged=True, paged_kernel=False`) token for
token.  `reduced()` cuts heads to 4/2 at hd 32, so one case each keeps
the configs' real head geometry (n_heads, n_kv_heads, hd 128, the rope
settings: GQA groups 3 and 16) with d_model, d_ff, vocab and depth cut.
Last, the engine cases probed by hand before these configs were ported
(stop tokens at the 1st, 2nd and 3rd token, one chunk row a step, one
admission a step, chunks of 1 and 64, pages of 1 position, one slot),
each held on one of the configs, at kv_bits 8 or 4 in turn (the stop
tokens on both): tokens, finish reasons, completion order, steps,
rejects, occupancy and the page peak.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.synthetic import SyntheticConfig, SyntheticStream
from repro.models.lm import DecoderLM as JLM
from repro.serving import (
    SchedulerConfig as JSchedulerConfig, ServingConfig as JServingConfig,
    ServingEngine as JServingEngine,
)
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.calibrate import Calibrator
from repro_torch.models.lm import DecoderLM, tables_from_numpy
from repro_torch.serving import (
    SchedulerConfig, ServingConfig, ServingEngine,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' products are too small for torch's thread
    pool, which only contends with XLA's and the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("llama3_2_3b", "chatglm3_6b")
MAX_LEN = 96


def test_configs_equal_the_reference_values():
    assert set(ARCHS) < set(ARCH_IDS)
    for arch in ARCHS:
        got, want = get_config(arch), j_get_config(arch)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.hd == want.hd == 128
        assert got.vocab_padded == want.vocab_padded
        r, jr = got.reduced(), want.reduced()
        for f in dataclasses.fields(r):
            assert getattr(r, f.name) == getattr(jr, f.name), f.name
    assert get_config("llama3_2_3b").rope_base == 500000.0
    assert get_config("chatglm3_6b").rope_fraction == 0.5


_CACHE = {}


def _reference(arch: str, geometry: bool = False):
    """(reference lm, params, calibrator, tables) of the reduced config,
    or with `geometry` the config's real heads at small widths."""
    key = (arch, geometry)
    if key not in _CACHE:
        cfg = _cut(j_get_config(arch), geometry)
        lm = JLM(cfg, max_seq=MAX_LEN)
        p = lm.init(jax.random.PRNGKey(0))
        stream = SyntheticStream(SyntheticConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=4))
        calib = lm.calibrate(p, jnp.asarray(stream.batch(0))[:, :-1])
        _CACHE[key] = (lm, p, calib, lm.deploy(p, calib))
    return _CACHE[key]


def _cut(cfg, geometry: bool):
    if not geometry:
        return cfg.reduced()
    # the real head geometry, the rest small: 1 layer, d 128, d_ff 256,
    # vocab 256
    return dataclasses.replace(cfg, n_layers=1, d_model=128, d_ff=256,
                               vocab=256, name=cfg.name + "_heads")


def _port(arch: str, geometry: bool = False):
    jlm, _, _, jt = _reference(arch, geometry)
    tlm = DecoderLM(_cut(get_config(arch), geometry), max_seq=MAX_LEN)
    return jlm, jt, tlm, tables_from_numpy(jax.tree.map(np.asarray, jt),
                                           device="cpu")


def _compare(ref, got, path="", seen=None):
    if isinstance(ref, dict):
        assert not set(got) - set(ref), f"{path}: port-only keys"
        for k, v in ref.items():
            _compare(v, got[k], f"{path}/{k}", seen)
        return
    if isinstance(ref, list):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _compare(a, b, f"{path}/{i}", seen)
        return
    a, b = np.asarray(ref), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)
    seen.append(path)


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_deploy_equals_reference_leaf_for_leaf(arch, calibrated):
    jlm, p, calib, jt = _reference(arch)
    p_np = jax.tree.map(np.asarray, p)
    tlm = DecoderLM(get_config(arch).reduced(), max_seq=MAX_LEN)
    if calibrated:
        want = jt
        got = tlm.deploy(p_np, Calibrator.from_state(calib.state_dict()))
    else:
        want, got = jlm.deploy(p, None), tlm.deploy(p_np, None)
    seen = []
    _compare(jax.tree.map(np.asarray, want), got, seen=seen)
    assert len(seen) == 130  # every table leaf (sm_tabs' 5 included)


def _engines(models, *, kv_bits=8, n_slots=3, page_size=8, n_pages=None,
             **sched):
    jlm, jt, tlm, tt = models
    j = JServingEngine(jlm, jt, JServingConfig(
        n_slots=n_slots, max_len=MAX_LEN, paged=True, page_size=page_size,
        n_pages=n_pages, paged_kernel=False, kv_bits=kv_bits,
        scheduler=JSchedulerConfig(**sched)))
    t = ServingEngine(tlm, tt, ServingConfig(
        n_slots=n_slots, max_len=MAX_LEN, paged=True, page_size=page_size,
        n_pages=n_pages, device="cpu", kv_bits=kv_bits,
        scheduler=SchedulerConfig(**sched)))
    return j, t


def _drive(eng, work):
    """Submit the first three (each followed by a step), then the rest;
    drain.  -> {req_id: (tokens, finish reason)}, completion order."""
    for i, (prompt, g, stop) in enumerate(work):
        eng.submit(prompt, g, stop)
        if i < 3:
            eng.step()
    done = eng.run_until_drained()
    return ({c.req_id: (list(c.tokens), c.finish_reason) for c in done},
            [c.req_id for c in done])


def _work(vocab, seed, lens=(5, 17, 33, 40, 1, 16, 9), gen=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(n,)), gen, None) for n in lens]


def _both(models, work, **kw):
    j, t = _engines(models, **kw)
    jr, tr = _drive(j, work), _drive(t, work)
    assert tr == jr
    js, ts = j.stats(), t.stats()
    for k in ("steps", "admit_rejects", "mean_occupancy",
              "max_pages_in_use", "n_generated"):
        assert ts[k] == js[k], k
    return tr[0]


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_engine_tokens_equal_reference(arch, chunk, kv_bits):
    models = _port(arch)
    got = _both(models, _work(models[2].cfg.vocab, chunk + kv_bits),
                kv_bits=kv_bits, prefill_chunk=chunk)
    assert [len(v[0]) for v in got.values()] == [6] * 7


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_real_head_geometry_engine_tokens_equal_reference(arch, kv_bits):
    """n_heads / n_kv_heads / hd 128 and the rope settings as
    configured: GQA group 3 (llama) and 16 (chatglm), rotary on all of
    hd at base 500000 or on half of it."""
    models = _port(arch, geometry=True)
    cfg = models[2].cfg
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == (
        {"llama3_2_3b": 3, "chatglm3_6b": 16}[arch], 128)
    _both(models, _work(cfg.vocab, 40 + kv_bits), kv_bits=kv_bits,
          prefill_chunk=16)


# the hand probes' engine settings: (name, engine and scheduler knobs,
# the config and KV width each is held on, alternating)
ENGINE_CASES = [
    ("stop_tokens", {}, "llama3_2_3b", 8),
    ("one_chunk_row_a_step", {"max_chunks_per_step": 1}, "chatglm3_6b", 4),
    ("one_admission_a_step", {"max_prefills_per_step": 1}, "llama3_2_3b",
     4),
    ("chunk_1", {"prefill_chunk": 1}, "chatglm3_6b", 8),
    ("chunk_64", {"prefill_chunk": 64}, "llama3_2_3b", 8),
    ("page_size_1", {"page_size": 1}, "chatglm3_6b", 4),
    ("one_slot", {"n_slots": 1}, "llama3_2_3b", 4),
    ("stop_tokens", {}, "chatglm3_6b", 4),
]


@pytest.mark.parametrize("case,knobs,arch,kv_bits", ENGINE_CASES,
                         ids=[f"{c}-{a}-{k}" for c, _, a, k in ENGINE_CASES])
def test_probed_engine_cases_equal_reference(case, knobs, arch, kv_bits):
    models = _port(arch)
    kw = dict(knobs)
    kw.setdefault("prefill_chunk", 8)
    lens = (70, 5, 17, 66, 1, 40) if case == "chunk_64" else (
        5, 17, 9, 1, 12, 8)
    work = _work(models[2].cfg.vocab, 60 + len(case), lens, gen=5)
    if case == "stop_tokens":
        # each request stops at its own 1st, 2nd or 3rd generated token
        _, t = _engines(models, kv_bits=kv_bits, prefill_chunk=8)
        free = _drive(t, work)[0]
        work = [(p, g, free[i][0][i % 3]) for i, (p, g, _) in
                enumerate(work)]
    got = _both(models, work, kv_bits=kv_bits, **kw)
    if case == "stop_tokens":
        assert {r for _, r in got.values()} == {"stop"}
        assert all(len(got[i][0]) <= i % 3 + 1 for i in got)
