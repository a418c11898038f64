"""The requant kernel's three call forms against the JAX reference, and
the kernel's index map emulated in numpy.

On the CPU `requant`, `requant_add` and `requant_gate` run their plain
versions; these tests hold those, at tolerance 0, against the
reference's own functions on the same seeded inputs:

* `requant_add_plain` against `repro.layers.add.QAdd.apply_id`;
* `requant_gate_plain` against the reference MLP's sequence
  (`repro.core.intmath.apply_lut`, the gate product, `apply_rqt` of
  h_rqt);
* `requant(..., heads_to_rows=True)` against `apply_rqt` and the
  (B, H, S, hd) -> (B, S, H, hd) transpose,

with tables from the scheduler and planted ones whose staged product
wraps in int32 or whose s0 is 31 or more, nonzero zero points,
per-channel tables, and `a` both int8 and int32.  The CUDA kernel runs
only on the card (tests/test_torch_gpu.py); what decides which
elements each of its threads takes is emulated here: the 16 elements a
thread owns, the channel of each vector, the heads-to-rows address and
the split between vectors and the scalar tail, on shapes whose numel
and N are not multiples of 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.intmath import apply_lut as j_apply_lut
from repro.core.requant import apply_rqt as j_apply_rqt, make_rqt
from repro.layers.add import QAdd as JQAdd
from repro_torch.kernels import (
    requant, requant_add, requant_add_plain, requant_gate,
    requant_gate_plain,
)
from repro_torch.kernels.requant_kernel import (
    BRANCH, VEC, requant_plan, vector_ok,
)
from repro_torch.layers.add import QAdd


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rqt(rng, N, per_channel, kind, *, zp=0, int32_out=False):
    """Requant tables (numpy int32): `make` from the scheduler, `wrap`
    with m near 2^31 and s0 0 so (q >> s0) * m wraps in int32, `s0big`
    with s0 in [31, 35] (the shift fills with the sign)."""
    shape = (N,) if per_channel else ()
    if kind == "make":
        eps = (rng.uniform(1e-5, 4e-5, size=N) if per_channel
               else float(rng.uniform(1e-5, 4e-5)))
        kw = dict(qmin=-BRANCH, qmax=BRANCH) if int32_out else {}
        return make_rqt(eps, 0.05, zp_out=zp, acc_bound=float(1 << 24), **kw)
    if kind == "wrap":
        m, s0, d, lo, hi = (rng.integers(1 << 28, 1 << 31, size=shape), 0,
                            20, -(1 << 20), 1 << 20)
    else:
        m, s0, d, lo, hi = (12345, rng.integers(31, 36, size=shape), 40,
                            -(2 ** 31), 2 ** 31 - 1)

    def i32(v):  # broadcast to the table's shape, wrapped to int32
        v = np.broadcast_to(np.asarray(v, np.int64), shape)
        return (v - (1 << 32) * (v >= 1 << 31)).astype(np.int32)
    return {"m": i32(m), "d": np.int32(d), "s0": i32(s0), "lo": i32(lo),
            "hi": i32(hi), "zp": np.int32(zp)}


def _hits_wrap(q, rq):
    """Some (q >> s0) * m of these inputs leaves int32."""
    q = np.clip(q.astype(np.int64), rq["lo"].astype(np.int64),
                rq["hi"].astype(np.int64))
    staged = (q >> np.minimum(rq["s0"], 63)) * rq["m"].astype(np.int64)
    return bool(np.any(np.abs(staged) >= 2 ** 31))


ADD_CASES = [  # a int8?, rq_a per channel?, rq_b per channel?, kind
    (True, False, True, "make"),    # the serving path's QAdd
    (False, False, True, "make"),
    (True, True, False, "wrap"),
    (False, True, True, "wrap"),
    (True, False, False, "s0big"),
    (False, True, True, "s0big"),
]


@pytest.mark.parametrize("a_int8,pc_a,pc_b,kind", ADD_CASES)
def test_requant_add_plain_matches_the_reference_qadd(a_int8, pc_a, pc_b,
                                                      kind):
    rng = np.random.default_rng(len(kind) * 8 + 4 * a_int8 + 2 * pc_a + pc_b)
    shape = (3, 5, 48)
    N = shape[-1]
    a = (rng.integers(-128, 128, size=shape).astype(np.int8) if a_int8
         else rng.integers(-(1 << 30), 1 << 30, size=shape).astype(np.int32))
    b = rng.integers(-(1 << 30), 1 << 30, size=shape).astype(np.int32)
    t = {"rq_a": _rqt(rng, N, pc_a, kind, int32_out=True),
         "rq_b": _rqt(rng, N, pc_b, kind, int32_out=True),
         "zp_a": np.int32(rng.integers(-100, 100)),
         "zp_b": np.int32(rng.integers(-(1 << 31), 1 << 31))}
    if kind == "wrap":
        assert _hits_wrap(b.astype(np.int64) - t["zp_b"], t["rq_b"])
    want = np.asarray(JQAdd().apply_id(
        {k: (v if k.startswith("zp") else {n: jnp.asarray(x) for n, x in
                                             v.items()})
         for k, v in t.items()}, jnp.asarray(a), jnp.asarray(b)))
    tt = {"rq_a": _tt(t["rq_a"]), "rq_b": _tt(t["rq_b"]),
          "zp_a": torch.tensor(t["zp_a"]), "zp_b": torch.tensor(t["zp_b"])}
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (requant_add_plain(ta, tb, tt), requant_add(ta, tb, tt),
                QAdd().apply_id(tt, ta, tb)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pc,kind", [(False, "make"), (True, "make"),
                                     (False, "wrap"), (True, "s0big")])
def test_requant_gate_plain_matches_the_reference_sequence(pc, kind):
    rng = np.random.default_rng(10 + 2 * len(kind) + pc)
    shape = (6, 80)
    s_pre = rng.integers(-128, 128, size=shape).astype(np.int8)
    s_u = rng.integers(-128, 128, size=shape).astype(np.int8)
    lut = rng.integers(-128, 128, size=256).astype(np.int8)
    zp_g = np.int32(rng.integers(-128, 128))
    h_rqt = _rqt(rng, shape[-1], pc, kind, zp=int(rng.integers(-9, 10)))
    s_g = j_apply_lut(jnp.asarray(s_pre), jnp.asarray(lut), qmin=-128)
    prod = (s_g.astype(jnp.int32) - zp_g) * jnp.asarray(s_u).astype(
        jnp.int32)
    if kind == "wrap":
        assert _hits_wrap(np.asarray(prod), h_rqt)
    want = np.asarray(j_apply_rqt(prod, h_rqt))
    args = (torch.from_numpy(s_pre), torch.from_numpy(s_u),
            torch.from_numpy(lut), torch.tensor(zp_g), _tt(h_rqt))
    for got in (requant_gate_plain(*args), requant_gate(*args)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,pc,kind", [
    ((2, 4, 3, 32), False, "make"), ((2, 4, 1, 64), True, "make"),
    ((1, 3, 5, 24), False, "wrap"), ((2, 2, 7, 16), True, "s0big")])
def test_requant_heads_to_rows_matches_apply_rqt_transposed(shape, pc,
                                                            kind):
    rng = np.random.default_rng(20 + len(kind) + pc + shape[2])
    q = rng.integers(-(1 << 26), 1 << 26, size=shape).astype(np.int32)
    rq = _rqt(rng, shape[-1], pc, kind, zp=int(rng.integers(-9, 10)))
    want = np.asarray(j_apply_rqt(jnp.asarray(q), rq)).transpose(0, 2, 1, 3)
    got = requant(torch.from_numpy(q), _tt(rq), heads_to_rows=True)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


# -- the kernel's index map, emulated ---------------------------------

def _h2r(e, hd, H, S):
    """requant.cu `heads_to_rows`: offset in (B, S, H, hd) of element e
    of a contiguous (B, H, S, hd)."""
    row, j = divmod(e, hd)
    bh, s = divmod(row, S)
    b, h = divmod(bh, H)
    return ((b * S + s) * H + h) * hd + j


def _kernel_map(numel, N, plan, pc, heads=None):
    """Every (thread, element, channel, output offset) the kernel's two
    loops visit, in requant.cu's order: vectors of VEC elements, thread
    t from vector t in steps of the grid, each vector's channel taken
    once at its first element (0 with scalar tables); then the elements
    past the last whole vector (all of them without vectors) one at a
    time."""
    step = plan.blocks * plan.threads
    end = numel // VEC * VEC if plan.vec else 0
    out = (lambda e: _h2r(e, N, *heads)) if heads else (lambda e: e)
    visits = []
    for t in range(step):
        for e in range(t * VEC, end, step * VEC):
            c, o = (e % N if pc else 0), out(e)
            visits += [(t, e + k, c + k if pc else 0, o + k)
                       for k in range(VEC)]
        for e in range(end + t, numel, step):
            visits.append((t, e, e % N if pc else 0, out(e)))
    return visits


MAP_CASES = [  # shape, per-channel tables, heads-to-rows, data offset
    ((3, 37, 29), False, False, 0),   # numel % 16 = 15: a tail
    ((7, 100), True, False, 0),       # N % 16 != 0, per channel: scalar
    ((7, 100), False, False, 0),      # ... scalar tables: vectors
    ((5, 48), True, False, 0),
    ((5, 48), True, False, 4),        # a misaligned pointer: scalar
    ((2, 3, 5, 32), False, True, 0),  # heads to rows in vectors
    ((2, 3, 5, 24), True, True, 0),   # hd % 16 != 0: scalar
    ((1, 1, 1, 5), False, False, 0),
]


@pytest.mark.parametrize("shape,pc,h2r,offset", MAP_CASES)
@pytest.mark.parametrize("threads,per_thread", [(128, 1), (32, 2), (32, 64)])
def test_kernel_index_map_writes_every_element_once(shape, pc, h2r, offset,
                                                    threads, per_thread):
    numel, N = int(np.prod(shape)), shape[-1]
    vec = vector_ok([4096 + offset, 8192], [256] if pc else [], N,
                    pc or h2r)
    assert vec == (offset == 0 and (N % VEC == 0 or not (pc or h2r)))
    plan = requant_plan(numel, vec, threads, per_thread)
    assert plan.vec == vec
    heads = (shape[1], shape[2]) if h2r else None
    visits = _kernel_map(numel, N, plan, pc, heads)
    elements = sorted(e for _, e, _, _ in visits)
    assert elements == list(range(numel))          # each read once
    offsets = sorted(o for _, _, _, o in visits)
    assert offsets == list(range(numel))           # each written once
    for _, e, c, o in visits:
        assert c == (e % N if pc else 0)           # its own channel
        assert o == (_h2r(e, N, *heads) if h2r else e)
    # a vector is 16 consecutive elements of one row: its tables are
    # one 16-byte aligned run of channels
    if vec:
        firsts = [v for v in visits if v[1] % VEC == 0
                  and v[1] < numel // VEC * VEC]
        for _, e, c, _ in firsts:
            assert not pc or (c % VEC == 0 and c + VEC <= N)
    # no thread is idle for want of work while another takes two
    # vectors, beyond what per_thread asks
    per = np.bincount([t for t, _, _, _ in visits],
                      minlength=plan.blocks * plan.threads)
    unit = VEC if vec else 1
    assert per.max() <= per_thread * unit + (1 if vec else 0)


@pytest.mark.parametrize("H,S", [(1, 5), (32, 1), (1, 1)])
def test_heads_to_rows_is_the_identity_on_a_singleton_axis(H, S):
    """Why `requant` launches without the address map where H or S is
    1 (the decode step's ctx_rqt has S 1)."""
    hd, B = 32, 3
    n = B * H * S * hd
    assert [_h2r(e, hd, H, S) for e in range(n)] == list(range(n))


def test_requant_plan_sizes_the_grid_to_the_work():
    for numel in (1, 15, 16, 17, 16 * 128, 16 * 128 + 1, 2 * 256 * 8192):
        for vec in (True, False):
            p = requant_plan(numel, vec, 128, 1)
            items = -(-numel // VEC) if vec else numel
            assert p.blocks == max(1, -(-items // 128))
            assert (p.blocks - 1) * 128 < items <= p.blocks * 128


@pytest.mark.parametrize("fn", ["requant_add", "requant_gate"])
def test_new_forms_raise_off_cpu_instead_of_falling_back(fn):
    """A meta-device tensor reaches no plain version: the wrapper
    raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "requant_add":
            requant_add(torch.empty((2, 16), dtype=torch.int8, **meta),
                        torch.empty((2, 16), dtype=torch.int32, **meta), {})
        else:
            requant_gate(torch.empty((2, 16), dtype=torch.int8, **meta),
                         torch.empty((2, 16), dtype=torch.int8, **meta),
                         torch.empty((256,), dtype=torch.int8, **meta),
                         torch.empty((), dtype=torch.int32, **meta), {})


def test_wrapper_refuses_mismatched_operands():
    a = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32 b"):
        requant_add(a, a, {})
    with pytest.raises(ValueError, match="differ"):
        requant_add(a, torch.zeros((2, 8), dtype=torch.int32), {})
    with pytest.raises(ValueError, match="LUT"):
        requant_gate(a, a, torch.zeros(255, dtype=torch.int8),
                     torch.tensor(0, dtype=torch.int32), {})
    with pytest.raises(ValueError, match="B, H, S, hd"):
        requant(torch.zeros((2, 16), dtype=torch.int32), {},
                heads_to_rows=True)
