"""The port's integer primitives against the JAX reference, tolerance 0.

Inputs come from numpy seeds and go to both packages as numpy arrays:
`apply_rqt` (int8 and int32 out, scalar and per-channel tables),
the host-side requant scheduler, the exact bit length and `int_isqrt`,
the LUT builder and gather, and integer RoPE including rows parked at
INACTIVE_POS (whose table reads the reference fills with -32768).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import intmath as jim
from repro.core import requant as jrq
from repro.layers import rope as jrope
from repro.layers.attention import INACTIVE_POS as J_INACTIVE
from repro.layers.common import ActKind as JActKind, act_fn_np as j_act_np
from repro_torch.core import intmath as tim
from repro_torch.core import requant as trq
from repro_torch.layers import rope as trope
from repro_torch.layers.attention import INACTIVE_POS
from repro_torch.layers.common import ActKind, act_fn_np

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rand_int32(rng, shape):
    """Mixed magnitudes: small, mid, and full int32 range."""
    scale = rng.choice([1 << 7, 1 << 15, 1 << 24, 1 << 31], size=shape)
    x = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
    return (np.sign(x) * (np.abs(x) % scale)).astype(np.int32)


def test_inactive_pos_is_the_reference_value():
    assert INACTIVE_POS == J_INACTIVE


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("out", ["int8", "int32"])
def test_make_rqt_and_apply_rqt_match(per_channel, out):
    rng = np.random.default_rng(7 + per_channel + 2 * (out == "int32"))
    C = 24
    q = _rand_int32(rng, (40, C))
    kw = ({} if out == "int8"
          else dict(qmin=-(1 << 24), qmax=1 << 24))
    scheduled = 0
    for trial in range(16):
        eps_in = (rng.uniform(1e-6, 1e-3, size=C) if per_channel
                  else float(rng.uniform(1e-6, 1e-3)))
        eps_out = float(rng.uniform(1e-3, 0.2))
        acc = float(rng.choice([2.0 ** 16, 2.0 ** 24, 2.0 ** 30]))
        try:
            jt = jrq.make_rqt(eps_in, eps_out, acc_bound=acc, **kw)
        except ValueError:  # unschedulable: the port must refuse too
            with pytest.raises(ValueError, match="unschedulable"):
                trq.make_rqt(eps_in, eps_out, acc_bound=acc, **kw)
            continue
        tt = trq.make_rqt(eps_in, eps_out, acc_bound=acc, **kw)
        assert jt.keys() == tt.keys()
        for k in jt:
            assert jt[k].dtype == tt[k].dtype and np.array_equal(jt[k], tt[k])
        jd = jnp.int8 if out == "int8" else jnp.int32
        td = torch.int8 if out == "int8" else torch.int32
        want = np.asarray(jrq.apply_rqt(jnp.asarray(q), jt, out_dtype=jd,
                                        **kw))
        got = trq.apply_rqt(torch.from_numpy(q), _t(tt), out_dtype=td,
                            **kw).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        scheduled += 1
    assert scheduled >= 8


def test_apply_rqt_wraps_like_the_reference():
    """Adversarial tables: huge multipliers and shifts past 31 make the
    int32 products wrap and the shifts saturate; the port must wrap
    and sign-fill exactly as XLA does."""
    rng = np.random.default_rng(11)
    C = 16
    q = _rand_int32(rng, (64, C))
    for _ in range(20):
        tree = {
            "m": rng.integers(1, 1 << 31, size=C, dtype=np.int64).astype(
                np.int32),
            "s0": rng.integers(0, 32, size=C).astype(np.int32),
            "lo": np.full(C, I32_MIN, np.int32),
            "hi": np.full(C, I32_MAX, np.int32),
            "d": np.asarray(rng.integers(0, 48), np.int32),
            "zp": np.asarray(rng.integers(-100, 100), np.int32),
        }
        want = np.asarray(jrq.apply_rqt(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in tree.items()},
            qmin=I32_MIN, qmax=I32_MAX, out_dtype=jnp.int32))
        got = trq.apply_rqt(torch.from_numpy(q), _t(tree), qmin=I32_MIN,
                            qmax=I32_MAX, out_dtype=torch.int32).numpy()
        np.testing.assert_array_equal(got, want)


def test_requant_params_make_matches_including_negative_d():
    rng = np.random.default_rng(3)
    for _ in range(30):
        eps_in = float(rng.uniform(1e-4, 1.0))
        eps_out = float(rng.uniform(1e-4, 1.0))
        a = jrq.RequantParams.make(eps_in, eps_out)
        b = trq.RequantParams.make(eps_in, eps_out)
        assert a.d == b.d and a.zp_out == b.zp_out
        for f in ("m", "s0", "pre_lo", "pre_hi"):
            assert np.array_equal(getattr(a, f), getattr(b, f))


def _bit_length_ref(n):
    from jax import lax

    n = jnp.asarray(n, jnp.int32)
    return np.asarray(32 - lax.clz(n))


def test_bit_length_exact():
    powers = np.array([1 << k for k in range(31)], np.int64)
    edges = np.concatenate([powers - 1, powers, powers + 1, [I32_MAX]])
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        edges, rng.integers(0, 1 << 31, size=20000, dtype=np.int64),
        np.arange(0, 5000)]).clip(0, I32_MAX).astype(np.int32)
    got = tim.bit_length(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, _bit_length_ref(vals))


def test_integer_bit_length_equals_the_frexp_one():
    """The integer shift-and-compare bit length against the float64
    `frexp` exponent it replaced, on every power of two and its
    neighbours and on random values over the norms' int32 range (sums
    of squares up to d 18432 x 127^2, and the whole non-negative
    int32 range)."""
    powers = torch.tensor([1 << k for k in range(31)], dtype=torch.int64)
    g = torch.Generator().manual_seed(29)
    vals = torch.cat([powers - 1, powers, powers + 1,
                      torch.tensor([0, I32_MAX]),
                      torch.randint(0, 18432 * 127 * 127, (50000,),
                                    generator=g),
                      torch.randint(0, 1 << 31, (50000,), generator=g)])
    vals = vals.clamp(0, I32_MAX).to(torch.int32)
    want = torch.frexp(vals.to(torch.float64)).exponent.to(torch.int32)
    got = tim.bit_length(vals)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_int_isqrt_matches_reference():
    rng = np.random.default_rng(9)
    squares = np.arange(0, 46341, dtype=np.int64) ** 2
    vals = np.concatenate([
        np.arange(0, 1 << 16),
        squares[::7], squares[::7] - 1, squares[::7] + 1,
        rng.integers(0, 1 << 31, size=50000, dtype=np.int64),
        [I32_MAX, -1, -(1 << 20)],
    ]).clip(I32_MIN, I32_MAX).astype(np.int32)
    want = np.asarray(jim.int_isqrt(jnp.asarray(vals)))
    got = tim.int_isqrt(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_build_and_apply_lut_match(kind):
    jk, tk = JActKind(kind), ActKind(kind)
    args = (0.0625, 0, 0.035, -100)
    jl = jim.build_lut(lambda v: j_act_np(jk, v), *args)
    tl = tim.build_lut(lambda v: act_fn_np(tk, v), *args)
    assert jl.dtype == tl.dtype and np.array_equal(jl, tl)
    s = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    want = np.asarray(jim.apply_lut(jnp.asarray(s), jl))
    got = tim.apply_lut(torch.from_numpy(s), torch.from_numpy(tl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hd,fraction", [(32, 1.0), (64, 1.0), (64, 0.5)])
def test_rope_int_matches_including_parked_rows(hd, fraction):
    max_pos = 96
    rot_j, cos_j, sin_j = jrope.rope_tables_int(hd, max_pos, 10000.0,
                                                fraction)
    rot_t, cos_t, sin_t = trope.rope_tables_int(hd, max_pos, 10000.0,
                                                fraction, device="cpu")
    assert rot_j == rot_t
    np.testing.assert_array_equal(np.asarray(cos_j), cos_t.numpy())
    np.testing.assert_array_equal(np.asarray(sin_j), sin_t.numpy())
    rng = np.random.default_rng(hd)
    B, H, S = 5, 3, 7
    x = rng.integers(-128, 128, size=(B, H, S, hd)).astype(np.int8)
    start = np.array([0, 40, max_pos - 3, INACTIVE_POS, 89], np.int64)
    positions = start[:, None] + np.arange(S)  # rows past the table too
    want = np.asarray(jrope.apply_rope_int(
        jnp.asarray(x), cos_j, sin_j, jnp.asarray(positions, jnp.int32),
        rot_j))
    got = trope.apply_rope_int(torch.from_numpy(x), cos_t, sin_t,
                               torch.from_numpy(positions), rot_t).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
