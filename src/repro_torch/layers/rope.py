"""Rotary position embeddings (port of `repro.layers.rope`: the float
`rope_tables_fp` / `apply_rope_fp` of the FullPrecision forward, and
the integer `rope_tables_int` / `apply_rope_int`).

cos/sin become int16 images with quantum 2^-TRIG_BITS; the rotation
is int8 x int16 -> int32 and an exact power-of-two requant with
round-to-nearest (+2^13 >> 14).

Out-of-range positions: serving rows parked at INACTIVE_POS = 1 << 30
index far past the table.  The reference's `jnp.take` fills such reads
(-32768 for the int16 tables); torch indexing would raise on the CPU
and hit a device assert on CUDA.  `gather_trig` reproduces the fill,
so whole tensors (parked rows included) equal the reference's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

TRIG_BITS = 14
_INT16_FILL = -32768  # jnp.take's out-of-bounds fill for int16


@functools.lru_cache(maxsize=32)
def _angles(head_dim: int, max_pos: int, base: float, fraction: float):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (base ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    pos = np.arange(max_pos, dtype=np.float64)
    ang = np.outer(pos, inv)
    return rot, np.cos(ang), np.sin(ang)


def rope_tables_fp(head_dim: int, max_pos: int, base: float = 10000.0,
                   fraction: float = 1.0, device="cuda"):
    """-> (rot, cos, sin): float32 (max_pos, rot/2) tables on device,
    rounded once from the float64 angles."""
    rot, cos, sin = _angles(head_dim, max_pos, base, fraction)

    def enc(v):
        return torch.from_numpy(v.astype(np.float32)).to(device)

    return rot, enc(cos), enc(sin)


def apply_rope_fp(x, cos, sin, positions, rot: int):
    """x (..., S, head_dim) float, positions (S,) int, or (B, S) per
    row of x (B, H, S, head_dim) -> x rotated (the leading `rot`
    channels, in (even, odd) pairs; the rest pass)."""
    c = cos[positions].to(x.dtype)
    s = sin[positions].to(x.dtype)
    if positions.dim() == 2:
        c, s = c[:, None], s[:, None]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    y = torch.stack([y1, y2], dim=-1).reshape(*y1.shape[:-1], -1)
    return torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y


def rope_tables_int(head_dim: int, max_pos: int, base: float = 10000.0,
                    fraction: float = 1.0, device="cuda"):
    """-> (rot, cos_q, sin_q): int16 (max_pos, rot/2) tables on device."""
    rot, cos, sin = _angles(head_dim, max_pos, base, fraction)
    scale = float(1 << TRIG_BITS)

    def enc(v):
        a = np.clip(np.round(v * scale), -scale, scale - 1).astype(np.int16)
        return torch.from_numpy(a).to(device)

    return rot, enc(cos), enc(sin)


def gather_trig(cos_q, sin_q, positions):
    """positions (B, S) -> int32 trig (B, 1, S, rot/2), out-of-range
    positions filled with -32768 like the reference's jnp.take."""
    n = cos_q.shape[0]
    pos = positions.to(torch.int64)
    ok = (pos >= 0) & (pos < n)
    idx = torch.where(ok, pos, torch.zeros_like(pos))
    bad = ~ok[..., None]
    c = cos_q[idx].to(torch.int32).masked_fill_(bad, _INT16_FILL)
    s = sin_q[idx].to(torch.int32).masked_fill_(bad, _INT16_FILL)
    return c[:, None], s[:, None]


def apply_rope_int(s_x, cos_q, sin_q, positions, rot: int):
    """s_x (B, H, S, hd) int8 (zp=0), positions (B, S) -> int8, same
    quantum."""
    c, s = gather_trig(cos_q, sin_q, positions)
    return rotate_int(s_x, c, s, rot)


def rotate_int(s_x, c, s, rot: int):
    """The rotation itself, on trig already gathered by `gather_trig`
    (so q and k of one layer share one gather).  |x1*c + x2*s| <=
    2*128*2^15 < 2^31 even for filled rows."""
    x = s_x.to(torch.int32)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    half = 1 << (TRIG_BITS - 1)
    y1 = torch.bitwise_right_shift(x1 * c - x2 * s + half, TRIG_BITS)
    y2 = torch.bitwise_right_shift(x1 * s + x2 * c + half, TRIG_BITS)
    y1 = y1.clamp(-128, 127)
    y2 = y2.clamp(-128, 127)
    y = torch.stack([y1, y2], dim=-1).reshape(*y1.shape[:-1], -1)
    if x_pass.shape[-1]:
        y = torch.cat([y, x_pass], dim=-1)
    return y.to(torch.int8)
