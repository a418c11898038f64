"""int8 gradient compression with error feedback (port of
`repro.optim.grad_compress`).

NEMO's own symmetric quantizer applied to gradients before the
data-parallel mean: each tensor travels as int8 images and one float32
scale, and the quantization residual is carried to the next step.  On
one device this is the compress -> decompress round trip the reference
runs inside its jitted step: the returned gradients are the int8
images' values, a drop-in tree for the optimiser.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_one(g: torch.Tensor, err: torch.Tensor):
    g_c = g.to(torch.float32) + err
    # the divisor on the device: torch's CUDA division by a host scalar
    # multiplies by its rounded reciprocal
    scale = torch.clamp(torch.amax(torch.abs(g_c)), min=1e-12) / torch.full(
        (), 127.0, device=g_c.device)
    q = torch.clamp(torch.round(g_c / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, q, scale, g_c - deq


def compress_decompress_grads(grads, err_state):
    """-> (dequantized grads, new error state)."""
    both = tree_map(lambda g, e: _quantize_one(g, e), grads, err_state)
    return (tree_map(lambda g, b: b[0], grads, both),
            tree_map(lambda g, b: b[3], grads, both))
