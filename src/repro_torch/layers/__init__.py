"""Quantized layers: host-side numpy `deploy` plus torch `apply_id`."""
