"""Checkpoints in the reference's on-disk layout (`checkpoint.manager`)."""
