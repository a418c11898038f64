"""Integer primitives of the ID path (requant, isqrt, LUTs) and the
calibrator whose ranges deployment reads."""
