"""Integer primitives of the ID path (requant, isqrt, LUTs) and the
calibration state deployment reads."""
