"""Data pipelines of the port (the calibration sample's source)."""
