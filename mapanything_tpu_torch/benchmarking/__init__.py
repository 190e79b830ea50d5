"""Accuracy benchmarks of the port: dense N-view, single-view calibration, RobustMVD depth."""
