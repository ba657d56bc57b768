"""Synthetic data and camera raw file writers for tests and chip runs (port
of ``siriltpu.testing``)."""
