"""Measurement tools for the port's kernels, run as scripts."""
