"""Autoregressive sampling loops."""
