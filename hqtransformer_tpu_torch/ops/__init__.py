"""Kernels, their plain versions, and tensor utilities."""
