"""Evaluation of the port's models."""
