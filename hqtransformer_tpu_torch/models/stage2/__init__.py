"""Stage-2 autoregressive models."""
