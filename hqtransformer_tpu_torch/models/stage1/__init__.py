"""Stage-1 HQ-VAE (decode side)."""
