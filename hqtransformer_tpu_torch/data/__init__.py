"""Data handling of the port: the caption tokenizers."""
