"""Data handling of the port: the datasets and their loader, Pillow-exact
transforms, a PNG decoder for hosts without Pillow, the tokenizers."""
