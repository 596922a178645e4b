"""Stage-1 and stage-2 models."""
