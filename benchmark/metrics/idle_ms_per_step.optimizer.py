"""Device idle ms a step in the profiled steps while the host was in the
optimizer's update (`train.optimizer`: clip, AdamW)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('train.optimizer',), per_step=True)
