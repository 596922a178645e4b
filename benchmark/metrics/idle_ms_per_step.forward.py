"""Device idle ms a step in the profiled steps while the host was in the
stage-2 forward and the loss (`train.forward`)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('train.forward',), per_step=True)
