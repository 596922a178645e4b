"""Device idle ms a step in the profiled steps while the host was in the
backward (`train.backward`, waiting on autograd's own thread)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('train.backward',), per_step=True)
