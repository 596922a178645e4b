"""Device idle ms a step in the profiled steps while the host was in the
train step outside its layer spans (`train.step`: the dp all-reduce where
there is one, the step's own bookkeeping) or in no span (the caller)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('train.step', None), per_step=True)
