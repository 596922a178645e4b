"""Device idle ms a sample in the profiled call while the host was in the
stage-1 decode (`decode`)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('decode',))
