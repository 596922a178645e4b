"""Device idle ms a sample in the profiled call while the host was in a
draw (`ar.draw`: the uniforms and K2's launch)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('ar.draw',))
