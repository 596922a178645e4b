"""Device idle ms a sample in the profiled call while the host was in the
AR loop's depth chains (`ar.depth`) outside their draws."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('ar.depth',))
