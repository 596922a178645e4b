"""Device idle ms a sample in the profiled call while the host was in the
AR loop's spatial steps (`ar.spatial`: the cell embedding and the
KV-cached spatial step, K1 inside)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('ar.spatial',))
