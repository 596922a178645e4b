"""Device idle ms a step in the profiled steps while the host was in the
frozen stage 1's encode (`train.stage1_codes`, K3 inside)."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('train.stage1_codes',), per_step=True)
