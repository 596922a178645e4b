"""Device idle ms a sample in the profiled call while the host was in no
program span: the caller, between and after sampler calls."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, (None,))
