"""Device idle ms a sample in the profiled call while the host was in the
sampler's entry (`sample`: the weights' load, the serving set-up, the
caches, the prefill, the stacking) outside its layer spans."""

from hqbench import program_spans


def read(out):
    return program_spans.per_unit(out, ('sample',))
