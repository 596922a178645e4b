"""Device idle ms a sample in the profiled call while the host was in the
AR loop's prefill (`ar.prefill`: the conditioning prefix's embedding, the
caches and the prefill); nothing where the program records no such span."""

from hqbench import program_spans


def read(out):
    if out.trace is None or not any(
            s.name == 'ar.prefill'
            for s in program_spans.window_spans(out.trace)):
        return None
    return program_spans.per_unit(out, ('ar.prefill',))
