"""K1's (decode attention's) share of its roofline in the profiled call of
a caption-conditioned cell: the bound of every launch at its cache row and
batch (`counts.k1_bound_s`), over K1's device time. A call launches K1
once a layer at rows prefix .. prefix + positions - 2 (the caption's
rows are cached before the first spatial step), in that order; a trace
that holds another number of launches is not read."""

from hqbench import counts


def read(out):
    if out.trace is None or 'prefix' not in out.info:
        return None
    i = out.info
    events = out.trace.kernels('decode_attention_kernel')
    calls = sum(1 for _, _, profiled in i['calls'] if profiled)
    per_call = i['layers'] * (i['positions'] - 1)
    if not events or len(events) != calls * per_call:
        return None
    rows = range(i['prefix'], i['prefix'] + i['positions'] - 1)
    bound = calls * i['layers'] * sum(
        counts.k1_bound_s(pos, i['batch'], i['width']) for pos in rows)
    busy = sum(e - s for _, s, e in events) / 1e9
    return 100.0 * bound / busy
