"""K2's (top-k sampling's) share of its roofline in the profiled call:
the bound of every draw over its rows (`counts.k2_bytes`, `k2_ops`; a
position draws batch x each entry of `draw_rows` rows), over K2's device
time. A trace that holds another number of launches is not read."""

from hqbench import counts


def read(out):
    if out.trace is None or 'draw_rows' not in out.info:
        return None
    i = out.info
    events = out.trace.kernels('sample_topk_kernel')
    calls = sum(1 for _, _, profiled in i['calls'] if profiled)
    per_call = i['positions'] * len(i['draw_rows'])
    if not events or len(events) != calls * per_call:
        return None
    bound = calls * i['positions'] * sum(
        counts.k2_bound_s(n * i['batch'], i['vocab'])
        for n in i['draw_rows'])
    busy = sum(e - s for _, s, e in events) / 1e9
    return 100.0 * bound / busy
