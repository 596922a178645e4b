"""Host-clock ms a sample of the AR loop: the span around the call into
`make_hierarchical_sampler`'s / `make_multilevel_sampler`'s loop inside
the timed entry (synchronised at both ends), over the traced run's
unprofiled window calls."""


def read(out):
    spans = out.spans.get('ar_loop')
    if not spans or 'calls' not in out.info:
        return None
    units = sum(u for _, u, profiled in out.info['calls'] if not profiled)
    return 1e3 * sum(spans) / units
