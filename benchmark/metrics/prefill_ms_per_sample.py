"""Host-clock ms a sample of the conditioning prefix's prefill: the span
around `stage2.spatial_prefill` (one a call, synchronised at both ends;
the caption's 64 rows through every spatial block in the text cell), over
the traced run's unprofiled window calls."""


def read(out):
    spans = out.spans.get('prefill')
    if not spans or 'calls' not in out.info:
        return None
    units = sum(u for _, u, profiled in out.info['calls'] if not profiled)
    return 1e3 * sum(spans) / units
