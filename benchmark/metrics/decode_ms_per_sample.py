"""Host-clock ms a sample of the stage-1 decode: the spans around
`stage1.decode_code` (one a decode chunk, synchronised at both ends),
over the traced run's unprofiled window calls."""


def read(out):
    spans = out.spans.get('decode')
    if not spans or 'calls' not in out.info:
        return None
    units = sum(u for _, u, profiled in out.info['calls'] if not profiled)
    return 1e3 * sum(spans) / units
