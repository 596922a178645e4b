"""Host-clock ms a step of the optimizer: the span around
`Optimizer.update` (clip, AdamW; synchronised at both ends), over the
traced run's unprofiled window steps."""


def read(out):
    spans = out.spans.get('optimizer')
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
