"""Host-clock ms an image of the frozen stage 1's encode inside the
training step: the span around `train/stage2.py::stage1_codes`
(synchronised at both ends; K3 runs inside it), over the traced run's
unprofiled window steps."""


def read(out):
    spans = out.spans.get('stage1_codes')
    if not spans or 'batch' not in out.info:
        return None
    return 1e3 * sum(spans) / (len(spans) * out.info['batch'])
