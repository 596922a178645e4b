"""K3's (the nearest-code search's) share of its roofline in the profiled
steps: one 2 N K D pass at the bf16 peak, or its bytes, for each of a
step's searches (`counts.k3_bound_s`), over the device time of K3's
kernels (`vq_prepare`, `vq_argmin`, `vq_reduce`). A trace that holds no
K3 kernel is not read."""

from hqbench import counts

K3_KERNELS = ('vq_prepare', 'vq_argmin', 'vq_reduce')


def read(out):
    if out.trace is None or 'k3_calls' not in out.info:
        return None
    events = [e for e in out.trace.device
              if any(k in e[0] for k in K3_KERNELS)]
    if not events:
        return None
    steps = out.trace.units // out.info['batch']
    bound = steps * sum(counts.k3_bound_s(*c) for c in out.info['k3_calls'])
    busy = sum(e - s for _, s, e in events) / 1e9
    return 100.0 * bound / busy
