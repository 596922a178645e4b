"""Checks of the program's spans against the card's trace, and the cost of
recording them, at a sampling cell's own size in one process:

    python3 benchmark/tracing_check.py --workload l12.sample.b1024 \\
        --seed <n> [--pairs 4]

1. The clock: `time.time_ns()` read just before an operation against the
   profiler's host event of it and the kernel it launched.
2. One profiled call, as a traced run profiles one: the launch counters
   (`k1.launches`, `k2.launches`) grow by the trace's counts of K1's and
   K2's kernels; the k-th K2 kernel starts after the start of the k-th
   `ar.draw` span (the span that launched it); the idle time by span adds
   up to the window's idle time.
3. The cost of recording: calls with and without `recording()`, in turns
   (without, with, with, without), each ending in a synchronisation.

Prints one JSON line; exits 1 if a check fails, 3 without a card.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from hqbench import manifest, program, program_spans  # noqa: E402
from hqbench import weights as hqweights  # noqa: E402
from hqbench.trace import _events, profile  # noqa: E402


def clock_offsets(dev) -> dict:
    """How far the profiler's host event and kernel of one operation lie
    after a `time.time_ns()` read just before it (ns)."""
    from torch.profiler import ProfilerActivity
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t = time.time_ns()
        x.mul_(2.0)
        torch.cuda.synchronize(dev)
    host = [s for n, cuda, s, _ in _events(prof)
            if not cuda and n == 'aten::mul_']
    kernel = [s for n, cuda, s, _ in _events(prof) if cuda]
    return {'host_event_after_ns': host[0] - t if host else None,
            'kernel_after_ns': kernel[0] - t if kernel else None,
            'perf_counter_ns_gap': time.perf_counter_ns() - time.time_ns()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--pairs', type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 3
    from hqtransformer_tpu_torch.utils import tracing
    cell = manifest.cell(args.workload)
    driver = manifest.driver(cell.kind)
    dev = torch.device('cuda', 0)
    config, traffic = cell.config, cell.traffic
    levels = driver._levels(config)
    model = program.model(config, dev)
    weights = hqweights.make(hqweights.plan(model), args.seed, dev,
                             serving=True)
    n_classes = int(config['model']['stage2']['hparams']['n_classes'])
    gen = torch.Generator(device=dev).manual_seed(args.seed % 2 ** 63)
    B = int(traffic['batch'])
    labels = torch.randint(0, n_classes, (B,), generator=gen, device=dev)
    sampler = driver._sampler(model, levels, traffic)

    def one():
        sampler(weights, gen, labels)
        torch.cuda.synchronize(dev)
        return B

    line = {'workload': cell.name, 'seed': args.seed,
            'card': torch.cuda.get_device_name(dev),
            'torch': torch.__version__, 'clock': clock_offsets(dev)}
    one()                                   # warm
    before = {k: tracing.counter(k) for k in ('k1.launches', 'k2.launches')}
    tracing.clear()
    trace = profile(one, dev)
    grown = {k: tracing.counter(k) - v for k, v in before.items()}
    spans = program_spans.window_spans(trace)
    draws = sorted(s.start_ns for s in spans if s.name == 'ar.draw')
    k2 = sorted(s for _, s, _ in trace.kernels('sample_topk_kernel'))
    k1 = trace.kernels('decode_attention_kernel')
    lags = [k - d for d, k in zip(draws, k2)]
    idle = program_spans.idle_ms(trace, spans)
    idle_whole = (trace.window_s - trace.busy_s()) * 1e3
    checks = {
        'k1_counter_is_trace': grown['k1.launches'] == len(k1),
        'k2_counter_is_trace': grown['k2.launches'] == len(k2),
        'draws_are_kernels': len(draws) == len(k2),
        'kernels_start_after_their_draw': bool(lags) and min(lags) >= 0,
        'idle_parts_within_5pct': idle is not None and abs(
            sum(idle.values()) - idle_whole) <= 0.05 * idle_whole}
    line.update({
        'grown': grown, 'k1_kernels': len(k1), 'k2_kernels': len(k2),
        'draw_spans': len(draws), 'spans': len(spans),
        'draw_to_kernel_lag_us': None if not lags else
        [min(lags) / 1e3, statistics.median(lags) / 1e3, max(lags) / 1e3],
        'idle_ms_by_span': idle, 'idle_ms_window': idle_whole,
        'window_s': trace.window_s, 'busy_s': trace.busy_s()})

    times = {'off': [], 'on': []}
    for _ in range(args.pairs):
        for mode in ('off', 'on', 'on', 'off'):
            t0 = time.perf_counter()
            if mode == 'on':
                with tracing.recording():
                    one()
            else:
                one()
            times[mode].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in times.items()}
    line['cost'] = {'calls_s': times, 'median_s': med,
                    'on_over_off': med['on'] / med['off']}
    line['checks'] = checks
    print(json.dumps(line))
    return 0 if all(checks.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
