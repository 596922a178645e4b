"""Run one cell of the benchmark of `hqtransformer_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (an entry of `BENCHMARK.json`'s `workloads`) names a
configuration and a traffic mix; the mix's `kind` names the driver that
runs it (`benchmark/drivers/<kind>.py`). With `--trace 0` the result
holds the cell's end-to-end metrics, with `--trace 1` its per-layer ones
(`benchmark/metrics/<metric>.py`), read from spans and a device trace of a
short part of the window.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then `checks`,
every number compared with the reference beside its limit (also the last
lines of standard error). Exits 3 without the cards, 4 if JAX or the JAX
package was loaded, with no result line either way.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the program under test sits at the checkout's root, beside benchmark/
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from hqbench import check, manifest  # noqa: E402
from hqbench.run_context import Outcome, Run, forbidden_modules  # noqa: E402
from reference import lowp  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', choices=sorted(lowp.PRECISIONS),
                    default=None, help='put the reference in this '
                    'precision in the program\'s place and judge it '
                    '(the output check\'s control; never in a measured run)')
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '-i', '0'], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'not read'


def result(r: Run, out: Outcome) -> dict:
    """The result line of a run."""
    cell = r.cell
    metrics = {}
    if r.trace:
        readers = manifest.readers([m['name'] for m in cell.per_layer])
        for m in cell.per_layer:
            value = readers[m['name']].read(out)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(out.rates, setup_s=out.setup_s)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    device = {'platform': 'gpu' if r.device.type == 'cuda' else
              r.device.type,
              'kind': (torch.cuda.get_device_name(r.device)
                       if r.device.type == 'cuda' else 'cpu'),
              'count': cell.chips,
              'memory_peak_bytes': out.memory_peak_bytes}
    line = {'correct': bool(out.correct), 'attempted': out.attempted,
            'failed': out.failed, 'metrics': metrics, 'device': device}
    if r.trace and out.trace is not None:
        device['busy_s'] = out.trace.busy_s()
        device['window_s'] = out.trace.window_s
        line['breakdown'] = {'device_ops': out.trace.device_ops(),
                             'idle_gaps': out.trace.idle_gaps()}
    if r.device.type == 'cuda':
        line['card'] = power_limit()
    line['checks'] = out.checks
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{cell.name} needs {cell.chips} CUDA card(s); this machine '
              f'has {found}', file=sys.stderr)
        return 3
    r = Run(cell, args.seed, args.seconds, bool(args.trace), T_START,
            torch.device('cuda', 0), control=args.control)
    out = manifest.driver(cell.kind).run(r)
    check.judge(out, bool(args.control))
    line = result(r, out)
    bad = forbidden_modules()
    if bad:
        print(f'JAX or the JAX package was loaded: {bad}', file=sys.stderr)
        return 4
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
