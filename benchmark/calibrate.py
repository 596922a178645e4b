"""The readings that the limits of a cell's comparison are set from, on
the card, at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--seconds 3] [--control fp8] [--faults token,half_batch]

For every seed it runs the cell's driver with a short window and prints
one JSON line: the program's numbers and, with `--control`, the control's
(the reference with lower-precision operands in the program's place, on
the same codes or steps) and `correct`, the harness's verdict on the
control's numbers then. With `--faults` it also runs the program with
each planted fault (the drivers' `_install_fault`) on every seed. The
benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from hqbench import check, manifest  # noqa: E402
from hqbench.run_context import Run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--control', default=None)
    ap.add_argument('--faults', default='')
    ap.add_argument('--out', default=None, help='also append lines here')
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 3
    driver = manifest.driver(cell.kind)
    faults = [f for f in args.faults.split(',') if f]
    for seed in (int(s) for s in args.seeds.split(',')):
        for fault in [None] + faults:
            r = Run(cell, seed, args.seconds, False, time.perf_counter(),
                    torch.device('cuda', 0), fault=fault,
                    control=None if fault else args.control)
            out = driver.run(r)
            check.judge(out, bool(r.control))
            program = out.info['program'] if r.control else out.checks
            line = {'workload': cell.name, 'seed': seed, 'fault': fault,
                    'correct': out.correct,
                    'program': {k: v['value'] for k, v in program.items()},
                    'control': {k: v['value'] for k, v in
                                out.info.get('control', {}).items()},
                    'rate': out.rates, 'setup_s': out.setup_s,
                    'attempted': out.attempted}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, 'a') as f:
                    f.write(json.dumps(line) + '\n')
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
