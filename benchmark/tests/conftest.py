"""The benchmark's CPU tests: the harness, its counts and its reference
at tiny sizes. Tests marked `chip` need a CUDA card and skip without one
(the check is made inside each test); run them on the card with

    python3 -m pytest benchmark/tests -m chip
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line('markers', 'chip: needs a CUDA card (skips '
                            'without one)')
