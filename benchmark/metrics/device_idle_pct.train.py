"""The share of the profiled steps' host-clock window in which no device
operation ran (the union of the device intervals)."""

from pathlib import Path

from hqbench.manifest import load_module

read = load_module(Path(__file__).with_name('device_idle_pct.sample.py'),
                   'hqbench_metric_device_idle_pct_sample').read
