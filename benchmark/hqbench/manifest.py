"""`BENCHMARK.json` and the files it names, found by name:

- a configuration `<config>` is `benchmark/configs/<config>.json`: its
  `model` (the stage-1 / stage-2 configuration as it runs, the schema of
  the repo's YAML files), `precision`, `source`, `reduced`, `assumed`;
- a traffic mix `<traffic>` is `benchmark/traffic/<traffic>.json`: its
  `kind` (the driver, `benchmark/drivers/<kind>.py`) and the mix's
  parameters;
- a cell `<workload>` has `benchmark/workloads/<workload>.json`: the
  limits of its comparison with the reference and how many rows it
  compares;
- a per-layer metric `<metric>` is read by `benchmark/metrics/<metric>.py`,
  whose `read(ctx)` returns its value or None.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / 'BENCHMARK.json'


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of the manifest with the files it names."""
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix file
    workload: dict        # the workload file
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic['kind']


def _reported(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if 'workloads' in metric:
        return cell in metric['workloads']
    return metric.get('moves') in e2e_names if 'moves' in metric else True


def cell(name: str, manifest: Optional[dict] = None,
         bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the manifest (default: `BENCHMARK.json`), with
    the end-to-end and per-layer metrics it reports. Raises KeyError for a
    name the manifest lacks."""
    manifest = manifest or load_json(MANIFEST)
    entries = {w['name']: w for w in manifest['workloads']}
    if name not in entries:
        raise KeyError(f'no workload {name!r} in the manifest; it has '
                       f'{sorted(entries)}')
    w = entries[name]
    configs = {c['name']: c for c in manifest['configs']}
    config = load_json(bench_dir.parent / configs[w['config']]['file'])
    e2e = [m for m in manifest['end_to_end'] if _reported(m, name, [])]
    e2e_names = [m['name'] for m in e2e]
    per_layer = [m for m in manifest['per_layer']
                 if _reported(m, name, e2e_names)]
    return Cell(name, int(w['chips']), config,
                load_json(bench_dir / 'traffic' / f'{w["traffic"]}.json'),
                load_json(bench_dir / 'workloads' / f'{name}.json'),
                e2e, per_layer)


def driver(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / 'drivers' / f'{kind}.py',
                       f'hqbench_driver_{kind}')


def readers(names: List[str], bench_dir: Path = BENCH_DIR
            ) -> Dict[str, ModuleType]:
    return {n: load_module(bench_dir / 'metrics' / f'{n}.py',
                           'hqbench_metric_' + n.replace('.', '_'))
            for n in names}
