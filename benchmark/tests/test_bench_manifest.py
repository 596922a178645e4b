"""`BENCHMARK.json` against the benchmark's contract: keys, names, units,
the files each entry names, and the check's time budget."""

import json
import re
from pathlib import Path

from hqbench import manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')
WIDTHS = re.compile(r'.*(_dim|_rank|hidden|intermediate|latent|state|'
                    r'proj|head|expansion|experts_per_tok).*')


def _line(s):
    return 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_keys_and_limits():
    assert set(MAN) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(MAN['paths']) <= 16 and 1 <= len(MAN['command']) <= 32
    assert all(_line(w) for w in MAN['command'])
    assert isinstance(MAN['run_seconds'], int)
    assert 1 <= MAN['run_seconds'] <= 51
    cells = 24
    total = (2 + 14 * cells) * (MAN['run_seconds'] + 60) + \
        cells * 2 * 90 + 1200
    assert total <= 43200
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.fullmatch(n), n
    metric_keys = {'name', 'unit', 'better', 'source'}
    for m in MAN['end_to_end']:
        assert set(m) - {'workloads'} == metric_keys | {'bound'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert 'setup_s' in {m['name'] for m in MAN['end_to_end']}
    for m in MAN['per_layer']:
        assert set(m) - {'workloads'} == metric_keys | {'layer', 'moves'}
        assert _line(m['layer'])
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    for m in MAN['end_to_end'] + MAN['per_layer']:
        assert UNIT.fullmatch(m['unit']), m
        assert m['better'] in ('lower', 'higher')
        if 'roofline' in m['name']:   # a kernel's share: <kernel>_roofline
            assert m['name'].endswith('_roofline') and m['unit'] == '%'


def test_files_named_by_the_manifest():
    bench = ROOT / 'benchmark'
    configs = {c['name']: c for c in MAN['configs']}
    files = [c['file'] for c in MAN['configs']]
    assert len(files) == len(set(files))
    for c in MAN['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/') and _line(c['source'])
        assert _line(c['why'])
        data = json.loads((ROOT / c['file']).read_text())
        assert data['name'] == c['name'] and data['reduced'] == c['reduced']
        assert not any(WIDTHS.fullmatch(k) for k in c['reduced'])
    used = set()
    pairs = set()
    for w in MAN['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in configs and w['chips'] in (1, 4)
        assert _line(w['why']) and NAME.fullmatch(w['traffic'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        used.add(w['config'])
        traffic = json.loads((bench / 'traffic' /
                              f'{w["traffic"]}.json').read_text())
        assert (bench / 'drivers' / f'{traffic["kind"]}.py').exists()
        limits = json.loads((bench / 'workloads' /
                             f'{w["name"]}.json').read_text())['limits']
        driver = manifest.driver(traffic['kind'])
        assert set(limits) == set(driver.numbers(traffic))
    assert used == set(configs)
    cells = {w['name'] for w in MAN['workloads']}
    e2e = {m['name']: m for m in MAN['end_to_end']}
    for m in MAN['per_layer']:
        assert (bench / 'metrics' / f'{m["name"]}.py').exists(), m['name']
        assert m['moves'] in e2e
        for c in m.get('workloads', []):
            assert c in cells
            assert c in e2e[m['moves']].get('workloads', cells)
    for c in cells:   # every cell reports setup_s, another e2e, a layer
        reported = [n for n, m in e2e.items()
                    if c in m.get('workloads', cells)]
        assert 'setup_s' in reported and len(reported) >= 2
        assert any(c in m.get('workloads', cells) for m in MAN['per_layer'])
