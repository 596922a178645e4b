"""`hqbench/program_spans.py` and the `idle_ms_per_*` readers on synthetic
device traces and spans: an idle gap is split among the spans open over it
by overlap, a gap under no span counts as `other`, the parts add up to the
window's idle time, and without a trace or spans nothing is read."""

import random

import pytest

from hqbench import manifest, program_spans
from hqbench.run_context import Outcome
from hqbench.trace import Trace
from hqtransformer_tpu_torch.utils.tracing import SpanRecord

SAMPLE = ['idle_ms_per_sample.' + n for n in
          ('entry', 'spatial', 'depth', 'draw', 'decode', 'other')]
STEP = ['idle_ms_per_step.' + n for n in
        ('stage1_codes', 'forward', 'backward', 'optimizer', 'other')]
MS = 1_000_000


def _span(name, start, end, id_, parent=None):
    return SpanRecord(name, start, end, id_, parent, 0)


def _trace(device, host_start=0, units=1):
    return Trace(device=[('k', s, e) for s, e in device],
                 host=[('aten::op', host_start, host_start + 1)],
                 units=units)


def test_a_gap_is_split_between_two_spans_by_overlap():
    trace = _trace([(0, 10 * MS), (30 * MS, 40 * MS)])
    spans = [_span('a', 5 * MS, 20 * MS, 1), _span('b', 20 * MS, 35 * MS, 2)]
    assert program_spans.idle_ms(trace, spans) == {'a': 10.0, 'b': 10.0}


def test_the_innermost_span_takes_the_gap_and_none_outside_spans():
    trace = _trace([(0, 10 * MS), (30 * MS, 40 * MS), (60 * MS, 61 * MS)])
    spans = [_span('outer', 0, 35 * MS, 1),
             _span('inner', 12 * MS, 16 * MS, 2, parent=1)]
    got = program_spans.idle_ms(trace, spans)
    # gap 10-30: inner 12-16, outer the rest; gap 40-60: under no span
    assert got == {'outer': 16.0, 'inner': 4.0, None: 20.0}


def test_the_parts_add_up_to_the_window_idle_time():
    rng = random.Random(5)
    device, t = [], 0
    for _ in range(400):
        t += rng.randrange(0, 3000)
        d = rng.randrange(1, 5000)
        device.append((t, t + d))
        t += rng.randrange(0, d + 1)     # some intervals overlap
    spans, t, i = [], 500, 0
    while t < device[-1][1]:
        root_end = t + rng.randrange(10_000, 200_000)
        root = _span('root', t, root_end, i)
        c = t
        while c < root_end:
            ce = min(root_end, c + rng.randrange(1, 20_000))
            spans.append(_span(f'child{i % 3}', c, ce, i + 1, i))
            c = ce + rng.randrange(0, 3000)
            i += 1
        spans.append(root)
        i += 2
        t = root_end + rng.randrange(0, 20_000)
    trace = _trace(device, host_start=200)
    got = program_spans.idle_ms(trace, spans)
    window = device[-1][1] - 200
    busy = trace.busy_s() * 1e9
    assert sum(got.values()) == pytest.approx((window - busy) / MS, rel=1e-9)
    assert None in got and 'root' in got and 'child1' in got


def _outcome(trace, batch=None):
    out = Outcome(trace=trace)
    if batch:
        out.info['batch'] = batch
    return out


def test_readers_return_none_without_a_trace_or_spans():
    readers = manifest.readers(SAMPLE + STEP)
    # no span recorded near the synthetic trace's instants
    trace = _trace([(0, 10), (20, 30)], units=4)
    for name, r in readers.items():
        assert r.read(_outcome(None, batch=2)) is None, name
        assert r.read(_outcome(trace, batch=2)) is None, name


@pytest.mark.parametrize('kind', ['sample', 'step'])
def test_readers_add_up_to_the_idle_time_per_unit(kind, monkeypatch):
    """Each layer span over one idle gap of 1 ms; a cell's readers sum to
    the idle ms over its units (4 samples; 4 images of batch 2: 2
    steps)."""
    names = {'sample': ['sample', 'ar.spatial', 'ar.depth', 'ar.draw',
                        'decode'],
             'step': ['train.step', 'train.stage1_codes', 'train.forward',
                      'train.backward', 'train.optimizer']}[kind]
    device = [(k * 2 * MS, (2 * k + 1) * MS) for k in range(7)]
    spans = [_span(n, (2 * k + 1) * MS, (2 * k + 2) * MS, k)
             for k, n in enumerate(names)]
    monkeypatch.setattr(program_spans.tracing, 'spans', lambda: spans)
    trace = _trace(device, units=4)
    readers = manifest.readers(SAMPLE if kind == 'sample' else STEP)
    got = {n: r.read(_outcome(trace, batch=2)) for n, r in readers.items()}
    units = 4 if kind == 'sample' else 2
    assert sum(got.values()) == pytest.approx(6 / units)
    other = got[f'idle_ms_per_{kind}.other']
    # one gap under no span; in training also the step's own self time
    assert other == pytest.approx((2 if kind == 'step' else 1) / units)
    assert all(v == pytest.approx(1 / units) for n, v in got.items()
               if not n.endswith('.other'))
