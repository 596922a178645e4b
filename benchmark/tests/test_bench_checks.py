"""The comparison that decides `correct`: sound runs pass; each fault a
cell can have, planted under the harness, and the lower-precision
control fail. On the CPU at tiny sizes; the control at the cells' own
sizes on the card (marked `chip`)."""

import time

import pytest
import torch

import tiny
from hqbench import check, manifest
from hqbench.run_context import Run

FAULTS = [('sample', 'token'), ('sample', 'state'), ('sample', 'half_batch'),
          ('train', 'state'), ('train', 'half_batch'), ('train', 'token')]


@pytest.mark.parametrize('kind', ['sample', 'train'])
def test_sound_run_is_correct(kind):
    _, out = tiny.run(tiny.cell('tiny-l2', kind))
    assert out.correct, out.checks


def test_sound_top_p_run_is_correct():
    _, out = tiny.run(tiny.cell('tiny-l2', 'sample', top_p=0.8))
    assert out.correct, out.checks
    assert 'topp_excess' in out.checks


def test_sound_three_level_run_is_correct():
    _, out = tiny.run(tiny.cell('tiny-level3', 'sample'))
    assert out.correct, out.checks


@pytest.mark.parametrize('kind,fault', FAULTS)
def test_fault_is_not_correct(kind, fault):
    """The harness with the timed path broken underneath: a state left
    unchanged, half of the batch left out, a token altered where it is
    produced (one chip: no exchange between chips to leave out)."""
    _, out = tiny.run(tiny.cell('tiny-l2', kind), fault=fault)
    assert not out.correct, out.checks


@pytest.mark.parametrize('kind,traffic', [('sample', {}), ('train', {}),
                                          ('sample', {'top_p': 0.8})])
def test_control_is_not_correct(kind, traffic):
    """The reference with float8 operands in the program's place fails one
    of the cell's numbers: the harness's own verdict on the control's
    numbers is `correct` false."""
    _, out = tiny.run(tiny.cell('tiny-l2', kind, **traffic), control='fp8')
    assert set(out.checks) == set(out.info['control'])
    assert not out.correct, out.checks


@pytest.mark.chip
@pytest.mark.parametrize('cell', [w['name'] for w in manifest.load_json(
    manifest.MANIFEST)['workloads']])
def test_control_is_not_correct_on_the_card(cell):
    """Each cell at its own size on the card: the control fails one of its
    numbers with the committed limits, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    c = manifest.cell(cell)
    for seed in (101, 202, 303):
        r = Run(c, seed, 3.0, False, time.perf_counter(),
                torch.device('cuda', 0), control='fp8')
        out = manifest.driver(c.kind).run(r)
        assert check.verdict(out.checks), out.checks
        assert not check.judge(out, True), out.checks
