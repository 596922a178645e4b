"""The port's text-to-image path against the benchmark's plain text
reference (`benchmark/reference/stage2_txt.py`), on the CPU in float32, at
the tiny 2-level text config of `test_torch_conditioning.py` (d 64, 64
codes, 32 text ids, an 8-token caption; `benchmark/tests/data/
tiny-txt.json`) with seeded random weights: the teacher-forced forward and
the scorer (prefill, then the cached steps) give the reference's logits,
and a caption served to the wrong rows or a dropped `pos_emb_txt` does
not; a sampler call records `ar.prefill` once and counts its rows; the
`k1_txt_roofline` and `idle_ms_per_sample.prefill` readers on synthetic
traces; the `txt2img` driver at a tiny size judges a sound run correct and
every planted fault and the control not.
"""

import copy
import json
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

BENCH = Path(__file__).resolve().parents[1] / 'benchmark'
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from hqbench import check, counts, manifest, program  # noqa: E402
from hqbench import program_spans  # noqa: E402
from hqbench import weights as hqweights  # noqa: E402
from hqbench.run_context import Outcome, Run  # noqa: E402
from hqbench.trace import Trace  # noqa: E402
from reference import stage2 as ref2, stage2_txt as ref_txt  # noqa: E402

from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    SamplingParams, make_hierarchical_scorer)
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

DATA = BENCH / 'tests' / 'data'
CPU = torch.device('cpu')
B, N, R, V, N_TXT = 4, 16, 4, 64, 8
CANDIDATES = 2            # rows of one caption in the tiny batches
# both sides in float32, the same products summed in another order: a few
# float32 steps at the logits' scale (about 1), as `benchmark/tests/
# test_bench_reference.py` holds the class-conditional forward
TOL = dict(atol=2e-5, rtol=0)
# a fault moves the logits by a hundredth or more, five hundred times TOL
FAULT_GAP = 1e-2
TRAFFIC = {'kind': 'txt2img', 'batch': B, 'captions': B // CANDIDATES,
           'candidates': CANDIDATES, 'caption_len': [2, 6], 'top_k': 8,
           'temperature': 0.9, 'decode_chunk': 2, 'caption_batches': 3}
LIMITS = {'check_rows': 4, 'limits': {'topk_gap': 1e-4,
                                      'pixel_rel_rms': 1e-4,
                                      'codes_out_of_range': 0}}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name='tiny-txt'):
    cfg = json.loads((DATA / f'{name}.json').read_text())
    cfg['precision'] = 'float32'
    return cfg


def _model(name='tiny-txt'):
    cfg = _config(name)
    model = program.model(cfg, CPU)
    w = hqweights.make(hqweights.plan(model), 3, CPU, serving=False)
    model.load_weights(w)
    return cfg['model']['stage2'], model, w


@pytest.fixture(scope='module')
def tiny():
    """(stage-2 config, model, weights, caption ids [B, 8] in groups of
    CANDIDATES rows, top codes [B, N], bottoms [B, N, R] by cell)."""
    s2, model, w = _model()
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 32, (B // CANDIDATES, N_TXT), generator=g)
    ids[0, 5:] = 0            # a padded caption
    ids = ids.repeat_interleave(CANDIDATES, dim=0)
    top = torch.randint(0, V, (B, N), generator=g)
    bots = torch.randint(0, V, (B, N, R), generator=g)
    return s2, model, w, ids, top, bots


def _port_logits(path, model, ids, top, bots):
    """The port's top logits [B, N, V] and bottom logits [B, N, R, V] by
    the teacher-forced forward or the serving scorer."""
    with torch.no_grad():
        if path == 'scorer':
            return make_hierarchical_scorer(model.stage2, N)(ids, top, bots)
        raster = ref2.cells_to_raster(bots, 4, 2).reshape(B, -1)
        lt, lb, ltxt = model.stage2(top, raster, ids)
    assert ltxt.shape == (B, N_TXT - 1, 32)
    lb = lb.reshape(B, 4, 2, 4, 2, V).permute(0, 1, 3, 2, 4, 5)
    return lt, lb.reshape(B, N, R, V)


def _reference(w, s2, ids, top, bots):
    with torch.no_grad():
        return ref_txt.forward_2level(w['stage2'], s2, ids, top, bots)


@pytest.mark.parametrize('path', ['forward', 'scorer'])
def test_port_logits_match_the_text_reference(tiny, path):
    """Top and bottom logits of the teacher-forced forward, and of the
    scorer (the caption's prefill, then one cached spatial step a cell),
    equal the reference's full forward within TOL."""
    s2, model, w, ids, top, bots = tiny
    lt, lb = _port_logits(path, model, ids, top, bots)
    rt, rb = _reference(w, s2, ids, top, bots)
    assert rt.shape == (B, N, V) and rb.shape == (B, N, R, V)
    torch.testing.assert_close(lt, rt, **TOL)
    torch.testing.assert_close(lb, rb, **TOL)


@pytest.mark.parametrize('path', ['forward', 'scorer'])
@pytest.mark.parametrize('fault', ['caption', 'no_pos_emb_txt'])
def test_faults_fail_the_comparison(tiny, path, fault):
    """Each row served under the next caption group's ids (`txt2img.py`'s
    `caption` fault), or the port's caption without its positions: the
    logits leave the reference's by more than FAULT_GAP."""
    s2, model, w, ids, top, bots = tiny
    pos = model.stage2.pos_emb_txt.weight
    saved = pos.detach().clone()
    try:
        if fault == 'caption':
            served = ids.roll(CANDIDATES, 0)
            assert not torch.equal(served, ids)
        else:
            served = ids
            with torch.no_grad():
                pos.zero_()
        lt, lb = _port_logits(path, model, served, top, bots)
    finally:
        with torch.no_grad():
            pos.copy_(saved)
    rt, rb = _reference(w, s2, ids, top, bots)
    assert float((lt - rt).abs().max()) > FAULT_GAP
    assert float((lb - rb).abs().max()) > FAULT_GAP


@pytest.mark.parametrize('name,prefix', [('tiny-txt', N_TXT), ('tiny-l2', 1)])
def test_sampler_call_records_one_prefill(name, prefix):
    """One `make_pixel_sampler` call: one `ar.prefill` span, a child of
    `sample`, and B x the prefix's rows (the caption's ctx_len_txt, or the
    class token) added to `ar.prefill_rows`."""
    _, model, w = _model(name)
    labels = (torch.randint(1, 32, (B, N_TXT)) if prefix > 1 else
              torch.randint(0, 10, (B,)))
    fn = model.make_pixel_sampler(params=SamplingParams(top_k_top=8,
                                                        top_k_bot=8))
    rows = tracing.counter('ar.prefill_rows')
    tracing.clear()
    with tracing.recording():
        fn(w, torch.Generator().manual_seed(1), labels)
    spans = tracing.spans()
    assert tracing.counter('ar.prefill_rows') - rows == B * prefix
    (pre,) = [s for s in spans if s.name == 'ar.prefill']
    by_id = {s.id: s for s in spans}
    assert by_id[pre.parent].name == 'sample'
    first_step = min(s.start_ns for s in spans if s.name == 'ar.spatial')
    assert pre.end_ns <= first_step


def _k1_outcome(launches, layers=12, positions=64, prefix=64, calls=1):
    ns = 100_000              # 0.1 ms a launch
    device = [('decode_attention_kernel', 2 * k * ns, (2 * k + 1) * ns)
              for k in range(launches)]
    out = Outcome(trace=Trace(device=device, units=512 * calls))
    out.info.update(batch=512, width=1536, layers=layers,
                    positions=positions, prefix=prefix,
                    calls=[(1.0, 512, True)] * calls)
    return out


K1_TXT = manifest.readers(['k1_txt_roofline'])['k1_txt_roofline']


@pytest.mark.parametrize('calls', [1, 2])
def test_k1_txt_roofline_bounds_rows_prefix_on(calls):
    """The bound of a call's 756 launches is K1's at cache rows 64..126,
    every layer, over the launches' device time."""
    out = _k1_outcome(756 * calls, calls=calls)
    bound = calls * 12 * sum(counts.k1_bound_s(pos, 512, 1536)
                             for pos in range(64, 127))
    busy = 756 * calls * 1e-4
    assert K1_TXT.read(out) == pytest.approx(100 * bound / busy, rel=1e-12)
    # rows 1..63, what `k1_roofline` bounds, give a share about 2.8x lower
    low = calls * 12 * sum(counts.k1_bound_s(pos, 512, 1536)
                           for pos in range(1, 64))
    assert bound / low > 2.5


@pytest.mark.parametrize('launches', [0, 755, 757])
def test_k1_txt_roofline_refuses_another_launch_count(launches):
    assert K1_TXT.read(_k1_outcome(launches)) is None


def test_k1_txt_roofline_needs_the_prefix():
    out = _k1_outcome(756)
    del out.info['prefix']
    assert K1_TXT.read(out) is None


@pytest.mark.parametrize('spans,want', [
    ([('sample', 0, 40), ('ar.prefill', 5, 25)], 15 / 4),
    ([('sample', 0, 40)], None)])
def test_idle_prefill_reads_its_span_or_nothing(monkeypatch, spans, want):
    """Device busy 0-10 and 30-40 ms: the prefill span over the idle gap
    takes 15 of its 20 ms (5 under `sample`), over 4 samples; a program
    that records no `ar.prefill` (an older checkout) gives nothing."""
    ms = 1_000_000
    records = [tracing.SpanRecord(n, s * ms, e * ms, i, None if i == 0
                                  else 0, 0)
               for i, (n, s, e) in enumerate(spans)]
    monkeypatch.setattr(program_spans.tracing, 'spans', lambda: records)
    trace = Trace(device=[('k', 0, 10 * ms), ('k', 30 * ms, 40 * ms)],
                  host=[('aten::op', 0, 1)], units=4)
    reader = manifest.readers(['idle_ms_per_sample.prefill'])[
        'idle_ms_per_sample.prefill']
    got = reader.read(Outcome(trace=trace))
    assert got == (None if want is None else pytest.approx(want))


def _cell():
    w = manifest.cell('cc15m.txt2img.b512')
    return manifest.Cell('tiny.txt2img', 1, _config(), copy.deepcopy(TRAFFIC),
                         LIMITS, w.end_to_end, w.per_layer)


def _drive(fault=None, control=None, trace=False, seconds=0.0):
    r = Run(_cell(), 7, seconds, trace, time.perf_counter(), CPU,
            fault=fault, control=control)
    out = manifest.driver('txt2img').run(r)
    check.judge(out, bool(control))
    return out


def test_driver_sound_run_is_correct():
    """A traced run with a short window: correct, and the shapes the
    readers need, the prefill's harness span among them."""
    out = _drive(trace=True, seconds=0.05)
    assert out.correct, out.checks
    assert out.info['prefix'] == N_TXT and out.info['positions'] == N
    assert out.info['draw_rows'] == [1, R] and out.info['flops_per_unit'] > 0
    prefills = out.spans['prefill']
    assert len(prefills) == sum(1 for *_, p in out.info['calls'] if not p)
    reader = manifest.readers(['prefill_ms_per_sample'])[
        'prefill_ms_per_sample']
    assert reader.read(out) > 0


@pytest.mark.parametrize('fault', ['caption', 'token', 'state',
                                   'half_batch'])
def test_driver_fault_is_not_correct(fault):
    out = _drive(fault=fault)
    assert not out.correct, out.checks
    assert out.checks['topk_gap']['value'] > 0.1


def test_driver_control_is_not_correct():
    """The text reference with float8 operands in the program's place."""
    out = _drive(control='fp8')
    assert set(out.checks) == set(out.info['control'])
    assert not out.correct, out.checks


def test_sample_flops_count_the_prefill():
    """The text reference's FLOPs on shapes grow with the caption by the
    spatial blocks' products over its rows."""
    _, _, w = _model()
    cfg = _config()
    txt = manifest.driver('txt2img')
    one = txt.sample_flops(w, cfg, 1, N, R)
    full = txt.sample_flops(w, cfg, N_TXT, N, R)
    hp = cfg['model']['stage2']['hparams']
    # a row through a block: q, k, v and proj (4 d^2 products) and the
    # MLP (8 d^2), a multiply and an add each; attention's on top
    per_row = hp['n_layers'] * 12 * hp['embed_dim'] ** 2 * 2
    assert full - one >= (N_TXT - 1) * per_row
