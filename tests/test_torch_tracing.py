"""The port's spans and counters (`utils/tracing.py`) on tiny models on the
CPU: nothing records outside `recording()` or a profiler; a sampler call
records its layer spans, nested, under one call id, and a train step its
five; the spans line up with the profiler's events of the operations they
ran; tracing changes no code drawn."""

import collections
import json

import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from hqtransformer_tpu_torch.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402
from hqtransformer_tpu_torch.train import scheduler as tsched  # noqa: E402
from hqtransformer_tpu_torch.train import stage2 as ttrain  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

TWO_LEVEL = 'configs/tiny/stage2-tiny.yaml'
LEVEL3 = 'configs/imagenet/stage2/hqtransformer-l12-top8x8-level3.yaml'
N_TOP = 16                   # spatial positions of both tiny models
CLOCK_SLACK_NS = 200_000     # 0.2 ms


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _level3_config():
    """The flagship level-3 config cut to a tiny size (as
    `test_torch_multilevel.tiny_config`): a 4x4 top, vocabularies 32, 48,
    64, d 64 with 2 layers."""
    cfg = build_twostage_config(LEVEL3)
    cfg.dataset.image_resolution = 64
    s1, s2 = cfg.stage1, cfg.stage2
    s1.hparams.resolution, s1.hparams.ch = 64, 32
    s1.hparams.ch_mult, s1.hparams.z_channels = [1, 2], 64
    s1.hparams.attn_resolutions = [16]
    s1.embed_dim, s1.n_embed, s1.n_embed_levels = 64, 64, [32, 48, 64]
    s2.vocab_sizes_img, s2.vocab_size_img = [32, 48, 64], 64
    hp = s2.hparams
    hp.embed_dim, hp.n_layers, hp.n_heads = 64, 2, 4
    hp.n_classes, hp.ctx_len_img = 10, N_TOP
    return cfg


_SAMPLERS = {}


def _sampler(levels):
    """(sampler, weights) of the tiny model with `levels` code levels,
    built once."""
    if levels not in _SAMPLERS:
        if levels == 2:
            tm = TwoStageModel(build_twostage_config(TWO_LEVEL), device='cpu')
            fn = tm.make_pixel_sampler(params=SamplingParams(
                top_k_top=16, top_k_bot=16, temperature_top=0.95,
                temperature_bot=0.95))
        else:
            tm = TwoStageModel(_level3_config(), device='cpu')
            fn = tm.make_pixel_sampler_multilevel(top_k=(8, 8, 8))
        _SAMPLERS[levels] = fn, tm.init_weights(seed=0)
    return _SAMPLERS[levels]


def _call(levels, seed=3):
    fn, weights = _sampler(levels)
    return fn(weights, torch.Generator().manual_seed(seed),
              torch.tensor([1, 2]))


def _new_spans(before):
    """The spans recorded since `before` (a `tracing.spans()` list)."""
    return tracing.spans()[len(before):]


def test_nothing_records_outside_recording_or_a_profiler():
    before = tracing.spans()
    _call(2)
    with tracing.span('outside'):
        pass
    assert _new_spans(before) == []
    with tracing.recording():
        with tracing.span('outside'):
            pass
    assert [r.name for r in _new_spans(before)] == ['outside']


def test_span_decorates_and_counters_add():
    @tracing.span('decorated')
    def f(x):
        return x + 1

    before = tracing.spans()
    with tracing.recording():
        assert f(1) == 2
    (r,) = _new_spans(before)
    assert (r.name, r.parent, r.call) == ('decorated', None, r.id)
    assert r.start_ns <= r.end_ns
    n = tracing.counter('test.events')
    tracing.count('test.events')
    tracing.count('test.events', 3)
    assert tracing.counter('test.events') == n + 4
    assert tracing.counter('test.never') == 0


def _profiled(levels):
    """A profiled tiny sampler call: (its spans, the profiler's host
    events (name, start_ns, end_ns))."""
    _call(levels)     # warm
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(levels)
    events = [(e.name(), int(e.start_ns()),
               int(e.start_ns() + e.duration_ns()))
              for e in prof.profiler.kineto_results.events()]
    return tracing.spans(), events


@pytest.mark.parametrize('levels', [2, 3])
def test_sampler_call_records_its_layer_spans(levels):
    """One call under the profiler: 1 `sample`, 1 `ar.prefill`, N - 1
    `ar.spatial`, N `ar.depth`, N x draws `ar.draw` (2 or 3 a position)
    and 1 `decode`; the loop's and the decode's spans children of
    `sample`, every draw a child of a depth span, all under one call id;
    each span's interval holds the profiler's events of an operation it
    ran (the k-th draw's `aten::rand`, the k-th spatial step's
    `aten::mean`, the decode's convolutions), within 0.2 ms."""
    spans, events = _profiled(levels)
    names = collections.Counter(r.name for r in spans)
    assert names == {'sample': 1, 'ar.prefill': 1, 'ar.spatial': N_TOP - 1,
                     'ar.depth': N_TOP, 'ar.draw': levels * N_TOP,
                     'decode': 1}
    by_id = {r.id: r for r in spans}
    (root,) = [r for r in spans if r.name == 'sample']
    assert root.parent is None and {r.call for r in spans} == {root.id}
    for r in spans:
        want = {'sample': None, 'ar.draw': 'ar.depth'}.get(r.name, 'sample')
        assert (by_id[r.parent].name if r.parent is not None
                else None) == want, r
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns

    def held(span_name, op):
        sp = sorted((r for r in spans if r.name == span_name),
                    key=lambda r: r.start_ns)
        ops = sorted((e for e in events if e[0] == op),
                     key=lambda e: e[1])
        return sp, ops

    for span_name, op in (('ar.draw', 'aten::rand'),
                          ('ar.spatial', 'aten::mean')):
        sp, ops = held(span_name, op)
        assert len(sp) == len(ops), (span_name, op, len(ops))
        for r, (_, s, e) in zip(sp, ops):
            assert r.start_ns - CLOCK_SLACK_NS <= s <= e <= \
                r.end_ns + CLOCK_SLACK_NS, (span_name, r, s, e)
    (dec,), convs = held('decode', 'aten::convolution')
    assert convs and all(dec.start_ns - CLOCK_SLACK_NS <= s <= e <=
                         dec.end_ns + CLOCK_SLACK_NS for _, s, e in convs)


def test_codes_are_the_same_with_tracing_on_and_off():
    px_off, codes_off = _call(2, seed=11)
    with tracing.recording():
        px_on, codes_on = _call(2, seed=11)
    for a, b in zip(codes_off, codes_on):
        assert torch.equal(a, b)
    assert torch.equal(px_off, px_on)


def test_train_step_records_its_five_spans():
    tm = TwoStageModel(build_twostage_config(TWO_LEVEL), device='cpu')
    tm.load_weights(tm.init_weights(seed=0))
    tm.stage1.requires_grad_(False)
    opt = ttrain.make_optimizer(
        tm.config.optimizer, tsched.build_schedule(1e-3, 2, 10,
                                                   warmup_epoch=1.0),
        mask=ttrain.decay_mask(tm.stage2))
    step = ttrain.make_train_step(tm.stage2, tm.stage1, opt)
    state = ttrain.init_train_state(tm.stage2, opt)
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    before = tracing.spans()
    with tracing.recording():
        step(state, images, torch.tensor([1, 2]))
    spans = _new_spans(before)
    names = collections.Counter(r.name for r in spans)
    assert names == {'train.step': 1, 'train.stage1_codes': 1,
                     'train.forward': 1, 'train.backward': 1,
                     'train.optimizer': 1}
    (root,) = [r for r in spans if r.name == 'train.step']
    assert all(r.parent == root.id and r.call == root.id
               for r in spans if r is not root)
    order = [r.name for r in sorted(spans, key=lambda r: r.start_ns)][1:]
    assert order == ['train.stage1_codes', 'train.forward',
                     'train.backward', 'train.optimizer']


def test_chrome_events_share_the_profiler_time_base(tmp_path):
    """The spans written into a profiler's Chrome trace, on its
    `baseTimeNanoseconds`, hold the trace's own events of their draws."""
    _call(2)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(2)
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = tracing.chrome_events(tracing.spans(),
                                   trace['baseTimeNanoseconds'])
    draws = sorted((e for e in events if e['name'] == 'ar.draw'),
                   key=lambda e: e['ts'])
    rands = sorted((e for e in trace['traceEvents']
                    if e.get('name') == 'aten::rand'), key=lambda e: e['ts'])
    assert len(draws) == len(rands) == 2 * N_TOP
    for d, r in zip(draws, rands):
        assert d['ts'] - 200 <= r['ts'] <= r['ts'] + r['dur'] <= \
            d['ts'] + d['dur'] + 200
    assert events[0]['ph'] == 'M' and \
        {e['pid'] for e in events} == {'program spans'}


def test_measure_throughput_profile_holds_the_program_spans(tmp_path):
    """`measure_throughput profile=<dir>`: each Chrome trace holds its
    call's spans on a `program spans` row; the AR loop's trace has no
    `sample` root, the whole call's one."""
    from hqtransformer_tpu_torch.cli import measure_throughput
    assert measure_throughput.main([
        f'model_path={TWO_LEVEL}', 'batch_size=2', 'top_resolution=4',
        'samples_per_loop=2', 'n_loop=2', 'device=cpu', 'dtype=float32',
        f'profile={tmp_path}']) == 0
    for name, want in (('ar', {'ar.prefill': 1, 'ar.spatial': N_TOP - 1,
                               'ar.depth': N_TOP, 'ar.draw': 2 * N_TOP}),
                       ('e2e', {'sample': 1, 'ar.prefill': 1,
                                'ar.spatial': N_TOP - 1, 'ar.depth': N_TOP,
                                'ar.draw': 2 * N_TOP, 'decode': 1})):
        trace = json.loads((tmp_path / f'{name}_trace.json').read_text())
        spans = [e for e in trace['traceEvents']
                 if e.get('pid') == 'program spans' and e['ph'] == 'X']
        assert collections.Counter(e['name'] for e in spans) == want, name
