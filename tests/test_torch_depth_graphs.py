"""The 2-level sampler's depth graphs (`sampling/engine.py::_DepthGraphs`)
where the CPU can see them: which calls may be replayed at all, that off
the card every call runs eagerly and captures nothing, and the tracing
calls they rest on. Replays themselves run on the card only, where
`chip_smoke.py` phase 19 holds them to the eager calls."""

import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from hqtransformer_tpu_torch.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.ops.int8 import Int8Serving  # noqa: E402
from hqtransformer_tpu_torch.sampling import engine  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

TWO_LEVEL = 'configs/tiny/stage2-tiny.yaml'
PARAMS = engine.SamplingParams(top_k_top=16, top_k_bot=16)


@pytest.fixture(scope='module')
def tiny():
    """The tiny 2-level model with seeded weights loaded, on the CPU."""
    torch.set_num_threads(1)
    tm = TwoStageModel(build_twostage_config(TWO_LEVEL), device='cpu')
    tm.load_weights(tm.init_weights(seed=0))
    return tm.stage2


@pytest.mark.parametrize('int8, replayable', [
    (Int8Serving(), True),
    (Int8Serving(kv_cache=True), False),
    (Int8Serving(decode_convs=True), False),
    (Int8Serving(depth_gemms=True), False),
])
def test_only_a_float_call_without_a_layout_is_replayable(tiny, int8,
                                                          replayable):
    graphs = engine._DepthGraphs(tiny, engine._depth_sample_parallel,
                                 PARAMS, int8, (0, 1))
    assert graphs.enabled is replayable


def test_a_model_with_a_layout_is_not_replayable(tiny, monkeypatch):
    monkeypatch.setattr(tiny, 'layout', object(), raising=False)
    graphs = engine._DepthGraphs(tiny, engine._depth_sample_parallel,
                                 PARAMS, Int8Serving(), (0, 1))
    assert not graphs.enabled


@torch.inference_mode()
def test_off_the_card_every_call_is_eager_and_nothing_is_captured(tiny):
    graphs = engine._DepthGraphs(tiny, engine._depth_sample_parallel,
                                 PARAMS, Int8Serving(), (0, 1))
    h = torch.randn(3, tiny.hparams.embed_dim,
                    generator=torch.Generator().manual_seed(1))
    graphs.start()
    with tiny.serving():
        for _ in range(3):
            got = graphs(h, torch.Generator().manual_seed(2))
            want = engine._depth_sample_parallel(
                tiny, h, torch.Generator().manual_seed(2), PARAMS, None,
                False)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert graphs.graphs == {}


def test_active_follows_recording_and_the_profiler():
    assert not tracing.active()
    with tracing.recording():
        assert tracing.active()
    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
    assert not tracing.active()


def test_counts_is_a_copy_of_every_counter():
    tracing.count('test.depth_graphs', 3)
    snapshot = tracing.counts()
    assert snapshot['test.depth_graphs'] == tracing.counter(
        'test.depth_graphs')
    snapshot['test.depth_graphs'] += 1
    assert snapshot['test.depth_graphs'] == tracing.counter(
        'test.depth_graphs') + 1
