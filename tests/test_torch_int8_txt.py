"""int8max serving with a text prefix, and the int8 set of the cell
embedding's blocks, in the PyTorch port against the JAX package (the
counterpart of `tests/test_int8_txt.py`): the A8W8 gemms of the caption's
prefill and of one spatial step and depth chain fed JAX's own activations,
the KV calibration over the caption's and the image's cache rows, the
calibrate-then-serve surface on the CPU, and which gemms each family's
int8max sampler quantizes with `transformer2` (JAX's own samplers traced
under its int8 switches).

The models are `test_torch_conditioning`'s tiny text config (2 levels,
d 64, an 8-token caption) and `test_torch_conditioning_multilevel`'s tiny
3-level config with `transformer2`, in bf16 with each package's
serving_bf16_params. JAX's switches are set with monkeypatch; scales come
from the port's calibrations, carried to JAX by `export_scales` (the
artifact's layout), where a test says so.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage2 import layers as jax_layers  # noqa: E402
from hqtransformer_tpu.models.stage2.hierarchical import \
    HierarchicalGPT as JaxGPT  # noqa: E402
from hqtransformer_tpu.sampling import engine as jax_engine  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (  # noqa: E402
    _segment, convert_variables, export_scales)
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.hierarchical import \
    cells_to_raster  # noqa: E402
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402

from test_torch_conditioning import (  # noqa: E402,F401
    B, GREEDY, N_TOP, N_TXT, V, _no_grad, _np, _one_thread, _t, codes2,
    config2, labels_for)
from test_torch_conditioning_multilevel import (  # noqa: E402
    codes3, config3)
from test_torch_int8 import _intercepting, _same_scales  # noqa: E402


def _quantized(model):
    """Names of the port's modules that run A8W8 in this serving call (the
    fused QKV under its attention's name)."""
    return {n for n, m in model.named_modules()
            if getattr(m, 'q8', None) is not None or
            getattr(getattr(m, 'serving', None), 'qkv_q8', None) is not None}


def _jax_variables(jm, key):
    """TwoStageModel.init_variables with each stage's init jitted."""
    k1, k2 = jax.random.split(key)
    res = jm.config.dataset.image_resolution
    v1 = jax.jit(jm.stage1.init)(k1, jnp.zeros((1, res, res, 3)))
    n_top = jm.top_res * jm.top_res
    v2 = jax.jit(jm.stage2.init)(
        k2, jnp.zeros((1, n_top), jnp.int32),
        jnp.zeros((1, n_top * jm.ratio), jnp.int32),
        jnp.zeros((1, N_TXT), jnp.int32))
    return {'stage1': v1, 'stage2': v2}


@pytest.fixture(scope='module')
def text_models():
    """The tiny text two-stage model in f32 on both sides: (JAX model, its
    variables, port weights)."""
    jm = jax_twostage.TwoStageModel(config2(build_twostage_config, 'text'))
    v = _jax_variables(jm, jax.random.PRNGKey(5))
    return jm, v, {s: convert_variables(t) for s, t in v.items()}


def _bf16_serving(cfg, v2, calibrate):
    """The port's bf16 two-stage model on `cfg` with JAX's stage-2 weights
    v2 (serving_bf16_params on both sides), and `calibrate(model,
    weights)`'s int8 scales; JAX's stage-2 variables carry the same scales
    (`export_scales`). Returns (port model, port weights, port scales, JAX
    variables)."""
    tm = twostage.TwoStageModel(cfg, dtype=torch.bfloat16, device='cpu')
    weights = {'stage1': twostage.serving_bf16_params(
                   tm.init_weights(0)['stage1']),
               'stage2': twostage.serving_bf16_params(convert_variables(v2))}
    scales = calibrate(tm, weights)
    v16 = dict(jax_twostage.serving_bf16_params(v2))
    for key, tree in export_scales(scales).items():
        v16[key.split('/')[1]] = jax.tree.map(jnp.asarray, tree)
    tm.load_weights(weights)
    return tm, weights, scales, v16


def _text_calibration(tm, weights):
    labels = _t(labels_for('text'))
    ct, cb, _ = codes2(3, 4)
    scales = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(2),
                                    labels)
    scales.update(tm.calibrate_stage2_int8(weights, _t(ct), _t(cb), labels))
    return scales


@pytest.fixture(scope='module')
def text_bf16(text_models):
    return _bf16_serving(config2(torch_config, 'text'),
                         text_models[1]['stage2'], _text_calibration)


# ------------------------------- the gemms of the text prefill and a step

def test_int8_gemms_of_the_text_prefill_match_jax(text_bf16, monkeypatch):
    """JAX's int8max prefill of an 8-token caption, one spatial step (at
    cache row 8) and one depth chain, run op by op, recording the input and
    output of every A8W8 gemm (QuantizableDense and the fused QKV): the
    port's module of the same name, in an int8max serving call, turns each
    recorded input into JAX's output bit for bit, and JAX's K/V outputs
    into JAX's int8 cache rows (rows 0..7 from the prefill, 8 from the
    step). The gemms the port quantizes are exactly those JAX runs A8W8;
    head_txt is not among them."""
    tm, _, scales, s2 = text_bf16
    jm = jax_twostage.build_stage2(config2(build_twostage_config, 'text'),
                                   dtype=jnp.bfloat16)
    ct, _, cells = codes2(4, 4)
    labels = jnp.asarray(labels_for('text', 1))

    def wanted(m, method):
        return (method == '_fused_qkv_flat' or (
            method == '__call__'
            and isinstance(m, jax_layers.QuantizableDense)))

    calls = []
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with fnn.intercept_methods(_intercepting(calls, wanted)):
        sos = jm.apply(s2, B, labels, method=JaxGPT.sos_tokens)
        kc = jnp.zeros((2, N_TXT + N_TOP - 1, B, 64), jnp.int8)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.apply(s2, sos, kc, jnp.zeros_like(kc), 0,
                                 method=JaxGPT.spatial_step)
        x = jm.apply(s2, jnp.asarray(ct[:, 0]), jnp.asarray(cells[:, 0]),
                     jnp.zeros(B, jnp.int32), method=JaxGPT.embed_cell_step)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.apply(s2, x, kc, vc, jnp.int32(N_TXT),
                                 method=JaxGPT.spatial_step)
        n_spatial = len(calls)
        _, kv = jm.apply(s2, h[:, -1], method=JaxGPT.depth_first_logits)
        n_first = len(calls) - n_spatial
        with jax_layers.int8_stage2_scope():
            jm.apply(s2, jnp.asarray(ct[:, 1:2]), kv, 1,
                     method=JaxGPT.depth_second_logits)
    int8_calls = calls[:n_spatial] + calls[n_spatial + n_first:]
    assert (n_spatial, n_first, len(int8_calls)) == (16, 12, 33)

    model = tm.stage2
    rows = {}
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        ran = set()
        for path, method, x, y in int8_calls:
            name = '.'.join(_segment(p) for p in path)
            xt = torch.from_numpy(np.array(_np(x))).bfloat16()
            mod = model.get_submodule(name)
            out = (mod.fused_qkv(xt, int8=True) if method == '_fused_qkv_flat'
                   else mod(xt, int8=True))
            ran.add(name)
            np.testing.assert_array_equal(out.float().numpy(), _np(y),
                                          err_msg=name)
            if method == '_fused_qkv_flat' and name.startswith('blocks.'):
                layer, T = int(name.split('.')[1]), xt.shape[1]
                row = rows.get(layer, 0)
                _, _, inv_k, inv_v = mod.serving.kv_scales
                k, vv = torch.from_numpy(np.array(_np(y))).bfloat16().split(
                    64, -1)[1:]
                for got, cache in ((q8.quantize_rows(k, inv_k), kc),
                                   (q8.quantize_rows(vv, inv_v), vc)):
                    np.testing.assert_array_equal(
                        got.transpose(0, 1).numpy(),
                        np.asarray(cache)[layer, row:row + T])
                rows[layer] = row + T
        quantized = _quantized(model)
    assert ran == quantized, sorted(ran ^ quantized)
    assert rows == {0: N_TXT + 1, 1: N_TXT + 1}
    assert 'head_txt' not in quantized


# ----------------------------------------------------------- calibration

def test_kv_calibration_over_the_caption_rows_matches_jax(text_models):
    """calibrate_kv_scales with a caption, f32, greedy (top-k 1, so both
    runs draw the same codes): the scales reduce the 8 + 16 - 1 cache rows
    of the caption and the image (the caches' rows:
    test_text_sampler_caches_hold_the_prefix), equal to JAX's within rtol
    1e-5."""
    jm, v, weights = text_models
    labels = labels_for('text', 2)
    ref = jm.calibrate_kv_scales(v, jax.random.PRNGKey(0),
                                 jnp.asarray(labels),
                                 jax_engine.SamplingParams(**GREEDY))
    tm = twostage.TwoStageModel(config2(torch_config, 'text'), device='cpu')
    ours = tm.calibrate_kv_scales(weights, torch.Generator(), _t(labels),
                                  SamplingParams(**GREEDY))
    _same_scales(ours['stage2/kv_scales'], ref['stage2']['kv_scales'],
                 'stage2/kv_scales', rtol=1e-5)


def test_int8max_text_surface_on_the_cpu():
    """The calibrate-then-serve sequence of `measure_throughput.py` for a
    text model (KV scales from one sampling run, a bf16 sampling call,
    decode scales on its codes, stage-2 scales on at most 64 of them), then
    make_pixel_sampler in int8max on 8 captions: pixels finite in [0, 1],
    codes in range."""
    tm = twostage.TwoStageModel(config2(torch_config, 'text'),
                                dtype=torch.bfloat16, device='cpu')
    weights = {s: twostage.serving_bf16_params(w)
               for s, w in tm.init_weights(1).items()}
    texts = torch.ones((8, N_TXT), dtype=torch.long)
    scales = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(2),
                                    texts)
    _, (ct, cb) = tm.make_pixel_sampler()(
        weights, torch.Generator().manual_seed(3), texts)
    tr, win = tm.top_res, tm.cell_win
    raster = cells_to_raster(cb, tr, win)
    scales.update(tm.calibrate_int8_decode(
        weights, ct.reshape(-1, tr, tr),
        raster.reshape(-1, tr * win, tr * win)))
    n = min(64, ct.shape[0])
    scales.update(tm.calibrate_stage2_int8(
        weights, ct[:n], raster.reshape(ct.shape[0], -1)[:n], texts[:n]))
    px, (ct8, cb8) = tm.make_pixel_sampler(int8=q8.INT8MAX, scales=scales)(
        weights, torch.Generator().manual_seed(4), texts)
    assert px.shape == (8, 32, 32, 3) and bool(torch.isfinite(px).all())
    assert float(px.min()) >= 0.0 and float(px.max()) <= 1.0
    for c in (ct8, cb8):
        assert int(c.min()) >= 0 and int(c.max()) < V


# -------------------------------------- the int8 set of the cell embedding

def _jax_a8w8_names(trace):
    """Module names of the gemms that JAX runs A8W8 while `trace()` traces
    a sampler under HQT_INT8_STAGE2=1 and HQT_INT8_SPATIAL=1: every
    QuantizableDense call and fused QKV inside int8_stage2_scope (every one
    has its calibrated scale)."""
    calls = []

    def wanted(m, method):
        return (method == '_fused_qkv_flat' or (
            method == '__call__'
            and isinstance(m, jax_layers.QuantizableDense))) and \
            jax_layers._INT8_STAGE2_SCOPE[0]

    with fnn.intercept_methods(_intercepting(calls, wanted)):
        trace()
    return {'.'.join(_segment(p) for p in path) for path, *_ in calls}


def _three_level_calibration(tm, weights):
    codes = [_t(c) for c in codes3(6)]
    labels = _t(labels_for('class'))
    scales = tm.calibrate_kv_scales(weights, torch.Generator(), labels)
    scales.update(tm.calibrate_stage2_int8(weights, codes, labels))
    return scales


def _three_level_models():
    cfg = config3(build_twostage_config, embedding='transformer2')
    jm = jax_twostage.build_stage2(cfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         [jnp.asarray(c) for c in codes3(0)],
                         jnp.zeros((B,), jnp.int32))
    tm, _, scales, v16 = _bf16_serving(
        config3(torch_config, embedding='transformer2'), v,
        _three_level_calibration)
    return jax_twostage.build_stage2(cfg, dtype=jnp.bfloat16), tm, scales, v16


def _two_level_models():
    cfg = config2(build_twostage_config, 'class', embedding='transformer2')
    jm = jax_twostage.build_stage2(cfg)
    ct, cb, _ = codes2(0, 4)
    labels = labels_for('class')
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ct),
                         jnp.asarray(cb), jnp.asarray(labels))

    def calibrate(tm, weights):
        c, b, _ = codes2(3, 4)
        scales = tm.calibrate_kv_scales(weights, torch.Generator(),
                                        _t(labels))
        scales.update(tm.calibrate_stage2_int8(weights, _t(c), _t(b),
                                               _t(labels)))
        return scales

    tm, _, scales, v16 = _bf16_serving(
        config2(torch_config, 'class', embedding='transformer2'), v,
        calibrate)
    return jax_twostage.build_stage2(cfg, dtype=jnp.bfloat16), tm, scales, v16


def test_int8_set_of_the_cell_embedding(monkeypatch):
    """With `transformer2`, JAX's int8max samplers (traced, under its
    switches, with the port's calibrated scales) run the 3-level
    `emb_blocks` gemms A8W8, since they embed each cell inside the spatial
    int8 scope, and the 2-level ones float, since they embed it outside.
    The port quantizes exactly the gemms JAX's sampler does in each family
    (emb_blocks in for 3 levels, out for 2), and its 3-level emb_blocks
    turn JAX's recorded inputs into JAX's outputs bit for bit."""
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    monkeypatch.setenv('HQT_INT8_SPATIAL', '1')
    key, labels = jax.random.PRNGKey(1), jnp.asarray(labels_for('class'))
    for levels, build in ((3, _three_level_models), (2, _two_level_models)):
        jm, tm, scales, v16 = build()
        if levels == 3:
            sampler = jax_engine.make_multilevel_sampler(
                jm, N_TOP, top_k=(1, 1, 1), cache_dtype=jnp.int8,
                attention='packed')
        else:
            sampler = jax_engine.make_hierarchical_sampler(
                jm, N_TOP, jax_engine.SamplingParams(**GREEDY),
                cache_dtype=jnp.int8, attention='packed')
        ref = _jax_a8w8_names(lambda: jax.eval_shape(sampler, v16, key,
                                                     labels))
        with tm.stage2.serving(q8.INT8MAX, scales):
            quantized = _quantized(tm.stage2)
        emb = {n for n in quantized if n.startswith('emb_blocks.')}
        assert quantized == ref, (levels, sorted(quantized ^ ref))
        assert len(emb) == (6 if levels == 3 else 0), (levels, emb)
        if levels == 3:
            _emb_blocks_match_jax(jm, tm, scales, v16)


def _emb_blocks_match_jax(jm, tm, scales, v16):
    """JAX's 3-level embed_cell_step inside its int8 scope, op by op: each
    emb_blocks gemm's recorded input turns into JAX's output through the
    port's module, A8W8, bit for bit."""
    from hqtransformer_tpu.models.stage2.multilevel import \
        MultiLevelHQTransformer as ML
    rng = np.random.RandomState(8)
    calls = []
    with fnn.intercept_methods(_intercepting(calls, lambda m, method: (
            method == '__call__'
            and isinstance(m, jax_layers.QuantizableDense)))), \
            jax_layers.int8_stage2_scope():
        jm.apply(v16, *(jnp.asarray(rng.randint(0, 32, s), jnp.int32)
                        for s in ((B,), (B, 4), (B, 16))),
                 jnp.arange(B, dtype=jnp.int32), method=ML.embed_cell_step)
    assert len(calls) == 6
    model = tm.stage2
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        for path, _, x, y in calls:
            name = '.'.join(_segment(p) for p in path)
            out = model.get_submodule(name)(
                torch.from_numpy(np.array(_np(x))).bfloat16(), int8=True)
            np.testing.assert_array_equal(out.float().numpy(), _np(y),
                                          err_msg=name)
