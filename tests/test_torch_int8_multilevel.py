"""int8max serving of the 3-level HQ-Transformer family in the PyTorch port
against the JAX package, on the tiny 3-level cut of
`test_torch_multilevel.py` (vocabularies 32, 48, 64; d 64, 2 spatial
layers, 4 heads, a 4x4 top; the 3-level HQ-VAE at 64^2): the A8W8 gemms of
the prefill, a spatial step and the three depth phases on JAX's own
activations, the calibrations, the depth phases' int8max logits, the
quantized sets, the scales artifact and the calibrate-then-serve surface.

The JAX side runs as its own tests run it: bf16 models with
`serving_bf16_params`, attention='packed' (the XLA oracle of the decode
attention kernel on the CPU), the HQT_INT8_* switches set with monkeypatch
inside the JAX package's scopes, and its scales from its own calibration.
Inputs come from numpy seeds; each test states its tolerance.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import (  # noqa: E402
    QuantizableConv, int8_decode_scope)
from hqtransformer_tpu.models.stage2 import layers as jax_layers  # noqa: E402
from hqtransformer_tpu.models.stage2 import \
    multilevel as jax_ml  # noqa: E402
from hqtransformer_tpu.sampling import engine as jax_engine  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (  # noqa: E402
    _segment, convert_variables, export_scales)
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.layers import \
    SelfAttention  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.multilevel import \
    cells_to_level  # noqa: E402
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    LevelSampling, make_multilevel_sampler)
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

from test_torch_int8 import (  # noqa: E402
    STAGE2_MODES, _assert_near_jax, _intercepting, _np, _same_scales)
from test_torch_multilevel import (  # noqa: E402,F401
    B, N_TOP, VOCABS, _jax_phases, _no_grad, _one_thread, _t, tiny_config,
    two_stage)

ML = jax_ml.MultiLevelHQTransformer
LABELS = np.array([1, 4, 9], np.int32)
D = 64
BF16_ULP = 2.0 ** -7     # bf16's relative spacing


def _raster_codes(seed, n=B):
    """Raster code maps [n, 16], [n, 64], [n, 256] of the three levels."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCABS[li], (n, N_TOP * 4 ** li)).astype(np.int32)
            for li in range(3)]


def _maps(codes):
    """Raster codes -> the stage-1 decode's [n, H, W] maps, top first."""
    return [c.reshape(c.shape[0], 4 * 2 ** li, 4 * 2 ** li)
            for li, c in enumerate(codes)]


@pytest.fixture(scope='module')
def bf16_models(two_stage, tmp_path_factory):
    """The tiny 3-level two-stage model in bf16 on both sides with the same
    bf16 serving weights (`two_stage`'s, rounded by each package's
    serving_bf16_params); JAX's int8 scales from its own calibrations (KV
    from a JAX sampling run, the rest on seeded codes), carried to the
    port by the artifact. Returns (JAX model, variables with the scale
    collections, port model, port weights, port scales, artifact path)."""
    jm = jax_twostage.TwoStageModel(tiny_config(build_twostage_config),
                                    dtype=jnp.bfloat16)
    v = jax_twostage.serving_bf16_params(two_stage[1])
    weights = {s: twostage.serving_bf16_params(convert_variables(t))
               for s, t in v.items()}
    codes = [jnp.asarray(c) for c in _raster_codes(11, 4)]
    labels = jnp.asarray([1, 3, 5, 7], jnp.int32)
    v = jm.calibrate_kv_scales(v, jax.random.PRNGKey(2), labels)
    v = jm.calibrate_stage2_int8(v, codes, labels)
    v = jm.calibrate_int8_decode(v, _maps(codes))
    path = str(tmp_path_factory.mktemp('scales') / 'jax3.pkl')
    jax_twostage.save_serving_scales(v, path)
    tm = twostage.TwoStageModel(tiny_config(torch_config),
                                dtype=torch.bfloat16, device='cpu')
    tm.load_weights(weights)
    return jm, v, tm, weights, twostage.load_serving_scales(path), path


def _quantized(model):
    """Names of the port's modules that run A8W8 in this serving call."""
    return {n for n, m in model.named_modules()
            if getattr(m, 'q8', None) is not None} | {
        n for n, m in model.named_modules()
        if isinstance(m, SelfAttention) and m.serving.qkv_q8 is not None}


# -------------------------------------- (a) the gemms on JAX's activations

def test_int8_quantizers_match_jax_on_its_activations(bf16_models,
                                                      monkeypatch):
    """JAX's int8max prefill, one spatial step and the three cached depth
    phases run op by op, recording the input and output of every A8W8 gemm
    (QuantizableDense and the fused QKV); the port's module of the same
    name, in an int8max serving call with the converted scales, turns each
    recorded input into JAX's output bit for bit, and the spatial K/V
    outputs into JAX's int8 cache rows. The gemms the port quantizes are
    exactly those JAX runs A8W8: every depth phase's, head_levels.0..2
    included, but not phase 0's K/V, a float product in both (the port's
    phase 0 on JAX's input launches exactly JAX's 13 A8W8 gemms, and its
    float K/V product turns"""
    jm, v, tm, _, scales, _ = bf16_models
    s2 = v['stage2']
    tops, mids, bots = _raster_codes(3)
    top, mid, bot = (jnp.asarray(c) for c in (tops[:, 0], mids[:, :4],
                                              bots[:, :16]))
    labels = jnp.asarray(LABELS)

    def wanted(m, method):
        return (method == '_fused_qkv_flat' or (
            method == '__call__'
            and isinstance(m, jax_layers.QuantizableDense)))

    calls, norms, marks = [], [], {}
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with fnn.intercept_methods(_intercepting(calls, wanted)), \
            fnn.intercept_methods(_intercepting(
                norms, lambda m, method: m.name == 'ln1')), \
            jax_layers.int8_stage2_scope():
        sos = jm.stage2.apply(s2, B, labels, method=ML.sos_tokens)
        kc = jnp.zeros((2, N_TOP, B, D), jnp.int8)
        h, kc, vc = jm.stage2.apply(s2, sos, kc, jnp.zeros_like(kc), 0,
                                    method=ML.spatial_step)
        marks['prefill'] = len(calls)
        x = jm.stage2.apply(s2, top, mid, bot, jnp.zeros(B, jnp.int32),
                            method=ML.embed_cell_step)
        marks['embed'] = len(calls)
        h, kc, vc = jm.stage2.apply(s2, x, kc, vc, jnp.int32(1),
                                    method=ML.spatial_step)
        marks['step'] = len(calls)
        n_norms = len(norms)
        l0, kv0 = jm.stage2.apply(s2, h[:, -1], None, None, None, 0,
                                  method=ML.depth_phase_cached)
        marks['phase 0'] = len(calls)
        phase0_norms = norms[n_norms:]
        _, kv = jm.stage2.apply(s2, None, top, None, kv0, 1,
                                method=ML.depth_phase_cached)
        jm.stage2.apply(s2, None, top, mid, kv, 2,
                        method=ML.depth_phase_cached)
    # 2 spatial layers x 4 gemms twice; 4 depth layers x 3 gemms (phase 0)
    # or 4 (phases 1, 2), and a head each phase
    assert marks == {'prefill': 8, 'embed': 8, 'step': 16, 'phase 0': 29}
    assert len(calls) == 63

    model = tm.stage2
    rows = {}
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        ran = set()
        for path, method, x, y in calls:
            name = '.'.join(_segment(p) for p in path)
            xt = torch.from_numpy(np.array(_np(x))).bfloat16()
            mod = model.get_submodule(name)
            if method == '_fused_qkv_flat':
                out = mod.fused_qkv(xt, int8=True)
            else:
                out = mod(xt, int8=True)
            ran.add(name)
            np.testing.assert_array_equal(out.float().numpy(), _np(y),
                                          err_msg=name)
            if method == '_fused_qkv_flat' and name.startswith('blocks.'):
                layer, T = int(name.split('.')[1]), xt.shape[1]
                row = rows.get(layer, 0)
                _, _, inv_k, inv_v = mod.serving.kv_scales
                k, vv = torch.from_numpy(np.array(_np(y))).bfloat16().split(
                    D, -1)[1:]
                for got, cache in ((q8.quantize_rows(k, inv_k), kc),
                                   (q8.quantize_rows(vv, inv_v), vc)):
                    np.testing.assert_array_equal(
                        got.transpose(0, 1).numpy(),
                        np.asarray(cache)[layer, row:row + T])
                rows[layer] = row + T
        quantized = _quantized(model)
        before = tracing.counter('int8.matmul_launches')
        model.depth_phase_cached(
            torch.from_numpy(np.array(_np(h[:, -1]))).bfloat16(), None, None,
            None, 0, int8=True)
        assert tracing.counter('int8.matmul_launches') - before == 13
        # phase 0's K/V: each depth layer's ln1 output through the float
        # fused K/V product gives JAX's K/V, within one bf16 ulp (the two
        # bf16 gemms sum in another order) and mostly equal; the A8W8 K/V
        # of the same input does not
        assert len(phase0_norms) == 4
        for (path, _, _, xn), k, vv in zip(phase0_norms, *kv0):
            attn = model.get_submodule(
                '.'.join(_segment(p) for p in path[:-1])).attn
            xt = torch.from_numpy(np.array(_np(xn))).bfloat16()
            ref = np.concatenate([_np(k), _np(vv)], -1)
            kv = attn.fused_kv(xt).float().numpy()
            np.testing.assert_allclose(kv, ref, rtol=BF16_ULP, atol=0,
                                       err_msg=str(path))
            assert np.mean(kv == ref) >= 0.99, path
            a8 = attn.fused_qkv(xt, int8=True)[..., D:].float().numpy()
            assert not np.allclose(a8, ref, rtol=BF16_ULP, atol=0), path
    assert ran == quantized, sorted(ran ^ quantized)
    assert {f'head_levels.{i}' for i in range(3)} <= ran
    assert {'depths.0.attn.proj', 'depths.1.mlp.2'} <= ran
    assert rows == {0: 2, 1: 2}


# ------------------------------------------------------- (b) calibrations

def test_kv_calibration_matches_jax(two_stage, monkeypatch):
    """calibrate_kv_scales runs the 3-level sampler with its final caches
    returned, f32, greedy at every level on both sides (JAX's function
    samples with its sampler's defaults, which no other sampler can
    reproduce; its sampler is given top-k 1 here): every layer's
    per-channel scale within rtol 1e-5 (the caches hold the same codes'
    f32 K/V, summed in another order)."""
    jm, variables, weights = two_stage
    real = jax_engine.make_multilevel_sampler
    monkeypatch.setattr(jax_engine, 'make_multilevel_sampler',
                        lambda m, n, **kw: real(m, n, top_k=(1, 1, 1),
                                                attention='packed', **kw))
    ref = jm.calibrate_kv_scales(variables, jax.random.PRNGKey(0),
                                 jnp.asarray(LABELS))
    tm = twostage.TwoStageModel(tiny_config(torch_config), device='cpu')
    ours = tm.calibrate_kv_scales(weights, torch.Generator(), _t(LABELS),
                                  (LevelSampling(top_k=1),) * 3)
    _same_scales(ours['stage2/kv_scales'], ref['stage2']['kv_scales'],
                 'stage2/kv_scales', rtol=1e-5)


def test_stage2_calibration_matches_jax(two_stage):
    """calibrate_stage2_int8 on the 3-level forward's arguments ([top, mid,
    bottom] rasters, labels), f32: the same modules (head_levels.0..2
    among them) and scales within rtol 1e-6 (the two forwards' f32 gemms
    sum in another order)."""
    jm, variables, weights = two_stage
    codes = _raster_codes(8)
    ref = jm.calibrate_stage2_int8(variables, [jnp.asarray(c) for c in codes],
                                   jnp.asarray(LABELS))
    tm = twostage.TwoStageModel(tiny_config(torch_config), device='cpu')
    ours = tm.calibrate_stage2_int8(weights, [_t(c) for c in codes],
                                    _t(LABELS))['stage2/act_scales']
    assert {f'head_levels.{i}' for i in range(3)} <= set(ours)
    _same_scales(ours, ref['stage2']['act_scales'], 'stage2/act_scales',
                 rtol=1e-6)


def test_decode_calibration_matches_jax_and_chunks(two_stage):
    """calibrate_int8_decode on the three code maps through the tiny
    3-level HQ-VAE, f32: the same convs and scales within rtol 1e-5 of
    JAX's (f32 convolutions and the decoder's attention blocks sum in
    another order: 1.7e-6 measured); calibrating in chunks of 2 gives the
    scales of one pass within rtol 1e-5."""
    jm, variables, weights = two_stage
    maps = _maps(_raster_codes(9, 5))
    ref = jm.calibrate_int8_decode(variables, [jnp.asarray(m) for m in maps])
    tm = twostage.TwoStageModel(tiny_config(torch_config), device='cpu')
    one, split = (tm.calibrate_int8_decode(weights, [_t(m) for m in maps],
                                           chunk=chunk)['stage1/act_scales']
                  for chunk in (8, 2))
    _same_scales(one, ref['stage1']['act_scales'], 'stage1/act_scales',
                 rtol=1e-5)
    for name, t in one.items():
        np.testing.assert_allclose(split[name].numpy(), t.numpy(), rtol=1e-5,
                                   err_msg=f'{name} in chunks')


# ------------------------------------ (c) the depth phases' int8max logits

def test_depth_phases_int8max_near_jax(bf16_models, monkeypatch):
    """The cached depth phases on the same h, top and mids in bf16, with
    JAX's scales: JAX's int8max phases (jitted, in int8_stage2_scope under
    HQT_INT8_STAGE2) against the port's in an int8max serving call. Every
    A8W8 gemm maps JAX's own input to JAX's output bit for bit
    (test_int8_quantizers_match_jax_on_its_activations); what is left is
    XLA's excess precision inside its fusions, which int8 carries further
    (ROADMAP C1). Bounds, per phase, those of the 2-level scorer
    (`_assert_near_jax`): mean and max |d| at most 3.5x the bf16 phases'
    port-to-JAX deviation, top-1 >= 90%, and int8max changes the port's
    logits by 0.9x-1.1x as much as it changes JAX's."""
    jm, v, tm, _, scales, _ = bf16_models
    rng = np.random.RandomState(10)
    n = 16
    h = jnp.asarray(rng.randn(n, D), jnp.bfloat16)
    top = rng.randint(0, VOCABS[0], (n,)).astype(np.int32)
    mids = rng.randint(0, VOCABS[1], (n, 4)).astype(np.int32)
    jm2 = jm.stage2
    ref16, _ = _jax_phases(jm2, v['stage2'], h, top, mids)
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with jax_layers.int8_stage2_scope():
        ref8, _ = _jax_phases(jm2, v['stage2'], h, top, mids)
    model = tm.stage2
    th = torch.from_numpy(np.array(_np(h))).bfloat16()

    def port(int8):
        l0, kv = model.depth_phase_cached(th, None, None, None, 0, int8)
        l1, kv = model.depth_phase_cached(None, _t(top), None, kv, 1, int8)
        l2, _ = model.depth_phase_cached(None, _t(top), _t(mids), kv, 2,
                                         int8)
        return [x.float().numpy() for x in (l0, l1, l2)]
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        ours8, ours16 = port(True), port(False)
    for phase, (o, r, ob, rb) in enumerate(zip(ours8, ref8, ours16, ref16)):
        r, rb = _np(r), _np(rb)
        d, db, gap = np.abs(o - r), np.abs(ob - rb), np.abs(r - rb)
        reading = dict(mean=d.mean() / db.mean(), max=d.max() / db.max(),
                       size=np.abs(o - ob).mean() / gap.mean(),
                       top1=float(np.mean(o.argmax(-1) == r.argmax(-1))))
        print(f'int8max depth phase {phase}: {reading}')
        _assert_near_jax(reading)


# ----------------------------------------------------- (d) quantized sets

def test_int8_decode_quantizes_jax_convs(bf16_models, monkeypatch):
    """HQVAEGenerator.int8_decode quantizes every convolution JAX builds as
    a QuantizableConv, which its int8_decode_scope switches (the encoder's
    and the decoder's; post_quant_conv_b and the quantizers stay float in
    both); of those, JAX's 3-level decode runs the decoder's A8W8 under
    HQT_INT8_DECODE, and their scales carry JAX's names."""
    jm, v, tm, _, scales, _ = bf16_models
    maps = [jnp.asarray(m) for m in _maps(_raster_codes(4, 1))]
    calls = []
    monkeypatch.setenv('HQT_INT8_DECODE', '1')
    with fnn.intercept_methods(_intercepting(
            calls, lambda m, method: isinstance(m, QuantizableConv))), \
            int8_decode_scope():
        # tracing alone runs every conv's Python, the int8 branch included
        jax.eval_shape(lambda s1, maps: jm.stage1.apply(
            s1, maps, method=type(jm.stage1).decode_code), v['stage1'], maps)
    jax_convs = {'.'.join(_segment(p) for p in path)
                 for path, _, _, _ in calls}
    calls.clear()
    with fnn.intercept_methods(_intercepting(
            calls, lambda m, method: isinstance(m, QuantizableConv))):
        jax.eval_shape(jm.stage1.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3), jnp.bfloat16))
    jax_all = {'.'.join(_segment(p) for p in path)
               for path, _, _, _ in calls}
    stage1 = tm.stage1
    with stage1.int8_decode(scales['stage1/act_scales']):
        ours = {n for n, m in stage1.named_modules()
                if getattr(m, 'q8', None) is not None}
    assert ours == jax_all and jax_convs < ours
    assert jax_convs == set(scales['stage1/act_scales'])
    assert all(n.startswith('decoder.') for n in jax_convs)
    assert all(getattr(m, 'q8', None) is None for m in stage1.modules())


def test_spatial_int8_set_is_the_blocks(bf16_models, monkeypatch):
    """Spatial gemms are the spatial blocks' alone: JAX's cell embedding
    (`transformer1`, no embedding blocks) runs no gemm inside its
    HQT_INT8_SPATIAL scope, and in an int8max serving call every
    quantized module outside the depth transformer and its heads is a
    `blocks.*` one; a serving call with the depth gemms alone quantizes
    none of them."""
    jm, v, tm, _, scales, _ = bf16_models
    calls = []
    z = jnp.zeros((B,), jnp.int32)
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with fnn.intercept_methods(_intercepting(
            calls, lambda m, method: isinstance(
                m, jax_layers.QuantizableDense))), \
            jax_layers.int8_stage2_scope():
        jm.stage2.apply(v['stage2'], z, jnp.zeros((B, 4), jnp.int32),
                        jnp.zeros((B, 16), jnp.int32), z,
                        method=ML.embed_cell_step)
    assert calls == []
    model = tm.stage2
    depth = ('depths.', 'head_levels.')
    with model.serving(q8.INT8MAX, scales):
        spatial = {n for n in _quantized(model) if not n.startswith(depth)}
    assert spatial and all(n.startswith('blocks.') for n in spatial)
    with model.serving(q8.Int8Serving(depth_gemms=True), scales):
        assert all(n.startswith(depth) for n in _quantized(model))


@pytest.mark.parametrize('mode', list(STAGE2_MODES))
def test_serving_modes_quantize_what_jax_does(bf16_models, mode):
    """Every stage-2 mode the JAX package can run, on the 3-level model:
    the spatial blocks' gemms quantized exactly with spatial_gemms, every
    depth block's gemms and head_levels.0..2 exactly with depth_gemms, the
    int8 cache scales set exactly with kv_cache; on exit no state is
    left."""
    _, _, tm, _, scales, _ = bf16_models
    model, int8 = tm.stage2, STAGE2_MODES[mode]
    with model.serving(int8, scales):
        quantized = _quantized(model)
        kv = [b.attn.serving.kv_scales is not None for b in model.blocks]
    assert {n for n in quantized if n.startswith('blocks.')} == (
        {f'blocks.{i}.{m}' for i in range(2) for m in (
            'attn', 'attn.proj', 'mlp.0', 'mlp.2')}
        if int8.spatial_gemms else set())
    assert {n for n in quantized if not n.startswith('blocks.')} == (
        {f'depths.{i}.{m}' for i in range(4) for m in (
            'attn', 'attn.proj', 'mlp.0', 'mlp.2')} |
        {f'head_levels.{i}' for i in range(3)}
        if int8.depth_gemms else set())
    assert kv == [int8.kv_cache] * 2
    assert all(b.attn.serving is None for b in (*model.blocks,
                                                 *model.depths))
    assert all(getattr(m, 'q8', None) is None for m in model.modules())


@pytest.mark.parametrize('missing', ['blocks.1.attn.k', 'depths.3.mlp.0',
                                     'head_levels.2'])
def test_failed_serving_setup_leaves_no_state(bf16_models, missing):
    """A scale missing for a later module of the 3-level model raises
    before any module takes serving state; int8 gemms asked of an f32
    model raise."""
    _, _, tm, _, scales, _ = bf16_models
    model = tm.stage2
    cut = {k: {n: t for n, t in c.items() if n != missing}
           for k, c in scales.items()}
    with pytest.raises(ValueError, match='scale'):
        with model.serving(q8.INT8MAX, cut):
            pass
    assert all(b.attn.serving is None for b in (*model.blocks,
                                                 *model.depths))
    assert all(getattr(m, 'q8', None) is None for m in model.modules())
    f32 = twostage.build_stage2(tiny_config(torch_config))
    with pytest.raises(ValueError, match='bf16'):
        with f32.serving(q8.Int8Serving(depth_gemms=True), scales):
            pass


# ------------------------------------------------------ (e) the artifact

def test_jax_artifact_loads_and_round_trips(bf16_models, tmp_path):
    """JAX's 3-level artifact (head_levels_<i>, depths_<i> and the 3-level
    HQ-VAE decoder's convs among its names) loads in the port with every
    scale equal and named after a port module; the port writes it back
    equal, and the JAX loader reads the port's file back equal."""
    jm, v, tm, _, scales, path = bf16_models
    assert sorted(scales) == ['stage1/act_scales', 'stage2/act_scales',
                              'stage2/kv_scales']
    modules = {**dict(tm.stage1.named_modules()),
               **dict(tm.stage2.named_modules())}
    for key, coll in scales.items():
        for name in coll:
            owner = name.rsplit('.', 1)[0] if key.endswith('kv_scales') \
                else name
            assert owner in modules, (key, name)
    assert {'head_levels.2', 'depths.3.mlp.2'} <= set(
        scales['stage2/act_scales'])
    with open(path, 'rb') as f:
        raw = pickle.load(f)
    mine = str(tmp_path / 'port.pkl')
    twostage.save_serving_scales(scales, mine)
    with open(mine, 'rb') as f:
        written = pickle.load(f)
    assert sorted(written) == sorted(raw)
    for key in raw:
        want = jax.tree_util.tree_leaves_with_path(raw[key])
        got = jax.tree_util.tree_leaves_with_path(written[key])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (_, a), (_, b) in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert export_scales(scales).keys() == raw.keys()
    back = jax_twostage.load_serving_scales(
        {'stage1': {}, 'stage2': {}}, mine)
    for stage, coll in (('stage1', 'act_scales'), ('stage2', 'kv_scales'),
                        ('stage2', 'act_scales')):
        for a, b in zip(jax.tree.leaves(v[stage][coll]),
                        jax.tree.leaves(back[stage][coll])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------ (f) the surface

def test_twostage_int8max_level3_surface():
    """The JAX package's test_twostage_int8max_level3_surface on the port,
    on the CPU: calibrate_kv_scales -> bf16 sampling ->
    calibrate_int8_decode -> calibrate_stage2_int8 ->
    make_pixel_sampler_multilevel(int8=INT8MAX, scales): pixels
    [8, 64, 64, 3] finite in [0, 1], codes in range, and the int8 paths
    taken (A8W8 gemms and convs counted, the KV caches int8; K1 launches
    count on a card only)."""
    tm = twostage.TwoStageModel(tiny_config(torch_config),
                                dtype=torch.bfloat16, device='cpu')
    weights = {s: twostage.serving_bf16_params(w)
               for s, w in tm.init_weights(0).items()}
    labels = torch.zeros(8, dtype=torch.long)
    scales = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(2),
                                    labels)
    _, codes = tm.make_pixel_sampler_multilevel()(
        weights, torch.Generator().manual_seed(3), labels)
    rasters = [codes[0]] + [cells_to_level(c, 4, w).reshape(8, -1)
                            for c, w in ((codes[1], 2), (codes[2], 4))]
    scales.update(tm.calibrate_int8_decode(weights, _maps(rasters)))
    scales.update(tm.calibrate_stage2_int8(weights, rasters, labels))
    sampler = tm.make_pixel_sampler_multilevel(int8=q8.INT8MAX,
                                               scales=scales)
    gemms, convs = (tracing.counter('int8.matmul_launches'),
                    tracing.counter('int8.conv2d_launches'))
    pixels, codes = sampler(weights, torch.Generator().manual_seed(4),
                            labels)
    assert pixels.shape == (8, 64, 64, 3) and pixels.dtype == torch.bfloat16
    assert bool(torch.isfinite(pixels).all())
    assert float(pixels.min()) >= 0 and float(pixels.max()) <= 1
    for c, v in zip(codes, VOCABS):
        assert int(c.min()) >= 0 and int(c.max()) < v
    # 2 spatial layers x 4 gemms x 16 positions, 4 depth layers x 15
    # gemms and 3 heads a position
    assert tracing.counter('int8.matmul_launches') - gemms == \
        16 * (2 * 4 + 4 * 11 + 3)
    assert tracing.counter('int8.conv2d_launches') > convs
    _, (kc, vc) = make_multilevel_sampler(
        tm.stage2, N_TOP, int8=q8.INT8MAX, scales=scales,
        return_caches=True)(torch.Generator(), labels)
    assert kc.dtype == vc.dtype == torch.int8
