"""int8 serving beyond the `parallel` depth mode, in the PyTorch port against
the JAX package: the 2-level `bidirectional` and `top2bot` modes (tiny
config at d 64, vocabulary 64, 2 spatial and 4 depth layers, a 4x4 top,
as `test_torch_depth_modes.py` cuts it), the flat iGPT and Transformer1d
baselines with an int8 KV cache (`test_torch_flat.py`'s cut), the iGPT
pixel sampler's int8 decode, and the set of convolutions the int8 decode
quantizes for every generator type.

The JAX side runs as its own tests run it: bf16 models with
`serving_bf16_params`, attention='packed' (the XLA oracle of the decode
attention kernel on the CPU; JAX's int8 rows exist only in that layout),
the HQT_INT8_* switches set with monkeypatch inside the JAX package's
scopes, op by op, recording every gemm's input and output. The port's
module of the same name must turn JAX's input into JAX's output bit for
bit (A8W8 where JAX ran A8W8, float where it ran float), and JAX's K/V into
JAX's int8 cache rows. Calibrations run f32 and greedy (top-k 1 at
temperature 1e-6, so both packages draw the same codes) and are held
within rtol 1e-5: the f32 sums run in another order.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage1 import generator as jgen  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import \
    QuantizableConv  # noqa: E402
from hqtransformer_tpu.models.stage2 import layers as jax_layers  # noqa: E402
from hqtransformer_tpu.models.stage2.hierarchical import \
    HierarchicalGPT as JaxGPT  # noqa: E402
from hqtransformer_tpu.sampling import engine as jax_engine  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (  # noqa: E402
    _segment, convert_variables, export_scales)
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage1 import \
    generator as tgen  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.layers import \
    QuantizableConv2d  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.layers import \
    SelfAttention  # noqa: E402
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    SamplingParams, make_hierarchical_sampler, make_igpt_sampler,
    make_txt2img_sampler)
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

from test_torch_depth_modes import (  # noqa: E402
    GREEDY, LABELS, MODES, codes, config)
from test_torch_flat import config as flat_config  # noqa: E402
from test_torch_flat import inputs as flat_inputs  # noqa: E402
from test_torch_int8 import (  # noqa: E402
    _intercepting, _jax_variables, _np, _same_scales)
from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401
from test_torch_stage1_variants import _variant  # noqa: E402

B, N_TOP, D = 3, 16, 64
SP = dict(top_k_top=16, top_k_bot=16, temperature_top=0.95,
          temperature_bot=0.95)
# per spatial layer and position: the fused QKV, proj, mlp.0 and mlp.2
SPATIAL_GEMMS = 4
BF16_ULP = 2.0 ** -7     # bf16's relative spacing


def _jax_gemm(m, method):
    return method == '_fused_qkv_flat' or (
        method == '__call__' and isinstance(m, jax_layers.QuantizableDense))


@functools.cache
def _bf16_mode(mode):
    """The tiny two-stage model of a depth mode in bf16 on both sides with
    the same bf16 serving weights, and the port's int8 scales (KV from a
    sampling run, stage 2 from the forward on seeded codes), also given to
    JAX as its 'kv_scales' and 'act_scales' collections: (JAX model,
    variables with the scales, port model, port weights, port scales,
    (codes_t, bottom cells, labels))."""
    jm = jax_twostage.TwoStageModel(config(build_twostage_config, mode),
                                    dtype=jnp.bfloat16)
    variables = jax_twostage.serving_bf16_params(
        _jax_variables(jm, jax.random.PRNGKey(0)))
    weights = {s: twostage.serving_bf16_params(convert_variables(v))
               for s, v in variables.items()}
    tm = twostage.TwoStageModel(config(torch_config, mode),
                                dtype=torch.bfloat16, device='cpu')
    ct, cb, cells = codes(11)
    labels = torch.from_numpy(LABELS)
    scales = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(2),
                                    labels, SamplingParams(**SP))
    scales.update(tm.calibrate_stage2_int8(weights, torch.from_numpy(ct),
                                           torch.from_numpy(cb), labels))
    trees = export_scales(scales)
    variables['stage2'] = {**variables['stage2'],
                           'kv_scales': trees['stage2/kv_scales'],
                           'act_scales': trees['stage2/act_scales']}
    return jm, variables, tm, weights, scales, (ct, cells, LABELS)


# ------------------------------------- bidirectional and top2bot: int8max

@pytest.mark.parametrize('mode', list(MODES))
def test_int8_products_and_rows_match_jax(mode, monkeypatch):
    """JAX's int8max prefill and spatial step (HQT_INT8_STAGE2 and
    HQT_INT8_SPATIAL, inside its spatial scope) and then its depth sampler
    of the mode, as the JAX sampler runs it, op by op: every spatial gemm
    ran A8W8 and the port's module of the same name, in an int8max serving
    call, gives its output bit for bit; its K/V give JAX's int8 rows. Every
    depth gemm, head_bot's included, ran float in JAX, and the port's
    module gives its float output within 1 bf16 ulp (the float bf16 gemms
    of the two frameworks sum in another order), holding no int8 weight:
    the gemms the port quantizes are exactly JAX's spatial ones. The
    scales are the port's calibration's, given to JAX."""
    jm, v, tm, weights, scales, (ct, cells, labels) = _bf16_mode(mode)
    s2 = v['stage2']
    labels = jnp.asarray(labels)
    calls = []
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    monkeypatch.setenv('HQT_INT8_SPATIAL', '1')
    with fnn.intercept_methods(_intercepting(calls, _jax_gemm)):
        sos = jm.stage2.apply(s2, B, labels, method=JaxGPT.sos_tokens)
        kc = jnp.zeros((2, 24, B, D), jnp.int8)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.stage2.apply(s2, sos, kc, jnp.zeros_like(kc), 0,
                                        method=JaxGPT.spatial_step)
        x = jm.stage2.apply(s2, jnp.asarray(ct[:, 0]),
                            jnp.asarray(cells[:, 0]), jnp.zeros(B, jnp.int32),
                            method=JaxGPT.embed_cell_step)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.stage2.apply(s2, x, kc, vc, jnp.int32(1),
                                        method=JaxGPT.spatial_step)
        n_spatial = len(calls)
        jax_engine._DEPTH_SAMPLERS[mode](
            jm.stage2, s2, h[:, -1], jax.random.PRNGKey(5),
            jax_engine.SamplingParams(**SP))
    spatial, depth = calls[:n_spatial], calls[n_spatial:]
    assert len(spatial) == 2 * 2 * SPATIAL_GEMMS and len(depth) > 0

    model = tm.stage2
    tm.load_weights(weights)
    rows, ran, float_ran = {}, set(), set()
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        for int8, group in ((True, spatial), (False, depth)):
            for path, method, x, y in group:
                name = '.'.join(_segment(p) for p in path)
                xt = torch.from_numpy(np.array(_np(x))).bfloat16()
                mod = model.get_submodule(name)
                out = (mod.fused_qkv(xt, int8=int8)
                       if method == '_fused_qkv_flat' else mod(xt, int8=int8))
                np.testing.assert_allclose(out.float().numpy(), _np(y),
                                           rtol=0 if int8 else BF16_ULP,
                                           atol=0, err_msg=name)
                (ran if int8 else float_ran).add(name)
                if not (int8 and method == '_fused_qkv_flat'):
                    continue
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
        quantized = {n for n, m in model.named_modules()
                     if getattr(m, 'q8', None) is not None} | {
            n for n, m in model.named_modules()
            if isinstance(m, SelfAttention) and m.serving.qkv_q8 is not None}
    assert ran == quantized, sorted(ran ^ quantized)
    assert 'head_bot' in float_ran and not quantized & float_ran
    assert all(n.startswith('blocks.') for n in quantized)
    assert rows == {0: 2, 1: 2}


@pytest.mark.parametrize('mode', list(MODES))
def test_int8_sampler_serves_the_mode(mode):
    """The port's sampler in the mode under every switch JAX can run: in
    int8max the caches are int8 and exactly the spatial gemms run A8W8
    (4 a layer at the prefill and each of the 15 steps); with the depth
    gemms alone nothing changes (greedy codes equal to the float
    sampler's, no A8W8 gemm), as HQT_INT8_STAGE2 alone changes nothing in
    JAX's `bidirectional` and `top2bot` samplers."""
    _, _, tm, weights, scales, (_, _, labels) = _bf16_mode(mode)
    tm.load_weights(weights)
    labels = torch.from_numpy(labels)
    greedy = SamplingParams(**GREEDY)
    before = tracing.counter('int8.matmul_launches')
    (codes_t, codes_b), (kc, vc) = make_hierarchical_sampler(
        tm.stage2, N_TOP, greedy, q8.INT8MAX, scales, return_caches=True)(
            torch.Generator(), labels)
    assert kc.dtype == vc.dtype == torch.int8
    assert tracing.counter('int8.matmul_launches') - before == \
        2 * SPATIAL_GEMMS * N_TOP
    assert codes_t.shape == (B, N_TOP) and codes_b.shape == (B, N_TOP, 4)
    plain = make_hierarchical_sampler(tm.stage2, N_TOP, greedy)(
        torch.Generator(), labels)
    before = tracing.counter('int8.matmul_launches')
    depth_only = make_hierarchical_sampler(
        tm.stage2, N_TOP, greedy, q8.Int8Serving(depth_gemms=True),
        scales)(torch.Generator(), labels)
    assert tracing.counter('int8.matmul_launches') == before
    for a, b in zip(plain, depth_only):
        assert torch.equal(a, b)


@pytest.mark.parametrize('mode', list(MODES))
def test_calibrations_reduce_as_jax(mode):
    """f32, greedy: calibrate_kv_scales runs the mode's own sampler and
    reduces its caches as JAX's does (JAX's caches are its per-head
    layout here, the port's packed); calibrate_stage2_int8 runs the mode's
    teacher-forced forward: the same modules (head_bot and the depth
    blocks among them, as JAX records them) and scales, within rtol 1e-5
    (f32 sums in another order)."""
    jm = jax_twostage.TwoStageModel(config(build_twostage_config, mode))
    variables = _jax_variables(jm, jax.random.PRNGKey(3))
    weights = {s: convert_variables(v) for s, v in variables.items()}
    tm = twostage.TwoStageModel(config(torch_config, mode), device='cpu')
    ref = jm.calibrate_kv_scales(variables, jax.random.PRNGKey(0),
                                 jnp.asarray(LABELS),
                                 jax_engine.SamplingParams(**GREEDY))
    ours = tm.calibrate_kv_scales(weights, torch.Generator(),
                                  torch.from_numpy(LABELS),
                                  SamplingParams(**GREEDY))
    _same_scales(ours['stage2/kv_scales'], ref['stage2']['kv_scales'],
                 'stage2/kv_scales', rtol=1e-5)
    ct, cb, _ = codes(8)
    ref = jm.calibrate_stage2_int8(variables, jnp.asarray(ct),
                                   jnp.asarray(cb), jnp.asarray(LABELS))
    ours = tm.calibrate_stage2_int8(weights, torch.from_numpy(ct),
                                    torch.from_numpy(cb),
                                    torch.from_numpy(LABELS))
    _same_scales(ours['stage2/act_scales'], ref['stage2']['act_scales'],
                 'stage2/act_scales', rtol=1e-5)
    assert 'head_bot' in ours['stage2/act_scales']
    assert any(n.startswith('depths.') for n in ours['stage2/act_scales'])


# ------------------------------------------------ flat baselines: int8 KV

FLAT = ('igpt-class', 'transformer1d')


@functools.cache
def _bf16_flat(case):
    """A flat baseline in bf16 on both sides with the same bf16 weights,
    and the port's KV scales from a float sampling run (`_flat_kv_scales`,
    the reduction of `calibrate_kv_scales`): (JAX model, its variables with
    those scales as its 'kv_scales' collection, port model, port scales,
    (codes, conditioning))."""
    jm = jax_twostage.build_stage2(flat_config(build_twostage_config, case),
                                   dtype=jnp.bfloat16)
    args = flat_inputs(case, 0)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    v = jax_twostage.serving_bf16_params({'stage2': v})['stage2']
    tm = twostage.build_stage2(flat_config(torch_config, case),
                               torch.bfloat16).eval()
    tm.load_state_dict(twostage.serving_bf16_params(convert_variables(v)),
                       strict=True)
    cond = torch.from_numpy(args[1])
    n = args[0].shape[1]
    scales = twostage._flat_kv_scales(tm, torch.Generator().manual_seed(4),
                                      cond, n, top_k=8)
    kv = export_scales(scales)['stage2/kv_scales']
    return jm, {**v, 'kv_scales': kv}, tm, scales, args


@pytest.mark.parametrize('case', FLAT)
def test_flat_int8_rows_match_jax(case):
    """JAX's `decode_step` of the flat model on int8 packed caches with the
    port's scales: its prefill (the sos token, or the 16-token prefix) and
    one step, op by op. The port's quantizer with its serving scales turns
    JAX's K/V (its fused QKV's output) into JAX's int8 cache rows bit for
    bit, and the port's float fused QKV gives that output within 1 bf16
    ulp (the two frameworks' bf16 gemms sum in another order)."""
    jm, v, tm, scales, (img, cond) = _bf16_flat(case)
    M = type(jm)
    L = tm.hparams.n_layers
    calls = []
    with fnn.intercept_methods(_intercepting(
            calls, lambda m, method: method == '_fused_qkv_flat')):
        if case == 'transformer1d':
            x = jm.apply(v, jnp.asarray(cond), method=M.embed_texts)
        else:
            x = jm.apply(v, B, jnp.asarray(cond), method=M.sos_tokens)
        sos_len = x.shape[1]
        kc = jnp.zeros((L, sos_len + 8, B, D), jnp.int8)
        _, kc, vc = jm.apply(v, x, kc, jnp.zeros_like(kc), 0,
                             method=M.decode_step)
        x = jm.apply(v, jnp.asarray(img[:, 0]), jnp.zeros(B, jnp.int32),
                     method=M.embed_step)
        _, kc, vc = jm.apply(v, x, kc, vc, jnp.int32(sos_len),
                             method=M.decode_step)
    assert len(calls) == 2 * L
    rows = {}
    with torch.inference_mode(), tm.serving(q8.Int8Serving(kv_cache=True),
                                            scales):
        for path, _, x, y in calls:
            name = '.'.join(_segment(p) for p in path)
            attn = tm.get_submodule(name)
            xt = torch.from_numpy(np.array(_np(x))).bfloat16()
            np.testing.assert_allclose(attn.fused_qkv(xt).float().numpy(),
                                       _np(y), rtol=BF16_ULP, atol=0,
                                       err_msg=name)
            layer, T = int(name.split('.')[1]), xt.shape[1]
            row = rows.get(layer, 0)
            _, _, inv_k, inv_v = attn.serving.kv_scales
            k, vv = torch.from_numpy(np.array(_np(y))).bfloat16().split(
                D, -1)[1:]
            for got, cache in ((q8.quantize_rows(k, inv_k), kc),
                               (q8.quantize_rows(vv, inv_v), vc)):
                np.testing.assert_array_equal(
                    got.transpose(0, 1).numpy(),
                    np.asarray(cache)[layer, row:row + T])
            rows[layer] = row + T
    assert rows == {i: sos_len + 1 for i in range(L)}


@pytest.mark.parametrize('case', FLAT)
def test_flat_samplers_take_the_int8_cache_alone(case):
    """make_igpt_sampler / make_txt2img_sampler with the int8 KV cache run
    on int8 caches and give codes in range; any gemm switch raises a
    ValueError naming the model (JAX's flat samplers enter no int8 scope);
    the cache without its scales raises as in JAX."""
    _, _, tm, scales, (img, cond) = _bf16_flat(case)
    make = make_txt2img_sampler if case == 'transformer1d' else \
        make_igpt_sampler
    n = img.shape[1]
    cond = torch.from_numpy(cond)
    kv = q8.Int8Serving(kv_cache=True)
    out = make(tm, n, top_k=8, int8=kv, scales=scales)(
        torch.Generator().manual_seed(1), cond)
    assert out.shape == (B, n) and 0 <= int(out.min()) and \
        int(out.max()) < 64
    _, (kc, _) = twostage._flat_sampler(tm, n, 8, None, 1.0, kv, scales,
                                        return_caches=True)(
        torch.Generator(), cond)
    assert kc.dtype == torch.int8
    name = type(tm).__name__
    for mode in (q8.INT8MAX, q8.Int8Serving(depth_gemms=True)):
        with pytest.raises(ValueError, match=name):
            make(tm, n, int8=mode, scales=scales)
    with pytest.raises(ValueError, match='calibrate_kv_scales'):
        make(tm, n, int8=kv)(torch.Generator(), cond)


def test_flat_kv_scales_reduce_the_float_run():
    """`_flat_kv_scales` is `calibrate_kv_scales`' reduction of the float
    sampler's final caches: per layer and channel, max(absmax, 1e-6) / 127
    over every row and sample, the prefix's included."""
    _, _, tm, scales, (img, cond) = _bf16_flat('transformer1d')
    n = img.shape[1]
    _, (kc, vc) = twostage._flat_sampler(
        tm, n, 8, None, 1.0, q8.Int8Serving(), None, return_caches=True)(
            torch.Generator().manual_seed(4), torch.from_numpy(cond))
    for which, c in zip('kv', (kc, vc)):
        want = torch.clamp_min(c.float().abs().amax(dim=(1, 2)), 1e-6) / 127
        for i in range(c.shape[0]):
            assert torch.equal(
                scales['stage2/kv_scales'][f'blocks.{i}.attn.{which}'],
                want[i])


# ------------------------------------------------ the iGPT pixel sampler

def test_igpt_pixel_sampler_int8(tmp_path):
    """make_pixel_sampler_igpt with the int8 KV cache and the A8W8 decode
    (bf16): pixels in [0, 1] from int8 caches and int8 convolutions, the
    decode scales calibrated on the top-only maps (the bottom None) with
    the names and, in f32, the values of JAX's calibrate_int8_decode on
    the same maps (rtol 1e-5: f32 convolutions sum in another order)."""
    case = 'igpt-class'
    cfg = flat_config(torch_config, case)
    jm = jax_twostage.TwoStageModel(flat_config(build_twostage_config,
                                                case))
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    args = flat_inputs(case, 0)
    variables = {'stage1': jax.jit(jm.stage1.init)(
        k1, jnp.zeros((1, 32, 32, 3))), 'stage2': jax.jit(jm.stage2.init)(
            k2, *map(jnp.asarray, args))}
    maps = np.random.RandomState(3).randint(0, 64, (5, 4, 4)).astype(
        np.int32)
    ref = jm.calibrate_int8_decode(variables, jnp.asarray(maps), None)
    tm = twostage.TwoStageModel(cfg, device='cpu')
    weights = {s: convert_variables(v) for s, v in variables.items()}
    ours = tm.calibrate_int8_decode(weights, torch.from_numpy(maps), None,
                                    chunk=2)
    _same_scales(ours['stage1/act_scales'], ref['stage1']['act_scales'],
                 'stage1/act_scales', rtol=1e-5)

    bf = twostage.TwoStageModel(cfg, dtype=torch.bfloat16, device='cpu')
    w16 = {s: twostage.serving_bf16_params(w) for s, w in weights.items()}
    labels = torch.from_numpy(args[1])
    bf.load_weights(w16)
    scales = twostage._flat_kv_scales(bf.stage2, torch.Generator(), labels,
                                      N_TOP, top_k=8)
    scales.update(bf.calibrate_int8_decode(w16, torch.from_numpy(maps),
                                           None))
    before = tracing.counter('int8.conv2d_launches')
    px, out = bf.make_pixel_sampler_igpt(
        top_k=8, int8=q8.Int8Serving(kv_cache=True, decode_convs=True),
        scales=scales)(w16, torch.Generator().manual_seed(2), labels)
    assert tracing.counter('int8.conv2d_launches') > before
    assert px.shape == (B, 32, 32, 3) and out.shape == (B, N_TOP)
    assert bool(torch.isfinite(px).all()) and 0 <= float(px.min()) and \
        float(px.max()) <= 1
    with pytest.raises(ValueError, match='IGPT'):
        bf.make_pixel_sampler_igpt(int8=q8.INT8MAX, scales=scales)


# --------------------------------------- the int8 decode's set of convs

GENERATORS = ('simrqgan2_nearest', 'hqvae3_conv2', 'vqgan2_deconv2d_concat',
              'vqgan2_nearest_sum', 'vqgan')


@pytest.mark.parametrize('name', GENERATORS)
def test_int8_decode_quantizes_every_jax_quantizable_conv(name):
    """`int8_decode` quantizes exactly the convolutions JAX builds as
    `QuantizableConv` (every one its `conv()` makes: the encoder's, its
    stride-2 downsamples and `conv_in`, the decoder's, VQGAN2's
    `decoder_top`), which JAX's `int8_decode_scope` switches, keyed by
    their full names; VQGAN2's `upsample_t` and every 1x1 quant conv are
    plain convs in JAX and stay float."""
    cfg = _variant(build_twostage_config('configs/tiny/stage2-tiny.yaml')
                   .stage1, name)
    tcfg = _variant(torch_config('configs/tiny/stage2-tiny.yaml').stage1,
                    name)
    calls = []
    with fnn.intercept_methods(_intercepting(
            calls, lambda m, method: isinstance(m, QuantizableConv))):
        jax.eval_shape(jgen.build_generator(cfg).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)))
    jax_convs = {'.'.join(_segment(p) for p in path)
                 for path, _, _, _ in calls}
    gen = tgen.build_generator(tcfg, torch.bfloat16)
    gen.load_state_dict(twostage.random_state(gen, torch.Generator()))
    with gen.int8_decode({}):
        ours = {n for n, m in gen.named_modules()
                if getattr(m, 'q8', None) is not None}
    assert ours == jax_convs
    assert ours == {n for n, m in gen.named_modules()
                    if isinstance(m, QuantizableConv2d)}
    assert any(n.startswith('encoder.') for n in ours)
    if name.startswith('vqgan2'):
        assert any(n.startswith('decoder_top.') for n in ours)
        assert not any(n.startswith('upsample_t') for n in ours)
    assert all(getattr(m, 'q8', None) is None for m in gen.modules())
