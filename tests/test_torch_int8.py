"""int8max serving in the PyTorch port against the JAX package, on the tiny
config: the quantizers and the A8W8 Linear and conv, decode attention's
int8 variant (its plain version), SelfAttention's step and prefill on int8
caches, the teacher-forced scorer end to end with JAX's calibrated scales,
the calibration functions, the scales artifact, and what raises.

The JAX side runs as its own tests run it: bf16 models with
`serving_bf16_params`, attention='packed' (the XLA oracle of the decode
attention kernel on the CPU, and the Pallas kernel in interpret mode where
named), the HQT_INT8_* switches set with monkeypatch inside the JAX
package's scopes. Inputs come from numpy seeds; each test states its
tolerance.
"""

import pickle
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip('torch')
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import (  # noqa: E402
    conv as jax_conv, int8_decode_scope)
from hqtransformer_tpu.models.stage2 import layers as jax_layers  # noqa: E402
from hqtransformer_tpu.models.stage2.hierarchical import \
    cells_to_raster as jax_cells_to_raster  # noqa: E402
from hqtransformer_tpu.ops.pallas_attention import (  # noqa: E402
    decode_attention_step, decode_attention_step_xla)
from hqtransformer_tpu.sampling.engine import \
    SamplingParams as JaxParams  # noqa: E402
from hqtransformer_tpu.sampling.engine import \
    make_hierarchical_scorer as jax_scorer  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (  # noqa: E402
    convert_scales, convert_variables, export_scales)
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.layers import \
    QuantizableConv2d  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.layers import (  # noqa: E402
    QuantizableLinear, SelfAttention)
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.ops.decode_attention import \
    decode_attention_step_plain  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    SamplingParams, _depth_chain, _draws, make_hierarchical_sampler,
    make_hierarchical_scorer)

CFG = 'configs/tiny/stage2-tiny.yaml'
BF16_ULP = 2.0 ** -7     # bf16's relative spacing


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------ quantizers, Linear, conv

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_quantizers_match_jax(dtype):
    """Same inputs and scales: every int8 tensor and weight scale equal."""
    rng = np.random.RandomState(0)
    x = rng.randn(37, 96).astype(np.float32) * 3
    w = rng.randn(96, 40).astype(np.float32) * 0.1     # JAX [I, O]
    if dtype == 'bf16':
        (tx, jx), (tw, jw) = _bf16(x), _bf16(w)
    else:
        tx, jx, tw, jw = _t(x), jnp.asarray(x), _t(w), jnp.asarray(w)
    s = float(np.abs(x).max() / 127 * 0.7)             # saturates some
    np.testing.assert_array_equal(
        q8.quant_per_tensor(tx, torch.tensor(s)).numpy(),
        np.asarray(jax_layers._quant_per_tensor(jx, jnp.float32(s))))
    wq, ws = q8.quant_weight(tw.T)                      # port [O, I]
    jwq, jws = jax_layers._quant_weight_cols(jw)
    np.testing.assert_array_equal(wq.T.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    inv = 1.0 / _t(np.abs(x).max(0) / 127)
    np.testing.assert_array_equal(
        q8.quantize_rows(tx, inv).numpy(),
        np.asarray(jax_layers._quantize_rows(jx, jnp.asarray(inv.numpy()))))


def test_int8_linear_matches_jax(monkeypatch):
    """QuantizableDense under HQT_INT8_STAGE2 against QuantizableLinear
    with int8=True: the int32 accumulators equal; the bf16 outputs equal,
    or 1 bf16 ulp apart where XLA fuses the f32 dequantization's multiply
    and add into one rounding."""
    rng = np.random.RandomState(1)
    M, I, O = 20, 64, 48
    x = rng.randn(M, I).astype(np.float32)
    kernel = rng.randn(I, O).astype(np.float32) * 0.1
    bias = rng.randn(O).astype(np.float32) * 0.1
    tx, jx = _bf16(x)
    tk, jk = _bf16(kernel)
    scale = float(np.abs(x).max() / 127)
    dense = jax_layers.QuantizableDense(O, dtype=jnp.bfloat16)
    variables = {'params': {'kernel': jk, 'bias': jnp.asarray(bias)},
                 'act_scales': {'scale': jnp.float32(scale)}}
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with jax_layers.int8_stage2_scope():
        ref = _np(dense.apply(variables, jx))

    lin = QuantizableLinear(I, O)
    lin.load_state_dict({'weight': tk.T.contiguous(), 'bias': _t(bias)},
                        assign=True)
    lin.q8 = q8.Int8Weight.from_float(lin.weight, lin.bias,
                                      torch.tensor(scale))
    out = lin(tx, int8=True)
    assert out.dtype == torch.bfloat16
    xq = q8.quant_per_tensor(tx, torch.tensor(scale))
    acc = q8.int_mm(xq, lin.q8.wq)
    jacc = jax.lax.dot_general(
        jax_layers._quant_per_tensor(jx, jnp.float32(scale)),
        jax_layers._quant_weight_cols(jk)[0], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_ULP,
                               atol=0)
    assert q8.int8_matmul.launches > 0


@pytest.mark.parametrize('kernel,static', [(3, True), (3, False), (1, True)])
def test_int8_conv_matches_jax(monkeypatch, kernel, static):
    """JAX QuantizableConv under HQT_INT8_DECODE (static or dynamic scale)
    against QuantizableConv2d with its quantized weight: int32 products
    equal (checked through the im2col); bf16 outputs equal or 1 ulp apart,
    for the reason of test_int8_linear_matches_jax."""
    rng = np.random.RandomState(2 + kernel)
    B, H, C, O = 2, 9, 16, 24
    x = rng.randn(B, H, H, C).astype(np.float32)          # NHWC
    w = rng.randn(kernel, kernel, C, O).astype(np.float32) * 0.1   # HWIO
    b = rng.randn(O).astype(np.float32) * 0.1
    tx, jx = _bf16(x)
    tw, jw = _bf16(w)
    scale = float(np.abs(x).max() / 127 * 0.9)
    mod = jax_conv(O, kernel, dtype=jnp.bfloat16)
    variables = {'params': {'kernel': jw, 'bias': jnp.asarray(b)}}
    if static:
        variables['act_scales'] = {'scale': jnp.float32(scale)}
    monkeypatch.setenv('HQT_INT8_DECODE', '1')
    with int8_decode_scope():
        ref = _np(mod.apply(variables, jx)).transpose(0, 3, 1, 2)

    conv = QuantizableConv2d(C, O, kernel, padding=kernel // 2)
    conv.load_state_dict({'weight': tw.permute(3, 2, 0, 1).contiguous(),
                          'bias': _t(b)}, assign=True)
    conv.q8 = q8.Int8Weight.from_float(
        conv.weight, conv.bias, torch.tensor(scale) if static else None)
    out = conv(tx.permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16 and out.shape == (B, O, H, H)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_ULP,
                               atol=0)
    # the int32 products alone: a zero bias and unit scales would lose
    # them to rounding, so compare the exact im2col product with XLA's conv
    xs = torch.tensor(scale) if static else q8.scale_from_absmax(
        q8.absmax(tx))
    xq = q8.quant_per_tensor(tx, xs)
    jq = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(
            conv.q8.wq[:O, :kernel * kernel * C].reshape(
                O, kernel, kernel, C).permute(1, 2, 3, 0).numpy()),
        (1, 1), [(kernel // 2, kernel // 2)] * 2,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    pad = kernel // 2
    xp = torch.nn.functional.pad(xq, (0, 0, pad, pad, pad, pad))
    cols = torch.cat([xp[:, i:i + H, j:j + H] for i in range(kernel)
                      for j in range(kernel)], dim=-1).reshape(B * H * H, -1)
    acc = q8.int_mm(cols, conv.q8.wq[:, :cols.shape[1]])[:, :O]
    np.testing.assert_array_equal(acc.reshape(B, H, H, O).numpy(),
                                  np.asarray(jq))


# ------------------------------------------------ K1's int8 variant (plain)

@pytest.mark.parametrize('layer,pos', [(0, 3), (1, 17), (0, 31)])
def test_decode_attention_int8_plain_matches_jax(layer, pos):
    """int8 caches, f32 q, int8 new rows: caches equal to both JAX
    functions'; y within atol and rtol 2e-4 of the XLA oracle and of the
    Pallas kernel in interpret mode (test_int8_kv.py's bound). With a bf16
    q: y within 1 bf16 ulp of the oracle (both sum in f32, then round),
    and within 2.0 + 1 bf16 ulp of the TPU kernel, which rounds its
    products and weights to bf16: 1.0 is one bf16 ulp of the values'
    range, |v| <= 127, and two such roundings can add."""
    B, T, D, NH, L = 32, 32, 256, 4, 2
    rng = np.random.RandomState(pos)
    kc, vc = (rng.randint(-127, 128, (L, T, B, D)).astype(np.int8)
              for _ in range(2))
    kn, vn = (rng.randint(-127, 128, (B, D)).astype(np.int8)
              for _ in range(2))
    q = (rng.randn(B, D) * 0.05).astype(np.float32)
    for bf16 in (False, True):
        tq, jq = _bf16(q) if bf16 else (_t(q), jnp.asarray(q))
        args = (jq, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
                jnp.asarray(vc), layer, pos, NH)
        y_xla, kc_xla, vc_xla = decode_attention_step_xla(*args)
        y_pl, kc_pl, vc_pl = decode_attention_step(*args, block_b=32,
                                                   interpret=True)
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        y = decode_attention_step_plain(tq, torch.from_numpy(kn),
                                        torch.from_numpy(vn), tk, tv, layer,
                                        pos, NH)
        assert y.dtype == tq.dtype
        for ref_k, ref_v in ((kc_xla, vc_xla), (kc_pl, vc_pl)):
            np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
        if bf16:
            np.testing.assert_allclose(y.float().numpy(), _np(y_xla),
                                       rtol=BF16_ULP, atol=0)
            np.testing.assert_allclose(y.float().numpy(), _np(y_pl),
                                       rtol=BF16_ULP, atol=2.0)
        else:
            for ref in (y_xla, y_pl):
                np.testing.assert_allclose(y.numpy(), np.asarray(ref),
                                           atol=2e-4, rtol=2e-4)


def test_decode_attention_int8_dtype_rules():
    """int8 caches take int8 new rows and a float q; float caches keep
    one dtype throughout."""
    from hqtransformer_tpu_torch.ops.decode_attention import _check
    L, T, B, D, nh = 2, 8, 4, 128, 4
    kc = torch.zeros(L, T, B, D, dtype=torch.int8)
    rows = torch.zeros(B, D, dtype=torch.int8)
    for q_dtype in (torch.float32, torch.bfloat16):
        _check(torch.zeros(B, D, dtype=q_dtype), rows, rows, kc, kc.clone(),
               1, 3, nh)
    with pytest.raises(TypeError, match='new rows'):
        decode_attention_step_plain(torch.zeros(B, D), rows.float(), rows,
                                    kc, kc.clone(), 1, 3, nh)
    with pytest.raises(TypeError, match='new rows'):
        decode_attention_step_plain(rows, rows, rows, kc, kc.clone(), 1, 3,
                                    nh)
    fc = torch.zeros(L, T, B, D)
    with pytest.raises(TypeError, match='new rows'):
        decode_attention_step_plain(torch.zeros(B, D), rows, rows, fc,
                                    fc.clone(), 1, 3, nh)


# ------------------------------------- SelfAttention step/prefill, int8 KV

def _attention_pair(int8_qkv):
    """A bf16 JAX SelfAttention (bf16 kernels, f32 biases) with kv_scales
    and the query's and proj's act scales, and the port's with the same
    weights and serving state (A8W8 QKV and proj when `int8_qkv`).
    Returns (jax module, variables, port module)."""
    D, NH = 128, 4
    rng = np.random.RandomState(5)
    jm = jax_layers.SelfAttention(embed_dim=D, n_heads=NH,
                                  dtype=jnp.bfloat16)
    params = {}
    for name in ('query', 'key', 'value', 'proj'):
        params[name] = {
            'kernel': jnp.asarray(rng.randn(D, D).astype(np.float32) *
                                  D ** -0.5).astype(jnp.bfloat16),
            'bias': jnp.asarray(rng.randn(D).astype(np.float32) * 0.05)}
    k_s = (np.abs(rng.randn(D)) * 0.02 + 0.01).astype(np.float32)
    v_s = (np.abs(rng.randn(D)) * 0.02 + 0.01).astype(np.float32)
    variables = {'params': params,
                 'kv_scales': {'k': jnp.asarray(k_s), 'v': jnp.asarray(v_s)},
                 'act_scales': {'query': {'scale': jnp.float32(0.03)},
                                'proj': {'scale': jnp.float32(0.05)}}}
    tm = SelfAttention(D, NH)
    tm.load_state_dict(convert_variables({'params': params}), assign=True)
    tm.load_state_dict({k: v.bfloat16() if v.dim() == 2 else v
                        for k, v in tm.state_dict().items()}, assign=True)
    scales = convert_scales({'stage2/kv_scales': {'attn': {
        'k': k_s, 'v': v_s}}, 'stage2/act_scales': {'attn': {
            'query': {'scale': np.float32(0.03)},
            'proj': {'scale': np.float32(0.05)}}}})
    act = scales['stage2/act_scales']
    tm.serving = tm.prepare_serving(torch.bfloat16,
                                    act if int8_qkv else None,
                                    scales['stage2/kv_scales'], 'attn')
    if int8_qkv:
        tm.proj.q8 = q8.Int8Weight.from_float(tm.proj.weight, tm.proj.bias,
                                              act['attn.proj'])
    return jm, variables, tm


def _rows_agree(ours, ref, exact):
    ours, ref = ours.numpy().astype(np.int32), np.asarray(ref, np.int32)
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        diff = np.abs(ours - ref)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.995, (
            diff.max(), (diff == 0).mean())


def _bits(t):
    return t.view(torch.int16).int()


def _rows_explained(tm, x, jax_qkv, written):
    """The witness for the float QKV's off-by-one rows. The port's gemm
    with its bias rounded once (torch's addmm) and then, as XLA does, the
    product and the bias sum rounded each: the latter gives JAX's bf16 K
    and V (its fused QKV's output) bit for bit. Those through the port's
    quantizer give JAX's int8 rows exactly, and a row differs only where
    its input does. `written` holds (port rows, JAX rows) for K and V,
    laid out as x's leading dims. Returns the count of rows that differ."""
    C = x.shape[-1]
    w, b = tm.serving.qkv
    ours = F.linear(x, w, b).split(C, dim=-1)[1:]
    twice = (F.linear(x, w) + b).split(C, dim=-1)[1:]
    ref = torch.from_numpy(np.array(_np(jax_qkv))).bfloat16().reshape(
        ours[0].shape[:-1] + (3 * C,)).split(C, dim=-1)[1:]
    _, _, inv_k, inv_v = tm.serving.kv_scales
    moved = 0
    for (rows, ref_rows), o, t, r, inv in zip(written, ours, twice, ref,
                                              (inv_k, inv_v)):
        ref_rows = np.asarray(ref_rows)
        assert torch.equal(t, r)
        np.testing.assert_array_equal(q8.quantize_rows(r, inv).numpy(),
                                      ref_rows)
        differ = rows.numpy() != ref_rows
        assert not differ[(o == r).numpy()].any()
        moved += int(differ.sum())
    return moved


@pytest.mark.parametrize('int8_qkv', [True, False])
def test_step_and_prefill_int8_cache_match_jax(monkeypatch, int8_qkv):
    """step_packed / prefill_packed on int8 caches against SelfAttention.
    step / prefill: with the A8W8 QKV (HQT_INT8_STAGE2, the query's scale)
    the int8 rows are equal; with the float QKV >= 99.5% of them are
    (measured 99.8%) and the rest are 1 apart. The cause, witnessed by
    _rows_explained: the bf16 gemm rounds once (torch's addmm) where XLA
    rounds the product and then the bias sum, so a K or V entry may be a
    bf16 rounding step from JAX's, up to a fifth of an int8 step at these
    scales, which now and then crosses a rounding boundary of the
    quantizer.
    Outputs within atol 0.05 + 2% (bf16 activations up to ~6 in size, a
    few ulps of which also pass through the proj gemm)."""
    from flax import linen as fnn
    jm, variables, tm = _attention_pair(int8_qkv)
    if int8_qkv:
        monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    calls = []

    def intercept():
        return fnn.intercept_methods(_intercepting(
            calls, lambda m, method: method == '_fused_qkv_flat'))
    L, T, B, D, pos = 2, 16, 8, 128, 5
    rng = np.random.RandomState(6)
    kc = rng.randint(-127, 128, (L, T, B, D)).astype(np.int8)
    vc = rng.randint(-127, 128, (L, T, B, D)).astype(np.int8)
    kc[:, pos:] = 0
    vc[:, pos:] = 0
    tx, jx = _bf16(rng.randn(B, 1, D))
    with jax_layers.int8_stage2_scope(), intercept():
        y_ref, jk, jv = jm.apply(
            variables, jx, jnp.asarray(kc), jnp.asarray(vc), 1,
            jnp.int32(pos), method=jax_layers.SelfAttention.step_packed)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y = tm.step(tx, tk, tv, 1, pos, int8=int8_qkv)
    _rows_agree(tk, jk, int8_qkv)
    _rows_agree(tv, jv, int8_qkv)
    np.testing.assert_allclose(y.float().numpy(), _np(y_ref), atol=0.05,
                               rtol=0.02)
    moved = 0
    if not int8_qkv:
        moved += _rows_explained(tm, tx[:, 0], calls[-1][3], (
            (tk[1, pos], jk[1, pos]), (tv[1, pos], jv[1, pos])))

    px, jpx = _bf16(rng.randn(B, 3, D))
    zeros = np.zeros((L, T, B, D), np.int8)
    with jax_layers.int8_stage2_scope(), intercept():
        y_ref, jk, jv = jm.apply(
            variables, jpx, jnp.asarray(zeros), jnp.asarray(zeros), 0,
            method=jax_layers.SelfAttention.prefill_packed)
    tk, tv = torch.from_numpy(zeros.copy()), torch.from_numpy(zeros.copy())
    y = tm.prefill(px, tk, tv, 0, int8=int8_qkv)
    _rows_agree(tk, jk, int8_qkv)
    _rows_agree(tv, jv, int8_qkv)
    np.testing.assert_allclose(y.float().numpy(), _np(y_ref), atol=0.05,
                               rtol=0.02)
    if not int8_qkv:
        moved += _rows_explained(tm, px, calls[-1][3], (
            (tk[0, :3].transpose(0, 1), np.asarray(jk)[0, :3].swapaxes(0, 1)),
            (tv[0, :3].transpose(0, 1), np.asarray(jv)[0, :3].swapaxes(0, 1))))
        assert moved > 0     # the float QKV's case does arise here


# --------------------------------------- the whole model: scales, scorer

def _jax_variables(jm, key):
    """TwoStageModel.init_variables, with each stage's init jitted."""
    k1, k2 = jax.random.split(key)
    res = jm.config.dataset.image_resolution
    n_top = jm.top_res * jm.top_res
    v1 = jax.jit(jm.stage1.init)(k1, jnp.zeros((1, res, res, 3), jm.dtype))
    v2 = jax.jit(jm.stage2.init)(k2, jnp.zeros((1, n_top), jnp.int32),
                                 jnp.zeros((1, n_top * jm.ratio), jnp.int32),
                                 jnp.zeros((1,), jnp.int32))
    return {'stage1': v1, 'stage2': v2}


@pytest.fixture(scope='module')
def bf16_models():
    """The tiny two-stage model in bf16 on both sides with the same bf16
    serving weights, and JAX's int8 scales from its own calibration (KV
    from a JAX sampling run, the rest on seeded codes): (JAX model,
    variables with the scale collections, port model, port weights, the
    codes and labels)."""
    jm = jax_twostage.TwoStageModel(build_twostage_config(CFG),
                                    dtype=jnp.bfloat16)
    variables = jax_twostage.serving_bf16_params(
        _jax_variables(jm, jax.random.PRNGKey(0)))
    weights = {s: twostage.serving_bf16_params(convert_variables(v))
               for s, v in variables.items()}
    tm = twostage.TwoStageModel(torch_config(CFG), dtype=torch.bfloat16,
                                device='cpu')
    labels = jnp.asarray([1, 3, 5, 7], jnp.int32)
    sp = JaxParams(top_k_top=16, top_k_bot=16, temperature_top=0.95,
                   temperature_bot=0.95)
    rng = np.random.RandomState(11)
    ct = jnp.asarray(rng.randint(0, 256, (4, 16)), jnp.int32)
    cb = jnp.asarray(rng.randint(0, 256, (4, 16, 4)), jnp.int32)
    cb_raster = jax_cells_to_raster(cb, 4, 2)
    v = jm.calibrate_kv_scales(variables, jax.random.PRNGKey(2), labels, sp)
    v = jm.calibrate_stage2_int8(v, ct, cb_raster.reshape(4, -1), labels)
    v = jm.calibrate_int8_decode(v, ct.reshape(-1, 4, 4),
                                 cb_raster.reshape(-1, 8, 8))
    codes = (np.asarray(ct), np.asarray(cb), np.asarray(labels))
    return jm, v, tm, weights, codes


def test_jax_artifact_loads_and_round_trips(bf16_models, tmp_path):
    """A JAX-written artifact loads in the port with every scale equal and
    named after a port module; the port's own save/load round trip is
    bit-exact and writes the JAX format, which the JAX loader reads."""
    jm, v, tm, _, _ = bf16_models
    path = str(tmp_path / 'jax.pkl')
    jax_twostage.save_serving_scales(v, path)
    scales = twostage.load_serving_scales(path)
    assert sorted(scales) == ['stage1/act_scales', 'stage2/act_scales',
                              'stage2/kv_scales']
    modules = {**{f'{n}': m for n, m in tm.stage1.named_modules()},
               **{f'{n}': m for n, m in tm.stage2.named_modules()}}
    for key, coll in scales.items():
        for name, t in coll.items():
            owner = name.rsplit('.', 1)[0] if key.endswith('kv_scales') \
                else name
            assert owner in modules, (key, name)
            assert t.dtype == torch.float32
    with open(path, 'rb') as f:
        raw = pickle.load(f)
    for key in raw:
        want = jax.tree_util.tree_leaves_with_path(raw[key])
        got = jax.tree_util.tree_leaves_with_path(export_scales(
            {key: scales[key]})[key])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (_, a), (_, b) in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b)
    mine = str(tmp_path / 'port.pkl')
    twostage.save_serving_scales(scales, mine)
    again = twostage.load_serving_scales(mine)
    for key, coll in scales.items():
        assert sorted(again[key]) == sorted(coll)
        for name, t in coll.items():
            assert torch.equal(again[key][name], t)
    back = jax_twostage.load_serving_scales(
        {'stage1': {}, 'stage2': {}}, mine)
    for stage, coll in (('stage1', 'act_scales'), ('stage2', 'kv_scales'),
                        ('stage2', 'act_scales')):
        for a, b in zip(jax.tree.leaves(v[stage][coll]),
                        jax.tree.leaves(back[stage][coll])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_partial_scale_collections_stay_partial(tmp_path):
    scales = {'stage2/kv_scales': {'blocks.0.attn.k': torch.ones(4),
                                   'blocks.0.attn.v': torch.ones(4)}}
    path = str(tmp_path / 's.pkl')
    twostage.save_serving_scales(scales, path)
    out = twostage.load_serving_scales(path)
    assert list(out) == ['stage2/kv_scales']
    with open(path, 'rb') as f:
        assert list(pickle.load(f)) == ['stage2/kv_scales']
    with pytest.raises(ValueError, match='collection'):
        convert_scales({'stage2/params': {}})


# The stage-2 serving modes the JAX package can run (its spatial gemms come
# only with the depth ones), each with its HQT_INT8_* switches.
STAGE2_MODES = {
    'kv_cache': q8.Int8Serving(kv_cache=True),
    'depth_gemms': q8.Int8Serving(depth_gemms=True),
    'kv_cache+depth_gemms': q8.Int8Serving(kv_cache=True, depth_gemms=True),
    'depth+spatial_gemms': q8.Int8Serving(depth_gemms=True,
                                          spatial_gemms=True),
    'int8max': q8.INT8MAX,
}


def _score_jax(jm, variables, codes, mode, monkeypatch):
    ct, cb, labels = codes
    if mode.depth_gemms:
        monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    if mode.spatial_gemms:
        monkeypatch.setenv('HQT_INT8_SPATIAL', '1')
    try:
        fn = jax_scorer(jm.stage2, 16,
                        cache_dtype=jnp.int8 if mode.kv_cache else None,
                        attention='packed')
        lt, lb = fn(variables['stage2'], jnp.asarray(labels),
                    jnp.asarray(ct), jnp.asarray(cb))
        return _np(lt), _np(lb)
    finally:
        monkeypatch.delenv('HQT_INT8_STAGE2', raising=False)
        monkeypatch.delenv('HQT_INT8_SPATIAL', raising=False)


@pytest.fixture(scope='module')
def bf16_scores(bf16_models, tmp_path_factory):
    """JAX's scales carried across by the artifact and convert_scales, and
    the bf16 scorer's logits on both sides: (scales, JAX's, the port's)."""
    jm, v, tm, weights, codes = bf16_models
    path = str(tmp_path_factory.mktemp('scales') / 'jax.pkl')
    jax_twostage.save_serving_scales(v, path)
    scales = twostage.load_serving_scales(path)
    with pytest.MonkeyPatch.context() as mp:
        ref = _score_jax(jm, v, codes, q8.Int8Serving(), mp)
    return scales, ref, _score_port(bf16_models, q8.Int8Serving(), scales)


def _score_port(bf16_models, mode, scales):
    _, _, tm, weights, codes = bf16_models
    tm.load_weights(weights)
    ct, cb, labels = (torch.from_numpy(np.array(c)) for c in codes)
    ours = make_hierarchical_scorer(tm.stage2, 16, mode, scales)(labels, ct,
                                                                 cb)
    assert ours[0].shape == (4, 16, 256) and ours[1].shape == (4, 16, 4, 256)
    return [o.float().numpy() for o in ours]


def _scorer_readings(bf16_models, bf16_scores, mode, monkeypatch):
    """Per logits (top, bottom), the port in `mode` against JAX in `mode`:
    mean and max |d| over the bf16 scorer's own port-to-JAX ones; mean |d|
    over JAX's own mode-vs-bf16 gap; the size of the port's mode-vs-bf16
    change over JAX's (None where JAX's mode leaves the logits bit-equal
    to its bf16 ones; then the port's must be too); top-1 agreement."""
    jm, v, _, _, codes = bf16_models
    scales, ref_bf16, ours_bf16 = bf16_scores
    ref = _score_jax(jm, v, codes, mode, monkeypatch)
    ours = _score_port(bf16_models, mode, scales)
    out = []
    for o, r, ob, rb in zip(ours, ref, ours_bf16, ref_bf16):
        d, db, gap = np.abs(o - r), np.abs(ob - rb), np.abs(r - rb)
        size = None
        if gap.any():
            size = np.abs(o - ob).mean() / gap.mean()
        else:
            np.testing.assert_array_equal(o, ob)
        out.append(dict(mean=d.mean() / db.mean(), max=d.max() / db.max(),
                        gap=d.mean() / gap.mean() if gap.any() else None,
                        size=size,
                        top1=float(np.mean(o.argmax(-1) == r.argmax(-1)))))
    return out


def _assert_near_jax(r):
    assert r['size'] is None or 0.9 <= r['size'] <= 1.1, r
    assert r['mean'] <= 4 and r['max'] <= 4 and r['top1'] >= 0.9, r


def test_scorer_int8max_matches_jax(bf16_models, bf16_scores, monkeypatch):
    """make_hierarchical_scorer on seeded codes in int8max (JAX's scales
    carried across by convert_scales) against JAX's scorer in int8max.
    Every quantizer of the path maps JAX's own input to JAX's codes and
    output bit for bit (test_int8_quantizers_match_jax_on_its_activations),
    so what is left comes from the float operations between them, which
    round bf16 differently in the two frameworks: a bf16 ulp at a
    quantizer's input is up to a fifth of an int8 step here, so now and
    then a code moves by one, and int8 carries the bf16 paths' rounding
    differences further than bf16 does. Bounds, per logits (top, bottom),
    from the readings in PERF.md section 7: int8max changes the port's
    logits by as much as it changes JAX's (0.9x-1.1x; a float path would
    not change them); the port's logits lie within 0.9x JAX's own
    int8max-vs-bf16 gap of JAX's; mean and max |d| at most 4x the bf16
    scorer's port-to-JAX deviation; top-1 agreement >= 90%."""
    for r in _scorer_readings(bf16_models, bf16_scores, q8.INT8MAX,
                              monkeypatch):
        _assert_near_jax(r)
        assert r['gap'] <= 0.9, r


@pytest.mark.parametrize('mode', [m for m in STAGE2_MODES if m != 'int8max'])
def test_scorer_partial_modes_match_jax(bf16_models, bf16_scores,
                                        monkeypatch, mode):
    """Each partial stage-2 mode (bench.py's BENCH_INT8_STAGE2 and
    BENCH_INT8_SPATIAL switches, and the int8 cache or the gemms alone)
    against JAX's scorer in the same mode. A mode that leaves JAX's top
    logits bit-equal to its bf16 ones (the depth gemms alone) leaves the
    port's so too; elsewhere the bounds of test_scorer_int8max_matches_jax
    but the gap, which the depth gemms alone do not meet (their change is
    2.6x the two frameworks' bf16 difference and carries it along: 1.09x
    the gap, bottom logits)."""
    for r in _scorer_readings(bf16_models, bf16_scores, STAGE2_MODES[mode],
                              monkeypatch):
        _assert_near_jax(r)


def _intercepting(calls, wanted):
    """A flax method interceptor recording (module path, method, input,
    output) of the outermost call of each module for which
    `wanted(module, method name)`: a module's own inner calls (the dummy
    call that materializes a Quantizable layer's parameters) are left
    out."""
    stack = []

    def intercept(next_fun, args, kwargs, context):
        m = context.module
        outer = wanted(m, context.method_name) and not (
            stack and stack[-1] is m)
        stack.append(m)
        try:
            out = next_fun(*args, **kwargs)
        finally:
            stack.pop()
        if outer:
            calls.append((m.path, context.method_name, args[0], out))
        return out
    return intercept


def test_int8_quantizers_match_jax_on_its_activations(bf16_models,
                                                      bf16_scores,
                                                      monkeypatch):
    """The witness for the scorer tests' bounds: JAX's int8max prefill, one
    spatial step and one depth chain run op by op, recording the input and
    output of every A8W8 gemm (QuantizableDense and the fused QKV); the
    port's module of the same name, in an int8max serving call with the
    converted scales, turns each recorded input into JAX's output bit for
    bit, and JAX's K/V outputs into JAX's int8 cache rows. The gemms the
    port quantizes are exactly those JAX runs A8W8."""
    jm, v, tm, weights, (ct, cb, labels) = bf16_models
    scales = bf16_scores[0]
    from flax import linen as fnn
    from hqtransformer_tpu.models.stage2.hierarchical import \
        HierarchicalGPT as JaxGPT
    from hqtransformer_tpu_torch.convert import _segment

    def wanted(m, method):
        return (method == '_fused_qkv_flat' or (
            method == '__call__'
            and isinstance(m, jax_layers.QuantizableDense)))

    calls = []
    s2, B = v['stage2'], len(labels)
    ct, cb, labels = jnp.asarray(ct), jnp.asarray(cb), jnp.asarray(labels)
    monkeypatch.setenv('HQT_INT8_STAGE2', '1')
    with fnn.intercept_methods(_intercepting(calls, wanted)):
        sos = jm.stage2.apply(s2, B, labels, method=JaxGPT.sos_tokens)
        kc = jnp.zeros((2, 24, B, 128), jnp.int8)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.stage2.apply(s2, sos, kc, jnp.zeros_like(kc), 0,
                                        method=JaxGPT.spatial_step)
        x = jm.stage2.apply(s2, ct[:, 0], cb[:, 0], jnp.zeros(B, jnp.int32),
                            method=JaxGPT.embed_cell_step)
        with jax_layers.int8_stage2_scope():
            h, kc, vc = jm.stage2.apply(s2, x, kc, vc, jnp.int32(1),
                                        method=JaxGPT.spatial_step)
        n_spatial = len(calls)
        _, kv = jm.stage2.apply(s2, h[:, -1],     # float in JAX and here
                                method=JaxGPT.depth_first_logits)
        n_first = len(calls) - n_spatial
        with jax_layers.int8_stage2_scope():
            jm.stage2.apply(s2, ct[:, 1:2], kv, 1,
                            method=JaxGPT.depth_second_logits)
    int8_calls = calls[:n_spatial] + calls[n_spatial + n_first:]
    assert (n_spatial, n_first, len(int8_calls)) == (16, 12, 33)

    model = tm.stage2
    tm.load_weights(weights)
    rows = {}
    with torch.inference_mode(), model.serving(q8.INT8MAX, scales):
        ran = set()
        for path, method, x, y in int8_calls:
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
                k_scale, v_scale, inv_k, inv_v = mod.serving.kv_scales
                k, vv = torch.from_numpy(np.array(_np(y))).bfloat16().split(
                    128, -1)[1:]
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
    assert rows == {0: 2, 1: 2}


# ------------------------------------------------------------ calibration

@pytest.fixture(scope='module')
def f32_models():
    jm = jax_twostage.TwoStageModel(build_twostage_config(CFG))
    variables = _jax_variables(jm, jax.random.PRNGKey(3))
    weights = {s: convert_variables(v) for s, v in variables.items()}
    return jm, variables, weights


def _same_scales(ours, jax_tree, key, rtol):
    ref = convert_scales({key: jax_tree})[key]
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=rtol,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_kv_calibration_reduces_caches_as_jax(f32_models, monkeypatch,
                                              dtype):
    """calibrate_kv_scales' reduction of given final caches (both samplers
    replaced by one that returns them): per-layer, per-channel
    max(absmax, 1e-6) / 127 (JAX's default margin of 1), equal in f32 and
    in bf16 caches."""
    jm, variables, weights = f32_models
    rng = np.random.RandomState(7)
    kc = rng.randn(2, 16, 4, 128).astype(np.float32) * 3
    vc = rng.randn(2, 16, 4, 128).astype(np.float32)
    if dtype == 'bf16':
        (tk, jk), (tv, jv) = _bf16(kc), _bf16(vc)
    else:
        tk, jk, tv, jv = _t(kc), jnp.asarray(kc), _t(vc), jnp.asarray(vc)
    monkeypatch.setattr(jax_twostage, 'make_hierarchical_sampler',
                        lambda *a, **k: lambda *b: (None, (jk, jv)))
    monkeypatch.setattr(twostage, 'make_hierarchical_sampler',
                        lambda *a, **k: lambda *b: (None, (tk, tv)))
    labels = np.arange(4, dtype=np.int32)
    ref = jm.calibrate_kv_scales(variables, jax.random.PRNGKey(0),
                                 jnp.asarray(labels))
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    ours = tm.calibrate_kv_scales(weights, torch.Generator(),
                                  torch.from_numpy(labels))
    _same_scales(ours['stage2/kv_scales'], ref['stage2']['kv_scales'],
                 'stage2/kv_scales', rtol=0)


def test_stage2_calibration_matches_jax(f32_models):
    """calibrate_stage2_int8 on the same codes, f32: the same modules, and
    scales within rtol 1e-6 (the two forwards' f32 gemms sum in another
    order)."""
    jm, variables, weights = f32_models
    rng = np.random.RandomState(8)
    ct = rng.randint(0, 256, (3, 16)).astype(np.int32)
    cb = rng.randint(0, 256, (3, 64)).astype(np.int32)
    labels = np.array([0, 4, 9], np.int32)
    ref = jm.calibrate_stage2_int8(variables, jnp.asarray(ct),
                                   jnp.asarray(cb), jnp.asarray(labels))
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    ours = tm.calibrate_stage2_int8(weights, torch.from_numpy(ct),
                                    torch.from_numpy(cb),
                                    torch.from_numpy(labels))
    _same_scales(ours['stage2/act_scales'], ref['stage2']['act_scales'],
                 'stage2/act_scales', rtol=1e-6)


def test_decode_calibration_matches_jax_and_chunks(f32_models):
    """calibrate_int8_decode on the same code maps, f32: the same convs and
    scales within rtol 1e-6 (f32 convolutions sum in another order);
    calibrating in chunks of 2 gives the scales of one pass within rtol
    1e-6, as the JAX package's own test holds it (a convolution's
    summation order may change with the batch)."""
    jm, variables, weights = f32_models
    rng = np.random.RandomState(9)
    ct = rng.randint(0, 256, (5, 4, 4)).astype(np.int32)
    cb = rng.randint(0, 256, (5, 8, 8)).astype(np.int32)
    ref = jm.calibrate_int8_decode(variables, jnp.asarray(ct),
                                   jnp.asarray(cb))
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    one = tm.calibrate_int8_decode(weights, torch.from_numpy(ct),
                                   torch.from_numpy(cb), chunk=8)
    split = tm.calibrate_int8_decode(weights, torch.from_numpy(ct),
                                     torch.from_numpy(cb), chunk=2)
    _same_scales(one['stage1/act_scales'], ref['stage1']['act_scales'],
                 'stage1/act_scales', rtol=1e-6)
    for name, t in one['stage1/act_scales'].items():
        np.testing.assert_allclose(split['stage1/act_scales'][name].numpy(),
                                   t.numpy(), rtol=1e-6, err_msg=name)


# ------------------------------------------------------------------ errors

def test_missing_scales_and_f32_models_raise():
    """Each switch either runs or raises: missing KV or activation scales
    raise, as in JAX; int8 gemms or convolutions asked of an f32 model
    raise, where JAX stays float."""
    cfg = torch_config(CFG)
    labels = torch.arange(2)
    g = torch.Generator()
    f32 = twostage.TwoStageModel(cfg, device='cpu')
    f32.load_weights(f32.init_weights(0))
    with pytest.raises(ValueError, match='calibrate_kv_scales'):
        make_hierarchical_sampler(f32.stage2, 4, SamplingParams(),
                                  q8.Int8Serving(kv_cache=True))(g, labels)
    for mode in (q8.Int8Serving(depth_gemms=True),
                 q8.Int8Serving(depth_gemms=True, spatial_gemms=True)):
        with pytest.raises(ValueError, match='bf16'):
            make_hierarchical_sampler(f32.stage2, 4, SamplingParams(),
                                      mode, {})(g, labels)
    with pytest.raises(ValueError, match='bf16'):
        f32.make_pixel_sampler(4, int8=q8.Int8Serving(decode_convs=True))(
            f32.init_weights(0), g, labels)

    bf16 = twostage.TwoStageModel(cfg, dtype=torch.bfloat16, device='cpu')
    bf16.load_weights(bf16.init_weights(0))
    with pytest.raises(ValueError, match='calibrate_stage2_int8'):
        make_hierarchical_sampler(bf16.stage2, 4, SamplingParams(),
                                  q8.Int8Serving(depth_gemms=True))(g, labels)
    with pytest.raises(ValueError, match='calibrate_stage2_int8'):
        bf16.stage2.head_bot(torch.zeros(2, 128, dtype=torch.bfloat16),
                             int8=True)
    # a float serving call leaves no serving state behind
    make_hierarchical_sampler(bf16.stage2, 2, SamplingParams())(g, labels)
    assert all(b.attn.serving is None for b in bf16.stage2.blocks)
    # spatial gemms without the depth ones: JAX has no such mode
    with pytest.raises(ValueError, match='depth_gemms'):
        q8.Int8Serving(spatial_gemms=True)


@pytest.mark.parametrize('missing', ['blocks.1.attn.k', 'depths.2.mlp.0',
                                     'head_bot'])
def test_failed_serving_setup_leaves_no_state(missing):
    """A scale missing for a later module raises before any module takes
    serving state: every attention layer's `serving` and every
    Linear's `q8` stays None, so a later call outside a serving context
    concatenates the weights it holds then."""
    cfg = torch_config(CFG)
    tm = twostage.TwoStageModel(cfg, dtype=torch.bfloat16, device='cpu')
    tm.load_weights(tm.init_weights(0))
    model = tm.stage2
    kv = {f'blocks.{i}.attn.{w}': torch.ones(128)
          for i in range(2) for w in 'kv'}
    act = {n: torch.tensor(0.05) for n, m in model.named_modules()
           if isinstance(m, QuantizableLinear)}
    for coll in (kv, act):
        coll.pop(missing, None)
    with pytest.raises(ValueError, match='scale'):
        with model.serving(q8.INT8MAX, {'stage2/kv_scales': kv,
                                        'stage2/act_scales': act}):
            pass
    assert all(b.attn.serving is None
               for b in (*model.blocks, *model.depths))
    assert all(getattr(m, 'q8', None) is None for m in model.modules())


def test_float_serving_state_keeps_codes(f32_models):
    """The hoisted QKV concatenation changes nothing: greedy codes of the
    float sampler equal those of steps that concatenate on every call."""
    _, _, weights = f32_models
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    tm.load_weights(weights)
    greedy = SamplingParams(top_k_top=1, top_k_bot=1)
    labels = torch.arange(3)
    hoisted = make_hierarchical_sampler(tm.stage2, 16, greedy)(
        torch.Generator(), labels)
    model = tm.stage2
    with torch.inference_mode():
        sos = model.sos_tokens(3, labels)
        kc = torch.zeros(2, 16, 3, 128)
        vc = torch.zeros_like(kc)
        h = model.spatial_prefill(sos, kc, vc)
        step = partial(_depth_chain, model,
                       pick=_draws(torch.Generator(), greedy))
        top, bot, _ = step(h[:, -1])
        tops = [top]
        for i in range(1, 16):
            x = model.embed_cell_step(top, bot, torch.full((3,), i - 1))
            h = model.spatial_step(x, kc, vc, i)
            top, bot, _ = step(h[:, -1])
            tops.append(top)
    assert torch.equal(hoisted[0], torch.stack(tops, 1))
