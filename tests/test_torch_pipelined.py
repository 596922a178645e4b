"""The port's pipelined sampler and its int8 decode, on the tiny config on
the CPU: the fill call equals `make_pixel_sampler` for the same generator
seed, a steady call returns the previous batch's pixels beside its own
codes (the semantics of `hqtransformer_tpu/models/twostage.py::
make_pipelined_sampler`, `tests/test_pipelined_sampler.py`), in bf16 and
in int8max; and the int8 stage-1 decode against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import \
    int8_decode_scope  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (  # noqa: E402
    convert_scales, convert_variables)
from hqtransformer_tpu_torch.models.stage2.hierarchical import \
    cells_to_raster  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import (  # noqa: E402
    TwoStageModel, serving_bf16_params)
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402
from test_torch_int8 import _intercepting  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
SP = SamplingParams(top_k_top=16, top_k_bot=16, temperature_top=0.95,
                    temperature_bot=0.95)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def bf16_model():
    """The tiny model in bf16 with seeded bf16 serving weights and the
    port's own int8 scales, calibrated on one sampled batch."""
    tm = TwoStageModel(torch_config(CFG), dtype=torch.bfloat16, device='cpu')
    weights = {s: serving_bf16_params(w)
               for s, w in tm.init_weights(seed=0).items()}
    labels = torch.tensor([1, 2, 3, 4])
    _, (ct, cb) = tm.make_pixel_sampler(params=SP)(
        weights, torch.Generator().manual_seed(9), labels)
    cb_raster = cells_to_raster(cb, 4, 2)
    scales = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(8),
                                    labels, SP)
    scales.update(tm.calibrate_stage2_int8(weights, ct,
                                           cb_raster.reshape(4, -1), labels))
    scales.update(tm.calibrate_int8_decode(weights, ct.reshape(-1, 4, 4),
                                           cb_raster.reshape(-1, 8, 8)))
    return tm, weights, scales


@pytest.mark.parametrize('mode', ['bf16', 'int8max'])
def test_pipelined_fill_and_steady_calls(bf16_model, mode):
    """Fill: the codes and pixels of make_pixel_sampler with the same
    generator seed (exactly: the same computation). Steady: this call's
    codes as make_pixel_sampler draws them, and the pixels of the previous
    call's codes (exactly). int8max also runs its int8 gemms and convs."""
    tm, weights, scales = bf16_model
    int8 = q8.INT8MAX if mode == 'int8max' else q8.Int8Serving()
    labels = torch.tensor([0, 5, 7, 9])
    plain = tm.make_pixel_sampler(params=SP, int8=int8, scales=scales)
    piped = tm.make_pipelined_sampler(params=SP, int8=int8, scales=scales)
    px0, codes0 = plain(weights, torch.Generator().manual_seed(1), labels)
    px1, codes1 = plain(weights, torch.Generator().manual_seed(2), labels)
    counts = (tracing.counter('int8.matmul_launches'),
              tracing.counter('int8.conv2d_launches'))

    fill_codes, fill_px = piped(weights, torch.Generator().manual_seed(1),
                                labels)
    for a, b in zip(fill_codes, codes0):
        assert torch.equal(a, b)
    assert torch.equal(fill_px, px0)
    steady_codes, lag_px = piped(weights, torch.Generator().manual_seed(2),
                                 labels, fill_codes)
    for a, b in zip(steady_codes, codes1):
        assert torch.equal(a, b)
    assert torch.equal(lag_px, px0)
    assert lag_px.shape == (4, 32, 32, 3) and lag_px.dtype == torch.bfloat16
    ran = (tracing.counter('int8.matmul_launches') > counts[0],
           tracing.counter('int8.conv2d_launches') > counts[1])
    assert ran == ((True, True) if mode == 'int8max' else (False, False))


def test_int8max_stays_near_bf16(bf16_model):
    """With the port's own calibration, int8max pixels of the same codes
    stay near the bf16 decode (PSNR > 20 dB, the JAX package's bound for
    random weights) and differ from it (the int8 path ran)."""
    tm, weights, scales = bf16_model
    labels = torch.tensor([0, 5, 7, 9])
    _, codes = tm.make_pixel_sampler(params=SP)(
        weights, torch.Generator().manual_seed(3), labels)
    bf16 = tm.make_pipelined_sampler(params=SP)
    int8 = tm.make_pipelined_sampler(params=SP, int8=q8.INT8MAX,
                                     scales=scales)
    ref = bf16(weights, torch.Generator(), labels, codes)[1].float()
    got = int8(weights, torch.Generator(), labels, codes)[1].float()
    mse = float(torch.mean((got - ref) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 20.0
    assert not torch.equal(got, ref)


def test_int8_decode_matches_jax(monkeypatch):
    """The A8W8 decoder against JAX's under HQT_INT8_DECODE, both bf16,
    with JAX's calibrated scales (convert_scales), conv by conv: JAX's
    decode_code runs op by op, recording every QuantizableConv's input and
    output; the port's conv of the same name, inside int8_decode, turns
    each recorded input into JAX's output bit for bit, where its float
    conv does not. The convs the port quantizes, the scales' names and the
    convs JAX runs A8W8 are one set, and the port's own decode runs that
    many int8 convolutions. (The two whole decodes are not compared: the
    float operations between the convs round bf16 differently in the two
    frameworks, and a quantizer turns such a difference into a whole int8
    step now and then.)"""
    from flax import linen as fnn
    from hqtransformer_tpu.models.stage1.layers import QuantizableConv
    from hqtransformer_tpu_torch.convert import _segment
    from hqtransformer_tpu_torch.models.stage1.layers import \
        QuantizableConv2d

    jm = jax_twostage.TwoStageModel(build_twostage_config(CFG),
                                    dtype=jnp.bfloat16)
    res = jm.config.dataset.image_resolution
    variables = jax_twostage.serving_bf16_params({'stage1': jax.jit(
        jm.stage1.init)(jax.random.PRNGKey(4),
                        jnp.zeros((1, res, res, 3), jnp.bfloat16))})
    rng = np.random.RandomState(10)
    ct = rng.randint(0, 256, (3, 4, 4)).astype(np.int32)
    cb = rng.randint(0, 256, (3, 8, 8)).astype(np.int32)
    calibrated = jm.calibrate_int8_decode(variables, jnp.asarray(ct),
                                          jnp.asarray(cb))
    calls = []
    intercept = _intercepting(
        calls, lambda m, method: isinstance(m, QuantizableConv))
    monkeypatch.setenv('HQT_INT8_DECODE', '1')
    with int8_decode_scope(), fnn.intercept_methods(intercept):
        jm.stage1.apply(calibrated['stage1'], jnp.asarray(ct),
                        jnp.asarray(cb), method=type(jm.stage1).decode_code)
    calls = [('.'.join(_segment(p) for p in path),
              np.array(x.astype(jnp.float32)),
              np.array(y.astype(jnp.float32))) for path, _, x, y in calls]

    tm = TwoStageModel(torch_config(CFG), dtype=torch.bfloat16, device='cpu')
    tm.stage1.load_state_dict(serving_bf16_params(convert_variables(
        variables['stage1'])), strict=True, assign=True)
    scales = convert_scales(
        {'stage1/act_scales': calibrated['stage1']['act_scales']})[
            'stage1/act_scales']
    convs = {n for n, m in tm.stage1.named_modules()
             if isinstance(m, QuantizableConv2d) and n.startswith('decoder.')}
    names = [name for name, _, _ in calls]
    assert len(names) == 29 and set(names) == convs == set(scales)
    with torch.inference_mode(), tm.stage1.int8_decode(scales):
        for name, x, y in calls:
            conv = tm.stage1.get_submodule(name)
            xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
            out = conv(xt).float().permute(0, 2, 3, 1).numpy()
            np.testing.assert_array_equal(out, y, err_msg=name)
            w, conv.q8 = conv.q8, None
            assert not np.array_equal(
                conv(xt).float().permute(0, 2, 3, 1).numpy(), y), name
            conv.q8 = w
        before = tracing.counter('int8.conv2d_launches')
        px = tm.stage1.decode_code(torch.from_numpy(ct), torch.from_numpy(cb))
    assert tracing.counter('int8.conv2d_launches') - before == 29
    assert px.shape == (3, 32, 32, 3) and bool(torch.isfinite(px).all())
