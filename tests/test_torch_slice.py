"""The port's whole slice against the JAX package: greedy class-conditional
sampling (labels -> codes -> pixels) on the tiny config in f32, plus the
port's import and device rules."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.twostage import \
    TwoStageModel as JaxTwoStage  # noqa: E402
from hqtransformer_tpu.sampling.engine import \
    SamplingParams as JaxParams  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (convert_variables,  # noqa: E402
                                             drop_prefixes)
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.ops.topk_topp import \
    sample_from_logits  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'


def _jax_variables(jm, key):
    """TwoStageModel.init_variables, with each stage's init jitted."""
    k1, k2 = jax.random.split(key)
    res = jm.config.dataset.image_resolution
    n_top = jm.top_res * jm.top_res
    v1 = jax.jit(jm.stage1.init)(k1, jnp.zeros((1, res, res, 3)))
    v2 = jax.jit(jm.stage2.init)(k2, jnp.zeros((1, n_top), jnp.int32),
                                 jnp.zeros((1, n_top * jm.ratio), jnp.int32),
                                 jnp.zeros((1,), jnp.int32))
    return {'stage1': v1, 'stage2': v2}


def test_greedy_slice_matches_jax():
    """top_k = 1 makes every draw the argmax, so the two samplers must give
    the same codes whatever their random numbers; the pixels are then the
    stage-1 decode of equal codes."""
    jm = JaxTwoStage(build_twostage_config(CFG))
    variables = _jax_variables(jm, jax.random.PRNGKey(0))
    labels = np.array([0, 3, 7, 9], np.int32)
    jax_sampler = jm.make_pixel_sampler(
        params=JaxParams(top_k_top=1, top_k_bot=1), attention='packed')
    ref_px, (ref_t, ref_b) = jax_sampler(variables, jax.random.PRNGKey(1),
                                         jnp.asarray(labels))

    tm = TwoStageModel(torch_config(CFG), device='cpu')
    weights = {'stage1': drop_prefixes(convert_variables(variables['stage1']),
                                       'encoder.', 'quant_conv_b.'),
               'stage2': convert_variables(variables['stage2'])}
    sampler = tm.make_pixel_sampler(
        params=SamplingParams(top_k_top=1, top_k_bot=1))
    px, (codes_t, codes_b) = sampler(weights, torch.Generator().manual_seed(0),
                                     torch.from_numpy(labels))

    assert codes_t.shape == (4, 16) and codes_b.shape == (4, 16, 4)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(codes_b.numpy(), np.asarray(ref_b))
    assert px.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(px.numpy(), np.asarray(ref_px), atol=2e-4,
                               rtol=1e-3)


def test_port_imports_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import hqtransformer_tpu_torch as p\n'
        'names = [m.name for m in pkgutil.walk_packages(p.__path__, '
        'p.__name__ + ".")]\n'
        'for n in names: importlib.import_module(n)\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "hqtransformer_tpu" or m.startswith("hqtransformer_tpu.")]\n'
        'assert not bad, bad\n'
        'assert len(names) >= 15, names\n')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)


def test_entry_point_needs_a_card_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TwoStageModel(torch_config(CFG))
    TwoStageModel(torch_config(CFG), device='cpu')


def test_nucleus_filtering_not_ported():
    with pytest.raises(NotImplementedError):
        sample_from_logits(torch.Generator(), torch.zeros(2, 8), top_k=4,
                           top_p=0.9)
