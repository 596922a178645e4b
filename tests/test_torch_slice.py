"""The port's slices against the JAX package, on the tiny config in f32:
greedy class-conditional sampling (labels -> codes -> pixels); encoding
(images -> codes -> stage-2 logits, and images -> codes -> pixels with
the numbers `eval_stage1.py` reports); plus the port's import and device
rules."""

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
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.evaluation.stage1 import (  # noqa: E402
    ReconstructionMetrics, init_stage1_weights, make_reconstructor)
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.ops.topk_topp import \
    sample_from_logits  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)


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


@pytest.fixture(scope='module')
def jax_model():
    """(JAX TwoStageModel, its variables, the same weights for the port)."""
    jm = JaxTwoStage(build_twostage_config(CFG))
    variables = _jax_variables(jm, jax.random.PRNGKey(0))
    weights = {s: convert_variables(v) for s, v in variables.items()}
    return jm, variables, weights


def _images(seed, B, res=32):
    return np.random.RandomState(seed).uniform(
        -1, 1, (B, res, res, 3)).astype(np.float32)


def test_greedy_slice_matches_jax(jax_model):
    """top_k = 1 makes every draw the argmax, so the two samplers must give
    the same codes whatever their random numbers; the pixels are then the
    stage-1 decode of equal codes."""
    jm, variables, weights = jax_model
    labels = np.array([0, 3, 7, 9], np.int32)
    jax_sampler = jm.make_pixel_sampler(
        params=JaxParams(top_k_top=1, top_k_bot=1), attention='packed')
    ref_px, (ref_t, ref_b) = jax_sampler(variables, jax.random.PRNGKey(1),
                                         jnp.asarray(labels))

    tm = TwoStageModel(torch_config(CFG), device='cpu')
    sampler = tm.make_pixel_sampler(
        params=SamplingParams(top_k_top=1, top_k_bot=1))
    px, (codes_t, codes_b) = sampler(weights, torch.Generator().manual_seed(0),
                                     torch.from_numpy(labels))

    assert codes_t.shape == (4, 16) and codes_b.shape == (4, 16, 4)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(codes_b.numpy(), np.asarray(ref_b))
    assert px.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(px.numpy(), np.asarray(ref_px), **TOL)


def test_extract_codes_and_forward_match_jax(jax_model):
    """Images -> codes -> teacher-forced stage-2 logits: codes equal, f32
    logits within atol 2e-4."""
    jm, variables, weights = jax_model
    x = _images(11, B=3)
    labels = np.array([1, 4, 9], np.int32)
    (ref_t, ref_b), _ = jax.jit(jm.extract_codes)(variables, jnp.asarray(x))
    (ref_lt, ref_lb), _, _ = jax.jit(jm.forward)(variables, jnp.asarray(x),
                                                 jnp.asarray(labels))

    tm = TwoStageModel(torch_config(CFG), device='cpu')
    (ct, cb), softs = tm.extract_codes(weights, torch.from_numpy(x))
    (lt, lb), (ft, fb), _ = tm.forward(weights, torch.from_numpy(x),
                                       torch.from_numpy(labels))
    assert softs == (None, None)
    assert ct.shape == (3, 16) and cb.shape == (3, 64)
    for ours in ((ct, cb), (ft, fb)):
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref_t))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref_b))
    assert lt.shape == (3, 16, 256) and lb.shape == (3, 64, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(ref_lt), **TOL)
    np.testing.assert_allclose(lb.numpy(), np.asarray(ref_lb), **TOL)


def test_reconstruction_metrics_match_jax(jax_model):
    """make_reconstructor and ReconstructionMetrics against the numbers
    eval_stage1.py computes from the JAX generator, over two batches; the
    top-only reconstruction against forward_topbottom's dec_t."""
    jm, variables, weights = jax_model
    gen, v1 = jm.stage1, variables['stage1']
    recon = jax.jit(lambda x: gen.apply(v1, x))
    recon_top = jax.jit(lambda x: gen.apply(
        v1, x, method=type(gen).forward_topbottom)[0][0])
    cfg = torch_config(CFG).stage1
    ours = make_reconstructor(cfg, device='cpu')
    ours_top = make_reconstructor(cfg, device='cpu', top_only=True)
    metrics = ReconstructionMetrics(cfg.n_embed)
    mse_sum, n_img, usage = 0.0, 0, {}
    for seed in (12, 13):
        x = _images(seed, B=4)
        dec, _, codes = recon(jnp.asarray(x))
        dec = np.clip(np.asarray(dec), -1, 1)
        mse_sum += float(np.sum(np.mean(np.square(dec - x), axis=(1, 2, 3))))
        n_img += x.shape[0]
        for li, c in enumerate(codes[:2]):
            u = usage.setdefault(li, np.zeros(cfg.n_embed, np.int64))
            u += np.bincount(np.asarray(c).reshape(-1), minlength=cfg.n_embed)

        px, levels = ours(weights['stage1'], torch.from_numpy(x))
        np.testing.assert_allclose(px.numpy(), dec, **TOL)
        for a, b in zip(levels, codes[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        metrics.update(torch.from_numpy(x), px, levels)
        top, _ = ours_top(weights['stage1'], torch.from_numpy(x))
        np.testing.assert_allclose(
            top.numpy(), np.clip(np.asarray(recon_top(jnp.asarray(x))), -1, 1),
            **TOL)

    np.testing.assert_allclose(metrics.mse, mse_sum / n_img, rtol=1e-4)
    assert metrics.n_images == n_img
    assert metrics.code_usage() == [float((u > 0).mean())
                                    for _, u in sorted(usage.items())]


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
    stage1 = torch_config(CFG).stage1
    for entry in (lambda: make_reconstructor(stage1),
                  lambda: init_stage1_weights(stage1, seed=0)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            entry()
    make_reconstructor(stage1, device='cpu')(
        init_stage1_weights(stage1, seed=0, device='cpu'),
        torch.zeros(1, 32, 32, 3))


def test_nucleus_filtering_not_ported():
    """The call that once raised for want of a top-p port now draws: every
    code of 50 draws a row inside the kept set of the plain filter (top-k
    4, then the smallest prefix of mass 0.9)."""
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0],
                           [2.0, 2.0, 2.0, 2.0, 0.0, 0.0, 0.0, 0.0]])
    kept = [{0, 1, 2}, {0, 1, 2, 3}]   # 0.644 + 0.237 + 0.087 >= 0.9
    gen = torch.Generator().manual_seed(0)
    seen = [set(), set()]
    for _ in range(50):
        codes = sample_from_logits(gen, logits, top_k=4, top_p=0.9)
        for r, c in enumerate(codes.tolist()):
            seen[r].add(c)
    assert all(1 < len(s) and s <= k for s, k in zip(seen, kept)), seen


@pytest.mark.parametrize('bisect3', [False, True])
def test_sampler_draws_with_bisect3_as_asked(jax_model, monkeypatch,
                                             bisect3):
    """SamplingParams.bisect3 reaches every draw of the 2-level sampler,
    the top and the bottom groups', 16 positions of each."""
    import hqtransformer_tpu_torch.ops.topk_topp as tt
    _, _, weights = jax_model
    real, seen = tt.sample_topk, []

    def spy(*args, **kw):
        seen.append(kw['bisect3'])
        return real(*args, **kw)
    monkeypatch.setattr(tt, 'sample_topk', spy)
    tm = TwoStageModel(torch_config(CFG), device='cpu')
    _, (codes_t, codes_b) = tm.make_pixel_sampler(params=SamplingParams(
        top_k_top=8, top_k_bot=8, bisect3=bisect3))(
            weights, torch.Generator().manual_seed(2), torch.arange(3))
    assert codes_t.shape == (3, 16) and codes_b.shape == (3, 16, 4)
    assert seen == [bisect3] * 2 * 16
