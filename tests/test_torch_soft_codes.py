"""Soft codes of the PyTorch port against the JAX package, f32 on the CPU:
`ops/quantize.py::soft_codes`, `get_soft_codes` of both quantizers and of
both HQ generators, and `TwoStageModel.extract_codes(temp_soft_labels=...)`
on the tiny two-stage config. Soft maps within atol 2e-4 / rtol 1e-3, hard
codes equal. The stochastic draw is `jax.random.categorical`, the argmax of
log(soft + 1e-20) plus the Gumbel noise its key draws: the port draws the
same codes when handed that noise in place of its generator's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.stage1.generator import \
    build_generator as jax_generator  # noqa: E402
from hqtransformer_tpu.models.stage1.quantizer import (  # noqa: E402
    EMAVectorQuantizer as JaxEMA, VectorQuantizer as JaxVQ)
from hqtransformer_tpu.models.twostage import \
    TwoStageModel as JaxTwoStage  # noqa: E402
from hqtransformer_tpu.ops import quantize as jq  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.generator import \
    build_generator  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.quantizer import (  # noqa: E402
    EMAVectorQuantizer, VectorQuantizer)
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.ops import quantize as q  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               **TOL)


def _equal(actual, expected):
    np.testing.assert_array_equal(np.asarray(actual), np.asarray(expected))


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class JaxNoise:
    """Stands in for the port's `gumbel_noise`: hands out, in order, the
    Gumbel noise `jax.random.gumbel` draws for each key, as
    `jax.random.categorical(key, logits, axis=1)` does."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __call__(self, shape, generator):
        assert generator is not None
        noise = jax.random.gumbel(self.keys.pop(0), tuple(shape))
        return torch.from_numpy(np.array(noise))


@pytest.mark.parametrize('temp', [1.0, 0.5])
def test_soft_codes_match_jax(temp):
    z, e = _randn(0, (50, 16)), _randn(1, (40, 16))
    codes, soft = jq.soft_codes(jnp.asarray(z), jnp.asarray(e), temp)
    t_codes, t_soft = q.soft_codes(torch.from_numpy(z), torch.from_numpy(e),
                                   temp)
    _close(t_soft, soft)
    np.testing.assert_allclose(t_soft.sum(1).numpy(), 1.0, atol=1e-5)
    _equal(t_codes, codes)


def test_stochastic_draw_is_jax_categorical(monkeypatch):
    """Given JAX's noise, the port's draw is jax.random.categorical's; and
    the port's own noise is standard Gumbel on the generator's device."""
    z, e = _randn(2, (300, 16)), _randn(3, (40, 16))
    key = jax.random.PRNGKey(7)
    codes, soft = jq.soft_codes(jnp.asarray(z), jnp.asarray(e), 2.0,
                                stochastic=True, key=key)
    monkeypatch.setattr(q, 'gumbel_noise', JaxNoise([key]))
    t_codes, t_soft = q.soft_codes(torch.from_numpy(z), torch.from_numpy(e),
                                   2.0, stochastic=True,
                                   generator=torch.Generator())
    _close(t_soft, soft)
    _equal(t_codes, codes)
    assert int((t_codes != t_soft.argmax(1)).sum()) > 0   # really drawn
    monkeypatch.undo()
    g = q.gumbel_noise((200, 500), torch.Generator().manual_seed(0))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 0.01     # Euler's constant
    with pytest.raises(ValueError, match='generator'):
        q.soft_codes(torch.from_numpy(z), torch.from_numpy(e),
                     stochastic=True)


@pytest.mark.parametrize('kind', ['ema', 'ema_l2', 'learned'])
@pytest.mark.parametrize('stochastic', [False, True])
def test_quantizer_soft_codes_match_jax(kind, stochastic, monkeypatch):
    """get_soft_codes: z_q, loss (the commitment loss alone, for the
    learned codebook too, as in JAX), codes and soft maps."""
    z = _randn(4, (2, 3, 3, 16))
    jmod = (JaxVQ(n_embed=40, dim=16) if kind == 'learned' else
            JaxEMA(n_embed=40, dim=16, use_l2_norm=kind == 'ema_l2'))
    v = jmod.init(jax.random.PRNGKey(8), jnp.asarray(z))
    key = jax.random.PRNGKey(9) if stochastic else None
    ref = jmod.apply(v, jnp.asarray(z), 0.7, stochastic, key,
                     method=type(jmod).get_soft_codes)
    if kind == 'learned':
        tmod = VectorQuantizer(40, 16)
        tmod.load_state_dict({k.removeprefix('quantize.'): t for k, t in
                              convert_variables({'params': {
                                  'quantize': v['params']}}).items()},
                             strict=True)
    else:
        tmod = EMAVectorQuantizer(40, 16, use_l2_norm=kind == 'ema_l2')
        tmod.load_state_dict(convert_variables(v), strict=True)
    if stochastic:
        monkeypatch.setattr(q, 'gumbel_noise', JaxNoise([key]))
    with torch.no_grad():
        ours = tmod.get_soft_codes(torch.from_numpy(z), 0.7, stochastic,
                                   torch.Generator())
    _close(ours[0], ref[0])
    _close(ours[1], ref[1])
    _equal(ours[2], ref[2])
    _close(ours[3], ref[3])
    assert ours[3].shape == (2, 3, 3, 40)


def _generator_pair(kind):
    """(JAX generator, variables, port generator) for the tiny config as
    the pixel-shuffle 2-level HQ-VAE, the nearest one with a shared
    codebook, or the 3-level one with conv2."""
    cfgs = [build_twostage_config(CFG).stage1, torch_config(CFG).stage1]
    for i, cfg in enumerate(cfgs):
        aux = cfg.hparams_aux
        if kind == 'nearest_shared':
            aux = dataclasses.replace(aux, upsample='nearest',
                                      shared_codebook=True)
        elif kind == 'hqvae3_conv2':
            aux = dataclasses.replace(aux, upsample='conv2', code_levels=3)
            cfg = dataclasses.replace(cfg, type='hqvae',
                                      n_embed_levels=[64, 128, 256])
        cfgs[i] = dataclasses.replace(cfg, hparams_aux=aux)
    jg = jax_generator(cfgs[0])
    variables = jax.jit(jg.init)(jax.random.PRNGKey(10),
                                 jnp.zeros((1, 32, 32, 3), jnp.float32))
    tg = build_generator(cfgs[1]).eval()
    tg.load_state_dict(convert_variables(variables), strict=True)
    return jg, variables, tg


def _level_keys(kind, rng):
    """The keys the JAX generator's levels draw with, top first."""
    if kind == 'hqvae3_conv2':
        keys = []
        for _ in range(3):
            rng, r = jax.random.split(rng)
            keys.append(r)
        return keys
    return list(jax.random.split(rng))


@pytest.mark.parametrize('kind', ['pixelshuffle', 'nearest_shared',
                                  'hqvae3_conv2'])
@pytest.mark.parametrize('stochastic', [False, True])
def test_generator_soft_codes_match_jax(kind, stochastic, monkeypatch):
    jg, variables, tg = _generator_pair(kind)
    x = np.random.RandomState(11).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    rng = jax.random.PRNGKey(12) if stochastic else None
    codes, softs = jax.jit(lambda v, x, r: jg.apply(
        v, x, 1.0, stochastic, r, method=type(jg).get_soft_codes))(
            variables, jnp.asarray(x), rng)
    if stochastic:
        monkeypatch.setattr(q, 'gumbel_noise',
                            JaxNoise(_level_keys(kind, rng)))
    with torch.no_grad():
        t_codes, t_softs = tg.get_soft_codes(torch.from_numpy(x), 1.0,
                                             stochastic, torch.Generator())
    assert len(t_codes) == len(codes) == (3 if kind == 'hqvae3_conv2' else 2)
    for a, b in zip(t_codes, codes):
        _equal(a, b)
    for a, b in zip(t_softs, softs):
        assert a.shape == b.shape
        _close(a, b)
    if not stochastic:
        # the hard codes are the nearest codes of the plain encode
        with torch.no_grad():
            plain = tg.get_codes(torch.from_numpy(x))
        for a, b in zip(t_codes, plain):
            _equal(a, b)


def test_extract_codes_soft_labels_match_jax():
    """TwoStageModel.extract_codes on the tiny config: with
    temp_soft_labels, codes [B, T] and soft maps [B, T, K] as JAX's; with
    a generator, codes drawn from the soft maps; without, (None, None)."""
    jm = JaxTwoStage(build_twostage_config(CFG))
    v1 = jax.jit(jm.stage1.init)(jax.random.PRNGKey(13),
                                 jnp.zeros((1, 32, 32, 3), jnp.float32))
    tm = TwoStageModel(torch_config(CFG), device='cpu')
    weights = {'stage1': convert_variables(v1),
               'stage2': tm.init_weights(seed=0)['stage2']}
    x = np.random.RandomState(14).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    (ct, cb), (st, sb) = jax.jit(lambda v, x: jm.extract_codes(
        {'stage1': v}, x, temp_soft_labels=1.0))(v1, jnp.asarray(x))
    (t_ct, t_cb), (t_st, t_sb) = tm.extract_codes(
        weights, torch.from_numpy(x), temp_soft_labels=1.0)
    assert t_ct.shape == (3, 16) and t_cb.shape == (3, 64)
    assert t_st.shape == (3, 16, 256) and t_sb.shape == (3, 64, 256)
    _equal(t_ct, ct)
    _equal(t_cb, cb)
    _close(t_st, st)
    _close(t_sb, sb)
    (h_t, h_b), softs = tm.extract_codes(weights, torch.from_numpy(x))
    assert softs == (None, None)
    _equal(h_t, ct)
    _equal(h_b, cb)
    (d_t, d_b), (s_t, s_b) = tm.extract_codes(
        weights, torch.from_numpy(x), temp_soft_labels=1.0,
        generator=torch.Generator().manual_seed(15))
    _close(s_t, st)
    assert int(d_t.min()) >= 0 and int(d_t.max()) < 256
    assert bool((d_b != h_b).any())
