"""Stage-1 parity of the PyTorch port against the JAX package on the tiny
config in f32: the whole generator's weights load strictly; the encoder,
`encode`, `forward`, `forward_topbottom` and `decode_code` of the 2-level
`SimRQGAN2Generator`, and the same of a 3-level `HQVAEGenerator` built from
the tiny config. Codes must be equal, tensors within atol 2e-4 / rtol 1e-3.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.stage1.generator import \
    build_generator as jax_generator  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import \
    Downsample as JaxDownsample  # noqa: E402
from hqtransformer_tpu.models.stage1.layers import \
    Encoder as JaxEncoder  # noqa: E402
from hqtransformer_tpu.models.stage1.quantizer import \
    EMAVectorQuantizer as JaxQuantizer  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.generator import \
    build_generator  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.layers import (  # noqa: E402
    Downsample, Encoder)
from hqtransformer_tpu_torch.models.stage1.quantizer import \
    EMAVectorQuantizer  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)


def _three_level(cfg):
    """The tiny stage-1 config as a 3-level HQ-VAE: codes at 2x2, 4x4 and
    8x8 with codebook dims 1024, 256 and 64."""
    aux = dataclasses.replace(cfg.hparams_aux, code_levels=3)
    return dataclasses.replace(cfg, type='hqvae', n_embed_levels=[64, 128, 256],
                               hparams_aux=aux)


def _shared(cfg):
    """The tiny stage-1 config with one codebook for both levels' search."""
    return dataclasses.replace(cfg, hparams_aux=dataclasses.replace(
        cfg.hparams_aux, shared_codebook=True))


def _build(levels, shared=False):
    cfg = build_twostage_config(CFG).stage1
    tcfg = torch_config(CFG).stage1
    if levels == 3:
        cfg, tcfg = _three_level(cfg), _three_level(tcfg)
    if shared:
        cfg, tcfg = _shared(cfg), _shared(tcfg)
    jg = jax_generator(cfg)
    res = cfg.hparams.resolution
    variables = jax.jit(jg.init)(jax.random.PRNGKey(levels),
                                 jnp.zeros((1, res, res, 3), jnp.float32))
    tg = build_generator(tcfg)
    tg.load_state_dict(convert_variables(variables), strict=True)
    return cfg, jg, variables, tg


@pytest.fixture(scope='module')
def generators():
    return _build(2)


@pytest.fixture(scope='module')
def hqvae():
    return _build(3)


def _images(seed, res, B=2):
    return np.random.RandomState(seed).uniform(
        -1, 1, (B, res, res, 3)).astype(np.float32)


def _apply(jg, variables, method, *args):
    return jax.jit(lambda v, *a: jg.apply(v, *a, method=method))(
        variables, *map(jnp.asarray, args))


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               **TOL)


def _equal(actual, expected):
    np.testing.assert_array_equal(np.asarray(actual), np.asarray(expected))


def test_convert_matches_export(generators):
    _, _, variables, _ = generators
    mine = convert_variables(variables)
    ref = export_torch_state_dict(variables)
    assert sorted(mine) == sorted(ref)
    assert any(k.startswith('encoder.down.0.downsample.conv') for k in mine)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_code_pixels(generators, seed):
    cfg, jg, variables, tg = generators
    bot = cfg.hparams.attn_resolutions[0]
    rng = np.random.RandomState(seed)
    ct = rng.randint(0, cfg.n_embed, (2, bot // 2, bot // 2)).astype(np.int32)
    cb = rng.randint(0, cfg.n_embed, (2, bot, bot)).astype(np.int32)
    ref = _apply(jg, variables, type(jg).decode_code, ct, cb)
    with torch.no_grad():
        ours = tg.decode_code(torch.from_numpy(ct), torch.from_numpy(cb))
    assert ours.shape == ref.shape == (2, cfg.hparams.resolution,
                                       cfg.hparams.resolution, 3)
    _close(ours, ref)


@pytest.mark.parametrize('with_conv', [True, False])
def test_downsample(with_conv):
    x = np.random.RandomState(2).randn(2, 9, 9, 32).astype(np.float32)
    jd = JaxDownsample(with_conv)
    v = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jd.apply(v, jnp.asarray(x))
    td = Downsample(32, with_conv)
    td.load_state_dict(convert_variables(v) if with_conv else {},
                       strict=True)
    with torch.no_grad():
        ours = td(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ours.shape == ref.shape == (2, 4, 4, 32)
    _close(ours, ref)


def test_encoder(generators):
    cfg, jg, variables, tg = generators
    x = _images(3, cfg.hparams.resolution)
    ref, ref_prev = _apply(jg, variables,
                           lambda m, a: m.encoder(a, ret_bottom=True), x)
    with torch.no_grad():
        ours, prev = tg.encoder(torch.from_numpy(x).permute(0, 3, 1, 2),
                                ret_bottom=True)
    assert not len(tg.encoder.down[0].attn)   # the curr_res quirk
    _close(ours.permute(0, 2, 3, 1), ref)
    _close(prev.permute(0, 2, 3, 1), ref_prev)


def test_encoder_level_attention():
    """No init downsample and attention at the input resolution: the
    level-attention blocks the repo's configs never reach."""
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=2, attn_resolutions=(16,),
              in_channels=3, resolution=16, z_channels=32)
    x = _images(12, 16)
    je = JaxEncoder(out_ch=3, **kw)
    variables = je.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = je.apply(variables, jnp.asarray(x))
    te = Encoder(**kw)
    te.load_state_dict(convert_variables(variables), strict=True)
    assert len(te.down[0].attn) == 2 and not len(te.down[1].attn)
    with torch.no_grad():
        ours = te(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ours.permute(0, 2, 3, 1), ref)


def test_quantizer_l2_norm():
    """use_l2_norm: the search runs on unit-norm rows of z."""
    z = np.random.RandomState(11).randn(2, 3, 3, 16).astype(np.float32)
    jq = JaxQuantizer(n_embed=40, dim=16, use_l2_norm=True)
    variables = jq.init(jax.random.PRNGKey(1), jnp.asarray(z))
    ref = jq.apply(variables, jnp.asarray(z))
    tq = EMAVectorQuantizer(40, 16, use_l2_norm=True)
    tq.load_state_dict(convert_variables(variables), strict=True)
    ours = tq(torch.from_numpy(z))
    _close(ours[0], ref[0])
    _close(ours[1], ref[1])
    _equal(ours[2], ref[2])


@pytest.mark.parametrize('seed', [4, 5])
def test_encode(generators, seed):
    cfg, jg, variables, tg = generators
    x = _images(seed, cfg.hparams.resolution)
    ref = _apply(jg, variables, type(jg).encode, x)
    with torch.no_grad():
        ours = tg.encode(torch.from_numpy(x))
    for a, b in zip(ours[:4], ref[:4]):   # quant_t, quant_b, diff_t, diff_b
        _close(a, b)
    _equal(ours[4][0], ref[4][0])
    _equal(ours[4][1], ref[4][1])
    _close(ours[4][2], ref[4][2])
    assert ours[4][0].shape == (2, 4, 4) and ours[4][1].shape == (2, 8, 8)


def test_encode_shared_codebook():
    """shared_codebook: the bottom residual is searched in the top
    codebook (whose dim must then equal the bottom's: window 1)."""
    cfg = build_twostage_config(CFG).stage1
    tcfg = torch_config(CFG).stage1
    one = [dataclasses.replace(_shared(c), hparams_aux=dataclasses.replace(
        _shared(c).hparams_aux, upsample='pixelshuffle1')) for c in (cfg, tcfg)]
    jg = jax_generator(one[0])
    variables = jax.jit(jg.init)(jax.random.PRNGKey(4),
                                 jnp.zeros((1, 32, 32, 3), jnp.float32))
    tg = build_generator(one[1])
    tg.load_state_dict(convert_variables(variables), strict=True)
    x = _images(13, 32)
    ref = _apply(jg, variables, type(jg).encode, x)
    with torch.no_grad():
        ours = tg.encode(torch.from_numpy(x))
    assert tg.quantize_b is None
    _close(ours[1], ref[1])
    _equal(ours[4][0], ref[4][0])
    _equal(ours[4][1], ref[4][1])


def test_forward(generators):
    cfg, jg, variables, tg = generators
    x = _images(6, cfg.hparams.resolution, B=3)
    dec, diff, codes = _apply(jg, variables, type(jg).__call__, x)
    with torch.no_grad():
        t_dec, t_diff, t_codes = tg(torch.from_numpy(x))
        t_ct, t_cb = tg.get_codes(torch.from_numpy(x))
    _close(t_dec, dec)
    for a, b in zip(t_diff, diff):
        _close(a, b)
    _equal(t_codes[0], codes[0])
    _equal(t_codes[1], codes[1])
    _equal(t_ct, codes[0])
    _equal(t_cb, codes[1])
    # the EMA update (training) is ported: on a copy, so that the shared
    # generator keeps its codebooks, it moves the buffers
    q = copy.deepcopy(tg.quantize_t)
    q(torch.zeros(1, 2, 2, q.dim), update_ema=True)
    assert not torch.equal(q.cluster_size, tg.quantize_t.cluster_size)


def test_forward_topbottom(generators):
    cfg, jg, variables, tg = generators
    x = _images(7, cfg.hparams.resolution)
    decs, diffs, codes = _apply(jg, variables, type(jg).forward_topbottom, x)
    with torch.no_grad():
        t_decs, t_diffs, t_codes = tg.forward_topbottom(torch.from_numpy(x))
    for a, b in zip(t_decs + t_diffs, decs + diffs):
        _close(a, b)
    _equal(t_codes[1], codes[1])


def test_hqvae_convert_matches_export(hqvae):
    _, _, variables, tg = hqvae
    mine = convert_variables(variables)
    ref = export_torch_state_dict(variables)
    assert sorted(mine) == sorted(ref)
    assert [q.dim for q in tg.quantizers] == [1024, 256, 64]
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('seed', [8, 9])
def test_hqvae_forward(hqvae, seed):
    cfg, jg, variables, tg = hqvae
    x = _images(seed, cfg.hparams.resolution)
    dec, diffs, codes = _apply(jg, variables, type(jg).__call__, x)
    with torch.no_grad():
        t_dec, t_diffs, t_codes = tg(torch.from_numpy(x))
        t_levels = tg.get_codes(torch.from_numpy(x))
    _close(t_dec, dec)
    for a, b in zip(t_diffs, diffs):
        _close(a, b)
    assert [c.shape[1] for c in t_levels] == [2, 4, 8]
    for a, b, c in zip(t_codes[:-1], codes[:-1], t_levels):
        _equal(a, b)
        _equal(c, b)
    _close(t_codes[-1], codes[-1])


def test_hqvae_decode_code(hqvae):
    cfg, jg, variables, tg = hqvae
    rng = np.random.RandomState(10)
    codes = [rng.randint(0, n, (2, s, s)).astype(np.int32)
             for n, s in zip(cfg.n_embed_levels, (2, 4, 8))]
    for drop in (None, 1):
        cs = [None if i == drop else c for i, c in enumerate(codes)]
        ref = jax.jit(lambda v: jg.apply(
            v, [None if c is None else jnp.asarray(c) for c in cs],
            method=type(jg).decode_code))(variables)
        with torch.no_grad():
            ours = tg.decode_code([None if c is None else torch.from_numpy(c)
                                   for c in cs])
        _close(ours, ref)
