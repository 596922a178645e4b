"""Stage-1 variants of the PyTorch port against the JAX package, f32 on
the CPU: the resampling ops and modules; the 2-level HQ-VAE with the
nearest and conv2 resamplers, the 3-level HQ-VAE with conv2 and average
pooling, the plain VQGAN and the VQGAN2 baseline in both upsample modes and
decoding types, with EMA and learned codebooks, shared and not; and every
released stage-1 config, built at full width in name and shape only.

Each variant's JAX variables load into the port with `strict=True` through
`convert_variables`, which must agree with the JAX package's
`export_torch_state_dict`. Codes must be equal, tensors within atol 2e-4 /
rtol 1e-3.
"""

import dataclasses
import functools
import glob
import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_stage1_config  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.stage1 import generator as jgen  # noqa: E402
from hqtransformer_tpu.models.stage1.quantizer import \
    VectorQuantizer as JaxVQ  # noqa: E402
from hqtransformer_tpu.ops import resample as jrs  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_stage1_config as torch_stage1_config  # noqa: E402
from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.evaluation.stage1 import (  # noqa: E402
    init_stage1_weights, make_reconstructor)
from hqtransformer_tpu_torch.models.stage1 import \
    generator as tgen  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.layers import \
    ConvTranspose2d  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.quantizer import \
    VectorQuantizer  # noqa: E402
from hqtransformer_tpu_torch.ops import resample as rs  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)
B = 2
RES = 32


def _close(actual, expected):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               **TOL)


def _equal(actual, expected):
    np.testing.assert_array_equal(np.asarray(actual), np.asarray(expected))


# ------------------------------------------------------------ resampling ops

def _nhwc(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('op', ['avg_pool', 'upsample_nearest',
                                'space_to_depth_conv',
                                'depth_to_space_conv_transpose'])
def test_resample_op_matches_jax(op):
    x = _nhwc(0, (2, 8, 6, 12))
    if op == 'space_to_depth_conv':
        hwio = _nhwc(1, (2, 2, 12, 5))
        bias = _nhwc(2, (5,))
        ref = jrs.space_to_depth_conv(jnp.asarray(x), jnp.asarray(hwio),
                                      jnp.asarray(bias), 2)
        ours = rs.space_to_depth_conv(
            torch.from_numpy(x),
            torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias), 2)
    elif op == 'depth_to_space_conv_transpose':
        w = _nhwc(1, (12, 5, 2, 2))
        bias = _nhwc(2, (5,))
        ref = jrs.depth_to_space_conv_transpose(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), 2)
        ours = rs.depth_to_space_conv_transpose(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            2)
    else:
        ref = getattr(jrs, op)(jnp.asarray(x), 2)
        ours = getattr(rs, op)(torch.from_numpy(x), 2)
    assert ours.shape == ref.shape
    _close(ours, ref)


def _module_pair(name, jmod, x, tmod):
    """Init the JAX module as the generator's child `name` (the name
    decides the weight layout in the conversion), load its weights into the
    port module strictly, and return the port module and the JAX output on
    x."""
    v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    prefix = name.replace('_0', '.0') + '.'
    state = convert_variables({'params': {name: v['params']}})
    tmod.load_state_dict({k.removeprefix(prefix): t
                          for k, t in state.items()}, strict=True)
    return tmod, jmod.apply(v, jnp.asarray(x))


@pytest.mark.parametrize('kind', ['ConvDown', 'ConvTransposeUp',
                                  'TorchConvTranspose'])
def test_resample_module_matches_jax(kind):
    x = _nhwc(4, (2, 8, 8, 16))
    if kind == 'ConvDown':
        tmod, ref = _module_pair('down_t', jgen.ConvDown(16, 2), x,
                                 tgen.ConvDown(16, 2))
        ours = tmod(torch.from_numpy(x))
    elif kind == 'ConvTransposeUp':
        tmod, ref = _module_pair('upsamples_0', jgen.ConvTransposeUp(16, 2),
                                 x, tgen.ConvTransposeUp(16, 2))
        ours = tmod(torch.from_numpy(x))
    else:
        tmod, ref = _module_pair('upsample_t',
                                 jgen.TorchConvTranspose(8, 4, 2, 1), x,
                                 ConvTranspose2d(16, 8, 4, stride=2,
                                                 padding=1))
        ours = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert ours.shape == ref.shape
    _close(ours.detach(), ref)


def test_vector_quantizer_matches_jax():
    """The learned codebook: z_q, the loss with its codebook term, codes;
    and the straight-through value."""
    z = _nhwc(5, (2, 3, 3, 16))
    tq, ref = _module_pair('quantize', JaxVQ(n_embed=40, dim=16), z,
                           VectorQuantizer(40, 16))
    assert list(tq.state_dict()) == ['embedding.weight']
    ours = tq(torch.from_numpy(z))
    _close(ours[0].detach(), ref[0])
    _close(ours[1].detach(), ref[1])
    _equal(ours[2], ref[2])
    _close(tq.get_codebook_entry(ours[2]).detach(), ref[0])


# ------------------------------------------------------ generator variants

def _variant(cfg, name):
    """The tiny stage-1 config (32^2 images, an 8x8 bottom grid, 256 codes
    of dim 64) as the variant `name`."""
    aux = cfg.hparams_aux
    hp = cfg.hparams
    opts = dict(
        simrqgan2_nearest=dict(upsample='nearest'),
        simrqgan2_conv2=dict(upsample='conv2'),
        simrqgan2_conv2_learned=dict(upsample='conv2', ema=False),
        simrqgan2_nearest_shared=dict(upsample='nearest', shared=True),
        hqvae3_conv2=dict(type='hqvae', upsample='conv2', levels=3),
        hqvae3_avgpool_learned=dict(type='hqvae', upsample=None, levels=3,
                                    ema=False),
        vqgan=dict(type='vqgan', ema=False),
        vqgan_ema=dict(type='vqgan'),
        vqgan2_deconv2d_concat=dict(type='vqgan2', upsample='deconv2d'),
        vqgan2_deconv2d_concat_shared=dict(type='vqgan2',
                                           upsample='deconv2d', shared=True),
        # 'sum' adds the encoder's 16x16 map to decoder_top's, so their
        # widths (ch * ch_mult[-2], z_channels) must agree
        vqgan2_nearest_sum=dict(type='vqgan2', upsample='nearest',
                                decoding='sum', ema=False, ch_mult=[2, 2]),
    )[name]
    aux = dataclasses.replace(
        aux, upsample=opts.get('upsample', aux.upsample),
        shared_codebook=opts.get('shared', False),
        decoding_type=opts.get('decoding', 'concat'),
        code_levels=opts.get('levels'))
    hp = dataclasses.replace(hp, ch_mult=opts.get('ch_mult', hp.ch_mult))
    return dataclasses.replace(cfg, type=opts.get('type', 'simrqgan2'),
                               ema_update=opts.get('ema', True),
                               n_embed_levels=[64, 128, 256], hparams=hp,
                               hparams_aux=aux)


VARIANTS = ('simrqgan2_nearest', 'simrqgan2_conv2', 'simrqgan2_conv2_learned',
            'simrqgan2_nearest_shared', 'hqvae3_conv2',
            'hqvae3_avgpool_learned', 'vqgan', 'vqgan_ema',
            'vqgan2_deconv2d_concat', 'vqgan2_deconv2d_concat_shared',
            'vqgan2_nearest_sum')
BYPASS = tuple(v for v in VARIANTS if v.startswith(('simrqgan2', 'vqgan2')))
# VQGAN2 has no decode_code and no get_codes, in JAX and in the port
CODES = tuple(v for v in VARIANTS if not v.startswith('vqgan2'))


def _code_grids(cfg):
    """Each level's code grid side, top first."""
    bot = cfg.hparams.attn_resolutions[0]
    if cfg.type == 'vqgan':
        return [bot]
    if cfg.type == 'hqvae':
        return [bot // 4, bot // 2, bot]
    if cfg.type == 'vqgan2':
        return [bot, 2 * bot]
    return [bot // 2, bot]


def _jax_outputs(jg, cfg, variables, x, codes):
    """Every entry point of the JAX generator on images x, and its
    decode_code on `codes` (a level of None: zeros), in one jitted call."""
    G = type(jg)

    def run(v, x, codes):
        out = {'encode': jg.apply(v, x, method=G.encode),
               'forward': jg.apply(v, x)}
        if cfg.type in ('simrqgan2', 'vqgan2'):
            out['bypass'] = jg.apply(v, x, bottom_bypass=True)
        if cfg.type != 'vqgan2':
            out['get_codes'] = jg.apply(v, x, method=G.get_codes)
            if cfg.type == 'vqgan':
                out['decode_code'] = [jg.apply(v, codes[0],
                                               method=G.decode_code)]
            elif cfg.type == 'hqvae':
                out['decode_code'] = [
                    jg.apply(v, [None if i == drop else c
                                 for i, c in enumerate(codes)],
                             method=G.decode_code)
                    for drop in (None, 1)]
            elif cfg.hparams_aux.shared_codebook:
                # JAX's decode_code looks bottom codes up in quantize_b,
                # which a shared codebook leaves without variables: decode
                # the top codebook's entries (the port's lookup) instead
                qt, qb = (jg.apply(v, c, method=lambda m, c:
                                   m.quantize_t.get_codebook_entry(c))
                          for c in codes)
                out['decode_code'] = [
                    jg.apply(v, *pair, method=G.decode)
                    for pair in ((qt, qb), (jnp.zeros_like(qt), qb),
                                 (qt, jnp.zeros_like(qb)))]
            else:
                out['decode_code'] = [
                    jg.apply(v, *[None if i == drop else c
                                  for i, c in enumerate(codes)],
                             method=G.decode_code)
                    for drop in (None, 0, 1)]
        return out

    return jax.jit(run)(variables, jnp.asarray(x),
                        [jnp.asarray(c) for c in codes])


@functools.cache
def variant(name):
    """(config, JAX variables, JAX outputs, port generator, images, codes)
    of a variant; the port generator holds the JAX weights."""
    cfg = _variant(build_twostage_config(CFG).stage1, name)
    tcfg = _variant(torch_config(CFG).stage1, name)
    jg = jgen.build_generator(cfg)
    variables = jax.jit(jg.init)(jax.random.PRNGKey(len(name)),
                                 jnp.zeros((1, RES, RES, 3), jnp.float32))
    tg = tgen.build_generator(tcfg).eval()
    tg.load_state_dict(convert_variables(variables), strict=True)
    rng = np.random.RandomState(len(name))
    x = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    n_embed = (cfg.n_embed_levels if cfg.type == 'hqvae'
               else [cfg.n_embed] * 2)
    codes = [rng.randint(0, n, (B, s, s)).astype(np.int32)
             for n, s in zip(n_embed, _code_grids(cfg))]
    return cfg, tcfg, variables, _jax_outputs(jg, cfg, variables, x, codes), \
        tg, x, codes


def _reference_layout(exported):
    """The JAX export with a learned codebook of an N-level HQ-VAE named as
    in the PyTorch reference, the quantizer's nn.Embedding: the export
    names it `quantizers.<n>.weight`, the port `quantizers.<n>.embedding.
    weight`."""
    return {re.sub(r'^(quantizers\.\d+)\.weight$', r'\1.embedding.weight',
                   k): v for k, v in exported.items()}


@pytest.mark.parametrize('name', VARIANTS)
def test_variant_convert_matches_export(name):
    """The strict load (in `variant`) and the JAX export agree on every
    name and value; no quantize_b where JAX creates none."""
    cfg, _, variables, _, tg, _, _ = variant(name)
    mine = convert_variables(variables)
    ref = _reference_layout(export_torch_state_dict(variables))
    assert sorted(mine) == sorted(ref) == sorted(tg.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    has_b = any(k.startswith('quantize_b.') for k in mine)
    assert has_b == (cfg.type in ('simrqgan2', 'vqgan2')
                     and not cfg.hparams_aux.shared_codebook)
    if cfg.type in ('simrqgan2', 'vqgan2') and not has_b:
        assert tg.quantize_b is None


def _compare_tree(ours, ref, path='out'):
    """Codes (integers) equal, floats within the tolerance, recursively."""
    if isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _compare_tree(a, b, f'{path}[{i}]')
        return
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else \
        np.asarray(ours)
    assert ours.shape == ref.shape, path
    if np.issubdtype(ref.dtype, np.integer):
        _equal(ours, ref)
    else:
        _close(ours, ref)


@pytest.mark.parametrize('name', VARIANTS)
def test_variant_encode(name):
    _, _, _, ref, tg, x, _ = variant(name)
    with torch.no_grad():
        ours = tg.encode(torch.from_numpy(x))
    _compare_tree(ours, ref['encode'])


@pytest.mark.parametrize('name', VARIANTS)
def test_variant_forward(name):
    _, _, _, ref, tg, x, _ = variant(name)
    with torch.no_grad():
        ours = tg(torch.from_numpy(x))
    _compare_tree(ours, ref['forward'])


@pytest.mark.parametrize('name', BYPASS)
def test_variant_forward_bottom_bypass(name):
    """SimRQGAN2 gives (top-only pixels, pixels); VQGAN2 decodes zeros in
    place of its bottom."""
    _, _, _, ref, tg, x, _ = variant(name)
    with torch.no_grad():
        ours = tg(torch.from_numpy(x), bottom_bypass=True)
    _compare_tree(ours, ref['bypass'])


@pytest.mark.parametrize('name', CODES)
def test_variant_get_codes(name):
    _, _, _, ref, tg, x, _ = variant(name)
    with torch.no_grad():
        ours = tg.get_codes(torch.from_numpy(x))
    _compare_tree(ours, ref['get_codes'])


@pytest.mark.parametrize('name', CODES)
def test_variant_decode_code(name):
    """decode_code of random codes, with each level in turn given as None
    (zeros of the resampler's shape) for the 2-level generators and the
    middle level for the 3-level one."""
    cfg, _, _, ref, tg, _, codes = variant(name)
    codes = [torch.from_numpy(c).long() for c in codes]
    with torch.no_grad():
        if cfg.type == 'vqgan':
            ours = [tg.decode_code(codes[0])]
        elif cfg.type == 'hqvae':
            ours = [tg.decode_code([None if i == drop else c
                                    for i, c in enumerate(codes)])
                    for drop in (None, 1)]
        else:
            ours = [tg.decode_code(*[None if i == drop else c
                                     for i, c in enumerate(codes)])
                    for drop in (None, 0, 1)]
    for o in ours:
        assert o.shape == (B, RES, RES, 3)
    _compare_tree(ours, ref['decode_code'])


@pytest.mark.parametrize('name', VARIANTS)
def test_variant_reconstructor(name):
    """make_reconstructor: the forward's pixels clipped to [-1, 1] and
    each level's code map, top first."""
    cfg, tcfg, variables, ref, _, x, _ = variant(name)
    pixels, levels = make_reconstructor(tcfg, device='cpu')(
        convert_variables(variables), torch.from_numpy(x))
    dec, _, codes = ref['forward']
    _close(pixels, np.clip(np.asarray(dec), -1, 1))
    ref_levels = ([codes] if cfg.type == 'vqgan' else
                  codes[:2] if cfg.type != 'hqvae' else codes[:-1])
    assert [tuple(c.shape) for c in levels] == \
        [(B, s, s) for s in _code_grids(cfg)]
    _compare_tree(levels, list(ref_levels))
    if cfg.type != 'simrqgan2':
        with pytest.raises(ValueError, match='top_only'):
            make_reconstructor(tcfg, device='cpu', top_only=True)


def test_random_state_scales():
    """Seeded random weights of the conv2 generator with a learned
    codebook at the JAX initialisers' scales: a conv-transpose kernel
    lecun-normal over flax's fan-in (Cin Cout k, its kernel in torch's
    layout) with a zero bias, the codebook uniform in +-1/K."""
    tcfg = _variant(torch_config(CFG).stage1, 'simrqgan2_conv2_learned')
    w = init_stage1_weights(tcfg, seed=0, device='cpu')
    up = w['upsample_t.weight']
    assert up.shape == (64, 64, 2, 2)
    assert abs(float(up.std()) * (64 * 64 * 2) ** 0.5 - 1) < 0.05
    assert not w['upsample_t.bias'].any()
    down = w['down_t.weight']
    assert abs(float(down.std()) * (64 * 2 * 2) ** 0.5 - 1) < 0.05
    for q in ('quantize_t', 'quantize_b'):
        e = w[f'{q}.embedding.weight']
        assert float(e.abs().max()) <= 1 / 256
        assert float(e.abs().max()) > 0.9 / 256


# ------------------------------------------ released configs, full width

_EXPORT_SHAPES = {}


def _jax_export_shapes(cfg):
    """{name: shape} of the JAX export of a stage-1 config's variables,
    from `jax.eval_shape`: no weight is made; the export reads zero-strided
    views of one zero. Configs with the same generator share one trace."""
    key = repr((cfg.type, cfg.embed_dim, cfg.n_embed, cfg.n_embed_levels,
                cfg.ema_update, cfg.hparams, cfg.hparams_aux))
    if key not in _EXPORT_SHAPES:
        jg = jgen.build_generator(cfg)
        res = cfg.hparams.resolution
        shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, res, res, 3), jnp.float32))
        zeros = jax.tree.map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
            shapes)
        _EXPORT_SHAPES[key] = {k: v.shape for k, v in
                               export_torch_state_dict(zeros).items()}
    return _EXPORT_SHAPES[key]


STAGE1_CONFIGS = sorted(glob.glob('configs/*/stage1/*.yaml'))
STAGE2_CONFIGS = sorted(glob.glob('configs/*/stage2/*.yaml'))


@pytest.mark.parametrize('path', STAGE1_CONFIGS + STAGE2_CONFIGS)
def test_released_config_builds(path):
    """Every released stage-1 generator (and every stage-2 config's) builds
    in the port with the JAX export's names and shapes."""
    if '/stage1/' in path:
        cfg = build_stage1_config(path).stage1
        tcfg = torch_stage1_config(path).stage1
    else:
        cfg = build_twostage_config(path).stage1
        tcfg = torch_config(path).stage1
    with torch.device('meta'):
        tg = tgen.build_generator(tcfg)
    ours = {k: tuple(v.shape) for k, v in tg.state_dict().items()}
    assert ours == _reference_layout(_jax_export_shapes(cfg))
