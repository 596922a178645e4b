"""The flat stage-2 baselines in the PyTorch port against the JAX package:
`IGPT` (class-conditional and unconditional) and `Transformer1d`, on the
tiny config at d 64, vocabulary 64, 2 layers and 4 heads (a 4x4 top of 16
codes; Transformer1d over 64 bottom codes after a 16-token prefix, the top
codes, as the released `bottom` config reads them): the strict load of
JAX's export, the teacher-forced logits, the greedy samplers
(`make_igpt_sampler`, `make_txt2img_sampler`) and their decode attention
positions, `make_pixel_sampler_igpt` and the stage-1 decode of a missing
level; and, at full size on the meta device, the parameters of the four
released configs this port builds beside the flagship's family (both
`vqvae2-*` baselines, the `-bidirectional` and `-causal` depth modes).

Both sides get the same weights (JAX init, converted by
`convert_variables` and loaded with strict=True) and the same numpy
inputs. f32 logits are held at the repo's parity bound, atol 2e-4 / rtol
1e-3; greedy codes (top-k 1: every draw is the argmax, whatever the random
numbers) must be equal. The JAX samplers run with attention='packed',
their XLA oracle of the decode attention kernel on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import \
    export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.checkpoint import torch_key_to_path  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.sampling.engine import (  # noqa: E402
    make_igpt_sampler as jax_igpt_sampler)
from hqtransformer_tpu.sampling.engine import (  # noqa: E402
    make_txt2img_sampler as jax_txt2img_sampler)

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage2 import \
    transformer  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    make_igpt_sampler, make_txt2img_sampler)

from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401
from test_torch_slice import _images  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)
B, N_TOP, N_BOT, V = 3, 16, 64, 64
LABELS = np.array([2, 5, 8], np.int32)
CASES = {'igpt-class': ('top', True), 'igpt-none': ('top', False),
         'transformer1d': ('bottom', False)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(actual, expected, **kw):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               **{**TOL, **kw})


def config(build, case):
    """The tiny config with stage-2 type 'top' (an IGPT over the 16 top
    codes) or 'bottom' (a Transformer1d over the 64 bottom codes after a
    16-token prefix), at d 64 and vocabulary 64, by `build`."""
    kind, cls = CASES[case]
    cfg = build(CFG)
    s2 = cfg.stage2
    s2.type, s2.use_cls_cond, s2.vocab_size_img = kind, cls, V
    s2.hparams.embed_dim = 64
    if kind == 'bottom':
        s2.hparams.ctx_len_img, s2.hparams.ctx_len_txt = N_BOT, N_TOP
    return cfg


def inputs(case, seed):
    """(codes, conditioning) of a case: top codes [B, 16] and labels for
    IGPT (class ids, or the JAX package's dummy zeros); bottom codes
    [B, 64] and a prefix of top codes [B, 16] for Transformer1d."""
    rng = np.random.RandomState(seed)
    if CASES[case][0] == 'bottom':
        return (rng.randint(0, V, (B, N_BOT)).astype(np.int32),
                rng.randint(0, V, (B, N_TOP)).astype(np.int32))
    labels = LABELS if CASES[case][1] else np.zeros(B, np.int32)
    return rng.randint(0, V, (B, N_TOP)).astype(np.int32), labels


_PAIRS = {}


def pair(case):
    """(JAX stage-2 model, its f32 variables, port model with the same
    weights), built once."""
    if case not in _PAIRS:
        jm = jax_twostage.build_stage2(config(build_twostage_config, case))
        v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                             *map(jnp.asarray, inputs(case, 0)))
        tm = twostage.build_stage2(config(torch_config, case)).eval()
        tm.load_state_dict(convert_variables(v), strict=True)
        _PAIRS[case] = jm, v, tm
    return _PAIRS[case]


@pytest.mark.parametrize('case', list(CASES))
def test_builds_and_loads_jax_export_strictly(case):
    """build_stage2 makes the IGPT of type 'top' and the Transformer1d of
    type 'bottom' (its text vocabulary the image one, as JAX builds it);
    the state dict has exactly the keys of JAX's export_torch_state_dict
    (`sos` a bare [1, 1, D] parameter without class conditioning), each
    equal, and loads with strict=True."""
    _, v, tm = pair(case)
    want = {'igpt-class': ('sos.weight', 'head.weight'),
            'igpt-none': ('sos', 'head.weight'),
            'transformer1d': ('tok_emb_txt.weight', 'pos_emb_txt.weight',
                              'head_img.weight', 'head_txt.weight')}[case]
    assert isinstance(tm, transformer.Transformer1d if case ==
                      'transformer1d' else transformer.IGPT)
    ref = export_torch_state_dict(v)
    mine = convert_variables(v)
    assert sorted(mine) == sorted(ref) == sorted(tm.state_dict())
    for name in want:
        assert name in mine, name
    for k, r in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), r, err_msg=k)
    if case == 'transformer1d':
        assert tm.head_txt.weight.shape == (V, 64)
    tm.load_state_dict(mine, strict=True)


@pytest.mark.parametrize('case', list(CASES))
def test_forward_matches_jax(case):
    """The teacher-forced logits within atol 2e-4 of JAX's, f32: IGPT's
    [B, 16, V]; Transformer1d's image [B, 64, V] and text [B, 15, V]
    logits."""
    jm, v, tm = pair(case)
    a, b = inputs(case, 1)
    ref = jax.jit(jm.apply)(v, jnp.asarray(a), jnp.asarray(b))
    ours = tm(_t(a), _t(b))
    if case == 'transformer1d':
        assert ours[0].shape == (B, N_BOT, V)
        assert ours[1].shape == (B, N_TOP - 1, V)
        for o, r in zip(ours, ref):
            _close(o, r)
    else:
        assert ours.shape == (B, N_TOP, V)
        _close(ours, ref)


@pytest.mark.parametrize('case', list(CASES))
def test_greedy_sampler_matches_jax(case):
    """make_igpt_sampler / make_txt2img_sampler at top-k 1 against JAX's:
    the codes equal; decode attention runs at pos 1..15 (IGPT) and 16..78
    (after the 16-token prefix), n_layers launches a position."""
    from hqtransformer_tpu_torch.models.stage2 import layers
    jm, v, tm = pair(case)
    _, cond = inputs(case, 2)
    if case == 'transformer1d':
        jax_fn, ours_fn, n, first = (jax_txt2img_sampler,
                                     make_txt2img_sampler, N_BOT, N_TOP)
    else:
        jax_fn, ours_fn, n, first = (jax_igpt_sampler, make_igpt_sampler,
                                     N_TOP, 1)
    ref = jax_fn(jm, n, top_k=1, attention='packed')(
        v, jax.random.PRNGKey(1), jnp.asarray(cond))
    real, seen = layers.decode_attention_step, []

    def spy(*args, **kwargs):
        seen.append(args[6])
        return real(*args, **kwargs)
    layers.decode_attention_step = spy
    try:
        codes = ours_fn(tm, n, top_k=1)(torch.Generator().manual_seed(0),
                                        _t(cond))
    finally:
        layers.decode_attention_step = real
    assert codes.shape == (B, n) and codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    assert seen == [p for p in range(first, first + n - 1)
                    for _ in range(2)]


@pytest.fixture(scope='module')
def igpt_two_stage():
    """(JAX TwoStageModel of the 'top' config, its variables, the same
    weights for the port)."""
    cfg = config(build_twostage_config, 'igpt-class')
    jm = jax_twostage.TwoStageModel(cfg)
    res = cfg.dataset.image_resolution
    v1 = jax.jit(jm.stage1.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, res, res, 3)))
    _, v2, _ = pair('igpt-class')
    variables = {'stage1': v1, 'stage2': v2}
    return jm, variables, {s: convert_variables(x)
                           for s, x in variables.items()}


def test_pixel_sampler_igpt_matches_jax(igpt_two_stage):
    """TwoStageModel.make_pixel_sampler_igpt at top-k 1 against JAX's: the
    codes equal, the pixels of the top codes decoded alone within atol
    2e-4."""
    jm, variables, weights = igpt_two_stage
    ref_px, ref_codes = jm.make_pixel_sampler_igpt(top_k=1)(
        variables, jax.random.PRNGKey(4), jnp.asarray(LABELS))
    tm = twostage.TwoStageModel(config(torch_config, 'igpt-class'),
                                device='cpu')
    px, codes = tm.make_pixel_sampler_igpt(top_k=1)(
        weights, torch.Generator().manual_seed(0), _t(LABELS))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert px.shape == (B, 32, 32, 3)
    _close(px, ref_px)
    for entry in (tm.make_pixel_sampler, tm.make_pipelined_sampler):
        with pytest.raises(NotImplementedError, match='IGPT'):
            entry()


@pytest.mark.parametrize('missing', ['top', 'bottom'])
def test_decode_code_with_a_missing_level_matches_jax(igpt_two_stage,
                                                      missing):
    """stage1.decode_code with one level None (zeros in place of its code
    vectors) against JAX's, within atol 2e-4, f32."""
    jm, variables, weights = igpt_two_stage
    (ct, cb), _ = jax.jit(jm.extract_codes)(
        variables, jnp.asarray(_images(9, B)))
    ct, cb = np.asarray(ct).reshape(B, 4, 4), np.asarray(cb).reshape(B, 8, 8)
    args = (None, cb) if missing == 'top' else (ct, None)
    ref = jm.stage1.apply(variables['stage1'],
                          *[None if a is None else jnp.asarray(a)
                            for a in args],
                          method=type(jm.stage1).decode_code)
    tm = twostage.TwoStageModel(config(torch_config, 'igpt-class'),
                                device='cpu')
    tm.load_weights(weights)
    ours = tm.stage1.decode_code(*[None if a is None else _t(a).long()
                                   for a in args])
    _close(ours, ref)
    with pytest.raises(ValueError, match='level'):
        tm.stage1.decode_code(None, None)


RELEASED = tuple(f'configs/imagenet/stage2/{name}.yaml' for name in (
    'vqvae2-l12-top8x8', 'vqvae2-l4-cond-top8x8-pred-bot16x16',
    'hqtransformer-l12-top8x8-bidirectional',
    'hqtransformer-l12-top8x8-causal'))


@pytest.mark.parametrize('path', RELEASED)
def test_released_config_shapes_match_jax(path):
    """A released config at full size: the port's stage-2 model, built on
    the meta device (nothing allocated), has one parameter for every leaf
    of JAX's `jax.eval_shape` of init, of the same shape (Dense kernels
    transposed), and the JAX module's class."""
    cfg = build_twostage_config(path)
    jm = jax_twostage.build_stage2(cfg)
    hp, z = cfg.stage2.hparams, (lambda *s: jnp.zeros(s, jnp.int32))
    args = {'top': (z(1, 64), z(1)), 'bottom': (z(1, 256), z(1, 64))}.get(
        cfg.stage2.type, (z(1, 64), z(1, 256), z(1)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    leaves = {(col, tuple(str(k.key) for k in p)): leaf.shape
              for col, tree in shapes.items()
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    with torch.device('meta'):
        tm = twostage.build_stage2(torch_config(path))
    assert type(tm).__name__ == type(jm).__name__
    found = set()
    for name, t in tm.state_dict().items():
        col, p = torch_key_to_path(name)
        shape = leaves[(col, p)]
        want = tuple(reversed(shape)) if p[-1] == 'kernel' else tuple(shape)
        assert tuple(t.shape) == want, name
        found.add((col, p))
    assert found == set(leaves)
    assert len(tm.blocks) == hp.n_layers
