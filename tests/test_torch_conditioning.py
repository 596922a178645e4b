"""The conditionings and cell embeddings of the 2-level family in the
PyTorch port against the JAX package, on the tiny config at d 64,
vocabulary 64, a text vocabulary of 32 and an 8-token caption: class, text
and no conditioning, the `reduce`, `multiple`, `transformerN` and
`bidirectionalN` cell embeddings, 2-d positions with a 4x4 bottom window,
and random order; the teacher-forced logits, the greedy samplers and the
scorer with a text prefix (f32, and the scorer in bf16), and the strict
load of every new parameter name. The 3-level family's are in
`test_torch_conditioning_multilevel.py`.

Both sides get the same weights (JAX init, converted by
`convert_variables` and loaded with strict=True) and the same numpy
inputs. f32 logits are held at the repo's parity bound, atol 2e-4 / rtol
1e-3; greedy (top-k 1) codes must be equal; bf16 gets a stated bound. The
JAX samplers run with attention='packed', their XLA oracle of the decode
attention kernel on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import \
    export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402
from hqtransformer_tpu.models.stage2.hierarchical import \
    HierarchicalGPT as JaxGPT  # noqa: E402
from hqtransformer_tpu.sampling.engine import \
    SamplingParams as JaxParams  # noqa: E402
from hqtransformer_tpu.sampling.engine import \
    make_hierarchical_sampler as jax_sampler  # noqa: E402
from hqtransformer_tpu.sampling.engine import \
    make_hierarchical_scorer as jax_scorer  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage2 import \
    hierarchical  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    SamplingParams, make_hierarchical_sampler, make_hierarchical_scorer)

from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)
B, N_TOP, V, V_TXT, N_TXT = 3, 16, 64, 32, 8
GREEDY = dict(top_k_top=1, top_k_bot=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(actual, expected, **kw):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               **{**TOL, **kw})


def _condition(s2, cond):
    s2.use_cls_cond = cond == 'class'
    s2.use_txt_cond = cond == 'text'
    s2.vocab_size_txt = V_TXT
    s2.hparams.ctx_len_txt = N_TXT


def config2(build, cond, embedding='transformer1', position='1d', ratio=4,
            random_order=False):
    """The tiny 2-level config at d 64 and vocabulary 64, with the given
    conditioning ('class', 'text' or 'none'), cell embedding, positions,
    bottom ratio (16: `parallel16`, a 4x4 bottom window) and random
    order, by `build` (the JAX package's or the port's parser)."""
    cfg = build(CFG)
    s2 = cfg.stage2
    _condition(s2, cond)
    s2.vocab_size_img = V
    if ratio == 16:
        s2.type, s2.ratio_bot2top = 'hq-transformer/parallel16', 16
    hp = s2.hparams
    hp.embed_dim, hp.embedding_type = 64, embedding
    hp.position_embedding, hp.use_random_order = position, random_order
    return cfg


def labels_for(cond, seed=0):
    rng = np.random.RandomState(100 + seed)
    if cond == 'text':
        return rng.randint(0, V_TXT, (B, N_TXT)).astype(np.int32)
    if cond == 'class':
        return rng.randint(0, 10, (B,)).astype(np.int32)
    return np.zeros((B,), np.int32)     # the JAX package's dummy labels


def codes2(seed, ratio):
    """Top codes [B, 16] and raster bottom codes [B, 16 ratio] whose
    bottoms differ from each other within every cell."""
    rng = np.random.RandomState(seed)
    ct = rng.randint(0, V, (B, N_TOP)).astype(np.int32)
    cells = np.stack([np.stack([rng.choice(V, ratio, replace=False)
                                for _ in range(N_TOP)]) for _ in range(B)])
    cb = hierarchical.cells_to_raster(_t(cells), 4, int(ratio ** 0.5))
    return ct, cb.numpy().astype(np.int32), cells.astype(np.int32)


CASES2 = {
    'none-reduce': dict(cond='none', embedding='reduce'),
    'text-transformer1': dict(cond='text'),
    'class-multiple': dict(cond='class', embedding='multiple'),
    'class-transformer2': dict(cond='class', embedding='transformer2'),
    'none-2d-ratio16': dict(cond='none', position='2d', ratio=16),
    'class-bidirectional1': dict(cond='class', embedding='bidirectional1'),
    'class-random-order': dict(cond='class', random_order=True),
}
_PAIRS = {}


def pair2(case):
    """(JAX stage-2 model, its f32 variables, port model with the same
    weights, codes, labels) of a 2-level case, built once."""
    key = ('2', case)
    if key not in _PAIRS:
        kw = CASES2[case]
        jm = jax_twostage.build_stage2(config2(build_twostage_config, **kw))
        ct, cb, cells = codes2(1, kw.get('ratio', 4))
        labels = labels_for(kw['cond'])
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ct),
                             jnp.asarray(cb), jnp.asarray(labels))
        tm = twostage.build_stage2(config2(torch_config, **kw)).eval()
        tm.load_state_dict(convert_variables(v), strict=True)
        _PAIRS[key] = jm, v, tm, (ct, cb, cells), labels
    return _PAIRS[key]


# ------------------------------------------------- teacher-forced forward

@pytest.mark.parametrize('case', list(CASES2))
def test_forward_matches_jax(case):
    """2 levels: every logit output (the text logits third) within atol
    2e-4 of JAX's, f32."""
    jm, v, tm, (ct, cb, _), labels = pair2(case)
    ref = jax.jit(jm.apply)(v, jnp.asarray(ct), jnp.asarray(cb),
                            jnp.asarray(labels))
    ours = tm(_t(ct), _t(cb), _t(labels))
    assert len(ours) == len(ref) == (3 if case.startswith('text') else 2)
    r = CASES2[case].get('ratio', 4)
    want = [(B, N_TOP, V), (B, N_TOP * r, V), (B, N_TXT - 1, V_TXT)]
    for i, (o, e) in enumerate(zip(ours, ref)):
        assert tuple(o.shape) == want[i]
        _close(o, e, err_msg=f'output {i}')


def test_reduce_packs_bottoms_k_major():
    """The `reduce` cell embedding packs the r bottom embeddings K-major
    (channel c holds element c // r of bottom c % r): equal to JAX's
    embed_cells, where a plain reshape (bottom-major) is not, on cells
    whose four bottoms all differ."""
    jm, v, tm, (ct, _, cells), _ = pair2('none-reduce')
    pos = np.tile(np.arange(N_TOP, dtype=np.int32), (B, 1))
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, method=JaxGPT.embed_cells))(
        v, jnp.asarray(ct), jnp.asarray(cells), jnp.asarray(pos))
    ours = tm.embed_cells(_t(ct), _t(cells), _t(pos).long())
    _close(ours, ref)
    top = tm._emb(tm.tok_emb_top, _t(ct)) + tm.spatial_pos_emb(_t(pos).long())
    plain = top + tm._emb(tm.tok_emb_bot, _t(cells)).reshape(B, N_TOP, -1)
    assert tm.tok_emb_bot.weight.shape == (V, 64 // 4)
    assert not np.allclose(plain.numpy(), _np(ref), **TOL)


# --------------------------------------------------------- serving paths

@pytest.mark.parametrize('case', ['none-reduce', 'text-transformer1',
                                  'class-random-order'])
def test_greedy_sampler_matches_jax(case):
    """make_hierarchical_sampler at top-k 1 against JAX's: the codes equal
    (with an 8-token caption prefix in the text case; with random order,
    each cell embedding of the sampler carries pred_emb_top)."""
    jm, v, tm, _, labels = pair2(case)
    ref_t, ref_b = jax_sampler(jm, N_TOP, JaxParams(**GREEDY),
                               attention='packed')(
        v, jax.random.PRNGKey(1), jnp.asarray(labels))
    ct, cb = make_hierarchical_sampler(tm, N_TOP, SamplingParams(**GREEDY))(
        torch.Generator().manual_seed(0), _t(labels))
    assert ct.shape == (B, N_TOP) and cb.shape == (B, N_TOP, 4)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(ref_b))


def test_text_sampler_caches_hold_the_prefix():
    """With a caption of 8 tokens the packed caches have 8 + N - 1 rows:
    the prefill writes rows 0..7, the steps 8..22, and no row stays
    empty."""
    _, _, tm, _, labels = pair2('text-transformer1')
    _, (kc, vc) = make_hierarchical_sampler(
        tm, N_TOP, SamplingParams(**GREEDY), return_caches=True)(
            torch.Generator(), _t(labels))
    assert kc.shape == (2, N_TXT + N_TOP - 1, B, 64)
    assert bool((kc.abs().amax(dim=(0, 2, 3)) > 0).all())
    assert bool((vc.abs().amax(dim=(0, 2, 3)) > 0).all())


def test_text_scorer_matches_jax():
    """make_hierarchical_scorer with a text prefix against JAX's: the
    per-step top and bottom logits within atol 2e-4, f32."""
    jm, v, tm, (ct, _, cells), labels = pair2('text-transformer1')
    ref = jax_scorer(jm, N_TOP, attention='packed')(
        v, jnp.asarray(labels), jnp.asarray(ct), jnp.asarray(cells))
    ours = make_hierarchical_scorer(tm, N_TOP)(_t(labels), _t(ct),
                                               _t(cells))
    assert ours[0].shape == (B, N_TOP, V) and ours[1].shape == (B, N_TOP, 4,
                                                                V)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_text_scorer_bf16_near_jax():
    """The text scorer in bf16 (serving_bf16_params on both sides)
    against JAX's in bf16, within the bound of the bf16 depth tests
    (test_torch_multilevel.test_depth_phases_bf16_near_jax): |d| at most 4
    bf16 steps of the logits' largest magnitude and argmax equal in >= 90%
    of rows."""
    jm0, v, _, (ct, _, cells), labels = pair2('text-transformer1')
    kw = CASES2['text-transformer1']
    jm = jax_twostage.build_stage2(config2(build_twostage_config, **kw),
                                   dtype=jnp.bfloat16)
    v16 = jax_twostage.serving_bf16_params(v)
    tm = twostage.build_stage2(config2(torch_config, **kw),
                               torch.bfloat16).eval()
    tm.load_state_dict(twostage.serving_bf16_params(convert_variables(v)),
                       strict=True, assign=True)
    ref = jax_scorer(jm, N_TOP, attention='packed')(
        v16, jnp.asarray(labels), jnp.asarray(ct), jnp.asarray(cells))
    ours = make_hierarchical_scorer(tm, N_TOP)(_t(labels), _t(ct),
                                               _t(cells))
    for name, o, r in zip(('top', 'bottom'), ours, ref):
        o, r = o.float().numpy(), _np(r)
        steps = np.abs(o - r).max() / (np.abs(r).max() * 2.0 ** -7)
        agree = np.mean(o.argmax(-1) == r.argmax(-1))
        print(f'bf16 text scorer {name}: max |d| {steps:.2f} bf16 steps, '
              f'argmax equal {agree:.4f}')
        assert steps <= 4 and agree >= 0.9, (name, steps, agree)


# --------------------------------------------------------- weight names

NEW_NAMES = {
    'none-reduce': ['sos'],
    'text-transformer1': ['tok_emb_txt.weight', 'pos_emb_txt.weight',
                          'ln_txt.weight', 'ln_txt.bias', 'head_txt.weight'],
    'class-multiple': ['sos.weight', 'pos_emb_bot'],
    'class-transformer2': ['emb_blocks.0.attn.query.weight',
                           'emb_blocks.0.mlp.2.bias'],
    'none-2d-ratio16': ['sos', 'pos_emb_top_h.weight',
                        'pos_emb_top_w.weight'],
    'class-random-order': ['pred_emb_top.weight'],
}


@pytest.mark.parametrize('case', list(NEW_NAMES))
def test_new_names_load_strictly_as_exported(case):
    """Every new parameter name of the 2-level family: see
    `assert_names_as_exported`."""
    _, v, tm, _, _ = pair2(case)
    assert_names_as_exported(v, tm, NEW_NAMES[case])


def assert_names_as_exported(v, tm, names):
    """The port's state dict has exactly the keys of JAX's
    export_torch_state_dict (`sos` a bare parameter when unconditional,
    `sos.weight` under class labels), `names` among them, each equal to
    the export, and loads with strict=True."""
    ref = export_torch_state_dict(v)
    mine = convert_variables(v)
    assert sorted(mine) == sorted(ref) == sorted(tm.state_dict())
    for name in names:
        assert name in mine, name
    for k, r in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), r, err_msg=k)
    tm.load_state_dict(mine, strict=True)
    if 'sos' in names:
        assert 'sos.weight' not in mine
