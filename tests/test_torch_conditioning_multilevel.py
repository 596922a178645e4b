"""The conditionings and cell embeddings of the 3-level family in the
PyTorch port against the JAX package, on `test_torch_multilevel`'s tiny
config: class, text and no conditioning, the `transformer2` embedding,
2-d positions and the ignored random-order flag (teacher-forced logits and
the strict load of every new name); the full-size FFHQ l24 and CC15M
parameter shapes; and the 3-level `reduce` refusal. Helpers and bounds
are `test_torch_conditioning`'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import torch_key_to_path  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402

from test_torch_conditioning import (  # noqa: E402,F401
    B, N_TOP, _close, _condition, _no_grad, _one_thread, _t,
    assert_names_as_exported, labels_for)
from test_torch_multilevel import VOCABS, tiny_config  # noqa: E402

FFHQ = 'configs/ffhq/stage2/hqtransformer-l24-ffhq.yaml'
CC15M = 'configs/cc15m/stage2/hqtransformer-l12-cc15m.yaml'


def config3(build, cond='class', embedding='transformer1', position='1d',
            random_order=False):
    """test_torch_multilevel's tiny 3-level config with the given
    conditioning, cell embedding, positions and random order."""
    cfg = tiny_config(build)
    _condition(cfg.stage2, cond)
    hp = cfg.stage2.hparams
    hp.embedding_type, hp.position_embedding = embedding, position
    hp.use_random_order = random_order
    return cfg


def codes3(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCABS[li], (B, N_TOP * 4 ** li)).astype(np.int32)
            for li in range(3)]


CASES3 = {
    'text': dict(cond='text'),
    'none': dict(cond='none'),
    'class-transformer2': dict(embedding='transformer2'),
    'class-2d': dict(position='2d'),
    'class-random-order': dict(random_order=True),
}
_PAIRS = {}


def pair3(case):
    key = ('3', case)
    if key not in _PAIRS:
        kw = CASES3[case]
        jm = jax_twostage.build_stage2(config3(build_twostage_config, **kw))
        codes, labels = codes3(2), labels_for(kw.get('cond', 'class'))
        v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                             [jnp.asarray(c) for c in codes],
                             jnp.asarray(labels))
        tm = twostage.build_stage2(config3(torch_config, **kw)).eval()
        tm.load_state_dict(convert_variables(v), strict=True)
        _PAIRS[key] = jm, v, tm, codes, labels
    return _PAIRS[key]


NEW_NAMES = {
    'text': ['tok_emb_txt.weight', 'pos_emb_txt.weight', 'ln_txt.weight',
             'head_txt.weight'],
    'none': ['sos'],
    'class-transformer2': ['emb_blocks.0.attn.proj.weight',
                           'emb_blocks.0.mlp.0.weight'],
    'class-2d': ['pos_emb_top_h.weight', 'pos_emb_top_w.weight'],
}


@pytest.mark.parametrize('case', list(CASES3))
def test_forward_matches_jax_3_levels(case):
    """3 levels: every level's logits (the text logits fourth) within atol
    2e-4 of JAX's, f32. The random-order flag is ignored, as JAX ignores
    it: no pred_emb_top."""
    jm, v, tm, codes, labels = pair3(case)
    assert 'pred_emb_top.weight' not in tm.state_dict()
    ref = jax.jit(jm.apply)(v, [jnp.asarray(c) for c in codes],
                            jnp.asarray(labels))
    ours = tm([_t(c) for c in codes], _t(labels))
    assert len(ours) == len(ref) == (4 if case == 'text' else 3)
    for i, (o, e) in enumerate(zip(ours, ref)):
        _close(o, e, err_msg=f'output {i}')


@pytest.mark.parametrize('case', list(NEW_NAMES))
def test_new_names_load_strictly_as_exported(case):
    """Every new parameter name of the 3-level family, as
    `test_torch_conditioning.assert_names_as_exported` says."""
    _, v, tm, _, _ = pair3(case)
    assert_names_as_exported(v, tm, NEW_NAMES[case])


@pytest.mark.parametrize('path', [FFHQ, CC15M])
def test_full_size_shapes_match_jax(path):
    """The released FFHQ l24 and CC15M configs at full size: the port's
    stage-2 model, built on the meta device (nothing allocated), has one
    parameter for every leaf of JAX's `jax.eval_shape` of init, of the
    same shape (Dense kernels transposed); FFHQ's pos_emb_top keeps its
    256 rows (ctx_len_img) for 64 top positions; the depth transformer is
    JAX's hpd, 4 layers of the main width."""
    cfg, tcfg = build_twostage_config(path), torch_config(path)
    jm = jax_twostage.build_stage2(cfg)
    s2 = cfg.stage2
    labels = (jnp.zeros((1, s2.hparams.ctx_len_txt), jnp.int32)
              if s2.use_txt_cond else jnp.zeros((1,), jnp.int32))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64), jnp.int32),
                            jnp.zeros((1, 256), jnp.int32), labels)
    leaves = {(col, tuple(str(k.key) for k in p)): leaf.shape
              for col, tree in shapes.items()
              for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    with torch.device('meta'):
        tm = twostage.build_stage2(tcfg)
    state = tm.state_dict()
    assert all(t.is_meta for t in state.values())
    found = set()
    for name, t in state.items():
        col, p = torch_key_to_path(name)
        shape = leaves[(col, p)]
        want = tuple(reversed(shape)) if p[-1] == 'kernel' else tuple(shape)
        assert tuple(t.shape) == want, name
        found.add((col, p))
    assert found == set(leaves)
    D = s2.hparams.embed_dim
    assert tm.hpd.__dict__ == jm.hpd.__dict__
    assert len(tm.depths) == 4 and tm.depths[0].attn.n_heads == s2.hparams.n_heads
    if path == FFHQ:
        assert (tm.use_cls_cond, tm.use_txt_cond) == (False, False)
        assert tuple(state['pos_emb_top.weight'].shape) == (256, D)
        assert tuple(state['tok_emb_bot.weight'].shape) == (8192, D // 4)
        assert tuple(state['sos'].shape) == (1, 1, D)
    else:
        assert tm.use_txt_cond and tm.sos_len == 64
        assert tuple(state['tok_emb_txt.weight'].shape) == (16384, D)


def test_three_level_reduce_fails_in_jax_and_is_refused():
    """Why the 3-level `reduce` embedding is refused: the JAX module's
    embed_cells concatenates level embeddings of widths D, D/4 and D/16
    along the cell axis and raises TypeError; the port raises
    NotImplementedError when it is built."""
    codes = [jnp.asarray(c) for c in codes3(0)]
    with pytest.raises(TypeError, match='concatenate'):
        jax_twostage.build_stage2(config3(
            build_twostage_config, embedding='reduce')).init(
                jax.random.PRNGKey(0), codes, jnp.zeros((B,), jnp.int32))
    with pytest.raises(NotImplementedError, match='reduce'):
        twostage.build_stage2(config3(torch_config, embedding='reduce'))
