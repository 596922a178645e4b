"""The 2-level HQ-Transformer's `bidirectional` and `top2bot` depth modes
and `use_given_top` in the PyTorch port against the JAX package, on the
tiny config at d 64, vocabulary 64, 2 spatial and 4 depth layers, a 4x4
top: the strict load of JAX's export, the teacher-forced logits (f32 and
bf16), the depth functions, the greedy samplers with and without given top
codes, the draws each mode makes, and what the port refuses (the scorer
on these modes).

Both sides get the same weights (JAX init, converted by
`convert_variables` and loaded with strict=True) and the same numpy
inputs. f32 logits are held at the repo's parity bound, atol 2e-4 / rtol
1e-3; greedy codes (top-k 1 at temperature 1e-6: every draw is the argmax,
whatever the random numbers) must be equal; bf16 gets a stated bound. The
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

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.models.stage2 import \
    hierarchical  # noqa: E402
from hqtransformer_tpu_torch.ops import int8 as q8  # noqa: E402
from hqtransformer_tpu_torch.sampling import engine  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    SamplingParams, make_hierarchical_sampler, make_hierarchical_scorer)

from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)
B, N_TOP, V, R = 3, 16, 64, 4
GREEDY = dict(top_k_top=1, top_k_bot=1, temperature_top=1e-6,
              temperature_bot=1e-6)
MODES = {'bidirectional': 'hq-transformer/bidirectional4',
         'top2bot': 'hq-transformer'}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(actual, expected, **kw):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               **{**TOL, **kw})


def config(build, mode):
    """The tiny 2-level config at d 64 and vocabulary 64 in depth `mode`
    ('bidirectional' or 'top2bot'), by `build` (the JAX package's or the
    port's parser)."""
    cfg = build(CFG)
    cfg.stage2.type = MODES[mode]
    cfg.stage2.vocab_size_img = V
    cfg.stage2.hparams.embed_dim = 64
    return cfg


def codes(seed):
    """Top codes [B, 16], raster bottom codes [B, 64] and their cells
    [B, 16, 4] (four distinct bottoms a cell)."""
    rng = np.random.RandomState(seed)
    ct = rng.randint(0, V, (B, N_TOP)).astype(np.int32)
    cells = np.stack([np.stack([rng.choice(V, R, replace=False)
                                for _ in range(N_TOP)]) for _ in range(B)])
    cb = hierarchical.cells_to_raster(_t(cells), 4, 2)
    return ct, cb.numpy().astype(np.int32), cells.astype(np.int32)


LABELS = np.array([1, 4, 9], np.int32)
_PAIRS = {}


def pair(mode):
    """(JAX stage-2 model, its f32 variables, port model with the same
    weights) of a depth mode, built once."""
    if mode not in _PAIRS:
        jm = jax_twostage.build_stage2(config(build_twostage_config, mode))
        ct, cb, _ = codes(1)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ct),
                             jnp.asarray(cb), jnp.asarray(LABELS))
        tm = twostage.build_stage2(config(torch_config, mode)).eval()
        tm.load_state_dict(convert_variables(v), strict=True)
        _PAIRS[mode] = jm, v, tm
    return _PAIRS[mode]


# ------------------------------------------------------------ structure

@pytest.mark.parametrize('mode', list(MODES))
def test_mode_properties_match_jax(mode):
    """bot_win, num_bottom_pred, len_seq_depth and the rows of
    pos_emb_depth as the JAX module derives them (top2bot: a window of 1,
    5 depth tokens; bidirectional4: a window of 2, 2 depth tokens;
    pos_emb_depth max(len_seq_depth, 5) rows in both)."""
    jm, v, tm = pair(mode)
    want = {'bidirectional': (2, 4, 2), 'top2bot': (1, 1, 5)}[mode]
    assert (jm.bot_win, jm.num_bottom_pred, jm.len_seq_depth) == want
    assert (tm.bot_win, tm.num_bottom_pred, tm.len_seq_depth) == want
    assert tm.depth_mode == jm.depth_mode == mode
    assert tm.pos_emb_depth.weight.shape == (5, 64)
    assert v['params']['pos_emb_depth']['embedding'].shape == (5, 64)


@pytest.mark.parametrize('mode', list(MODES))
def test_loads_jax_export_strictly(mode):
    """The port's state dict has exactly the keys of JAX's
    export_torch_state_dict, each equal, and loads with strict=True
    (tok_emb_bot_depth included, which only top2bot's forward reads)."""
    _, v, tm = pair(mode)
    ref = export_torch_state_dict(v)
    mine = convert_variables(v)
    assert sorted(mine) == sorted(ref) == sorted(tm.state_dict())
    assert 'tok_emb_bot_depth.weight' in mine
    for k, r in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), r, err_msg=k)
    tm.load_state_dict(mine, strict=True)


# ------------------------------------------------- teacher-forced forward

@pytest.mark.parametrize('mode', list(MODES))
def test_forward_matches_jax(mode):
    """The teacher-forced top and bottom logits within atol 2e-4 of JAX's,
    f32 (top2bot: the causal chain over [sos + h, Top, Bot_0..2] and the
    cells of the raster bottoms)."""
    jm, v, tm = pair(mode)
    ct, cb, _ = codes(2)
    ref = jax.jit(jm.apply)(v, jnp.asarray(ct), jnp.asarray(cb),
                            jnp.asarray(LABELS))
    ours = tm(_t(ct), _t(cb), _t(LABELS))
    assert ours[0].shape == (B, N_TOP, V) and ours[1].shape == (B, 64, V)
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize('mode', list(MODES))
def test_forward_bf16_near_jax(mode):
    """The teacher-forced logits in bf16 (serving_bf16_params on both
    sides) against JAX's in bf16, within the bound of the repo's other
    bf16 tests (test_torch_conditioning.test_text_scorer_bf16_near_jax):
    |d| at most 4 bf16 steps of the logits' largest magnitude, argmax equal
    in >= 90% of rows. XLA keeps f32 inside its fusions where the port
    rounds each op (ROADMAP C1)."""
    _, v, _ = pair(mode)
    jm = jax_twostage.build_stage2(config(build_twostage_config, mode),
                                   dtype=jnp.bfloat16)
    tm = twostage.build_stage2(config(torch_config, mode),
                               torch.bfloat16).eval()
    tm.load_state_dict(twostage.serving_bf16_params(convert_variables(v)),
                       strict=True, assign=True)
    ct, cb, _ = codes(3)
    ref = jax.jit(jm.apply)(jax_twostage.serving_bf16_params(v),
                            jnp.asarray(ct), jnp.asarray(cb),
                            jnp.asarray(LABELS))
    ours = tm(_t(ct), _t(cb), _t(LABELS))
    for name, o, r in zip(('top', 'bottom'), ours, ref):
        o, r = o.float().numpy(), _np(r)
        steps = np.abs(o - r).max() / (np.abs(r).max() * 2.0 ** -7)
        agree = np.mean(o.argmax(-1) == r.argmax(-1))
        print(f'bf16 {mode} forward {name}: max |d| {steps:.2f} bf16 '
              f'steps, argmax equal {agree:.4f}')
        assert steps <= 4 and agree >= 0.9, (name, steps, agree)


# -------------------------------------------------------- depth functions

def test_depth_bidirectional_matches_jax():
    """depth_bidirectional on one h [B, D]: logits of the top [B, 1, V]
    and of the r bottoms [B, r, V] within atol 2e-4 of JAX's, f32."""
    jm, v, tm = pair('bidirectional')
    h = np.random.RandomState(4).randn(B, 64).astype(np.float32)
    ref = jax.jit(lambda v, h: jm.apply(
        v, h, method=JaxGPT.depth_bidirectional))(v, jnp.asarray(h))
    ours = tm.depth_bidirectional(_t(h))
    assert ours[0].shape == (B, 1, V) and ours[1].shape == (B, R, V)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_depth_causal_step_matches_jax():
    """depth_causal_step over the five tokens of one chain: each step's
    output within atol 2e-4 of JAX's (Block.step on per-head caches), and
    the caches' rows written so far equal within the same bound."""
    jm, v, tm = pair('top2bot')
    rng = np.random.RandomState(5)
    xs = rng.randn(5, B, 1, 64).astype(np.float32)
    step = jax.jit(lambda v, x, kc, vc, n: jm.apply(
        v, x, kc, vc, n, method=JaxGPT.depth_causal_step),
        static_argnums=4)
    jkc = jnp.zeros((4, B, 4, 5, 16), jnp.float32)
    jvc = jnp.zeros_like(jkc)
    kc, vc = tm.depth_caches(B, torch.device('cpu'))
    assert kc.shape == (4, B, 4, 5, 16)
    for n in range(5):
        ref, jkc, jvc = step(v, jnp.asarray(xs[n]), jkc, jvc, n)
        ours = tm.depth_causal_step(_t(xs[n]), kc, vc, n)
        _close(ours, ref)
        _close(kc[:, :, :, :n + 1], np.asarray(jkc)[:, :, :, :n + 1])
        _close(vc[:, :, :, :n + 1], np.asarray(jvc)[:, :, :, :n + 1])


# --------------------------------------------------------- the samplers

def _jax_greedy(mode, given=None):
    jm, v, _ = pair(mode)
    fn = jax_sampler(jm, N_TOP, JaxParams(**GREEDY), attention='packed',
                     use_given_top=given is not None)
    args = () if given is None else (jnp.asarray(given),)
    return fn(v, jax.random.PRNGKey(1), jnp.asarray(LABELS), *args)


@pytest.mark.parametrize('mode', list(MODES))
def test_greedy_sampler_matches_jax(mode):
    """make_hierarchical_sampler at top-k 1 against JAX's: the top codes
    [B, 16] and the bottoms [B, 16, 4] equal."""
    _, _, tm = pair(mode)
    ref_t, ref_b = _jax_greedy(mode)
    ct, cb = make_hierarchical_sampler(tm, N_TOP, SamplingParams(**GREEDY))(
        torch.Generator().manual_seed(0), _t(LABELS))
    assert ct.shape == (B, N_TOP) and cb.shape == (B, N_TOP, R)
    assert ct.dtype == cb.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(ref_b))


@pytest.mark.parametrize('mode', ['parallel', *MODES])
def test_use_given_top_matches_jax(mode):
    """With use_given_top the codes_t are the given codes and the greedy
    bottoms equal JAX's greedy ones under the same given codes (the
    parallel mode on the tiny config itself)."""
    given = np.random.RandomState(6).randint(0, V, (B, N_TOP)).astype(
        np.int32)
    if mode == 'parallel':
        cfg = torch_config(CFG)
        cfg.stage2.vocab_size_img, cfg.stage2.hparams.embed_dim = V, 64
        jcfg = build_twostage_config(CFG)
        jcfg.stage2.vocab_size_img, jcfg.stage2.hparams.embed_dim = V, 64
        jm = jax_twostage.build_stage2(jcfg)
        ct0, cb0, _ = codes(1)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ct0),
                             jnp.asarray(cb0), jnp.asarray(LABELS))
        tm = twostage.build_stage2(cfg).eval()
        tm.load_state_dict(convert_variables(v), strict=True)
        ref_t, ref_b = jax_sampler(jm, N_TOP, JaxParams(**GREEDY),
                                   attention='packed', use_given_top=True)(
            v, jax.random.PRNGKey(1), jnp.asarray(LABELS),
            jnp.asarray(given))
    else:
        _, _, tm = pair(mode)
        ref_t, ref_b = _jax_greedy(mode, given)
    ct, cb = make_hierarchical_sampler(
        tm, N_TOP, SamplingParams(**GREEDY), use_given_top=True)(
            torch.Generator().manual_seed(0), _t(LABELS), _t(given))
    np.testing.assert_array_equal(ct.numpy(), given)
    np.testing.assert_array_equal(np.asarray(ref_t), given)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(ref_b))


@pytest.mark.parametrize('mode,draws', [('parallel', [(B,), (B, R)]),
                                        ('bidirectional', [(B * 5,)]),
                                        ('top2bot', [(B,)] * 5)])
def test_draws_per_position(monkeypatch, mode, draws):
    """The sampling kernel's calls a position: parallel the top [B] and
    the bottom group [4B]; bidirectional one joint draw [5B] at the
    bottoms' top-k with the top's temperature; top2bot five draws [B].
    With use_given_top the same calls: the top is drawn, then replaced."""
    import hqtransformer_tpu_torch.ops.topk_topp as tt
    real, seen = tt.sample_topk, []

    def spy(logits, u, k, temperature, **kw):
        seen.append((tuple(u.shape), k, temperature))
        return real(logits, u, k, temperature, **kw)
    monkeypatch.setattr(tt, 'sample_topk', spy)
    tm = (pair(mode)[2] if mode != 'parallel' else
          twostage.build_stage2(torch_config(CFG)).eval())
    if mode == 'parallel':
        tm.load_state_dict(twostage.random_state(
            tm, torch.Generator().manual_seed(0)))
        draws = [(B,), (B * R,)]
    params = SamplingParams(top_k_top=3, top_k_bot=5, temperature_top=0.5,
                            temperature_bot=0.7)
    runs = {}
    for given in (False, True):
        seen.clear()
        args = (_t(np.zeros((B, N_TOP), np.int32)),) if given else ()
        make_hierarchical_sampler(tm, N_TOP, params, use_given_top=given)(
            torch.Generator().manual_seed(0), _t(LABELS), *args)
        runs[given] = list(seen)
    want_k = {'parallel': [(3, 0.5), (5, 0.7)], 'bidirectional': [(5, 0.5)],
              'top2bot': [(3, 0.5)] + [(5, 0.7)] * 4}[mode]
    want = [(s, k, t) for s, (k, t) in zip(draws, want_k)] * N_TOP
    assert runs[False] == runs[True] == want


# ------------------------------------------------------- what is refused

@pytest.mark.parametrize('mode', list(MODES))
def test_int8_serving_and_scorer_refuse_the_mode(mode):
    """The scorer takes the parallel mode only, as JAX asserts: in float
    and in int8 serving it raises a ValueError that names the mode. (The
    samplers serve these modes in int8: `test_torch_int8_modes.py`.)"""
    _, _, tm = pair(mode)
    for int8 in (q8.Int8Serving(), q8.INT8MAX):
        with pytest.raises(ValueError, match=mode):
            make_hierarchical_scorer(tm, N_TOP, int8)


def test_given_top_codes_go_with_the_flag():
    _, _, tm = pair('top2bot')
    gen, labels = torch.Generator(), _t(LABELS)
    with pytest.raises(ValueError, match='use_given_top'):
        make_hierarchical_sampler(tm, N_TOP)(
            gen, labels, torch.zeros(B, N_TOP, dtype=torch.long))
    with pytest.raises(ValueError, match='use_given_top'):
        make_hierarchical_sampler(tm, N_TOP, use_given_top=True)(gen, labels)


def test_depth_samplers_cover_every_mode():
    assert sorted(engine._DEPTH_SAMPLERS) == sorted(
        hierarchical.DEPTH_MODES)
