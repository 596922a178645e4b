"""The port's stage-2 training (`hqtransformer_tpu_torch/train/`) against
the JAX package's `train/scheduler.py` and `train/stage2.py`, f32 on the
CPU on the tiny configs: the schedule at every step, the five losses, the
decay mask through the export names, one train step's loss, metrics and
gradients (2-level class, text and soft-label, 3-level), the parameters
and Adam moments after 3 steps with clipping active and with accumulation,
a bf16 step within a stated bound, and `remat`'s gradients bit-equal.

Each model's JAX variables load into the port with `strict=True`
(`convert_variables`, the JAX `export_torch_state_dict`'s mapping); both
get the same seeded numpy images and labels. Each test states its bound
and prints what it measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hqtransformer_tpu.config import OptConfig as JaxOptConfig  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.twostage import \
    TwoStageModel as JaxTwoStage  # noqa: E402
from hqtransformer_tpu.train import scheduler as jsched  # noqa: E402
from hqtransformer_tpu.train import stage2 as jtrain  # noqa: E402

from hqtransformer_tpu_torch.config import OptConfig  # noqa: E402
from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402
from hqtransformer_tpu_torch.train import scheduler as tsched  # noqa: E402
from hqtransformer_tpu_torch.train import stage2 as ttrain  # noqa: E402
from hqtransformer_tpu_torch.train.optim import grads_of  # noqa: E402

from test_torch_multilevel import tiny_config  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
B = 4
RES = 32


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))


# ---------------------------------------------------------------- schedule

SCHEDULES = {
    'fix': dict(warmup_epoch=1.0, mode='fix'),
    'not-from-zero': dict(warmup_epoch=1.0, multiplier=2.0,
                          start_from_zero=False),
    'buffer': dict(warmup_epoch=0.5, buffer_epoch=1.5),
    'const': dict(warmup_epoch=1.0, sched_type='const'),
    'min-lr': dict(warmup_epoch=0.5, min_lr=1e-5),
    'linear': dict(warmup_epoch=1.0, mode='linear', multiplier=1.5,
                   world_size=4),
    'sqrt': dict(warmup_epoch=1.0, mode='sqrt', world_size=4),
    'no-warmup': dict(),
}


@pytest.mark.parametrize('case', list(SCHEDULES))
def test_schedule_matches_jax_at_every_step(case):
    """Bound: rtol 1e-6, atol 1e-6 * base lr (f32 arithmetic in both; the
    cos may differ by an ulp, which the cosine's tail, 1 + cos near 0,
    magnifies relative to its tiny value)."""
    kw = SCHEDULES[case]
    ours = tsched.build_schedule(3e-4, 10, 60, **kw)
    ref = jsched.build_schedule(3e-4, 10, 60, **kw)
    got = np.array([ours(t) for t in range(66)])
    want = np.array([float(ref(t)) for t in range(66)])
    print(f'{case}: max abs diff {np.abs(got - want).max():.2e}')
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 3e-4)


def test_schedule_from_config_reads_warmup_or_warmup_config():
    cfg = torch_config(CFG)
    jcfg = build_twostage_config(CFG)
    for opt, jopt in ((cfg.optimizer, jcfg.optimizer),
                      (OptConfig(), JaxOptConfig())):
        ours = tsched.build_schedule_from_config(opt, 7, 40, world_size=1)
        ref = jsched.build_schedule_from_config(jopt, 7, 40, world_size=1)
        np.testing.assert_allclose([ours(t) for t in range(40)],
                                   [float(ref(t)) for t in range(40)],
                                   rtol=1e-6, atol=1e-6 * opt.base_lr)


# ------------------------------------------------------------------ losses

def _logits(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3


def _codes(seed, n, v):
    return np.random.RandomState(seed).randint(0, v, (B, n))


def _soft(seed, n, v):
    x = np.exp(_logits(seed, B, n, v))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('fn', ['log_prob_from_logits', 'cross_entropy',
                                'soft_target_cross_entropy',
                                'hierarchical_loss', 'multilevel_loss'])
def test_losses_match_jax(fn):
    """Bound: rtol 1e-6 on every loss and metric (f32)."""
    V = 37
    lt, lb, ltx = _logits(0, B, 4, V), _logits(1, B, 16, V), \
        _logits(2, B, 7, V)
    ct, cb = _codes(3, 4, V), _codes(4, 16, V)
    txt = _codes(5, 8, V)
    st, sb = _soft(6, 4, V), _soft(7, 16, V)
    cases = []
    if fn == 'log_prob_from_logits':
        cases.append(({'x': jtrain.log_prob_from_logits(jnp.asarray(lt))},
                      {'x': ttrain.log_prob_from_logits(_t(lt))}))
    elif fn == 'cross_entropy':
        cases.append(({'x': jtrain.cross_entropy(jnp.asarray(lb),
                                                 jnp.asarray(cb))},
                      {'x': ttrain.cross_entropy(_t(lb), _t(cb))}))
    elif fn == 'soft_target_cross_entropy':
        for ls in (0.0, 0.1):
            cases.append((
                {'x': jtrain.soft_target_cross_entropy(
                    jnp.asarray(lb), jnp.asarray(sb), ls)},
                {'x': ttrain.soft_target_cross_entropy(_t(lb), _t(sb), ls)}))
    elif fn == 'hierarchical_loss':
        for softs, text in ((None, False), ((st, sb), False),
                            (None, True)):
            jl = [jnp.asarray(lt), jnp.asarray(lb)] + \
                ([jnp.asarray(ltx)] if text else [])
            tl = [_t(lt), _t(lb)] + ([_t(ltx)] if text else [])
            kw = dict(weight_bottom=3.0, weight_img=0.9 if text else None,
                      weight_txt=0.1 if text else None)
            cases.append((
                jtrain.hierarchical_loss(
                    jl, (jnp.asarray(ct), jnp.asarray(cb)),
                    None if softs is None else tuple(map(jnp.asarray, softs)),
                    jnp.asarray(txt), **kw)[1],
                ttrain.hierarchical_loss(
                    tl, (_t(ct), _t(cb)),
                    None if softs is None else tuple(map(_t, softs)),
                    _t(txt), **kw)[1]))
    else:
        l2 = _logits(8, B, 64, V)
        c2 = _codes(9, 64, V)
        s2 = _soft(10, 64, V)
        for soft, text in ((False, False), (True, False), (False, True)):
            jl = [jnp.asarray(x) for x in (lt, lb, l2)]
            tl = [_t(x) for x in (lt, lb, l2)]
            if text:
                jl.append(jnp.asarray(ltx))
                tl.append(_t(ltx))
            softs = (st, sb, s2) if soft else None
            kw = dict(weight_img=0.9 if text else None,
                      weight_txt=0.1 if text else None)
            cases.append((
                jtrain.multilevel_loss(
                    jl, [jnp.asarray(c) for c in (ct, cb, c2)],
                    None if softs is None else [jnp.asarray(s)
                                                for s in softs],
                    jnp.asarray(txt), **kw)[1],
                ttrain.multilevel_loss(
                    tl, [_t(c) for c in (ct, cb, c2)],
                    None if softs is None else [_t(s) for s in softs],
                    _t(txt), **kw)[1]))
    for want, got in cases:
        assert set(want) == set(got)
        for k in want:
            print(f'{fn} {k}: rel diff {_rel(got[k], want[k]):.2e}')
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)


# -------------------------------------------------------------- the models

def _text(cfg):
    s2 = cfg.stage2
    s2.use_cls_cond, s2.use_txt_cond = False, True
    s2.vocab_size_txt, s2.hparams.ctx_len_txt = 64, 8
    s2.weight_img, s2.weight_txt = 0.9, 0.1
    return cfg


def _soft_labels(cfg):
    cfg.stage2.temp_soft_labels = 1.0
    return cfg


def _level3(cfg):
    return cfg


KINDS = {'class': (CFG, lambda c: c), 'text': (CFG, _text),
         'soft': (CFG, _soft_labels),
         'level3': (None, _level3)}


def _configs(kind):
    path, edit = KINDS[kind]
    if path is None:
        return (tiny_config(build_twostage_config),
                tiny_config(torch_config))
    return edit(build_twostage_config(path)), edit(torch_config(path))


_MODELS = {}


def models(kind, dtype='float32'):
    """(JAX TwoStageModel, its variables, the port's TwoStageModel holding
    the same weights, the configs), cached per kind and dtype."""
    key = (kind, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _configs(kind)
        jm = JaxTwoStage(jcfg, dtype=getattr(jnp, dtype))
        variables = jax.jit(jm.init_variables)(jax.random.PRNGKey(0))
        tm = TwoStageModel(tcfg, getattr(torch, dtype), device='cpu')
        tm.load_weights({s: convert_variables(v)
                         for s, v in variables.items()})
        tm.stage1.requires_grad_(False)
        _MODELS[key] = (jm, variables, tm, (jcfg, tcfg))
    return _MODELS[key]


def _batch(seed, cfg):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    s2 = cfg.stage2
    if s2.use_txt_cond:
        labels = rng.randint(0, s2.vocab_size_txt,
                             (B, s2.hparams.ctx_len_txt))
    else:
        labels = rng.randint(0, 10, (B,))
    return images, labels.astype(np.int32)


def _loss_kwargs(cfg):
    s2 = cfg.stage2
    return dict(weight_bottom=s2.weight_bottom or 4.0,
                weight_img=s2.weight_img, weight_txt=s2.weight_txt,
                temp_soft_labels=s2.temp_soft_labels,
                use_cond=bool(s2.use_cls_cond or s2.use_txt_cond),
                multilevel='multilevel-hq' in s2.type)


def _capture():
    """An optax transformation whose state after an update is the update
    it was given: the train step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def _jax_step(jm, variables, cfg, tx):
    step = jax.jit(jtrain.make_train_step(jm.stage2, jm.stage1, tx,
                                          **_loss_kwargs(cfg)))
    params = variables['stage2']['params']
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    return step, state


def _port_names(tree):
    return convert_variables({'params': jax.tree.map(np.asarray, tree)})


@pytest.mark.parametrize('kind', list(KINDS))
def test_train_step_loss_metrics_and_grads_match_jax(kind):
    """One step's loss, metrics and gradients. Bounds: loss and metrics
    rtol 1e-5; every gradient within 1e-5 of its tensor's largest entry,
    or of a thousandth of the largest entry of all gradients where that
    is more (the key biases' gradients are zero but for rounding)."""
    jm, variables, tm, (jcfg, tcfg) = models(kind)
    images, labels = _batch(1, jcfg)
    step, state = _jax_step(jm, variables, jcfg, _capture())
    state, jmetrics = step(state, variables['stage1'], jnp.asarray(images),
                           jnp.asarray(labels))
    want = _port_names(state.opt_state)
    loss_fn = ttrain.make_loss_fn(tm.stage2, tm.stage1, **_loss_kwargs(tcfg))
    params = dict(tm.stage2.named_parameters())
    loss, metrics = loss_fn(_t(images), _t(labels).long())
    got = grads_of(loss, params)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5)
    assert set(got) == set(want)
    worst = 0.0
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        scale = max(float(np.abs(w).max()), floor)
        worst = max(worst, float(np.abs(g - w).max()) / scale)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    print(f'{kind}: loss {float(loss.detach()):.6f} (JAX {float(jmetrics["loss"]):.6f}'
          f'), worst gradient error {worst:.2e} of its tensor\'s max')


def _find(tree, cls):
    return next(s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(s, cls))


@pytest.mark.parametrize('accum', [1, 2])
def test_three_steps_params_and_moments_match_jax(accum):
    """Parameters, Adam's moments (and the pending accumulation) after 3
    f32 steps, clipping active (norm 0.05). Bounds: parameters atol 1e-5,
    1% of one update's lr of 1e-3 (Adam divides each gradient by its own
    root mean square, so where a gradient is near zero its rounding
    error moves the update by up to that share); mu, nu and the
    accumulated gradients atol 1e-5 of their tensor's max (or of a
    thousandth of the largest over all tensors, where that is more)."""
    jm, variables, tm, (jcfg, tcfg) = models('class')
    tm = TwoStageModel(tcfg, device='cpu')
    tm.load_weights({s: convert_variables(v) for s, v in variables.items()})
    tm.stage1.requires_grad_(False)
    opt_kw = dict(base_lr=1e-3, weight_decay=0.05, betas=[0.9, 0.95],
                  grad_clip_norm=0.05)
    jopt = jtrain.make_optimizer(JaxOptConfig(**opt_kw), jsched.build_schedule(
        1e-3, 2, 10, warmup_epoch=1.0), accum)
    jstep, jstate = _jax_step(jm, variables, jcfg, jopt)
    topt = ttrain.make_optimizer(OptConfig(**opt_kw), tsched.build_schedule(
        1e-3, 2, 10, warmup_epoch=1.0), accum,
        mask=ttrain.decay_mask(tm.stage2))
    tstep = ttrain.make_train_step(tm.stage2, tm.stage1, topt,
                                   **_loss_kwargs(tcfg))
    tstate = ttrain.init_train_state(tm.stage2, topt)
    for i in range(3):
        images, labels = _batch(10 + i, jcfg)
        jstate, _ = jstep(jstate, variables['stage1'], jnp.asarray(images),
                          jnp.asarray(labels))
        tstate, _ = tstep(tstate, _t(images), _t(labels).long())
    assert tstate.step == 3 and tstate.opt_state.count == 3 // accum
    want = _port_names(jstate.params)
    moved = err = 0.0
    for k, w in want.items():
        got = tstate.params[k].detach().numpy()
        np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        err = max(err, float(np.abs(got - w.numpy()).max()))
        moved = max(moved, float(np.abs(got - convert_variables(
            {'params': variables['stage2']['params']})[k].numpy()).max()))
    adam = _find(jstate.opt_state, optax.ScaleByAdamState)
    pending = {}
    if accum > 1:
        pending = {'acc': (_port_names(jstate.opt_state.acc_grads),
                           tstate.opt_state.acc)}
    for name, (w_tree, g_tree) in dict(
            mu=(_port_names(adam.mu), tstate.opt_state.mu),
            nu=(_port_names(adam.nu), tstate.opt_state.nu),
            **pending).items():
        floor = 1e-3 * max(float(w.abs().max()) for w in w_tree.values())
        for k, w in w_tree.items():
            scale = max(float(w.abs().max()), floor)
            np.testing.assert_allclose(g_tree[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f'{name} {k}')
    print(f'accum {accum}: parameters moved up to {moved:.2e}, within '
          f'{err:.2e} of JAX; moments within 1e-5 of their max')


def test_decay_mask_matches_jax():
    """The decayed names equal JAX's `decay_mask` through the export names,
    for the 2-level, 3-level and text models."""
    for kind in ('class', 'level3', 'text'):
        jm, variables, tm, _ = models(kind)
        params = variables['stage2']['params']
        mask = jtrain.decay_mask(params)
        flags = _port_names(jax.tree.map(
            lambda m, p: np.full(p.shape, float(m), np.float32), mask,
            params))
        want = {k for k, v in flags.items() if float(v.reshape(-1)[0])}
        got = ttrain.decay_mask(tm.stage2)
        assert got == want, sorted(got ^ want)
        assert got < set(dict(tm.stage2.named_parameters()))
        print(f'{kind}: {len(got)} of {len(flags)} parameters decay')


def _step_grads(kind, dtype, seed):
    """(JAX's loss and gradients, the port's) of one step in `dtype`."""
    jm, variables, tm, (jcfg, tcfg) = models(kind, dtype)
    images, labels = _batch(seed, jcfg)
    step, state = _jax_step(jm, variables, jcfg, _capture())
    state, jmetrics = step(state, variables['stage1'], jnp.asarray(images),
                           jnp.asarray(labels))
    loss_fn = ttrain.make_loss_fn(tm.stage2, tm.stage1, **_loss_kwargs(tcfg))
    loss, _ = loss_fn(_t(images), _t(labels).long())
    got = grads_of(loss, dict(tm.stage2.named_parameters()))
    return ((float(jmetrics['loss']), _port_names(state.opt_state)),
            (float(loss.detach()), got, loss.dtype))


def _rel_l2(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return (num / sum(float((b[k] ** 2).sum()) for k in b)) ** 0.5


def test_bf16_step_within_bound():
    """A bf16 step (bf16 activations, f32 parameters, f32 losses and
    gradients) against JAX's bf16 step. bf16 rounding alone moves JAX's
    gradients by some 20% (relative L2) from its f32 ones on this random
    model, so the bounds are relative to that: the port's bf16 gradients
    lie within 1.5x that distance of JAX's bf16 ones, and within 1.5x of
    it from the f32 gradients; the loss within rtol 2e-2."""
    (jl, jg), (tl, tg, dtype) = _step_grads('class', 'bfloat16', 2)
    (_, jg32), (_, tg32, _) = _step_grads('class', 'float32', 2)
    assert dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in tg.values())
    noise = _rel_l2(jg, jg32)
    to_jax, to_f32 = _rel_l2(tg, jg), _rel_l2(tg, tg32)
    print(f'bf16: loss {tl:.5f} vs JAX {jl:.5f}; gradients (relative L2): '
          f'port to JAX {to_jax:.3f}, port to its f32 {to_f32:.3f}, JAX '
          f'to its f32 {noise:.3f}')
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert to_jax <= 1.5 * noise and to_f32 <= 1.5 * noise


def test_remat_gradients_bit_equal():
    """`remat=True` (each main block under torch.utils.checkpoint) gives
    the same gradients bit for bit on the CPU."""
    _, variables, _, (_, tcfg) = models('class')
    grads = []
    images, labels = _batch(3, tcfg)
    for remat in (False, True):
        tm = TwoStageModel(tcfg, device='cpu', remat=remat)
        tm.load_weights({s: convert_variables(v)
                         for s, v in variables.items()})
        loss_fn = ttrain.make_loss_fn(tm.stage2, tm.stage1,
                                      **_loss_kwargs(tcfg))
        loss, _ = loss_fn(_t(images), _t(labels).long())
        grads.append(grads_of(loss, dict(tm.stage2.named_parameters())))
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    with pytest.raises(ValueError, match='remat'):
        cfg = torch_config('configs/imagenet/stage2/vqvae2-l12-top8x8.yaml')
        cfg.stage2.hparams.n_layers = 1
        TwoStageModel(cfg, device='cpu', remat=True)


# ------------------------------------------------------------- BPE dropout

DROPOUT_CAPTIONS = ('a photograph of an astronaut riding a horse on the '
                    'moon', 'Two dogs playing in the snow, one of them brown!')


@pytest.mark.parametrize('name,p', [('bpe16k_huggingface', 0.1),
                                    ('bytebpe16k_huggingface', 0.5)])
def test_bpe_dropout_matches_jax_in_distribution(name, p):
    """BPE dropout (training's `bpe_pdrop`; 0.1 in the text config): p 0
    is bit-equal to the tokenizer without dropout; at p the mean token
    count over 2,000 encodes of a caption is within 3 standard errors of
    JAX's (the `tokenizers` package's, whose draws cannot be reproduced:
    one comparison a case, as each misses by chance 0.27% of the time),
    and draws from a seeded generator repeat."""
    import random

    pytest.importorskip('tokenizers')
    from hqtransformer_tpu.data.tokenizers import \
        create_tokenizer as jax_tokenizer
    from hqtransformer_tpu_torch.data.tokenizers import create_tokenizer

    plain = create_tokenizer(name)
    zero = create_tokenizer(name, dropout=0.0, generator=random.Random(0))
    for c in DROPOUT_CAPTIONS:
        assert zero.encode(c) == plain.encode(c)
    n, c = 2000, DROPOUT_CAPTIONS[0]
    ref = jax_tokenizer(name, dropout=p)
    ours = create_tokenizer(name, dropout=p, generator=random.Random(1))
    a = np.array([len(ours.encode(c)) for _ in range(n)], float)
    b = np.array([len(ref.encode(c)) for _ in range(n)], float)
    se = np.sqrt(a.var() / n + b.var() / n)
    print(f'{name} p {p}: mean {a.mean():.3f} tokens (JAX {b.mean():.3f}, '
          f'{len(plain.encode(c))} without dropout), '
          f'{abs(a.mean() - b.mean()) / se:.2f} standard errors')
    assert a.var() > 0 and abs(a.mean() - b.mean()) <= 3 * se
    again = create_tokenizer(name, dropout=0.5, generator=random.Random(1))
    first = create_tokenizer(name, dropout=0.5, generator=random.Random(1))
    assert [again.encode(DROPOUT_CAPTIONS[0]) for _ in range(5)] == \
        [first.encode(DROPOUT_CAPTIONS[0]) for _ in range(5)]
    gen = create_tokenizer(name, dropout=0.5,
                           generator=torch.Generator().manual_seed(2))
    assert len({tuple(gen.encode(DROPOUT_CAPTIONS[0])) for _ in range(20)}) > 1
