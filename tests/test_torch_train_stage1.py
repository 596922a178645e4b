"""The port's stage-1 training against the JAX package, f32 on the CPU at
tiny sizes: the EMA codebook update (with and without restarts), the
discriminator (`ActNorm`, `NLayerDiscriminator` in 'gn', 'bn' and
'actnorm'), LPIPS on random VGG weights, `decode(ret_pre_out=True)`, the
GAN losses and `adopt_weight`, and the whole two-optimizer GAN step in
its faithful, fast, bypass and residual-L1 modes over 2 steps.

Each module's JAX variables load into the port with `strict=True`
(`convert_variables`); both get the same seeded numpy inputs. Each test
states its bound and prints what it measured.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.config import OptConfig as JaxOptConfig  # noqa: E402
from hqtransformer_tpu.config import (Stage1Hparams as JaxHparams,  # noqa
                                      Stage1HparamsDisc as JaxDisc,
                                      VQGAN2Hparams as JaxAux)
from hqtransformer_tpu.models.stage1 import generator as jgen  # noqa: E402
from hqtransformer_tpu.models.stage1 import layers as jlayers  # noqa: E402
from hqtransformer_tpu.models.stage1 import lpips as jlpips  # noqa: E402
from hqtransformer_tpu.ops import quantize as jq  # noqa: E402
from hqtransformer_tpu.train import stage1 as jtrain  # noqa: E402
from hqtransformer_tpu.train.scheduler import \
    build_schedule as jax_schedule  # noqa: E402

from hqtransformer_tpu_torch.config import (OptConfig, Stage1Hparams,  # noqa
                                            Stage1HparamsDisc, VQGAN2Hparams)
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models.stage1 import generator as tgen  # noqa
from hqtransformer_tpu_torch.models.stage1 import layers as tlayers  # noqa
from hqtransformer_tpu_torch.models.stage1 import lpips as tlpips  # noqa
from hqtransformer_tpu_torch.ops import quantize as tq  # noqa: E402
from hqtransformer_tpu_torch.train import stage1 as ttrain  # noqa: E402
from hqtransformer_tpu_torch.train.scheduler import \
    build_schedule  # noqa: E402

B, RES = 2, 32


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, variables):
    module.load_state_dict(convert_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return module


# -------------------------------------------------------------- EMA update

def _ema_inputs(n, k=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randn(k, d).astype(np.float32)
    cluster = (rng.rand(k) * 3).astype(np.float32)
    avg = (emb * cluster[:, None]).astype(np.float32)
    z = rng.randn(n, d).astype(np.float32)
    codes = rng.randint(0, k // 2, n)      # the upper half stays unused
    return emb, cluster, avg, z, codes


@pytest.mark.parametrize('l2', [False, True])
def test_ema_update_matches_jax(l2):
    """Without restarts. Bound: rtol 1e-5, atol 1e-6 (the per-code sums in
    another order: index-add against JAX's one-hot product)."""
    emb, cluster, avg, z, codes = _ema_inputs(300)
    want = jq.ema_update(jq.EMAState(*map(jnp.asarray, (emb, cluster, avg))),
                         jnp.asarray(z), jnp.asarray(codes), use_l2_norm=l2)
    got = tq.ema_update(tq.EMAState(*map(_t, (emb, cluster, avg))), _t(z),
                        _t(codes), use_l2_norm=l2)
    for name, g, w in zip(tq.EMAState._fields, got, want):
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        print(f'l2 {l2} {name}: max abs diff {err:.2e}')
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize('n', [40, 200])
def test_ema_restart_rows(n):
    """With restarts (40 rows: fewer than the 64 codes, tiled with noise;
    200: more): the used codes' rows equal JAX's, each restarted row of
    embedding_avg is a batch vector plus noise in [0, 0.01 / sqrt(D))
    (exactly a batch vector when there are enough rows), with count 1.
    Bounds: rtol 1e-5, atol 1e-6 on the used rows."""
    emb, cluster, avg, z, codes = _ema_inputs(n)
    state = jq.EMAState(*map(jnp.asarray, (emb, cluster, avg)))
    want = jq.ema_update(state, jnp.asarray(z), jnp.asarray(codes),
                         restart_unused_codes=True,
                         restart_key=jax.random.PRNGKey(3))
    gen = torch.Generator().manual_seed(3)
    got = tq.ema_update(tq.EMAState(*map(_t, (emb, cluster, avg))), _t(z),
                        _t(codes), restart_unused_codes=True, generator=gen)
    used = np.asarray(want.cluster_size) >= 1.0
    restarted = ~(cluster * 0.99 + np.bincount(codes, minlength=64) * 0.01
                  >= 1.0)
    assert restarted.any() and (~restarted).any()
    np.testing.assert_array_equal(got.cluster_size.numpy()[restarted], 1.0)
    for g, w in zip(got, want):
        if g.dim() == 2:
            np.testing.assert_allclose(g.numpy()[~restarted],
                                       np.asarray(w)[~restarted], rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(got.cluster_size.numpy(),
                               np.asarray(want.cluster_size), rtol=1e-5)
    assert used.sum() == (~restarted).sum() + restarted.sum()
    noise = 0.01 / np.sqrt(z.shape[1])
    rows = got.embedding_avg.numpy()[restarted]
    diff = rows[:, None, :] - z[None]          # [restarted, N, D]
    if n < 64:
        ok = ((diff >= -1e-7) & (diff < noise + 1e-7)).all(-1).any(-1)
    else:
        ok = (np.abs(diff) == 0).all(-1).any(-1)
    print(f'n {n}: {restarted.sum()} rows restarted, each a batch vector '
          f'(+ noise < {noise:.4f}): {ok.all()}')
    assert ok.all()


def test_quantizer_updates_after_its_lookup():
    """EMAVectorQuantizer.forward(update_ema=True): the codes and the
    quantization come from the codebook as it was, the buffers equal
    `ema_update`'s on the flattened z."""
    q = tgen.make_quantizer(True, 16, 64)
    emb, cluster, avg, _, _ = _ema_inputs(1)
    q.load_state_dict({'embedding': _t(emb), 'cluster_size': _t(cluster),
                       'embedding_avg': _t(avg)})
    z = _t(_np(4, 2, 5, 5, 16))
    before_q, _, before_codes = q(z)
    after_q, _, codes = q(z, update_ema=True)
    assert torch.equal(codes, before_codes) and torch.equal(after_q, before_q)
    want = tq.ema_update(tq.EMAState(_t(emb), _t(cluster), _t(avg)),
                         z.reshape(-1, 16), codes.reshape(-1))
    assert torch.equal(q.embedding, want.embedding)
    assert not torch.equal(q.embedding, _t(emb))


# ------------------------------------------------------ stage-1 modules

@pytest.mark.parametrize('norm', ['gn', 'bn', 'actnorm'])
def test_discriminator_matches_jax(norm):
    """NLayerDiscriminator (3 layers, ndf 64) on random images, its norms'
    parameters and BatchNorm statistics randomised. Bound: atol 1e-4,
    rtol 1e-4."""
    x = _np(0, B, RES, RES, 3)
    jd = jlayers.NLayerDiscriminator(n_layers=3, norm_type=norm)
    v = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree.map(lambda a: np.asarray(a) + _np(2, *a.shape, scale=0.1)
                     if a.ndim == 1 else np.asarray(a), v)
    if 'batch_stats' in v:
        v['batch_stats'] = jax.tree.map(lambda a: np.abs(a) + 0.5,
                                        v['batch_stats'])
    want = jax.jit(jd.apply)(v, jnp.asarray(x))
    td = _load(tlayers.NLayerDiscriminator(n_layers=3, norm_type=norm), v)
    got = td(_t(x))
    print(f'{norm}: max abs diff {float(np.abs(got.detach().numpy() - np.asarray(want)).max()):.2e}')
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    names = [k for k, _ in td.named_parameters()]
    assert all(k.startswith('main.') for k in names)


def test_actnorm_matches_jax():
    x = _np(3, B, 5, 5, 8)
    ja = jlayers.ActNorm()
    v = jax.tree.map(lambda a: _np(4, *a.shape), ja.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want = ja.apply(v, jnp.asarray(x))
    ta = _load(tlayers.ActNorm(8), v)
    got = ta(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_lpips_matches_jax():
    """LPIPS with JAX's random (flax-initialised) weights on two image
    batches. Bound: atol 1e-5; the loaders map the torchvision, reference
    and head layouts onto the same weights."""
    x, y = _np(5, B, RES, RES, 3, scale=0.5), _np(6, B, RES, RES, 3,
                                                  scale=0.5)
    jm, v = jlpips.init_lpips(jax.random.PRNGKey(7), RES)
    want = float(jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(y)))
    tm = _load(tlpips.LPIPS(), v).requires_grad_(False)
    got = float(tm(_t(x), _t(y)))
    print(f'LPIPS {got:.7f} vs JAX {want:.7f}')
    assert abs(got - want) <= 1e-5
    sd = tm.state_dict()
    vgg = {f'features.{s}.{w}': sd[f'net.conv_{s}.{w}']
           for s, _ in tlpips.VGG16_CONVS for w in ('weight', 'bias')}
    lins = {f'lin{i}.model.1.weight': sd[f'lin{i}.weight'] for i in range(5)}
    slices = {f'net.slice{s}.{q}.{w}': sd[f'net.conv_{q}.{w}']
              for s, (lo, hi) in enumerate(tlpips.SLICES, 1)
              for q, _ in tlpips.VGG16_CONVS if lo <= q < hi
              for w in ('weight', 'bias')}
    for load, state in ((tlpips.load_torch_vgg16, vgg),
                        (tlpips.load_torch_lpips_lins, lins),
                        (tlpips.load_reference_lpips, {**slices, **lins})):
        fresh = tlpips.init_lpips(seed=1)
        if load is tlpips.load_torch_vgg16:
            tlpips.load_torch_lpips_lins(fresh, lins)
        elif load is tlpips.load_torch_lpips_lins:
            tlpips.load_torch_vgg16(fresh, vgg)
        load(fresh, state)
        assert float(fresh(_t(x), _t(y))) == got


def _hp():
    return dict(z_channels=64, resolution=32, ch=32, ch_mult=[1, 2],
                num_res_blocks=1, attn_resolutions=[8],
                use_init_downsample=True)


def _generators(kind, **aux_kw):
    """(JAX generator, its variables, the port's generator holding them)
    of a tiny `kind`."""
    x = jnp.asarray(_np(0, 1, RES, RES, 3))
    aux = dict(upsample='pixelshuffle', shared_codebook=False,
               decoding_type='concat', **aux_kw)
    if kind == 'vqgan':
        j = jgen.VQGANGenerator(n_embed=64, embed_dim=64, ema_update=True,
                                hparams=JaxHparams(**_hp()))
        t = tgen.VQGANGenerator(64, 64, True, Stage1Hparams(**_hp()))
    elif kind == 'vqgan2':
        aux.update(upsample='deconv2d')
        j = jgen.VQGAN2Generator(n_embed=64, embed_dim=64, ema_update=True,
                                 hparams=JaxHparams(**_hp()),
                                 hparams_aux=JaxAux(**aux))
        t = tgen.VQGAN2Generator(64, 64, True, Stage1Hparams(**_hp()),
                                 VQGAN2Hparams(**aux))
    elif kind == 'hqvae':
        aux.update(code_levels=3, decoding_type='add')
        j = jgen.HQVAEGenerator(n_embed_levels=(64, 64, 64), embed_dim=16,
                                ema_update=True, hparams=JaxHparams(**_hp()),
                                hparams_aux=JaxAux(**aux))
        t = tgen.HQVAEGenerator((64, 64, 64), 16, True, Stage1Hparams(**_hp()),
                                VQGAN2Hparams(**aux))
    else:
        j = jgen.SimRQGAN2Generator(n_embed=64, embed_dim=64, ema_update=True,
                                    hparams=JaxHparams(**_hp()),
                                    hparams_aux=JaxAux(**aux))
        t = tgen.SimRQGAN2Generator(64, 64, True, Stage1Hparams(**_hp()),
                                    VQGAN2Hparams(**aux))
    v = jax.jit(j.init)(jax.random.PRNGKey(1), x)
    return j, v, _load(t, v)


@pytest.mark.parametrize('kind', ['vqgan', 'vqgan2', 'simrqgan2', 'hqvae'])
def test_decode_ret_pre_out_matches_jax(kind):
    """decode(..., ret_pre_out=True): the pixels and the decoder's
    pre-conv_out features. Bound: atol 2e-4, rtol 1e-3 (the repo's f32
    bound). JAX's VQGAN2 decode has no ret_pre_out: there the pixels are
    held to its decode and the features' shape to its decoder's input of
    conv_out."""
    j, v, t = _generators(kind)
    x = _np(2, B, RES, RES, 3)
    enc = jax.jit(lambda v, x: j.apply(v, x, method=j.encode))(
        v, jnp.asarray(x))
    quant = enc[:2] if kind in ('simrqgan2', 'vqgan2') else enc[:1]
    flags = () if kind == 'vqgan2' else (True, True)
    want = jax.jit(lambda v, *q: j.apply(v, *q, *flags,
                                         method=j.decode))(v, *quant)
    got = t.decode(*[_t(np.asarray(q)) for q in quant], ret_pre_out=True)
    if kind == 'vqgan2':
        want = (want,)
        assert got[1].shape == (B, RES, RES, 32)
    assert len(got) == 2 and got[-1].shape[:3] == got[0].shape[:3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-4, rtol=1e-3)
    assert torch.equal(t.decode(*[_t(np.asarray(q)) for q in quant]),
                       got[0])


@pytest.mark.parametrize('encode_kind', ['vqgan', 'vqgan2', 'simrqgan2',
                                         'hqvae'])
def test_encode_updates_ema_as_jax(encode_kind):
    """encode(update_ema=True) moves every EMA codebook as JAX's mutable
    'ema' collection moves. Bound: rtol 1e-5, atol 1e-5."""
    j, v, t = _generators(encode_kind)
    x = _np(3, B, RES, RES, 3)
    _, mut = jax.jit(lambda v, x: j.apply(
        v, x, update_ema=True, mutable=['ema'], method=j.encode))(
        v, jnp.asarray(x))
    with torch.no_grad():
        t.encode(_t(x), update_ema=True)
    want = convert_variables({'ema': jax.tree.map(np.asarray, mut['ema'])})
    got = dict(t.named_buffers())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# -------------------------------------------------------------- GAN losses

@pytest.mark.parametrize('fn', ['hinge_d_loss', 'vanilla_d_loss'])
def test_disc_losses_match_jax(fn):
    a, b = _np(7, 2, 3, 3, 1, scale=2), _np(8, 2, 3, 3, 1, scale=2)
    want = float(getattr(jtrain, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(ttrain, fn)(_t(a), _t(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adopt_weight_matches_jax():
    for step in (0, 4, 5, 9):
        assert np.float32(ttrain.adopt_weight(0.7, step, 5)) == np.asarray(
            jtrain.adopt_weight(0.7, step, 5))


# --------------------------------------------------------- the GAN step

MODES = {'faithful': dict(lpips=True), 'fast': dict(fast=True),
         'bypass': dict(bottom_start=1), 'residual_l1':
         dict(residual_l1_weight=0.5)}


def _step_pair(mode):
    kw = MODES[mode]
    hd_kw = dict(disc_start=0, disc_weight=0.75, disc_num_layers=2,
                 norm_type='gn')
    j, gv, t = _generators('simrqgan2')
    jd = jtrain.make_discriminator(JaxDisc(**hd_kw))
    dv = jax.jit(jd.init)(jax.random.PRNGKey(2), jnp.zeros((1, RES, RES, 3)))
    td = _load(ttrain.make_discriminator(Stage1HparamsDisc(**hd_kw)), dv)
    jl = tl = lv = None
    if kw.get('lpips'):
        jl, lv = jlpips.init_lpips(jax.random.PRNGKey(5), RES)
        tl = _load(tlpips.LPIPS(), lv).requires_grad_(False)
    opt = dict(betas=[0.5, 0.9], grad_clip_norm=0.0)
    step_kw = dict(bottom_start=kw.get('bottom_start'),
                   residual_l1_weight=kw.get('residual_l1_weight', 0.0),
                   perceptual_weight=1.0 if jl is not None else 0.0,
                   faithful_double_forward=not kw.get('fast'))
    jg_opt, jd_opt = (jtrain.make_stage1_optimizer(
        JaxOptConfig(**opt), jax_schedule(1e-3, 10, 1000)) for _ in range(2))
    jstep = jax.jit(jtrain.make_stage1_train_step(
        j, jd, jl, jg_opt, jd_opt, JaxDisc(**hd_kw), **step_kw))
    jstate = jtrain.Stage1State(jnp.zeros((), jnp.int32), gv['params'],
                                gv['ema'], dv['params'],
                                jg_opt.init(gv['params']),
                                jd_opt.init(dv['params']))
    tg_opt, td_opt = (ttrain.make_stage1_optimizer(
        OptConfig(**opt), build_schedule(1e-3, 10, 1000)) for _ in range(2))
    tstep = ttrain.make_stage1_train_step(
        t, td, tl, tg_opt, td_opt, Stage1HparamsDisc(**hd_kw), **step_kw)
    tstate = ttrain.init_stage1_state(t, td, tg_opt, td_opt)
    return (jstep, jstate, lv), (tstep, tstate)


def _param_diffs(jstate, tstate):
    """|port - JAX| over every generator and discriminator parameter
    entry, and the name of the generator's worst tensor."""
    want = convert_variables({'params': jax.tree.map(
        np.asarray, jstate.gen_params)})
    wd = convert_variables({'params': jax.tree.map(np.asarray,
                                                   jstate.disc_params)})
    diffs, worst = [], (0.0, '')
    for k, w in want.items():
        d = np.abs(tstate.gen_params[k].detach().numpy() - w.numpy())
        worst = max(worst, (float(d.max()), k))
        diffs.append(d.reshape(-1))
    for k, w in wd.items():
        diffs.append(np.abs(tstate.disc_params[k].detach().numpy() -
                            w.numpy()).reshape(-1))
    assert set(want) == set(tstate.gen_params)
    assert set(wd) == set(tstate.disc_params)
    return np.concatenate(diffs), worst[1]


@pytest.mark.parametrize('mode', list(MODES))
def test_gan_step_matches_jax(mode):
    """Two steps of the GAN step. Bounds: total loss, nll, g loss,
    d_weight and the discriminator's loss rtol 1e-4 at the first step and
    2e-3 at the second; generator and discriminator parameters (moved
    ~1e-3 a step) after the first step: 99.9% of the entries within 1e-7;
    after the second: median under 2e-6 and 99% within 1e-4; after both,
    the EMA counts within 1e-6 (the same codes), the codebooks and their
    sums rtol 1e-2, atol 1e-3 (some entries near zero by cancellation).
    The tail is rounding made whole: Adam divides each gradient by its
    own root mean square, so where a gradient is zero but for rounding
    (the attention blocks' key biases; at this tiny width, biases read
    only by a GroupNorm of one channel a group) both packages move the
    entry by +-lr at random, and the second step's gradients (the
    residual-L1 mode's sign() most) inherit that."""
    (jstep, jstate, lv), (tstep, tstate) = _step_pair(mode)
    for i in range(2):
        x = _np(10 + i, B, RES, RES, 3, scale=0.5).clip(-1, 1)
        jstate, jm = jstep(jstate, lv, jnp.asarray(x),
                           jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, _t(x))
        for k in ('total_loss', 'nll_loss', 'g_loss', 'd_weight',
                  'disc_loss', 'p_loss', 'resid_l1_loss', 'rec_loss'):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4 if i == 0 else 2e-3,
                                       atol=1e-7, err_msg=f'step {i} {k}')
        diffs, worst = _param_diffs(jstate, tstate)
        q = np.quantile(diffs, (0.5, 0.99, 0.999))
        print(f'{mode} step {i}: total {float(tm["total_loss"]):.6f} (JAX '
              f'{float(jm["total_loss"]):.6f}), d_weight '
              f'{float(tm["d_weight"]):.6f} ({float(jm["d_weight"]):.6f}); '
              f'parameters differ by median {q[0]:.2e}, 99% within '
              f'{q[1]:.2e}, 99.9% within {q[2]:.2e}, at most '
              f'{diffs.max():.2e} ({worst})')
        if i == 0:
            assert q[2] <= 1e-7
        else:
            assert q[0] < 2e-6 and q[1] <= 1e-4
    assert tstate.step == 2
    want = convert_variables({'ema': jax.tree.map(np.asarray, jstate.ema)})
    assert set(want) == set(tstate.ema)
    for k, w in want.items():
        tol = dict(rtol=0, atol=1e-6) if k.endswith('cluster_size') else \
            dict(rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(tstate.ema[k].numpy(), w.numpy(),
                                   err_msg=k, **tol)
