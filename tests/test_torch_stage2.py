"""Stage-2 parity of the PyTorch port against the JAX package: weight
conversion, the transformer block, the teacher-forced HierarchicalGPT
forward and every decode-step method, on the tiny config in f32.

Both sides get the same weights (JAX init, converted) and the same numpy
inputs; the bound is the repo's f32 parity bound, atol 2e-4 / rtol 1e-3.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.stage2.hierarchical import \
    HierarchicalGPT as JaxGPT  # noqa: E402
from hqtransformer_tpu.models.stage2.layers import \
    Block as JaxBlock  # noqa: E402
from hqtransformer_tpu.models.stage2.layers import \
    SelfAttention as JaxAttention  # noqa: E402
from hqtransformer_tpu.models.twostage import build_stage2  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models.stage2.layers import (  # noqa: E402
    Block, SelfAttention)
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope='module')
def models():
    """(JAX stage-2 model, its variables, port stage-2 model with the same
    weights)."""
    cfg = build_twostage_config(CFG)
    jm = build_stage2(cfg)
    Ttop = cfg.stage2.hparams.ctx_len_img
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, Ttop), jnp.int32),
                                 jnp.zeros((1, 4 * Ttop), jnp.int32),
                                 jnp.zeros((1,), jnp.int32))
    tm = TwoStageModel(torch_config(CFG), device='cpu').stage2
    tm.load_state_dict(convert_variables(variables), strict=True,
                       assign=True)
    return jm, variables, tm


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               **(tol or TOL))


def test_convert_matches_export(models):
    _, variables, tm = models
    mine = convert_variables(variables)
    ref = export_torch_state_dict(variables)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    tm.load_state_dict(mine, strict=True)


@pytest.mark.parametrize('masked', [False, True])
def test_block_forward(masked):
    D, nh, T = 128, 4, 9
    jb = JaxBlock(embed_dim=D, n_heads=nh)
    x = np.random.RandomState(0).randn(3, T, D).astype(np.float32)
    v = jb.init(jax.random.PRNGKey(1), jnp.asarray(x))
    mask = np.tril(np.ones((T, T), bool)) if masked else None
    ref = jb.apply(v, jnp.asarray(x), mask=None if mask is None
                   else jnp.asarray(mask))
    tb = Block(D, nh)
    tb.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        out = tb(_t(x), None if mask is None else _t(mask))
    _close(out, ref)


@pytest.mark.parametrize('shape', [(4, 1), (3, 16)])
def test_bf16_projections_round_as_flax_dense(shape):
    """bf16 Linear, fused_qkv and fused_kv against flax Dense (bf16
    weights, f32 biases) on the same bf16 inputs: bit for bit. flax rounds
    the product to bf16 and then the bias sum; a gemm with the bias folded
    in (F.linear(x, w, b), one rounding) differs here."""
    D, nh = 128, 4
    rng = np.random.RandomState(3)
    params = {name: {
        'kernel': jnp.asarray(rng.randn(D, D).astype(np.float32) *
                              D ** -0.5).astype(jnp.bfloat16),
        'bias': jnp.asarray(rng.randn(D).astype(np.float32) * 0.3)}
        for name in ('query', 'key', 'value', 'proj')}
    jm = JaxAttention(embed_dim=D, n_heads=nh, dtype=jnp.bfloat16)
    x = rng.randn(*shape, D).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = jax.jit(lambda p, x: jm.apply({'params': p}, x, method=lambda m, x: (
        m.query(x), m._fused_qkv_flat(x),
        jnp.concatenate([m.key(x), m.value(x)], axis=-1))))(params, jx)
    tm = SelfAttention(D, nh)
    tm.load_state_dict(convert_variables({'params': params}), assign=True)
    tx = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        ours = (tm.query(tx), tm.fused_qkv(tx), tm.fused_kv(tx))
        w, b = tm._concat((tm.key, tm.value), torch.bfloat16)
        once = torch.nn.functional.linear(tx, w, b)
    for name, o, r in zip(('Linear', 'fused_qkv', 'fused_kv'), ours, ref):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r.astype(jnp.float32)),
                                      err_msg=name)
    assert not torch.equal(once, ours[2])


def _codes(seed, B, n, V):
    return np.random.RandomState(seed).randint(0, V, (B, n)).astype(np.int32)


def test_teacher_forced_logits(models):
    jm, variables, tm = models
    V = jm.vocab_size_top
    ct, cb = _codes(1, 2, 16, V), _codes(2, 2, 64, V)
    labels = np.array([3, 7], np.int32)
    lt, lb = jax.jit(jm.apply)(variables, jnp.asarray(ct), jnp.asarray(cb),
                               jnp.asarray(labels))
    with torch.no_grad():
        mt, mb = tm(_t(ct), _t(cb), _t(labels))
    _close(mt, lt)
    _close(mb, lb)


def _caches(seed, L, T, B, D, pos):
    """Random [L, T, B, D] caches with rows >= pos zero."""
    c = np.random.RandomState(seed).randn(L, T, B, D).astype(np.float32)
    c[:, pos:] = 0.0
    return c


def test_spatial_prefill(models):
    jm, variables, tm = models
    hp = jm.hparams
    B, T = 2, 16
    labels = np.array([1, 4], np.int32)
    kc = np.zeros((hp.n_layers, T, B, hp.embed_dim), np.float32)
    sos = jm.apply(variables, B, jnp.asarray(labels),
                   method=JaxGPT.sos_tokens)
    h, jk, jv = jm.apply(variables, sos, jnp.asarray(kc), jnp.asarray(kc), 0,
                         method=JaxGPT.spatial_step)
    tk, tv = _t(kc).clone(), _t(kc).clone()
    with torch.no_grad():
        tsos = tm.sos_tokens(B, _t(labels))
        th = tm.spatial_prefill(tsos, tk, tv)
    _close(tsos, sos)
    _close(th, h)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize('pos', [1, 6, 15])
def test_spatial_step_packed(models, pos):
    """Single-token step against packed caches; the JAX side needs a traced
    cache length to take its packed decode path (the XLA oracle on CPU)."""
    jm, variables, tm = models
    hp = jm.hparams
    B, T, D = 3, 16, hp.embed_dim
    kc = _caches(10 + pos, hp.n_layers, T, B, D, pos)
    vc = _caches(20 + pos, hp.n_layers, T, B, D, pos)
    x = np.random.RandomState(pos).randn(B, 1, D).astype(np.float32)
    step = jax.jit(partial(jm.apply, method=JaxGPT.spatial_step))
    h, jk, jv = step(variables, jnp.asarray(x), jnp.asarray(kc),
                     jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    tk, tv = _t(kc).clone(), _t(vc).clone()
    with torch.no_grad():
        th = tm.spatial_step(_t(x), tk, tv, pos)
    _close(th, h)
    _close(tk, jk)
    _close(tv, jv)


def test_embed_cell_step(models):
    jm, variables, tm = models
    V = jm.vocab_size_top
    ct = _codes(3, 4, 1, V)[:, 0]
    cb = _codes(4, 4, 4, V)
    position = np.array([0, 3, 9, 15], np.int32)
    ref = jm.apply(variables, jnp.asarray(ct), jnp.asarray(cb),
                   jnp.asarray(position), method=JaxGPT.embed_cell_step)
    with torch.no_grad():
        out = tm.embed_cell_step(_t(ct), _t(cb), _t(position))
    _close(out, ref)


def test_depth_logits(models):
    jm, variables, tm = models
    D = jm.hparams.embed_dim
    V = jm.vocab_size_top
    h = np.random.RandomState(5).randn(4, D).astype(np.float32)
    top = _codes(6, 4, 1, V)
    first = jax.jit(partial(jm.apply, method=JaxGPT.depth_first_logits))
    second = jax.jit(partial(jm.apply, group=1,
                             method=JaxGPT.depth_second_logits))
    lt, kv = first(variables, jnp.asarray(h))
    lb, kv2 = second(variables, jnp.asarray(top), kv)
    with torch.no_grad():
        mt, tkv = tm.depth_first_logits(_t(h))
        mb, tkv2 = tm.depth_second_logits(_t(top), tkv, 1)
    _close(mt, lt)
    _close(mb, lb)
    for ours, ref in zip(tkv[0] + tkv[1] + tkv2[0] + tkv2[1],
                         kv[0] + kv[1] + kv2[0] + kv2[1]):
        _close(ours, ref)
