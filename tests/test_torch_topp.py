"""Top-p (nucleus) sampling in the PyTorch port against the JAX package's
`ops/topk_topp.py`: the top-k threshold by bisection, the nucleus filter,
the whole filtered distribution, where the draws land, the inverse-CDF
draw, and the 2-level and 3-level samplers with top-p.

Rows: random logits at three scales, integer logits (ties at every rank),
rows of bf16 values, and flat rows (every probability equal, so the
running sum meets p exactly); V 8192 (the configs' vocabulary) and 1000.
Each test makes its rows with numpy from a seed and hands both packages
the same arrays.

The bisection is exact f32 arithmetic: its threshold must be bit-equal.
XLA's softmax and running sum round differently from PyTorch's (XLA sums
in f32, PyTorch's CPU cumsum in f64; over the thousands of tokens of a
flat nucleus the two sums drift apart by a few 1e-6), so the kept sets may
differ at a token only where p lies between the two packages' running
sums before it, and those sums lie within NEAR (1e-5) of each other; the
tests count those tokens. The filtered probabilities are held at 1e-6 at
every other token.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.ops import topk_topp as jax_tt  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.ops import topk_topp as tt  # noqa: E402
from hqtransformer_tpu_torch.ops.sample_topk import \
    inverse_cdf_draw  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    LevelSampling, SamplingParams, make_hierarchical_sampler,
    make_multilevel_sampler)

from test_torch_multilevel import _one_thread, tiny_config  # noqa: E402,F401

KINDS = ('random', 'wide', 'ties', 'bf16', 'flat')
NEAR = 1e-5


def rows(kind, n, v, seed):
    """[n, v] f32 logits of one kind: random (N(0, 2)), wide (N(0, 8)),
    ties (integers in [-6, 6]), bf16 (N(0, 2) rounded to bf16 values), or
    flat (all equal, but row i's first i % 7 tokens one higher)."""
    rng = np.random.RandomState(seed)
    if kind == 'flat':
        x = np.zeros((n, v), np.float32)
        for i in range(n):
            x[i, :i % 7] = 1.0
        return x
    x = rng.randn(n, v).astype(np.float32) * (8.0 if kind == 'wide'
                                              else 2.0)
    if kind == 'ties':
        return np.round(x).clip(-6, 6).astype(np.float32)
    if kind == 'bf16':
        return torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _jit_threshold(k):
    return jax.jit(lambda x: jax_tt.kth_largest_threshold(x, k))


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('v', [8192, 1000])
def test_kth_largest_threshold_bit_equal(kind, v):
    """The 30-step bisection over [row min, row max + 1e-6]: the port's
    threshold equals JAX's bit for bit at k in {1, 2, 100, V/2, V - 1}."""
    x = rows(kind, 48, v, seed=v)
    for k in (1, 2, 100, v // 2, v - 1):
        ref = np.asarray(_jit_threshold(k)(jnp.asarray(x)))
        ours = tt.kth_largest_threshold(torch.from_numpy(x), k).numpy()
        assert ours.shape == (48, 1)
        np.testing.assert_array_equal(ours.view(np.int32),
                                      ref.view(np.int32), err_msg=str(k))


def test_cutoff_topk_logits_matches_jax():
    """Logits below the threshold become -inf, ties at it stay; k None or
    k >= V leaves the row as it is."""
    x = rows('ties', 32, 1000, seed=1)
    for k in (None, 5, 999, 1000, 5000):
        ref = np.asarray(jax_tt.cutoff_topk_logits(jnp.asarray(x), k))
        ours = tt.cutoff_topk_logits(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(ours, ref, err_msg=str(k))


def _running_sums(probs, jax_side):
    """(running sum a row over its stable descending order, each token's
    rank in it), the sum as that package computes it (XLA's cumsum or
    torch's)."""
    order = np.argsort(-probs, axis=-1, kind='stable')
    ranked = np.take_along_axis(probs, order, -1)
    cum = (np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(ranked))
           if jax_side else torch.cumsum(torch.from_numpy(ranked), -1)
           .numpy())
    return cum, np.argsort(order, axis=-1)


def assert_filters_agree(ours, ref, probs_ours, probs_ref, p):
    """The filtered probabilities ours and ref (from the unfiltered
    probs_ours, probs_ref) allclose at 1e-6 wherever both keep or both
    remove the token; where only one keeps it, p must lie between the two
    packages' running sums before the token, which must lie within NEAR
    of each other. Returns (the number of such tokens, the largest gap of
    the two running sums there)."""
    differ = (ours > 0) != (ref > 0)
    cum_o, rank_o = _running_sums(probs_ours, False)
    cum_r, rank_r = _running_sums(probs_ref, True)
    gap = 0.0
    for r, j in zip(*np.nonzero(differ)):
        assert rank_o[r, j] > 0 and rank_r[r, j] > 0, (r, j)
        a, b = cum_o[r, rank_o[r, j] - 1], cum_r[r, rank_r[r, j] - 1]
        assert min(a, b) <= p <= max(a, b) and abs(a - b) < NEAR, (r, j, a,
                                                                  b)
        gap = max(gap, abs(float(a) - float(b)))
    np.testing.assert_allclose(np.where(differ, 0, ours),
                               np.where(differ, 0, ref), atol=1e-6, rtol=0)
    return int(differ.sum()), gap


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('p', [0.5, 0.9, 0.95])
def test_cutoff_topp_probs_matches_jax(kind, p):
    """cutoff_topp_probs on the same probabilities (JAX's softmax of the
    rows): see `assert_filters_agree`; the top token always kept; every
    row sums to 1."""
    x = rows(kind, 64, 8192, seed=int(p * 100))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    ref = np.asarray(jax.jit(lambda a: jax_tt.cutoff_topp_probs(a, p))(
        jnp.asarray(probs)))
    ours = tt.cutoff_topp_probs(torch.from_numpy(probs.copy()), p).numpy()
    n, gap = assert_filters_agree(ours, ref, probs, probs, p)
    print(f'top-p {p} on {kind} rows: {n} kept-set differences (running '
          f'sums {gap:.2e} apart)')
    assert (ours[np.arange(64), probs.argmax(-1)] > 0).all()
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('temperature,top_k,p', [(1.0, None, 0.9),
                                                 (0.95, 2048, 0.95),
                                                 (0.7, 50, 0.5)])
def test_nucleus_distribution_matches_jax(kind, temperature, top_k, p):
    """The whole filter the draw samples from (f32 logits over the
    temperature, top-k, softmax, top-p) against JAX's steps on the same
    logits, by `assert_filters_agree` (each package's running sums over
    its own softmax). bf16 logits go in as bf16 on both sides."""
    x = rows(kind, 64, 8192, seed=7)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if kind == 'bf16':
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)

    def jax_probs(a):
        a = a.astype(jnp.float32) / temperature
        return jax.nn.softmax(jax_tt.cutoff_topk_logits(a, top_k), axis=-1)
    before = np.asarray(jax.jit(jax_probs)(xj))
    ref = np.asarray(jax.jit(lambda a: jax_tt.cutoff_topp_probs(
        jax_probs(a), p))(xj))
    ours = tt.nucleus_probs(xt, temperature, top_k, p).numpy()
    mine = torch.softmax(tt.cutoff_topk_logits(tt.scaled_logits(
        xt, temperature), top_k), dim=-1).numpy()
    n, gap = assert_filters_agree(ours, ref, mine, before, p)
    print(f'nucleus T {temperature} k {top_k} p {p} on {kind} rows: {n} '
          f'kept-set differences (running sums {gap:.2e} apart)')


@pytest.mark.parametrize('kind', ['random', 'ties', 'bf16'])
def test_draws_fall_in_jax_kept_set(kind):
    """sample_from_logits with top-p (and top-k): 40 draws a row from a
    seeded generator, every code inside the kept set of JAX's filter, and
    the sampling kernel's wrapper never called."""
    import hqtransformer_tpu_torch.ops.topk_topp as mod
    x = rows(kind, 32, 1000, seed=11)
    ref = np.asarray(jax_tt.cutoff_topp_probs(jax.nn.softmax(
        jax_tt.cutoff_topk_logits(jnp.asarray(x) / 0.9, 200), axis=-1),
        0.8))
    called = []
    real = mod.sample_topk
    mod.sample_topk = lambda *a, **k: called.append(1) or real(*a, **k)
    try:
        gen = torch.Generator().manual_seed(3)
        for _ in range(40):
            codes = tt.sample_from_logits(gen, torch.from_numpy(x),
                                          temperature=0.9, top_k=200,
                                          top_p=0.8)
            assert codes.dtype == torch.int32 and codes.shape == (32,)
            assert (ref[np.arange(32), codes.numpy()] > 0).all()
    finally:
        mod.sample_topk = real
    assert not called


def test_inverse_cdf_draw_equals_numpy():
    """The draw on the renormalised probabilities against numpy with the
    same uniforms: running sum in f64 rounded to f32 (as torch's CPU cumsum
    accumulates), u * total clamped to 1e-30, the first index whose sum
    reaches it, snapped down to a kept token; uniforms include 0 and
    values just below 1."""
    x = rows('random', 256, 8192, seed=5)
    probs = tt.nucleus_probs(torch.from_numpy(x), 1.0, None, 0.9).numpy()
    rng = np.random.RandomState(6)
    u = rng.rand(256).astype(np.float32)
    u[:3] = (0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5)
    ours = inverse_cdf_draw(torch.from_numpy(probs), torch.from_numpy(u))
    cdf = np.cumsum(probs.astype(np.float64), -1).astype(np.float32)
    want = []
    for r in range(256):
        draw = max(np.float32(u[r] * cdf[r, -1]), np.float32(1e-30))
        idx = int(np.searchsorted(cdf[r], draw, side='left'))
        idx = max(i for i in range(min(idx, 8191) + 1) if probs[r, i] > 0)
        want.append(idx)
    np.testing.assert_array_equal(ours.numpy(), np.array(want))


def test_two_level_sampler_with_top_p():
    """The tiny 2-level sampler with top-p at both levels: codes in range,
    and every draw off the sampling kernel (the JAX routing)."""
    import hqtransformer_tpu_torch.ops.topk_topp as mod
    tm = twostage.build_stage2(torch_config('configs/tiny/stage2-tiny.yaml')
                               ).eval()
    tm.load_state_dict(twostage.random_state(
        tm, torch.Generator().manual_seed(0)))
    real, called = mod.sample_topk, []
    mod.sample_topk = lambda *a, **k: called.append(1) or real(*a, **k)
    try:
        ct, cb = make_hierarchical_sampler(tm, 16, SamplingParams(
            top_k_top=64, top_p_top=0.9, top_k_bot=64, top_p_bot=0.9,
            temperature_top=0.95, temperature_bot=0.95))(
                torch.Generator().manual_seed(1), torch.arange(3))
    finally:
        mod.sample_topk = real
    assert ct.shape == (3, 16) and cb.shape == (3, 16, 4) and not called
    assert int(ct.min()) >= 0 and int(cb.max()) < 256


def test_three_level_sampler_with_top_p():
    """The tiny 3-level sampler with top-p at every level (LevelSampling):
    codes in range, and top-p at one level only leaves the other levels on
    the sampling kernel's path (its plain version on the CPU)."""
    import hqtransformer_tpu_torch.ops.topk_topp as mod
    tm = twostage.build_stage2(tiny_config(torch_config)).eval()
    tm.load_state_dict(twostage.random_state(
        tm, torch.Generator().manual_seed(0)))
    real, called = mod.sample_topk, []
    mod.sample_topk = lambda *a, **k: called.append(1) or real(*a, **k)
    try:
        for levels, n_kernel in ((LevelSampling(top_k=16, top_p=0.9),) * 3,
                                 0), ((LevelSampling(top_p=0.8),
                                       LevelSampling(top_k=4),
                                       LevelSampling(top_k=4)), 2 * 16):
            called.clear()
            tops, mids, bots = make_multilevel_sampler(tm, 16, levels)(
                torch.Generator().manual_seed(2), torch.arange(3))
            assert tops.shape == (3, 16) and mids.shape == (3, 16, 4)
            assert bots.shape == (3, 16, 16) and len(called) == n_kernel
            for c, v in zip((tops, mids, bots), (32, 48, 64)):
                assert int(c.min()) >= 0 and int(c.max()) < v
    finally:
        mod.sample_topk = real
