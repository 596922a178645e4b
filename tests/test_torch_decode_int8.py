"""Decode attention on int8 caches (K1-int8) in the PyTorch port, on the
CPU: the plain mirror of the CUDA kernel's byte widening and of its
fixed-point q, the launch the wrapper plans for the kernel, the accuracy
of the kernel's arithmetic (fixed-point scores, the new token as the first
row, scores first, one softmax a round, rounds merged) written out in
PyTorch against the plain version, and the plain version against the JAX
package over the full int8 range, -128 included. The kernel itself runs
only on the card (`chip_smoke.py` holds it to the plain version there).
Inputs come from numpy seeds; each test states its tolerance."""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.ops.pallas_attention import (  # noqa: E402
    decode_attention_step, decode_attention_step_xla)

from hqtransformer_tpu_torch.ops.decode_attention import (  # noqa: E402
    _launch_plan, decode_attention_step_plain, q_fixed_point,
    widen_int8_words)

H100_SMEM_PER_BLOCK = 232448   # 227 KB, with the opt-in
H100_SMS = 132


# ------------------------------------------------------------ the widening

def _words(values: np.ndarray) -> torch.Tensor:
    """int8 values [N, 4] packed little-endian into int32 words [N]."""
    return torch.from_numpy(np.ascontiguousarray(values, np.int8)).view(
        torch.int32)[:, 0]


def test_widen_int8_words_every_byte():
    """All 256 byte values, each in a word of four equal bytes: the
    kernel's constants give `.float()` exactly."""
    b = np.arange(-128, 128, dtype=np.int8)
    got = widen_int8_words(_words(np.repeat(b[:, None], 4, axis=1)))
    want = torch.from_numpy(b).float()[:, None].expand(256, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize('position', range(4))
def test_widen_int8_words_every_position(position):
    """Each byte value in each position of a word whose other bytes are
    random: every lane of the result equals `.float()` of its byte."""
    rng = np.random.RandomState(position)
    values = rng.randint(-128, 128, (256, 4)).astype(np.int8)
    values[:, position] = np.arange(-128, 128)
    got = widen_int8_words(_words(values))
    assert torch.equal(got, torch.from_numpy(values).float())


@pytest.mark.parametrize('magnitude', [0.0, 1e-30, 1e-20, 0.02, 3.0, 1e6])
def test_q_fixed_point_splits_exactly(magnitude):
    """The kernel's fixed-point q: hi * 2^16 + lo is q * 2^shift rounded
    to the nearest integer, below 2^30 in magnitude (so 16-bit hi and lo
    halves and int32 sums over 64 int8 products cannot overflow); unless
    the shift is clamped (heads whose largest |q| is below ~2^-70), the
    largest |q| of a head keeps at least 29 bits; a head of zeros stays
    zero."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy((rng.randn(8, 256) * magnitude).astype(np.float32))
    hi, lo, shift = q_fixed_point(q, 4)
    a = hi * 65536 + lo
    scaled = q.double().reshape(8, 4, 64) * torch.pow(2.0, shift.double())[
        ..., None]
    assert torch.all((a.double() - scaled).abs() <= 0.5)
    assert torch.all(a.abs() < 2 ** 30)
    assert torch.all((lo >= -32768) & (lo < 32768))
    assert torch.all(hi.abs() <= 2 ** 14)
    if magnitude:
        unclamped = shift < 100
        assert torch.all(a.abs().amax(-1)[unclamped] >= 2 ** 29)
    else:
        assert torch.all(a == 0)


# ------------------------------------------------------------- launch plan

@pytest.mark.parametrize('batch', [8, 128, 1024])
@pytest.mark.parametrize('cache_dtype', [torch.int8, torch.bfloat16])
@pytest.mark.parametrize('n_rows', [16, 64, 160])
def test_launch_plan_covers_rows(n_rows, cache_dtype, batch):
    """At every pos < T, for the flagship's 24 heads of 64, the 3-level
    tiny cut's 4 heads of 32 and 48 heads of 32: the int8 kernel's grid,
    as the kernel maps blocks and warps to (batch row, head), takes every
    head of every batch row exactly once; a whole batch row a block while
    the blocks fit one wave of an H100, else 4 heads; the shared memory
    holds, for every warp, q's 256 bytes, K and V bytes and an f32 score
    of each of the round's rows (the new token's and up to 64 cache rows),
    and stays within the H100's 227 KB a block. Float caches take the
    kernel's fixed launch (0, 0)."""
    for n_heads, hd in ((24, 64), (4, 32), (48, 32)):
        plans = [_launch_plan(cache_dtype, hd, n_heads, batch, pos, H100_SMS)
                 for pos in range(n_rows)]
        if cache_dtype != torch.int8:
            assert all(plan == (0, 0) for plan in plans)
            continue
        hpb = plans[0].heads_per_block
        one_wave = batch * -(-n_heads // min(n_heads, 24)) <= H100_SMS
        assert hpb == min(n_heads, 24 if one_wave else 4)
        groups = -(-n_heads // hpb)
        block = torch.arange(batch * groups)[:, None]
        head = block % groups * hpb + torch.arange(hpb)
        row = (block // groups).expand_as(head)
        taken = (row * n_heads + head)[head < n_heads]
        assert torch.equal(taken.sort().values,
                           torch.arange(batch * n_heads))
        for pos, plan in enumerate(plans):
            assert plan.heads_per_block == hpb
            rows = min(pos, 64) + 1
            assert plan.smem >= hpb * (256 + 2 * rows * hd + 4 * rows)
            assert plan.smem <= H100_SMEM_PER_BLOCK


# ------------------------------------------------- the kernel's algorithm

def _widen(x: torch.Tensor) -> torch.Tensor:
    """An int8 tensor whose last dim is a multiple of 4, widened as the
    kernel widens it."""
    words = x.contiguous().view(torch.int32)
    return widen_int8_words(words).reshape(x.shape)


def _int8_design(q, kn, vn, kc, vc, layer, pos, n_heads, round_rows=64):
    """The arithmetic of the int8 kernel's design in plain PyTorch (the
    kernel adds in its own order, so it is held to the plain version on the
    card, not to this function): q as the kernel's
    fixed point, each score an exact integer sum scaled back once; V
    widened as the kernel widens it, P.V in f32; the running state (max,
    sum, accumulators) starts empty; each round scores every row,
    takes one max and one weight a row, rescales the state once and adds
    P.V; round 0 holds the new token first, then `round_rows` cache rows,
    the later rounds `round_rows` cache rows each; y is the accumulators
    over the sum."""
    B, D = q.shape
    hd = D // n_heads
    scale = 1.0 / math.sqrt(hd)
    kc[layer, pos], vc[layer, pos] = kn, vn
    hi, lo, shift = q_fixed_point(q, n_heads)
    m = torch.full((B, n_heads), -math.inf)
    l = torch.zeros(B, n_heads)
    acc = torch.zeros(B, n_heads, hd)
    for t0 in range(0, max(pos, 1), round_rows):
        n = min(pos - t0, round_rows)
        rows = torch.cat([kn[None], kc[layer, t0:t0 + n]]) if t0 == 0 \
            else kc[layer, t0:t0 + n]
        k = rows.reshape(len(rows), B, n_heads, hd).long()
        rows = torch.cat([vn[None], vc[layer, t0:t0 + n]]) if t0 == 0 \
            else vc[layer, t0:t0 + n]
        v = _widen(rows).reshape(len(rows), B, n_heads, hd)
        dot = (torch.einsum('bhd,tbhd->bht', hi, k) * 65536 +
               torch.einsum('bhd,tbhd->bht', lo, k))
        s = dot.float() * (scale * torch.pow(2.0, -shift.float()))[..., None]
        m_r = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_r[..., None])
        corr = torch.exp(m - m_r)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum('bht,tbhd->bhd', p, v)
        m = m_r
    return (acc / l[..., None]).reshape(B, D)


@pytest.mark.parametrize('n_heads', [2, 4])
@pytest.mark.parametrize('pos', [0, 1, 15, 16, 17, 63, 64, 65, 127, 128,
                                 129, 159])
def test_int8_design_matches_plain(pos, n_heads):
    """The design's arithmetic (fixed-point scores, one softmax a round,
    rounds merged) loses no more than the tolerance chip_smoke.py holds
    the kernel to: against the plain version at the edges of its stages
    (16 rows) and rounds (64 rows), head dims 64 and 32, the full int8
    range and an f32 q, caches bit-equal and y within 1e-5 in units of
    1/127."""
    L, T, B, D = 2, 160, 4, 128
    layer = pos % L
    rng = np.random.RandomState(pos)
    kc, vc = (torch.from_numpy(rng.randint(-128, 128, (L, T, B, D))
                               .astype(np.int8)) for _ in range(2))
    kn, vn = (torch.from_numpy(rng.randint(-128, 128, (B, D))
                               .astype(np.int8)) for _ in range(2))
    q = torch.from_numpy((rng.randn(B, D) * 0.05).astype(np.float32))
    kc1, vc1 = kc.clone(), vc.clone()
    y1 = _int8_design(q, kn, vn, kc1, vc1, layer, pos, n_heads)
    y2 = decode_attention_step_plain(q, kn, vn, kc, vc, layer, pos, n_heads)
    assert torch.equal(kc1, kc) and torch.equal(vc1, vc)
    torch.testing.assert_close(y1 / 127, y2 / 127, atol=1e-5, rtol=1e-5)


# ---------------------------------------- the full int8 range against JAX

@pytest.mark.parametrize('pos', [16, 17, 63])
def test_decode_attention_int8_full_range_matches_jax(pos):
    """Caches and new rows over all of -128..127 (every tenth value -128),
    f32 q: caches equal to the XLA oracle's and the Pallas kernel's
    (interpret mode); y within atol and rtol 2e-4 of both
    (test_torch_int8.py's bound)."""
    B, T, D, NH, L = 32, 64, 256, 4, 2
    layer = pos % L
    rng = np.random.RandomState(pos)

    def int8(*shape):
        x = rng.randint(-128, 128, shape).astype(np.int8)
        x.reshape(-1)[::10] = -128
        return x

    kc, vc = int8(L, T, B, D), int8(L, T, B, D)
    kn, vn = int8(B, D), int8(B, D)
    q = (rng.randn(B, D) * 0.05).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(kc), jnp.asarray(vc), layer, pos, NH)
    y_xla, kc_xla, vc_xla = decode_attention_step_xla(*args)
    y_pl, kc_pl, vc_pl = decode_attention_step(*args, block_b=32,
                                               interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y = decode_attention_step_plain(torch.from_numpy(q), torch.from_numpy(kn),
                                    torch.from_numpy(vn), tk, tv, layer, pos,
                                    NH)
    for ref_k, ref_v, ref_y in ((kc_xla, vc_xla, y_xla),
                                (kc_pl, vc_pl, y_pl)):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-4,
                                   rtol=2e-4)
