"""The port's nearest-code search and quantize ops against the JAX package:
`vq_argmin_plain` (the plain version of the K3 CUDA kernel) against the
TPU kernel in interpret mode and against the XLA path, exact ties, the
CPU dispatch of the wrapper, the split of the kernel's grid, the f32
operands' three-piece split and the scores of its pair lists, and the
quantize helpers. Inputs are numpy arrays made from a seed."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.ops import quantize as jq  # noqa: E402
from hqtransformer_tpu.ops.pallas_vq import vq_argmin_pallas  # noqa: E402

from hqtransformer_tpu_torch.ops import quantize as tq  # noqa: E402
from hqtransformer_tpu_torch.ops import vq_argmin as vq  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

NEAR_TIE = 1e-5   # relative f64 gap under which f32 rounding may decide


def _inputs(n, k, d, seed, bf16=False):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, d).astype(np.float32)
    e = rng.randn(k, d).astype(np.float32)
    if bf16:   # round to bf16 here so both sides see the same values
        z, e = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (z, e))
    return z, e


def _count_near_ties(z, e, ours, ref):
    """Rows where the codes differ. Each must be a near-tie: the two
    codes' squared distances, recomputed in f64, within NEAR_TIE of
    |z|^2 + |e|^2. Returns the count, which may be at most 0.1% of rows."""
    rows = np.nonzero(ours != ref)[0]
    z64, e64 = z[rows].astype(np.float64), e.astype(np.float64)
    d_ours = ((z64 - e64[ours[rows]]) ** 2).sum(1)
    d_ref = ((z64 - e64[ref[rows]]) ** 2).sum(1)
    scale = (z64 ** 2).sum(1) + np.maximum((e64[ours[rows]] ** 2).sum(1),
                                           (e64[ref[rows]] ** 2).sum(1))
    assert (np.abs(d_ours - d_ref) <= NEAR_TIE * scale).all(), rows
    assert rows.size <= 1e-3 * len(ours), rows.size
    return rows.size


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('n,k,d', [(100, 512, 64), (1000, 1000, 32),
                                   (64, 1024, 4096), (37, 1000, 256)])
def test_vq_argmin_plain_matches_jax(n, k, d, bf16):
    z, e = _inputs(n, k, d, seed=n + k + d, bf16=bf16)
    tz, te = torch.from_numpy(z), torch.from_numpy(e)
    jz, je = jnp.asarray(z), jnp.asarray(e)
    if bf16:
        tz, te = tz.bfloat16(), te.bfloat16()
        jz, je = jz.astype(jnp.bfloat16), je.astype(jnp.bfloat16)
    ours = vq.vq_argmin_plain(tz, te).numpy()
    assert ours.dtype == np.int64 and ours.shape == (n,)
    for ref in (np.asarray(vq_argmin_pallas(jz, je, interpret=True)),
                np.asarray(jq.vq_lookup(jz, je, use_pallas=False))):
        assert _count_near_ties(z, e, ours, ref) == 0


def test_vq_argmin_exact_ties_go_to_lowest_index():
    """Integer-valued inputs make every distance exact in f32 whatever the
    summation order; each code appears four times in the codebook (rows
    2m, 2m+1, 500+2m, 501+2m), so every row ties and must take the lowest
    index of its minimum, as numpy's exact argmin does."""
    rng = np.random.RandomState(3)
    base = np.repeat(rng.randint(-3, 4, (250, 32)), 2, axis=0)
    e = np.concatenate([base, base]).astype(np.float32)
    z = rng.randint(-3, 4, (300, 32)).astype(np.float32)
    exact = np.argmin(((z[:, None, :] - e[None]) ** 2).sum(-1), axis=1)
    assert (exact % 2 == 0).all() and (exact < 500).all()
    ours = vq.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(ours.numpy(), exact)
    np.testing.assert_array_equal(
        np.asarray(vq_argmin_pallas(jnp.asarray(z), jnp.asarray(e),
                                    interpret=True)), exact)


def test_vq_argmin_wrapper_takes_plain_on_cpu():
    z, e = _inputs(50, 300, 32, seed=4)
    before = tracing.counter('k3.launches')
    out = vq.vq_argmin(torch.from_numpy(z), torch.from_numpy(e))
    assert tracing.counter('k3.launches') == before
    np.testing.assert_array_equal(
        out.numpy(),
        vq.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy())


def test_vq_argmin_kernel_checks():
    """What the CUDA path refuses, checked before any launch."""
    ok = torch.zeros(8, 32)
    vq._check(ok, torch.zeros(16, 32))
    with pytest.raises(ValueError, match='multiple of 8'):
        vq._check(torch.zeros(8, 20), torch.zeros(16, 20))
    with pytest.raises(ValueError, match='dim'):
        vq._check(ok, torch.zeros(16, 48))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        vq._check(ok.half(), torch.zeros(16, 32))
    with pytest.raises(ValueError, match='contiguous'):
        vq._check(torch.zeros(32, 8).T, torch.zeros(16, 32))


@pytest.mark.parametrize('n,k,n_sms,splits', [(8192, 8192, 114, 1),
                                              (2048, 8192, 114, 7),
                                              (4096, 8192, 132, 4),
                                              (32768, 1000, 132, 1)])
def test_codebook_splits(n, k, n_sms, splits):
    """Other card sizes and codebooks: an H100 PCIe's 114 SMs hold one
    slice of the flagship top's 64 row tiles, and 7 uneven slices (4 or 5
    of 32 code tiles) of the 3-level top's 16; more row tiles than SMs take
    one slice. The split route's pair lists run the same tiles, so the
    splits do not depend on them."""
    assert vq.codebook_splits(n, k, n_sms) == splits
    tiles = -(-k // vq.CODE_PAD)
    sizes = {(s + 1) * tiles // splits - s * tiles // splits
             for s in range(splits)}
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize('n,k,splits', [(8192, 8192, 2), (32768, 8192, 1),
                                        (2048, 8192, 8), (37, 1000, 4)])
def test_codebook_splits_wgmma(n, k, splits):
    """128 rows x 256 codes a block, one block an SM, on 132 SMs at the
    served shapes: 64, 256 and 16 row tiles of 32 code tiles; and a small
    ragged search that takes every tile."""
    assert vq.codebook_splits(n, k, 132) == splits
    tiles = -(-k // vq.CODE_PAD)
    assert tiles % splits == 0 or splits == tiles


@pytest.mark.parametrize('z_dtype,e_dtype,pieces,n_pairs', [
    (torch.bfloat16, torch.bfloat16, (1, 1), 1),
    (torch.float32, torch.float32, (3, 3), 6),
    (torch.float32, torch.bfloat16, (3, 1), 3),
    (torch.bfloat16, torch.float32, (1, 3), 3)])
def test_kernel_variant(z_dtype, e_dtype, pieces, n_pairs):
    """An f32 operand runs as three bf16 pieces, a bf16 one as itself; the
    kernel sums the products of 6, 3 or 1 pairs of pieces, hi.hi first,
    and for f32 x f32 drops mid.lo, lo.mid and lo.lo."""
    assert vq.kernel_variant(z_dtype, e_dtype) == pieces
    assert vq._check(torch.zeros(8, 64, dtype=z_dtype),
                     torch.zeros(16, 64, dtype=e_dtype)) == pieces
    pairs = vq.piece_pairs(pieces)
    assert len(pairs) == n_pairs and pairs[0] == (0, 0)
    assert all(p < pieces[0] and q < pieces[1] for p, q in pairs)
    assert not {(1, 2), (2, 1), (2, 2)} & set(pairs)
    # the kernel reads pair i from bits 4i..4i+3: z piece low, codebook high
    packed = vq.pack_pairs(pairs)
    assert packed < 2**31
    assert tuple(((packed >> 4 * i) & 3, (packed >> 4 * i + 2) & 3)
                 for i in range(n_pairs)) == pairs


def test_vq_argmin_tma_checks():
    """TMA loads need 16-byte aligned pointers and bf16 rows of a multiple
    of 16 bytes, so D a multiple of 8 for every dtype pair (an f32
    operand's pieces are bf16, and its split pass reads 8 values at a
    time)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert vq._check(torch.zeros(8, 24, dtype=bf),
                     torch.zeros(16, 24, dtype=bf)) == (1, 1)
    assert vq._check(torch.zeros(8, 24), torch.zeros(16, 24)) == (3, 3)
    for zt, et in ((bf, bf), (f32, f32), (f32, bf), (bf, f32)):
        with pytest.raises(ValueError, match='multiple of 8'):
            vq._check(torch.zeros(8, 20, dtype=zt),
                      torch.zeros(16, 20, dtype=et))
    shifted = torch.zeros(8 * 64 + 1, dtype=bf)[1:].view(8, 64)
    with pytest.raises(ValueError, match='16-byte aligned'):
        vq._check(shifted, torch.zeros(16, 64, dtype=bf))
    with pytest.raises(ValueError, match='16-byte aligned'):
        vq._check(torch.zeros(8, 64, dtype=bf),
                  torch.zeros(16 * 64 + 4, dtype=bf)[4:].view(16, 64))


@pytest.mark.parametrize('scale', [1.0, 1e-3, 1e4])
def test_split3_is_exact(scale):
    """hi + mid + lo == x exactly (in f64) for normal f32 x, hi is x
    rounded to bf16, and each piece is at most half an ulp of the one
    before."""
    rng = np.random.RandomState(int(scale * 1000) % 997)
    x = torch.from_numpy((rng.randn(4000) * scale).astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, -1.0, 3.0 - 2**-22, 1 + 2**-23,
                                    0.0, -0.0, 2.0**-100, -(2.0**100)])])
    hi, mid, lo = vq.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert torch.equal(hi, x.bfloat16())
    for big, small in ((hi, mid), (mid, lo)):
        ulp = torch.where(big == 0, 0.0, big.double().abs() * 2.0**-7)
        assert (small.double().abs() <= ulp).all()


@pytest.mark.parametrize('n,k,d', [(300, 512, 64), (64, 1000, 1024)])
@pytest.mark.parametrize('z_bf16,e_bf16', [(False, False), (False, True),
                                           (True, False)])
def test_split_scores_match_jax(n, k, d, z_bf16, e_bf16):
    """The scores of the split route's pair lists (f32 x f32: 6 pairs,
    mixed: 3) pick the codes of the TPU kernel in interpret mode and of the
    XLA path, but for near-ties."""
    rng = np.random.RandomState(n + k + d)
    z = rng.randn(n, d).astype(np.float32)
    e = rng.randn(k, d).astype(np.float32)
    tz, te = torch.from_numpy(z), torch.from_numpy(e)
    jz, je = jnp.asarray(z), jnp.asarray(e)
    if z_bf16:
        tz, jz = tz.bfloat16(), jz.astype(jnp.bfloat16)
        z = tz.float().numpy()
    if e_bf16:
        te, je = te.bfloat16(), je.astype(jnp.bfloat16)
        e = te.float().numpy()
    scores = vq.split_scores(tz, te)
    assert scores.dtype == torch.float32 and scores.shape == (n, k)
    ours = scores.argmin(dim=1).numpy()
    for ref in (np.asarray(vq_argmin_pallas(jz, je, interpret=True)),
                np.asarray(jq.vq_lookup(jz, je, use_pallas=False))):
        assert _count_near_ties(z, e, ours, ref) == 0


def test_split_scores_exact_ties_go_to_lowest_index():
    """Integer-valued f32 operands split into hi alone (mid = lo = 0), so
    every score is exact and each tie takes the lowest index."""
    rng = np.random.RandomState(4)
    base = np.repeat(rng.randint(-3, 4, (100, 16)), 2, axis=0)
    e = np.concatenate([base, base]).astype(np.float32)
    z = rng.randint(-3, 4, (200, 16)).astype(np.float32)
    exact = np.argmin(((z[:, None, :] - e[None]) ** 2).sum(-1), axis=1)
    ours = vq.split_scores(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(ours.argmin(dim=1).numpy(), exact)


def test_quantize_ops_match_jax():
    rng = np.random.RandomState(5)
    z = rng.randn(2, 3, 4, 16).astype(np.float32)
    e = rng.randn(50, 16).astype(np.float32)
    tz, te = torch.from_numpy(z), torch.from_numpy(e)
    jz, je = jnp.asarray(z), jnp.asarray(e)

    np.testing.assert_allclose(
        vq.codebook_distances(tz.reshape(-1, 16), te).numpy(),
        np.asarray(jq.codebook_distances(jz.reshape(-1, 16), je)),
        atol=1e-4, rtol=1e-6)
    codes, z_q = tq.quantize_lookup(tz, te)
    j_codes, j_zq = jq.quantize_lookup(jz, je, use_pallas=False)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(z_q.numpy(), np.asarray(j_zq))
    np.testing.assert_array_equal(tq.straight_through(tz, z_q).numpy(),
                                  np.asarray(jq.straight_through(jz, j_zq)))
    np.testing.assert_allclose(
        float(tq.commitment_loss(tz, z_q, 0.25)),
        float(jq.commitment_loss(jz, j_zq, 0.25)), rtol=1e-6)
    x = np.concatenate([z.reshape(-1, 16), np.zeros((1, 16), np.float32)])
    np.testing.assert_allclose(tq._l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jq._l2_normalize(jnp.asarray(x))),
                               atol=1e-7, rtol=1e-6)
