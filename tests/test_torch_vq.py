"""The port's nearest-code search and quantize ops against the JAX package:
`vq_argmin_plain` (the plain version of the K3 CUDA kernel) against the
TPU kernel in interpret mode and against the XLA path, exact ties, the
CPU dispatch of the wrapper, the split of the kernel's grid, and the
quantize helpers. Inputs are numpy arrays made from a seed."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.ops import quantize as jq  # noqa: E402
from hqtransformer_tpu.ops.pallas_vq import vq_argmin_pallas  # noqa: E402

from hqtransformer_tpu_torch.ops import quantize as tq  # noqa: E402
from hqtransformer_tpu_torch.ops import vq_argmin as vq  # noqa: E402

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
    vq.vq_argmin.launches = 0
    out = vq.vq_argmin(torch.from_numpy(z), torch.from_numpy(e))
    assert vq.vq_argmin.launches == 0
    np.testing.assert_array_equal(
        out.numpy(),
        vq.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy())


def test_vq_argmin_kernel_checks():
    """What the CUDA path refuses, checked before any launch."""
    ok = torch.zeros(8, 32)
    vq._check(ok, torch.zeros(16, 32))
    with pytest.raises(ValueError, match='multiple of 16'):
        vq._check(torch.zeros(8, 24), torch.zeros(16, 24))
    with pytest.raises(ValueError, match='dim'):
        vq._check(ok, torch.zeros(16, 48))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        vq._check(ok.half(), torch.zeros(16, 32))
    with pytest.raises(ValueError, match='contiguous'):
        vq._check(torch.zeros(32, 8).T, torch.zeros(16, 32))


@pytest.mark.parametrize('n,k,splits', [(8192, 8192, 4), (32768, 8192, 1),
                                        (2048, 8192, 16), (37, 1000, 8)])
def test_codebook_splits(n, k, splits):
    """On 132 SMs: the flagship top and bottom and the 3-level top at the
    chip-smoke batches, and a small ragged search that takes every tile."""
    assert vq.codebook_splits(n, k, 132) == splits


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
