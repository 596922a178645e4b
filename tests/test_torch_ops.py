"""The PyTorch port's ops against the JAX package: the plain versions of
the two CUDA kernels (decode attention, top-k sampling) against the TPU
kernels run in interpret mode and against their XLA oracle, plus the masks
and the pixel (un)shuffle. Inputs are numpy arrays made from a seed."""

import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.ops import masks as jax_masks  # noqa: E402
from hqtransformer_tpu.ops import resample as jax_resample  # noqa: E402
from hqtransformer_tpu.ops.pallas_attention import (  # noqa: E402
    decode_attention_step, decode_attention_step_xla)
from hqtransformer_tpu.ops.pallas_sample import _sample_topk_2d  # noqa: E402
from hqtransformer_tpu.ops.topk_topp import cutoff_topk_logits  # noqa: E402

from hqtransformer_tpu_torch.ops import (  # noqa: E402
    cuda_build, masks, resample)
from hqtransformer_tpu_torch.ops.decode_attention import \
    decode_attention_step_plain  # noqa: E402
from hqtransformer_tpu_torch.ops.sample_topk import (  # noqa: E402
    sample_topk, sample_topk_plain, scaled_logits, topk_threshold)


# --------------------------------------------------------- decode attention

@pytest.mark.parametrize('pos', [0, 1, 7, 8, 15, 16, 31, 32])
def test_decode_attention_plain_matches_jax(pos):
    """Caches bit-equal and y within atol 1e-5 of both the XLA oracle and
    the Pallas kernel in interpret mode; pos 15, 16, 31 and 32 sit on the
    edges of the rows the CUDA kernel's warps take at once."""
    L, B, D, nh = 2, 32, 128, 4
    T = 16 if pos < 16 else 40   # a multiple of the TPU kernel's row chunk
    layer = pos % L
    rng = np.random.RandomState(pos)
    kc, vc = (rng.randn(L, T, B, D).astype(np.float32) for _ in range(2))
    q, kn, vn = (rng.randn(B, D).astype(np.float32) for _ in range(3))

    y_xla, kc_xla, vc_xla = decode_attention_step_xla(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), layer, pos, nh)
    y_pl, kc_pl, vc_pl = decode_attention_step(
        *map(jnp.asarray, (q, kn, vn, kc, vc)), layer, pos, nh,
        block_b=32, interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y = decode_attention_step_plain(torch.from_numpy(q), torch.from_numpy(kn),
                                    torch.from_numpy(vn), tk, tv, layer, pos,
                                    nh)
    for ref_k, ref_v, ref_y in ((kc_xla, vc_xla, y_xla),
                                (kc_pl, vc_pl, y_pl)):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5,
                                   rtol=0)


def test_decode_attention_kernel_checks():
    """What the CUDA path refuses, checked before any launch: the kernel
    moves 16-byte vectors, so rows and caches must be 16-byte aligned."""
    from hqtransformer_tpu_torch.ops.decode_attention import _check
    L, T, B, D, nh = 2, 8, 4, 128, 4
    caches = torch.zeros(L, T, B, D), torch.zeros(L, T, B, D)
    qkv = torch.zeros(B, 3 * D)
    _check(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], *caches, 1, 3, nh)
    odd = torch.zeros(B, 3 * D + 1)[:, 1:]   # rows 4 bytes off alignment
    with pytest.raises(ValueError, match='16-byte'):
        _check(odd[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], *caches, 1, 3,
               nh)
    narrow = torch.zeros(B, D + 2)[:, :D]   # row stride 520 bytes
    with pytest.raises(ValueError, match='16-byte'):
        _check(qkv[:, :D], narrow, qkv[:, 2 * D:], *caches, 1, 3, nh)
    shifted = torch.zeros(L * T * B * D + 1)[1:].view(L, T, B, D)
    with pytest.raises(ValueError, match='16-byte'):
        _check(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], shifted,
               caches[1], 1, 3, nh)
    with pytest.raises(ValueError, match='head dim'):
        _check(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], *caches, 1, 3, 8)
    with pytest.raises(IndexError):
        _check(qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:], *caches, 1, T,
               nh)


# ----------------------------------------------------------- top-k sampling

def _logits(shape, seed, ties=False, bf16=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2  # many exact ties, also at the k-th value
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _check_draws(logits, u, k, temperature, bf16=False):
    """Plain version vs the Pallas kernel (interpret mode) on the same
    uniforms: identical exact kept sets; identical codes except rows whose
    draw lies within 1e-4 of the row's mass from the CDF boundary between
    the two codes (the TPU kernel's two-level prefix sums carry ~2^-17
    relative error); at most 1% of rows differ; with k = 1 none may."""
    N, V = logits.shape
    t_logits = torch.from_numpy(logits)
    j_logits = jnp.asarray(logits)
    if bf16:
        t_logits, j_logits = t_logits.bfloat16(), j_logits.astype(jnp.bfloat16)
    ref = np.asarray(_sample_topk_2d(j_logits, jnp.asarray(u), jnp.int32(k),
                                     jnp.float32(temperature),
                                     interpret=True))
    ours = sample_topk_plain(t_logits, torch.from_numpy(u), k,
                             temperature).numpy()
    assert ours.dtype == np.int32 and ours.shape == (N,)

    x = scaled_logits(t_logits, temperature)
    thr, _ = topk_threshold(x, k)
    kept = (x >= thr).numpy()
    exact = np.asarray(cutoff_topk_logits(jnp.asarray(x.numpy()), k,
                                          use_bisect=False)) > -np.inf
    np.testing.assert_array_equal(kept, exact)
    rows = np.arange(N)
    assert kept[rows, ours].all() and kept[rows, ref].all()

    diff = np.nonzero(ours != ref)[0]
    if k == 1:
        assert diff.size == 0
    assert diff.size <= 0.01 * N, (diff.size, N)
    xs = x.numpy().astype(np.float64)
    p = np.where(kept, np.exp(xs - xs.max(-1, keepdims=True)), 0.0)
    cdf = np.cumsum(p, axis=-1)
    for r in diff:
        boundary = cdf[r, min(ours[r], ref[r])]
        draw = u[r] * cdf[r, -1]
        assert abs(draw - boundary) <= 1e-4 * cdf[r, -1], (r, ours[r], ref[r])


@pytest.mark.parametrize('temperature', [0.95, 1.0])
@pytest.mark.parametrize('k', [1, 8, 40, 'V'])
@pytest.mark.parametrize('shape', [(200, 256), (64, 1000)])
def test_sample_topk_plain_matches_pallas(shape, k, temperature):
    logits = _logits(shape, seed=shape[1] + (0 if k == 'V' else k))
    u = np.random.RandomState(shape[0]).rand(shape[0]).astype(np.float32)
    _check_draws(logits, u, shape[1] if k == 'V' else k, temperature)


@pytest.mark.parametrize('bf16', [False, True])
def test_sample_topk_plain_ties_and_bf16(bf16):
    logits = _logits((200, 256), seed=7, ties=not bf16, bf16=bf16)
    u = np.random.RandomState(8).rand(200).astype(np.float32)
    for k in (1, 40):
        _check_draws(logits, u, k, 0.95, bf16=bf16)


def test_sample_topk_wrapper_takes_plain_on_cpu():
    logits = torch.from_numpy(_logits((16, 300), seed=9))
    u = torch.from_numpy(np.random.RandomState(10).rand(16)
                         .astype(np.float32))
    np.testing.assert_array_equal(sample_topk(logits, u, 20, 0.9).numpy(),
                                  sample_topk_plain(logits, u, 20, 0.9)
                                  .numpy())


# ---------------------------------------------------- masks and resampling

@pytest.mark.parametrize('t', [1, 5, 17])
def test_causal_mask(t):
    np.testing.assert_array_equal(masks.causal(t).numpy(), jax_masks.causal(t))


@pytest.mark.parametrize('t,n', [(5, 4), (5, 1), (17, 4), (3, 4)])
def test_parallel_2level_mask(t, n):
    np.testing.assert_array_equal(masks.parallel_2level(t, n).numpy(),
                                  jax_masks.parallel_2level(t, n))


@pytest.mark.parametrize('r', [2, 4])
def test_pixel_shuffle_pair(r):
    x = np.random.RandomState(r).randn(2, 3, 5, 4 * r * r).astype(np.float32)
    ours = resample.pixel_shuffle(torch.from_numpy(x), r)
    ref = jax_resample.pixel_shuffle(jnp.asarray(x), r)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = resample.pixel_unshuffle(ours, r)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jax_resample.pixel_unshuffle(jnp.asarray(ours.numpy()), r)))


# ------------------------------------------------------------ kernel builds

@pytest.mark.parametrize('name', cuda_build.KERNEL_SOURCES)
def test_kernel_source_includes_no_repo_header(name):
    """The build key hashes a kernel's source and flags only, so a source
    may include the toolkit's headers (<...>) and none of the repo's."""
    src = (cuda_build.CSRC_DIR / f'{name}.cu').read_text()
    includes = re.findall(r'^\s*#\s*include\s*(\S+)', src, re.M)
    assert includes and all(inc.startswith('<') for inc in includes), includes


def test_library_path_keys_source_and_flags(tmp_path, monkeypatch):
    """An edited source or changed flags give another library name."""
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', tmp_path)
    src = tmp_path / 'k.cu'
    src.write_text('extern "C" int f() { return 0; }\n')
    first = cuda_build.library_path('k')
    assert cuda_build.library_path('k') == first
    src.write_text('extern "C" int f() { return 1; }\n')
    edited = cuda_build.library_path('k')
    assert edited != first
    monkeypatch.setattr(cuda_build, 'NVCC_FLAGS',
                        cuda_build.NVCC_FLAGS + ('-lineinfo',))
    assert cuda_build.library_path('k') not in (first, edited)
