"""The PyTorch port's ops against the JAX package: the plain versions of
the two CUDA kernels (decode attention, top-k sampling) against the TPU
kernels run in interpret mode and against their XLA oracle, plus the masks
and the pixel (un)shuffle. Inputs are numpy arrays made from a seed."""

import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
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
    BISECT_RANGE, bisection3_replay, bisection_replay, kth_pair, radix_key,
    replay_threshold, sample_topk, sample_topk_plain, scaled_logits,
    select_threshold, topk_threshold, topk_threshold3)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _check_draws(logits, u, k, temperature, bf16=False, bisect3=False):
    """Plain version vs the Pallas kernel (interpret mode) on the same
    uniforms, with the binary or (`bisect3`) the quartile threshold search
    on both sides: identical exact kept sets; identical codes except rows
    whose draw lies within 1e-4 of the row's mass from the CDF boundary
    between the two codes (the TPU kernel's two-level prefix sums carry
    ~2^-17 relative error); at most 1% of rows differ; with k = 1 none
    may."""
    N, V = logits.shape
    t_logits = torch.from_numpy(logits)
    j_logits = jnp.asarray(logits)
    if bf16:
        t_logits, j_logits = t_logits.bfloat16(), j_logits.astype(jnp.bfloat16)
    ref = np.asarray(_sample_topk_2d(j_logits, jnp.asarray(u), jnp.int32(k),
                                     jnp.float32(temperature),
                                     interpret=True, bisect3=bisect3))
    ours = sample_topk_plain(t_logits, torch.from_numpy(u), k,
                             temperature, bisect3).numpy()
    assert ours.dtype == np.int32 and ours.shape == (N,)

    x = scaled_logits(t_logits, temperature)
    thr = select_threshold(x, k, bisect3)
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


def _pallas_cases(test):
    for mark in (pytest.mark.parametrize('temperature', [0.95, 1.0]),
                 pytest.mark.parametrize('k', [1, 8, 40, 'V']),
                 pytest.mark.parametrize('shape', [(200, 256), (64, 1000)])):
        test = mark(test)
    return test


def _plain_matches_pallas(shape, k, temperature, bisect3):
    logits = _logits(shape, seed=shape[1] + (0 if k == 'V' else k))
    u = np.random.RandomState(shape[0]).rand(shape[0]).astype(np.float32)
    _check_draws(logits, u, shape[1] if k == 'V' else k, temperature,
                 bisect3=bisect3)


@_pallas_cases
def test_sample_topk_plain_matches_pallas(shape, k, temperature):
    _plain_matches_pallas(shape, k, temperature, bisect3=False)


@_pallas_cases
def test_sample_topk_plain_matches_pallas_bisect3(shape, k, temperature):
    """The twin of each case above with the quartile search
    (`_sample_topk_2d(bisect3=True)`, the TPU kernel's `threshold3`): its
    kept sets and codes are those of `topk_threshold3`."""
    _plain_matches_pallas(shape, k, temperature, bisect3=True)


@pytest.mark.parametrize('bf16', [False, True])
def test_sample_topk_plain_ties_and_bf16(bf16):
    logits = _logits((200, 256), seed=7, ties=not bf16, bf16=bf16)
    u = np.random.RandomState(8).rand(200).astype(np.float32)
    for k in (1, 40):
        _check_draws(logits, u, k, 0.95, bf16=bf16)
        _check_draws(logits, u, k, 0.95, bf16=bf16, bisect3=True)


def test_sample_topk_wrapper_takes_plain_on_cpu():
    logits = torch.from_numpy(_logits((16, 300), seed=9))
    u = torch.from_numpy(np.random.RandomState(10).rand(16)
                         .astype(np.float32))
    np.testing.assert_array_equal(sample_topk(logits, u, 20, 0.9).numpy(),
                                  sample_topk_plain(logits, u, 20, 0.9)
                                  .numpy())


def _hard_rows(kind, n, v, seed):
    """Rows that stress the threshold: 'random' N(0, 9); 'ties', integer
    values with many exact ties at every rank; 'zeros', 90% +0.0 and -0.0
    (random signs) among random values, so the k-th value is a signed zero
    for middle k; 'x30', random values scaled 30x, so the k-th value of
    most k lies below row max - 44."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, v) * 3).astype(np.float32)
    if kind == 'ties':
        x = np.round(x)
    elif kind == 'zeros':
        zero = np.where(rng.rand(n, v) < 0.5, -0.0, 0.0).astype(np.float32)
        x = np.where(rng.rand(n, v) < 0.9, zero, x)
    elif kind == 'x30':
        x = x * 30
    return x


def _hard_cases(test):
    for mark in (pytest.mark.parametrize('V', [256, 1000]),
                 pytest.mark.parametrize('bf16', [False, True]),
                 pytest.mark.parametrize('kind,seed', [
                     ('random', 0), ('random', 1), ('random', 2),
                     ('ties', 3), ('zeros', 4), ('x30', 5)])):
        test = mark(test)
    return test


@_hard_cases
def test_bisection_replay_matches_bisection(kind, seed, bf16, V):
    """The CUDA kernel's threshold (select on the logits as stored, divide,
    replay) equals the TPU kernel's bisection (`topk_threshold`) bit for
    bit; the selected pair is JAX's top_k values of the logits; the kept
    set is the exact top-k within the window [max - 44, max]."""
    logits = torch.from_numpy(_hard_rows(kind, 48, V, seed))
    if bf16:
        logits = logits.bfloat16()
    x = scaled_logits(logits, 0.95)
    row_max = x.amax(dim=-1, keepdim=True)
    top = np.asarray(jax.lax.top_k(jnp.asarray(logits.float().numpy()),
                                   V)[0])
    for k in (1, 2, 40, V - 1):
        thr = replay_threshold(logits, k, 0.95)
        assert torch.equal(thr.view(torch.int32),
                           topk_threshold(x, k).view(torch.int32)), k
        v_k, v_k1 = kth_pair(logits, k)
        np.testing.assert_array_equal(v_k[:, 0].numpy(), top[:, k - 1])
        np.testing.assert_array_equal(v_k1[:, 0].numpy(), top[:, k])
        assert torch.equal(thr, bisection_replay(
            row_max, *(scaled_logits(v, 0.95) for v in (v_k, v_k1))))
        kth = torch.topk(x, k, dim=-1).values[:, -1:]
        window = torch.maximum(kth, row_max - BISECT_RANGE)
        assert torch.equal(x >= thr, x >= window), k


@_hard_cases
def test_bisection3_replay_matches_threshold3(kind, seed, bf16, V):
    """The twin of each case above for the quartile search: the kernel's
    `bisect3` threshold (select on the logits as stored, divide,
    `bisection3_replay`) equals `topk_threshold3` bit for bit, ties, signed
    zeros, bf16 rows and V = 1000 included; the kept set is the exact
    top-k within the window [max - 44, max]."""
    logits = torch.from_numpy(_hard_rows(kind, 48, V, seed))
    if bf16:
        logits = logits.bfloat16()
    x = scaled_logits(logits, 0.95)
    row_max = x.amax(dim=-1, keepdim=True)
    differs = 0
    for k in (1, 2, 40, V - 1):
        thr = replay_threshold(logits, k, 0.95, bisect3=True)
        assert torch.equal(thr.view(torch.int32),
                           topk_threshold3(x, k).view(torch.int32)), k
        assert torch.equal(thr, bisection3_replay(
            row_max, *(scaled_logits(v, 0.95) for v in kth_pair(logits, k))))
        kth = torch.topk(x, k, dim=-1).values[:, -1:]
        window = torch.maximum(kth, row_max - BISECT_RANGE)
        assert torch.equal(x >= thr, x >= window), k
        differs += int((thr != topk_threshold(x, k)).sum())
    if kind == 'random':
        assert differs > 0   # the two searches end on other low bits


def test_radix_key_sorts_like_values():
    """The key is monotone in the value: x < y gives key(x) < key(y), and
    equal keys only for bit-equal values; -0 sorts just below +0; +-inf,
    subnormals and the extremes of f32 included."""
    f32 = np.finfo(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, f32.max, -f32.max,
                        f32.tiny, -f32.tiny, f32.smallest_subnormal,
                        -f32.smallest_subnormal, 1e-40, -1e-40, 1.0, -1.0,
                        np.nextafter(np.float32(1), np.float32(2)),
                        np.nextafter(np.float32(-1), np.float32(-2))],
                       dtype=np.float32)
    rng = np.random.RandomState(6)
    x = np.concatenate([special, (rng.randn(500) * 10.0 **
                                  rng.randint(-40, 38, 500)).astype(np.float32)])
    key = radix_key(torch.from_numpy(x)).numpy()
    assert key.min() >= 0 and key.max() < 2**32
    less = x[:, None] < x[None, :]
    assert (key[:, None] < key[None, :])[less].all()
    bits = x.view(np.uint32)
    same = key[:, None] == key[None, :]
    assert (bits[:, None] == bits[None, :])[same].all()
    assert key[1] + 1 == key[0]   # -0 just below +0


def test_sample_topk_wrapper_threshold_on_cpu():
    """The optional threshold output of the wrapper: on the CPU it holds
    the plain version's threshold."""
    logits = torch.from_numpy(_logits((16, 300), seed=11))
    u = torch.from_numpy(np.random.RandomState(12).rand(16)
                         .astype(np.float32))
    thr = torch.empty(16)
    codes = sample_topk(logits, u, 20, 0.9, threshold=thr)
    np.testing.assert_array_equal(
        codes.numpy(), sample_topk_plain(logits, u, 20, 0.9).numpy())
    assert torch.equal(thr, topk_threshold(scaled_logits(logits, 0.9),
                                           20)[:, 0])


def test_sample_topk_wrapper_bisect3_on_cpu():
    """bisect3 through the wrapper on the CPU: the quartile search's
    threshold and the plain version's codes with it."""
    logits = torch.from_numpy(_logits((16, 300), seed=13))
    u = torch.from_numpy(np.random.RandomState(14).rand(16)
                         .astype(np.float32))
    thr = torch.empty(16)
    codes = sample_topk(logits, u, 20, 0.9, threshold=thr, bisect3=True)
    np.testing.assert_array_equal(
        codes.numpy(),
        sample_topk_plain(logits, u, 20, 0.9, bisect3=True).numpy())
    assert torch.equal(thr, topk_threshold3(scaled_logits(logits, 0.9),
                                            20)[:, 0])


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
