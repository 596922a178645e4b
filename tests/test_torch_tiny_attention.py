"""Depth-chain attention (`ops/tiny_attention.py`).

On the CPU: the wrapper is the plain version bit for bit, the argument
check raises on what the kernel does not take (and launches nothing), the
launch plan fits the kernel at every shape the depth chains run, and no
launch is counted. On a card (tests marked `card`, skipped without one;
run there with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_tiny_attention.py`, since the conftest imports JAX): the
CUDA kernel against the plain version at the depth chains' shapes and
widths (within the reordered sums' rounding, `assert_close_to_plain`),
and a CUDA-graph-captured call against an eager one.
"""

import math

import pytest

torch = pytest.importorskip('torch')

from hqtransformer_tpu_torch.models.stage2 import (hierarchical,  # noqa: E402
                                                   layers, multilevel)
from hqtransformer_tpu_torch.ops import masks  # noqa: E402
from hqtransformer_tpu_torch.ops import tiny_attention as ta  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

H100_SMS = 132
# (Tq, Tk, mask): the 2-level depth-second chain (4 bottoms a group), the
# 3-level mid and bottom phases under their level-3 rows, and 2-level
# models with 16 bottoms a group
CASES = [(4, 5, None), (4, 5, (1, 4)), (16, 21, (5, 16)), (16, 17, None)]
CASE_IDS = ['4x5', '4x5-level3', '16x21-level3', '16x17']
# (D, heads): every published width, the tp 2 and tp 4 ranks' widths, and
# the tiny test config's
WIDTHS = [(1536, 24), (768, 12), (384, 6), (64, 4)]


def inputs(b, tq, tk, d, dtype, device='cpu', seed=0):
    """q as the depth phases take it (a view of a fused [B, Tq, 3D] qkv
    product, rows 3D apart), k and v contiguous, seeded."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, tq, 3 * d, generator=g).to(device, dtype)
    k, v = (torch.randn(b, tk, d, generator=g).to(device, dtype)
            for _ in range(2))
    return qkv[..., :d], k, v


def mask_of(case, device='cpu'):
    """The level-3 mask rows a case runs under (a strided view), or None."""
    rows = case[2]
    return None if rows is None else masks.level3_decode(
        'parallel', rows[0], rows[1], device)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU form')
    return torch.device('cuda')


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_cpu_wrapper_is_the_plain_version(dtype, case):
    q, k, v = inputs(3, case[0], case[1], 64, dtype, seed=1)
    m = mask_of(case)
    got = ta.tiny_attention(q, k, v, 4, m)
    assert got.dtype == dtype and got.shape == (3, case[0], 64)
    assert torch.equal(got, ta.tiny_attention_plain(q, k, v, 4, m))


def test_depth_chains_call_the_wrapper():
    """The model modules keep the name `tiny_attention`, now the wrapper."""
    assert layers.tiny_attention is ta.tiny_attention
    assert multilevel.tiny_attention is ta.tiny_attention
    assert hierarchical.tiny_attention is ta.tiny_attention
    assert layers.NEG_INF == ta.NEG_INF == -1e10


def test_cpu_counts_no_launch():
    before = tracing.counter('ta.launches')
    q, k, v = inputs(2, 16, 21, 64, torch.bfloat16)
    ta.tiny_attention(q, k, v, 4, mask_of(CASES[2]))
    assert tracing.counter('ta.launches') == before


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_check_takes_the_depth_chains_inputs(dtype, case):
    """The strided q and level-3 mask views the depth phases pass."""
    q, k, v = inputs(2, case[0], case[1], 64, dtype)
    ta.check(q, k, v, 4, mask_of(case))


def _bad(kind):
    q, k, v = inputs(2, 16, 21, 64, torch.bfloat16)
    n_heads, mask = 4, None
    if kind == 'tk33':
        k, v = (torch.zeros(2, 33, 64, dtype=torch.bfloat16)
                for _ in range(2))
    elif kind == 'tq33':
        q = torch.zeros(2, 33, 64, dtype=torch.bfloat16)
    elif kind == 'hd12':
        q, k, v = (torch.zeros(2, t, 48, dtype=torch.bfloat16)
                   for t in (16, 21, 21))
    elif kind == 'hd136':
        q, k, v = (torch.zeros(2, t, 136, dtype=torch.bfloat16)
                   for t in (16, 21, 21))
        n_heads = 1
    elif kind == 'mask_shape':
        mask = masks.level3('parallel')[:16, :20]
    elif kind == 'mask_dtype':
        mask = mask_of(CASES[2]).to(torch.uint8)
    elif kind == 'heads':
        n_heads = 5
    elif kind in ('float16', 'float64'):
        q, k, v = (t.to(getattr(torch, kind)) for t in (q, k, v))
    elif kind == 'mixed':
        k = k.float()
    elif kind == 'strided_channels':
        q = torch.zeros(2, 16, 128, dtype=torch.bfloat16)[..., ::2]
    elif kind == 'unaligned_rows':
        q = torch.zeros(2, 16, 67, dtype=torch.bfloat16)[..., :64]
    elif kind == 'shapes':
        v = v[:, :20]
    return q, k, v, n_heads, mask


@pytest.mark.parametrize('kind,error', [
    ('tk33', ValueError), ('tq33', ValueError), ('hd12', ValueError),
    ('hd136', ValueError), ('mask_shape', ValueError),
    ('mask_dtype', ValueError), ('heads', ValueError),
    ('float16', TypeError), ('float64', TypeError), ('mixed', TypeError),
    ('strided_channels', ValueError), ('unaligned_rows', ValueError),
    ('shapes', ValueError)])
def test_check_refuses(kind, error):
    with pytest.raises(error):
        ta.check(*_bad(kind))


@pytest.mark.parametrize('b', [1, 512, 1024])
@pytest.mark.parametrize('tq,tk', [(1, 1), (4, 5), (16, 21), (32, 32)])
@pytest.mark.parametrize('d,n_heads', WIDTHS + [(3072, 24)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_launch_plan_fits_the_kernel(dtype, d, n_heads, tq, tk, b):
    """Heads a block divide the heads, the threads are whole warps holding
    two threads a (head, query) within the kernel's 256, and the shared memory
    fits the card (the kernel refuses a plan whose bytes differ from its
    own count, `smem_bytes`)."""
    heads, threads, smem = ta.launch_plan(b, tq, tk, d, n_heads, dtype,
                                          H100_SMS)
    assert n_heads % heads == 0
    assert threads % 32 == 0 and 2 * heads * tq <= threads <= 256
    assert smem == ta.smem_bytes(heads, d // n_heads, tq, tk, dtype)
    assert smem <= ta.MAX_SMEM


def test_launch_plan_at_the_served_shapes():
    """A block of 8 heads at the 3-level bottom phase (256 threads), the
    whole row of 24 heads at the 4-query chains (192 threads)."""
    bf16 = torch.bfloat16
    assert ta.launch_plan(512, 16, 21, 1536, 24, bf16, H100_SMS) == \
        (8, 256, ta.smem_bytes(8, 64, 16, 21, bf16))
    assert ta.launch_plan(512, 4, 5, 1536, 24, bf16, H100_SMS)[:2] == \
        (24, 192)
    assert ta.launch_plan(1024, 4, 5, 1536, 24, bf16, H100_SMS)[:2] == \
        (24, 192)
    # a small batch takes fewer heads a block, for more blocks
    assert ta.launch_plan(3, 16, 21, 1536, 24, bf16, H100_SMS)[0] == 1


# ------------------------------------------------------------------ card

def assert_close_to_plain(got, want, q, k, v, n_heads, mask):
    """The kernel's output against the plain version's. Only the order of
    the f32 sums differs, so a score may round one f32 step apart; a
    weight then rounds to the other side of a bf16 step in a few places,
    moving y by at most that step times |v|, and y rounds once more. So
    in bf16: 99% of the elements equal, and each within 2^-7 of
    (sum_j w_j |v_j| + |y|) (a bf16 step is at most 2^-7 of its value).
    In f32: within 2e-6 of max(1, sum_j w_j |v_j|). Here sum_j w_j |v_j|
    is the plain version's output on |v|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = ta.tiny_attention_plain(q, k, v.abs(), n_heads, mask).double()
    diff = (got.double() - want.double()).abs()
    if got.dtype == torch.bfloat16:
        assert float((got == want).double().mean()) >= 0.99
        limit = 2.0 ** -7 * (scale + want.double().abs())
    else:
        limit = 2e-6 * scale.clamp_min(1.0)
    assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.card
@pytest.mark.parametrize('b', [1, 3, 512])
@pytest.mark.parametrize('d,n_heads', WIDTHS, ids=[f'{d}-{h}' for d, h in
                                                  WIDTHS])
@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_kernel_matches_plain(card, dtype, case, d, n_heads, b):
    q, k, v = inputs(b, case[0], case[1], d, dtype, card, seed=b + d)
    m = mask_of(case, card)
    before = tracing.counter('ta.launches')
    got = ta.tiny_attention(q, k, v, n_heads, m)
    assert tracing.counter('ta.launches') == before + 1
    want = ta.tiny_attention_plain(q, k, v, n_heads, m)
    assert_close_to_plain(got, want, q, k, v, n_heads, m)
    assert got.is_contiguous()


@pytest.mark.card
@pytest.mark.parametrize('case', CASES[1:3], ids=CASE_IDS[1:3])
def test_kernel_under_graph_capture(card, case):
    """A CUDA graph captures the launch (no host read, no synchronisation)
    and its replay on new inputs equals an eager call on them."""
    q, k, v = inputs(512, case[0], case[1], 1536, torch.bfloat16, card)
    m = mask_of(case, card)
    eager = ta.tiny_attention(q, k, v, 24, m)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ta.tiny_attention(q, k, v, 24, m)     # warm on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        out = ta.tiny_attention(q, k, v, 24, m)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    q2, k2, v2 = inputs(512, case[0], case[1], 1536, torch.bfloat16, card,
                        seed=9)
    q.copy_(q2)
    k.copy_(k2)
    v.copy_(v2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ta.tiny_attention(q, k, v, 24, m))


@pytest.mark.card
def test_kernel_repeats_itself(card):
    q, k, v = inputs(512, 16, 21, 1536, torch.bfloat16, card)
    m = mask_of(CASES[2], card)
    first = ta.tiny_attention(q, k, v, 24, m)
    assert all(torch.equal(first, ta.tiny_attention(q, k, v, 24, m))
               for _ in range(3))
    assert math.isfinite(float(first.float().abs().max()))
