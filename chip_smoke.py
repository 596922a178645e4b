#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hqtransformer_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Device: prints the card, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions; builds every CUDA kernel from
   hqtransformer_tpu_torch/csrc (one nvcc each, all at once) and prints the
   build time and ptxas report (registers, spills, shared memory, and any
   wgmma or setmaxnreg warning).
2. Kernels against their plain PyTorch versions at the flagship shapes
   (TF32 off for matmuls and convolutions):
   - decode attention, L=12 T=64 B=128 D=1536 24 heads, f32 and bf16,
     pos in {0, 1, 7, 8, 15, 16, 31, 32, 33, 63} (the edges of the rows a
     warp takes at once and of the kernel's shared-memory rounds), and
     L=2 T=160 B=8 at pos in {64, 65, 129, 159} (several rounds): caches
     bit-equal, y allclose at 1e-5 (f32) / 2e-2 (bf16);
   - top-k sampling, [640, 8192] bf16 and f32, k in {1, 2048, 8192},
     T=0.95, shared uniforms: k=1 draws an argmax, every code lies in the
     exact top-k set (from torch.topk), codes equal the plain version's
     except rows whose draw lies within 1e-5 of the row's mass from the CDF
     boundary between the two codes, at most 1% of rows.
   Then times each kernel, its plain version and one PyTorch library call
   computing the same function, with CUDA events, and computes the least
   time the card could take (the bound).
3. The main path at full width: the flagship class-conditional ImageNet-256
   config (12 spatial layers, d=1536) with seeded random weights in bf16,
   TwoStageModel.make_pixel_sampler(top-k 2048, T 0.95) on 128 labels,
   twice (the first call warms up): codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], and exactly 756 decode-attention
   and 128 sampling launches per call. Prints samples/s and peak memory,
   then a breakdown: the AR loop and the stage-1 decode timed apart, with
   the device's busy time and largest kernels from torch.profiler.
4. Nearest-code search (K3) against its plain version (TF32 off): N=8191,
   D in {256, 1024, 4096}, K in {8192, 1000}, f32 (the SIMT variant) and
   bf16 (the wgmma variant), and bf16 at D in {40, 200} (a ragged tail of
   D) and at N=37 D=64 K=1000 and N=100 D=32 K=100 (less than one tile):
   codes equal but for rows whose two codes' distances, recomputed in
   f64, lie within 1e-5 (|z|^2 + |e|^2) of each other, at most 0.1% of
   rows; and integer-valued inputs with every code four times in the
   codebook, where both versions must take the lowest index of each exact
   tie, in f32 and bf16. Then, in bf16 at every shape the encode paths
   launch it at (the flagship top and bottom levels, which the 3-level
   middle and bottom share at batch 32, and the 3-level top at batch 32),
   compares it with its plain version by the same rule and times the
   kernel, its plain version and cuBLAS addmm + argmin (extra peak memory
   of each beside); the bound takes the bf16 tensor-core rate. Two more
   lines, outside the JSON: the bf16 cuBLAS product z @ e.T alone at each
   shape (not the same function: how close the wgmma main loop comes to
   cuBLAS's bf16 GEMM), and the f32 SIMT variant at the flagship top.
5. The encode slice at full width: `make_reconstructor` on the flagship
   stage-1 HQ-VAE (seeded random bf16 weights) on 128 seeded images, twice:
   pixels [128, 256, 256, 3] finite in [-1, 1], codes in range, exactly 2
   K3 and no K1 or K2 launches per call. Prints images/s, peak memory and a
   breakdown (encoder, quantize with its K3 launches, decoder) from
   torch.profiler. Then `TwoStageModel.extract_codes` and `forward` on the
   flagship two-stage model at batch 128 (logits [128, 64, 8192] and
   [128, 256, 8192], finite, 2 K3 launches per call), and
   `make_reconstructor` on the 3-level HQ-VAE at batch 32 (3 K3 launches).
6. A reference on a small input: the tiny config, f32, greedy (top-k 1),
   sampled through the CUDA kernels and through the CPU plain versions with
   the same weights: equal codes, pixels within 1e-3; and the same images
   encoded on both: `extract_codes` equal, reconstructions within 1e-3.

Prints one JSON line of per-kernel numbers, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises, so the script exits
non-zero without that line; so it does without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8.yaml'
TINY = ROOT / 'configs/tiny/stage2-tiny.yaml'
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense

# K1 at the flagship main path: 12 layers, 64 cache rows, batch 128,
# d=1536, 24 heads; 12 launches per spatial step x 63 steps.
L, T, B, D, NH = 12, 64, 128, 1536, 24
K1_LAUNCHES = L * 63
# K2: one top draw [B, V] and one bottom-group draw [4B, V] per position.
V = 8192
K2_LAUNCHES = 2 * 64
TIMED_POS = 33
# K3: one launch per code level; N = batch x level area, K = 8192 codes.
# The 3-level middle and bottom levels at batch 32 have the flagship top's
# and bottom's (N, D), so these three shapes are every K3 launch of the
# encode paths, and every codebook split they take (2, 1, 8 on 132 SMs for
# the bf16 wgmma variant).
LEVEL3 = ROOT / 'configs/imagenet/stage1/hqvae-pixelshuffle-top8x8-level3.yaml'
N_CODES = 8192
K3_SHAPES = (('flagship top = 3-level middle', 8192, 1024),
             ('flagship bottom = 3-level bottom', 32768, 256),
             ('3-level top, batch 32', 2048, 4096))
B_LEVEL3 = 32
NEAR_TIE = 1e-5
# Names of the port's kernels as the profiler reports them.
PORT_KERNELS = ('decode_attention_kernel', 'sample_topk_kernel', 'vq_')


def require(ok, message) -> None:
    """A check of the run (unlike `assert`, kept under python -O)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {message}')


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def print_ptxas_report(source: str, text: str) -> None:
    """One line per compiled kernel of `source` from nvcc's -Xptxas=-v
    output: registers, barriers, shared memory and spills; then any
    warning (a wgmma serialised, a setmaxnreg ignored)."""
    kernels = re.findall(r"Compiling entry function '([^']+)'", text)
    spills = re.findall(r'(\d+) bytes spill stores', text)
    used = re.findall(r'Used (.*)', text)
    demangled = subprocess.run(['c++filt'], input='\n'.join(kernels),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    print(f'  {source}: {len(kernels)} kernels')
    for name, n_spill, line in zip(demangled, spills, used):
        name = name.replace('(anonymous namespace)::', '').split('(')[0]
        print(f'    {name.removeprefix("void ")}: {line.strip()}, '
              f'{n_spill} bytes spilled')
    for line in text.splitlines():
        if 'warning' in line.lower():
            print(f'    {line.strip()}')


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn(i) over `iters` back-to-back calls, by CUDA
    events. The stream first sleeps on the card while the host queues every
    call, so that the host's launch overhead leaves no gaps between the
    timed calls. A call that waits for the device (a copy to the host)
    cannot be queued ahead; its time then includes those waits, and the
    script says so."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 1_000_000
    for _ in range(2):
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued_ms < held.elapsed_time(start):
            break
        cycles *= 4
    else:
        print(f'  note: the host took {queued_ms:.2f} ms to queue {iters} '
              f'calls, longer than the device sleep; this time includes '
              f'launch gaps')
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """The least time in ms: bytes over the memory rate or operations over
    the card's peak for the operands' type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------- K1 decode attention

# K1 check cases: (L, T, B, positions). The flagship cache at the edges of
# the rows a warp takes at once (4 at hd 64 in bf16, 2 in f32) and of the
# shared-memory rounds (64 rows at hd 64 in bf16, 32 in f32); then a longer
# cache that takes several rounds in both dtypes.
K1_CASES = ((L, T, B, (0, 1, 7, 8, 15, 16, 31, 32, 33, 63)),
            (2, 160, 8, (64, 65, 129, 159)))


def check_decode_attention(da):
    max_err = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for n_layers, n_rows, batch, positions in K1_CASES:
            for pos in positions:
                g = torch.Generator(device='cuda').manual_seed(pos)

                def randn(*shape):
                    return torch.randn(shape, generator=g,
                                       device='cuda').to(dtype)

                kc = randn(n_layers, n_rows, batch, D)
                vc = randn(n_layers, n_rows, batch, D)
                q, kn, vn = randn(batch, D), randn(batch, D), randn(batch, D)
                layer = pos % n_layers
                kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc, vc
                y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer,
                                              pos, NH)
                y2 = da.decode_attention_step_plain(q, kn, vn, kc2, vc2,
                                                    layer, pos, NH)
                torch.cuda.synchronize()
                require(torch.equal(kc1, kc2) and torch.equal(vc1, vc2),
                        f'K1 cache rows differ ({dtype}, T {n_rows}, '
                        f'pos {pos})')
                err = (y1.float() - y2.float()).abs().max().item()
                torch.testing.assert_close(y1.float(), y2.float(), atol=tol,
                                           rtol=tol)
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
                print(f'K1 {str(dtype):14s} T={n_rows:3d} B={batch:3d} '
                      f'pos={pos:3d}: caches bit-equal, max|y - plain| = '
                      f'{err:.3e} (tol {tol})')
    return max_err[torch.bfloat16]


def time_decode_attention(da):
    """bf16 at pos 33, batch 128; the layer rotates over all 12 so that
    each call reads its cache prefix from HBM, not from L2, as on the main
    path."""
    g = torch.Generator(device='cuda').manual_seed(1)
    dt = torch.bfloat16
    kc = torch.randn((L, T, B, D), generator=g, device='cuda').to(dt)
    vc = torch.randn((L, T, B, D), generator=g, device='cuda').to(dt)
    q, kn, vn = (torch.randn((B, D), generator=g, device='cuda').to(dt)
                 for _ in range(3))
    pos = TIMED_POS
    hd = D // NH
    # few enough calls that every launch fits in the device's queue
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % L, pos, NH), 24)
    # library yardstick: SDPA over the valid cache rows, pre-permuted to
    # [B, nh, pos+1, hd] outside the timed region
    ks = [kc[l, :pos + 1].reshape(pos + 1, B, NH, hd).permute(1, 2, 0, 3)
          .contiguous() for l in range(L)]
    vs = [vc[l, :pos + 1].reshape(pos + 1, B, NH, hd).permute(1, 2, 0, 3)
          .contiguous() for l in range(L)]
    qh = q.reshape(B, NH, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda i: sdpa(qh, ks[i % L], vs[i % L]), 240)
    # bytes: q, k_new, v_new and the 2*pos cache rows read; the two new
    # rows and y written. flops: q.k and a.v over pos+1 rows.
    n_bytes = B * D * (3 + 2 * pos + 2 + 1) * 2
    flops = 2 * 2 * (pos + 1) * B * D
    rate = n_bytes / (kernel / 1e3)   # bytes per second
    print(f'K1 bf16 pos {pos} B {B}: kernel {kernel:.5f} ms moves the '
          f'bound\'s {n_bytes / 2**20:.2f} MiB at {rate / 1e12:.3f} TB/s '
          f'({rate / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} '
          f'TB/s)')
    return kernel, plain, library, bound(n_bytes, flops)


# ---------------------------------------------------------- K2 top-k sample

def check_sample_topk(st):
    N, temp = 640, 0.95
    max_err, worst_frac = 0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device='cuda').manual_seed(7)
        logits = (torch.randn((N, V), generator=g, device='cuda') * 3
                  ).to(dtype)
        u = torch.rand(N, generator=g, device='cuda')
        x = st.scaled_logits(logits, temp)
        rows = torch.arange(N, device='cuda')
        for k in (1, 2048, 8192):
            c1 = st.sample_topk(logits, u, k, temp).long()
            c2 = st.sample_topk_plain(logits, u, k, temp).long()
            torch.cuda.synchronize()
            kth = torch.topk(x, k, dim=-1).values[:, -1:]
            kept = x >= kth
            thr, _ = st.topk_threshold(x, k)
            require(torch.equal(kept, x >= thr),
                    f'K2 bisection kept set differs from top-k (k={k})')
            require(kept[rows, c1].all(), f'K2 code outside top-{k} set')
            if k == 1:
                require(torch.equal(x[rows, c1], x.amax(-1)),
                        'K2 k=1 drew a code that is not an argmax')
                require(torch.equal(c1, c2), 'K2 k=1 differs from plain')
            differ = torch.nonzero(c1 != c2).flatten()
            if differ.numel():
                x64 = x[differ].double()
                p = torch.where(kept[differ],
                                torch.exp(x64 - x64.amax(-1, keepdim=True)),
                                0.0)
                cdf = torch.cumsum(p, -1)
                total = cdf[:, -1]
                lo = torch.minimum(c1[differ], c2[differ])
                gap = (u[differ].double() * total -
                       cdf.gather(1, lo[:, None])[:, 0]).abs() / total
                require((gap <= 1e-5).all(), f'K2 codes differ away from a '
                        f'CDF boundary: {gap.max().item()}')
            frac = differ.numel() / N
            require(frac <= 0.01, f'K2 {differ.numel()} of {N} rows differ')
            max_err = max(max_err, (c1 - c2).abs().max().item())
            worst_frac = max(worst_frac, frac)
            print(f'K2 {str(dtype):14s} k={k:4d}: codes in the exact top-k '
                  f'set; {differ.numel()} of {N} rows differ from plain, '
                  f'all at a CDF boundary')
    return max_err, worst_frac


def time_sample_topk(st):
    """bf16 bottom-group draw at batch 128: [512, 8192], k 2048, T 0.95."""
    N, k, temp = 4 * B, 2048, 0.95
    g = torch.Generator(device='cuda').manual_seed(3)
    logits = (torch.randn((N, V), generator=g, device='cuda') * 3).to(
        torch.bfloat16)
    u = torch.rand(N, generator=g, device='cuda')
    kernel = time_ms(lambda i: st.sample_topk(logits, u, k, temp), 200)
    plain = time_ms(lambda i: st.sample_topk_plain(logits, u, k, temp), 1)

    def library(i):
        x = logits.float() / temp
        vals, idx = torch.topk(x, k, dim=-1)
        j = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=g)
        return idx.gather(1, j)

    lib = time_ms(library, 50)
    # bytes: the logits and u read once, the codes written once. ops per
    # logit: the divide, 2 per bisection step this row ran (compare, count),
    # and about 5 for the mask, exp, running sum, draw count and snap.
    _, iters = st.topk_threshold(st.scaled_logits(logits, temp), k)
    n_bytes = N * V * 2 + N * 4 + N * 4
    flops = V * (6 * N + 2 * int(iters.sum()))
    return kernel, plain, lib, bound(n_bytes, flops)


# ----------------------------------------------------- K3 nearest-code search

def compare_codes(z, e, c1, c2):
    """Rows where codes c1 and c2 differ must be near-ties: their two
    squared distances, recomputed in f64, within NEAR_TIE (|z|^2 + |e|^2);
    at most 0.1% of rows. Returns (rows differing, max f64 distance gap)."""
    rows = torch.nonzero(c1 != c2).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    z64, e1, e2 = z[rows].double(), e[c1[rows]].double(), e[c2[rows]].double()
    gap = ((z64 - e1).square().sum(1) - (z64 - e2).square().sum(1)).abs()
    scale = z64.square().sum(1) + torch.maximum(e1.square().sum(1),
                                                e2.square().sum(1))
    require(bool((gap <= NEAR_TIE * scale).all()),
            f'K3 codes differ away from a near-tie: gap {gap.max().item()}')
    require(rows.numel() <= 1e-3 * z.shape[0],
            f'K3 {rows.numel()} of {z.shape[0]} rows differ')
    return rows.numel(), gap.max().item()


def check_vq_argmin(vq):
    N = 8191   # ragged: not a multiple of the kernel's 128-row tile
    max_err = 0.0
    # f32 and mixed pairs run the SIMT variant, bf16 the wgmma variant;
    # D = 40 and 200 leave a ragged tail of the wgmma variant's 64-column
    # chunks, and the small cases have fewer rows and codes than one of its
    # TMA boxes.
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(N, D, K, dt, dt) for D in (256, 1024, 4096)
             for K in (N_CODES, 1000) for dt in (f32, bf16)]
    cases += [(N, 256, K, zt, et) for K in (N_CODES, 1000)
              for zt, et in ((f32, bf16), (bf16, f32))]
    cases += [(N, 40, 1000, bf16, bf16), (N, 200, N_CODES, bf16, bf16),
              (37, 64, 1000, bf16, bf16), (100, 32, 100, bf16, bf16)]
    for n, D, K, z_dtype, e_dtype in cases:
        g = torch.Generator(device='cuda').manual_seed(D + K)
        z = torch.randn((n, D), generator=g, device='cuda').to(z_dtype)
        e = torch.randn((K, D), generator=g, device='cuda').to(e_dtype)
        c1 = vq.vq_argmin(z, e)
        c2 = vq.vq_argmin_plain(z, e)
        torch.cuda.synchronize()
        n_diff, err = compare_codes(z, e, c1, c2)
        max_err = max(max_err, err)
        pair = f'{str(z_dtype)[6:]} z, {str(e_dtype)[6:]} e'
        print(f'K3 N={n:4d} D={D:4d} K={K:4d} {pair:20s} '
              f'({vq.kernel_variant(z_dtype, e_dtype)}): {n_diff} of {n} '
              f'rows differ from plain, each a near-tie')
    # Exact ties: integer values keep every distance exact in f32 whatever
    # the summation order. Code c equals codes c^1 and c^1 +- K/2.
    g = torch.Generator(device='cuda').manual_seed(11)
    base = torch.randint(-3, 4, (N_CODES // 4, 256), generator=g,
                         device='cuda').repeat_interleave(2, dim=0)
    e = torch.cat([base, base]).float()
    z = torch.randint(-3, 4, (N, 256), generator=g, device='cuda').float()
    for dtype in (torch.float32, torch.bfloat16):
        c1 = vq.vq_argmin(z.to(dtype), e.to(dtype))
        c2 = vq.vq_argmin_plain(z.to(dtype), e.to(dtype))
        torch.cuda.synchronize()
        require(torch.equal(c1, c2), f'K3 exact ties resolved differently '
                f'from plain ({dtype})')
        require(bool((c1 % 2 == 0).all() and (c1 < N_CODES // 2).all()),
                f'K3 exact ties not resolved to the lowest index ({dtype})')
        print(f'K3 exact ties {str(dtype):14s} '
              f'({vq.kernel_variant(dtype, dtype)}): equal to plain, every '
              f'row on the lowest index of its tie')
    return max_err


def extra_peak_mib(fn) -> float:
    """Device memory one call of fn allocates at its peak beyond what is
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def time_vq_argmin(vq):
    """bf16 z and codebooks, as served, at each K3_SHAPES shape: first the
    kernel's codes against the plain version's on these inputs (the
    near-tie rule of compare_codes), then the times. The library yardstick
    is cuBLAS SGEMM (TF32 off) + argmin, which writes the [N, K] f32 score
    matrix; the port never calls it. The bound takes the bf16 tensor-core
    rate: a bf16 x bf16 product is exact in f32, so a bf16 wgmma with f32
    accumulation gives the same scores up to summation order. Returns
    (one (ms, plain, lib, bound, memory) per shape, max f64 gap)."""
    out, max_err = [], 0.0
    for name, N, D in K3_SHAPES:
        g = torch.Generator(device='cuda').manual_seed(N + D)
        z = torch.randn((N, D), generator=g, device='cuda').bfloat16()
        e = torch.randn((N_CODES, D), generator=g,
                        device='cuda').bfloat16()
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = vq.codebook_splits(N, N_CODES, n_sms, 'wgmma')
        n_diff, err = compare_codes(z, e, vq.vq_argmin(z, e),
                                    vq.vq_argmin_plain(z, e))
        max_err = max(max_err, err)
        print(f'K3 {name} N={N} D={D} bf16, {splits} codebook slices: '
              f'{n_diff} of {N} rows differ from plain, each a near-tie')

        def library(i=0):
            ef = e.float()
            return torch.addmm(ef.square().sum(1), z.float(), ef.T,
                               alpha=-2).argmin(1)

        def kernel(i=0):
            return vq.vq_argmin(z, e)

        ms = time_ms(kernel, 10)
        plain = time_ms(lambda i: vq.vq_argmin_plain(z, e), 3)
        lib = time_ms(library, 10)
        mem = (extra_peak_mib(kernel), extra_peak_mib(library))
        # bytes: z and e read once, the codes written once; operations:
        # one multiply and one add per (row, code, dim), at the bf16 rate.
        n_bytes = (N + N_CODES) * D * 2 + N * 8
        flops = 2 * N * N_CODES * D
        bnd = bound(n_bytes, flops, BF16_FLOPS_PER_S)
        out.append((ms, plain, lib, bnd, mem))
        print(f'K3 {name} N={N} K={N_CODES} D={D} bf16: kernel {ms:.4f} ms '
              f'({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, '
              f'addmm+argmin {lib:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, '
              f'bf16 rate); extra peak memory kernel {mem[0]:.2f} MiB, '
              f'addmm+argmin {mem[1]:.1f} MiB')
        # Yardstick outside the JSON: cuBLAS's bf16 GEMM alone. It is not
        # the same function (no argmin, and it writes the [N, K] matrix).
        gemm = time_ms(lambda i: torch.matmul(z, e.T), 10)
        print(f'K3 {name} yardstick: bf16 cuBLAS z @ e.T alone {gemm:.4f} ms '
              f'({flops / gemm / 1e9:.1f} TFLOP/s); the kernel takes '
              f'{ms / gemm:.2f}x its time')
    # The f32 SIMT variant at the flagship top, f32 operands.
    _, N, D = K3_SHAPES[0]
    g = torch.Generator(device='cuda').manual_seed(N + D)
    z = torch.randn((N, D), generator=g, device='cuda')
    e = torch.randn((N_CODES, D), generator=g, device='cuda')
    simt = time_ms(lambda i: vq.vq_argmin(z, e), 5)
    f32_bound = bound((N + N_CODES) * D * 4 + N * 8, 2 * N * N_CODES * D)
    print(f'K3 f32 SIMT variant N={N} K={N_CODES} D={D}: {simt:.4f} ms, '
          f'bound {f32_bound[0]:.4f} ms ({f32_bound[1]}, f32 rate)')
    return out, max_err


# ------------------------------------------------------------ main path

def run_main_path(da, st):
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         serving_bf16_params)
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    cfg = build_twostage_config(str(FLAGSHIP))
    model = TwoStageModel(cfg, dtype=torch.bfloat16)
    weights = {s: serving_bf16_params(w)
               for s, w in model.init_weights(seed=0).items()}
    params = SamplingParams(top_k_top=2048, top_k_bot=2048,
                            temperature_top=0.95, temperature_bot=0.95)
    sampler = model.make_pixel_sampler(params=params)
    labels = torch.arange(B, device='cuda') % cfg.stage2.hparams.n_classes
    gen = torch.Generator(device='cuda').manual_seed(1)
    n_codes = cfg.stage2.vocab_size_img
    res = cfg.dataset.image_resolution
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.decode_attention_step.launches = 0
        st.sample_topk.launches = 0
        t0 = time.perf_counter()
        pixels, (codes_t, codes_b) = sampler(weights, gen, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (da.decode_attention_step.launches,
                    st.sample_topk.launches)
        require(launches == (K1_LAUNCHES, K2_LAUNCHES),
                f'kernel launches {launches}, expected '
                f'{(K1_LAUNCHES, K2_LAUNCHES)}')
        require(codes_t.shape == (B, 64) and codes_b.shape == (B, 64, 4),
                f'code shapes {codes_t.shape}, {codes_b.shape}')
        for c in (codes_t, codes_b):
            require(int(c.min()) >= 0 and int(c.max()) < n_codes,
                    f'codes outside [0, {n_codes})')
        require(pixels.shape == (B, res, res, 3),
                f'pixel shape {pixels.shape}')
        require(torch.isfinite(pixels).all(), 'pixels not finite')
        require(float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
                'pixels outside [0, 1]')
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'main path call {call}: {seconds:.3f} s, '
              f'{B / seconds:.2f} samples/s at batch {B}, peak '
              f'{peak:.2f} GiB, launches K1={launches[0]} K2={launches[1]}, '
              f'pixels {tuple(pixels.shape)} {pixels.dtype}')
    breakdown(model, weights, params, labels, gen)
    return launches, B / seconds, model, weights


def breakdown(model, weights, params, labels, gen):
    """Where one batch's time goes: the AR loop (stage 2) and the stage-1
    decode, each timed alone on the host clock, then run once more under
    torch.profiler for the device's busy time and its largest kernels."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    model.load_weights(weights)
    n_top, win = model.top_res, model.cell_win
    sampler = make_hierarchical_sampler(model.stage2, n_top * n_top, params)
    codes = sampler(gen, labels)

    @torch.inference_mode()
    def decode():
        ct = codes[0].reshape(-1, n_top, n_top)
        cb = cells_to_raster(codes[1], n_top, win).reshape(
            -1, n_top * win, n_top * win)
        return model.stage1.decode_code(ct, cb)

    profile_phases((('AR loop', lambda: sampler(gen, labels)),
                    ('stage-1 decode', decode)))


def profile_phases(phases):
    """Each (name, fn) timed alone on the host clock, then run once more
    under torch.profiler for the device's busy time and its largest
    kernels. Returns {name: {kernel name: (runs, device ms)}}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = per_kernel.get(e.name, (0, 0.0))
                per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
        per_kernel = {k: (n, us / 1e3) for k, (n, us) in per_kernel.items()}
        busy_ms = sum(ms for _, ms in per_kernel.values())
        print(f'breakdown {name}: {wall_ms:.1f} ms wall; device busy '
              f'{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}) in '
              f'{sum(n for n, _ in per_kernel.values())} kernel runs')
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
        # the six largest, and the port's own kernels wherever they rank
        for rank, (kname, (n, ms)) in enumerate(ranked):
            if rank < 6 or any(k in kname for k in PORT_KERNELS):
                print(f'  {ms:8.2f} ms {n:6d}x  {kname[:90]}')
        out[name] = per_kernel
    return out


# --------------------------------------------------------- the encode slice

def seeded_images(n: int, res: int, seed: int, device='cuda'):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, res, res, 3), generator=g, device=device) * 2 - 1


def reset_counts(*kernels):
    for k in kernels:
        k.launches = 0


def check_reconstruction(pixels, levels, n, res, grids):
    require(pixels.shape == (n, res, res, 3), f'pixel shape {pixels.shape}')
    require(bool(torch.isfinite(pixels).all()), 'pixels not finite')
    require(float(pixels.min()) >= -1.0 and float(pixels.max()) <= 1.0,
            'pixels outside [-1, 1]')
    require([tuple(c.shape) for c in levels] == [(n, s, s) for s in grids],
            f'code shapes {[tuple(c.shape) for c in levels]}')
    for c in levels:
        require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                f'codes outside [0, {N_CODES})')


def run_encode_slice(vq, da, st, stage1_weights):
    """make_reconstructor on the flagship stage-1 HQ-VAE, bf16, 128 images,
    twice; then a breakdown of one batch: encoder, quantize, decoder."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        ReconstructionMetrics, make_reconstructor)

    cfg = build_twostage_config(str(FLAGSHIP)).stage1
    res = cfg.hparams.resolution
    images = seeded_images(B, res, seed=5)
    recon = make_reconstructor(cfg, torch.bfloat16)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(vq.vq_argmin, da.decode_attention_step, st.sample_topk)
        t0 = time.perf_counter()
        pixels, levels = recon(stage1_weights, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (vq.vq_argmin.launches, da.decode_attention_step.launches,
                    st.sample_topk.launches)
        require(launches == (2, 0, 0), f'encode slice launches K3, K1, K2 '
                f'{launches}, expected (2, 0, 0)')
        check_reconstruction(pixels, levels, B, res, (8, 16))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'encode slice call {call}: {seconds:.3f} s, '
              f'{B / seconds:.2f} images/s at batch {B}, peak {peak:.2f} GiB, '
              f'launches K3={launches[0]}, pixels {tuple(pixels.shape)} '
              f'{pixels.dtype}')
    metrics = ReconstructionMetrics(N_CODES)
    metrics.update(images, pixels, levels)
    usage = ', '.join(f'{u:.4f}' for u in metrics.code_usage())
    print(f'encode slice (random weights): MSE {metrics.mse:.4f}, code '
          f'usage per level {usage}')
    encode_breakdown(cfg, stage1_weights, images)
    return launches[0], B / seconds


def encode_breakdown(cfg, stage1_weights, images):
    """The flagship reconstruction split into its three phases, each run
    alone, with the K3 kernels' share of the quantize phase."""
    from hqtransformer_tpu_torch.models.stage1.generator import \
        build_generator
    from hqtransformer_tpu_torch.ops.resample import (pixel_shuffle,
                                                      pixel_unshuffle)

    with torch.device('meta'):
        gen = build_generator(cfg, torch.bfloat16)
    gen = gen.to_empty(device='cuda').eval()
    gen.load_state_dict(stage1_weights, strict=True, assign=True)
    x = images.permute(0, 3, 1, 2).bfloat16()
    w = gen.window

    @torch.inference_mode()
    def encoder():
        return gen.quant_conv_b(gen.encoder(x)).permute(0, 2, 3, 1)

    h_b = encoder()

    @torch.inference_mode()
    def quantize():
        quant_t, _, _ = gen.quantize_t(pixel_unshuffle(h_b, w))
        quant_b, _, _ = gen.quantize_b(h_b - pixel_shuffle(quant_t, w))
        return quant_t, quant_b

    quant = quantize()

    @torch.inference_mode()
    def decoder():
        return gen.decode(*quant)

    per_phase = profile_phases((('encoder', encoder),
                                ('quantize (2 K3)', quantize),
                                ('decoder', decoder)))
    k3 = [(n, ms) for kname, (n, ms) in per_phase['quantize (2 K3)'].items()
          if 'vq_' in kname]
    print(f'breakdown K3 kernels in the quantize phase: '
          f'{sum(ms for _, ms in k3):.2f} ms in {sum(n for n, _ in k3)} runs')


def run_twostage_encode(vq, da, st, model, weights):
    """TwoStageModel.extract_codes and forward on the flagship two-stage
    model, bf16, batch 128."""
    res = model.config.dataset.image_resolution
    images = seeded_images(B, res, seed=6)
    labels = torch.arange(B, device='cuda') % \
        model.config.stage2.hparams.n_classes
    for name, fn in (('extract_codes',
                      lambda: model.extract_codes(weights, images)),
                     ('forward',
                      lambda: model.forward(weights, images, labels))):
        for call in (1, 2):
            torch.cuda.synchronize()
            reset_counts(vq.vq_argmin, da.decode_attention_step,
                         st.sample_topk)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = (vq.vq_argmin.launches,
                        da.decode_attention_step.launches,
                        st.sample_topk.launches)
            require(launches == (2, 0, 0), f'{name} launches K3, K1, K2 '
                    f'{launches}, expected (2, 0, 0)')
        codes = out[0] if name == 'extract_codes' else out[1]
        require(tuple(codes[0].shape) == (B, 64) and
                tuple(codes[1].shape) == (B, 256),
                f'{name} code shapes {[tuple(c.shape) for c in codes]}')
        if name == 'forward':
            lt, lb = out[0]
            require(tuple(lt.shape) == (B, 64, N_CODES) and
                    tuple(lb.shape) == (B, 256, N_CODES),
                    f'logit shapes {tuple(lt.shape)}, {tuple(lb.shape)}')
            require(bool(torch.isfinite(lt).all() and
                         torch.isfinite(lb).all()), 'logits not finite')
        print(f'two-stage {name} at batch {B}: {seconds * 1e3:.1f} ms '
              f'({B / seconds:.2f} images/s), launches K3={launches[0]}')


def run_level3(vq, da, st):
    """make_reconstructor on the 3-level HQ-VAE at batch 32, bf16."""
    from hqtransformer_tpu_torch.config import build_stage1_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)
    from hqtransformer_tpu_torch.models.twostage import serving_bf16_params

    cfg = build_stage1_config(str(LEVEL3)).stage1
    res = cfg.hparams.resolution
    weights = serving_bf16_params(init_stage1_weights(cfg, seed=3))
    images = seeded_images(B_LEVEL3, res, seed=7)
    recon = make_reconstructor(cfg, torch.bfloat16)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(vq.vq_argmin, da.decode_attention_step, st.sample_topk)
        t0 = time.perf_counter()
        pixels, levels = recon(weights, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (vq.vq_argmin.launches, da.decode_attention_step.launches,
                    st.sample_topk.launches)
        require(launches == (3, 0, 0), f'3-level launches K3, K1, K2 '
                f'{launches}, expected (3, 0, 0)')
        check_reconstruction(pixels, levels, B_LEVEL3, res, (8, 16, 32))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'3-level reconstruction call {call}: {seconds:.3f} s, '
              f'{B_LEVEL3 / seconds:.2f} images/s at batch {B_LEVEL3}, peak '
              f'{peak:.2f} GiB, launches K3={launches[0]}')


def check_small_reference(vq):
    """Tiny config, f32: greedy sampling, code extraction and
    reconstruction through the CUDA kernels against the CPU plain path with
    the same weights and inputs."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import make_reconstructor
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    cfg = build_twostage_config(str(TINY))
    greedy = SamplingParams(top_k_top=1, top_k_bot=1)
    labels = torch.arange(8) % cfg.stage2.hparams.n_classes
    cpu = TwoStageModel(cfg, device='cpu')
    weights = cpu.init_weights(seed=2)
    ref_px, (ref_t, ref_b) = cpu.make_pixel_sampler(params=greedy)(
        weights, torch.Generator().manual_seed(0), labels)
    gpu = TwoStageModel(cfg, device='cuda')
    w_gpu = {s: {k: v.cuda() for k, v in w.items()}
             for s, w in weights.items()}
    px, (ct, cb) = gpu.make_pixel_sampler(params=greedy)(
        w_gpu, torch.Generator(device='cuda').manual_seed(0), labels.cuda())
    require(torch.equal(ct.cpu(), ref_t) and torch.equal(cb.cpu(), ref_b),
            'tiny greedy codes differ between the CUDA and the CPU path')
    err = (px.cpu() - ref_px).abs().max().item()
    require(err <= 1e-3, f'tiny greedy pixels differ by {err}')
    print(f'tiny greedy reference: codes equal to the CPU plain path, '
          f'max|pixels - cpu| = {err:.2e}')

    res = cfg.dataset.image_resolution
    images = seeded_images(8, res, seed=9, device='cpu')
    (ref_t, ref_b), _ = cpu.extract_codes(weights, images)
    reset_counts(vq.vq_argmin)
    (ct, cb), _ = gpu.extract_codes(w_gpu, images.cuda())
    torch.cuda.synchronize()
    require(vq.vq_argmin.launches == 2, 'tiny extract_codes did not run K3')
    require(torch.equal(ct.cpu(), ref_t) and torch.equal(cb.cpu(), ref_b),
            'tiny extract_codes differ between the CUDA and the CPU path')
    ref_px, ref_levels = make_reconstructor(cfg.stage1, device='cpu')(
        weights['stage1'], images)
    px, levels = make_reconstructor(cfg.stage1, device='cuda')(
        w_gpu['stage1'], images.cuda())
    require(all(torch.equal(a.cpu(), b) for a, b in zip(levels, ref_levels)),
            'tiny reconstruction codes differ between CUDA and CPU')
    err = (px.cpu() - ref_px).abs().max().item()
    require(err <= 1e-3, f'tiny reconstruction pixels differ by {err}')
    print(f'tiny encode reference: extract_codes and reconstruction codes '
          f'equal to the CPU plain path, max|pixels - cpu| = {err:.2e}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hqtransformer_tpu_torch.ops import cuda_build
    from hqtransformer_tpu_torch.ops import decode_attention as da
    from hqtransformer_tpu_torch.ops import sample_topk as st
    from hqtransformer_tpu_torch.ops import vq_argmin as vq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f'device: {kind} (count {count}); nvidia-smi: {smi}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python '
          f'{sys.version.split()[0]}; TF32 off for matmul and cuDNN')
    t0 = time.perf_counter()
    messages = cuda_build.build()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'({", ".join(cuda_build.KERNEL_SOURCES)})')
    for name, text in messages.items():
        print_ptxas_report(name, text)

    k1_err = check_decode_attention(da)
    k2_err, k2_frac = check_sample_topk(st)
    k3_err = check_vq_argmin(vq)
    k1_times = time_decode_attention(da)
    k2_times = time_sample_topk(st)
    k3_shapes, k3_served_err = time_vq_argmin(vq)
    k3_err = max(k3_err, k3_served_err)
    launches, samples_per_s, model, weights = run_main_path(da, st)
    k3_launches, images_per_s = run_encode_slice(vq, da, st,
                                                 weights['stage1'])
    run_twostage_encode(vq, da, st, model, weights)
    del model, weights
    run_level3(vq, da, st)
    check_small_reference(vq)

    # K3's entry: the mean of one launch at each of the slice's two levels.
    flagship = k3_shapes[:2]
    k3_times = tuple(sum(t[i] for t in flagship) / 2 for i in range(3)) + (
        (sum(t[3][0] for t in flagship) / 2, flagship[0][3][1]),)

    kernels = []
    for name, src, replaces, n, err, (ms, plain, lib, (bnd, by)) in (
            ('decode_attention', 'hqtransformer_tpu_torch/csrc/'
             'decode_attention.cu', 'hqtransformer_tpu/ops/'
             'pallas_attention.py:200', launches[0], k1_err, k1_times),
            ('sample_topk', 'hqtransformer_tpu_torch/csrc/sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236', launches[1],
             k2_err, k2_times),
            ('vq_argmin', 'hqtransformer_tpu_torch/csrc/vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3_launches, k3_err,
             k3_times)):
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': n,
                        'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                        'plain_ms': plain, 'bound_ms': bnd, 'bound_by': by,
                        'library_ms': lib})
    print(f'K2 rows differing from plain at most {k2_frac:.4f}; main path '
          f'{samples_per_s:.2f} samples/s at batch {B}; encode slice '
          f'{images_per_s:.2f} images/s at batch {B}')
    print(json.dumps({'kernels': kernels}))
    print(f'nvidia-smi: {nvidia_smi()}')
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
