#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hqtransformer_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

With `--k1-only` it runs phase 1, decode attention's checks and timings
of phases 2 and 7 and the K1 sweep, and stops without the result line
(to compare two commits' K1, run it in a checkout of each, in turns).

1. Device: prints the card, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions; builds every CUDA kernel from
   hqtransformer_tpu_torch/csrc (one nvcc each, all at once) and prints the
   build time and ptxas report (registers, spills, shared memory, and any
   wgmma or setmaxnreg warning), and for each decode attention kernel its
   int-to-float conversions (I2F) and byte permutes in the SASS
   (`cuobjdump`).
2. Kernels against their plain PyTorch versions at the flagship shapes
   (TF32 off for matmuls and convolutions):
   - decode attention, L=12 T=64 B=128 D=1536 24 heads, f32 and bf16,
     pos in {0, 1, 7, 8, 15, 16, 31, 32, 33, 63} (the edges of the rows a
     warp takes at once and of the kernel's shared-memory rounds), and
     L=2 T=160 B=8 at pos in {64, 65, 129, 159} (several rounds): caches
     bit-equal, y allclose at 1e-5 (f32) / 2e-2 (bf16);
   - top-k sampling, bf16 and f32, T=0.95, shared uniforms, on four kinds
     of rows (random; integers with ties at every rank; 90% signed zeros;
     random x30, whose k-th value lies below max - 44) at V=8192 (640
     rows) and V=1000 (256 rows), k in {1, 2, 2048, V-1, V}: the kernel's
     threshold output equals topk_threshold bit for bit, its kept set is
     the exact top-k within [max - 44, max], every code lies in it, k=1
     draws an argmax, codes equal the plain version's except rows whose
     draw lies within 1e-5 of the row's mass from the CDF boundary between
     the two codes, at most 1% of rows.
   Then times each kernel, its plain version and one PyTorch library call
   computing the same function, with CUDA events, and computes the least
   time the card could take (the bound). K1 is also swept over every
   position the sampler launches it at (1..63), on int8 and on bf16 caches
   of the same values at batch 128, each time beside its bound, with the
   fitted fixed and per-row costs and the sum over a batch's 756 launches
   beside the summed bound. K2 at both main-path shapes
   ([512, 8192] and [128, 8192] bf16, k 2048), its library call topk +
   softmax + cumsum + searchsorted on the same uniforms.
   K2 with `bisect3` (the TPU kernel's quartile search) at the 3-level
   draw shapes [128 | 512 | 2048, 8192], k in {1, 2048}, T 1.0, on random
   and tied bf16 rows and random f32 rows: its threshold output equals
   `replay_threshold(bisect3=True)` and `topk_threshold3` bit for bit,
   with the kept-set and code checks above; then timed at those shapes
   with `bisect3` off and on, in turns, beside its plain version, the
   library call and the bound.
3. The main path at full width: the flagship class-conditional ImageNet-256
   config (12 spatial layers, d=1536) with seeded random weights in bf16,
   TwoStageModel.make_pixel_sampler(top-k 2048, T 0.95) on 128 labels,
   twice (the first call warms up): codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], and exactly 756 decode-attention
   and 128 sampling launches per call. Prints samples/s and peak memory,
   then a breakdown: the AR loop and the stage-1 decode timed apart, with
   the device's busy time and largest kernels from torch.profiler.
4. Nearest-code search (K3) against its plain version (TF32 off): N=8191,
   D in {256, 1024, 4096}, K in {8192, 1000}, f32 (6 pairs of bf16
   pieces) and bf16 (1 pair), both mixed pairs at D=256 (3 pairs), and
   bf16 at D in {40, 200} (a ragged tail of D) and at N=37 D=64 K=1000 and
   N=100 D=32 K=100 (less than one tile): codes equal but for rows whose
   two codes' distances, recomputed in f64, lie within 1e-5 (|z|^2 +
   |e|^2) of each other, at most 0.1% of rows; and integer-valued inputs
   with every code four times in the codebook, where both versions must
   take the lowest index of each exact tie, in f32 and bf16. Each case
   names the pair list it ran. Then, in bf16 and in f32 at every shape the
   encode paths launch it at (the flagship top and bottom levels, which
   the 3-level middle and bottom share at batch 32, and the 3-level top at
   batch 32), compares it with its plain version by the same rule and
   times the kernel, its plain version and cuBLAS addmm + argmin in f32
   (extra peak memory of each beside); the bound is the function's
   2 N K D operations (one pass) at the bf16 tensor-core rate, in either
   dtype, and a line of its own gives the design's floor, its passes at
   that rate (six in f32). One more line in bf16, outside the JSON: the
   bf16 cuBLAS product z @ e.T alone at each shape (not the same function:
   how close the wgmma main loop comes to cuBLAS's bf16 GEMM).
5. The encode slice at full width: `make_reconstructor` on the flagship
   stage-1 HQ-VAE (seeded random bf16 weights) on 128 seeded images, twice:
   pixels [128, 256, 256, 3] finite in [-1, 1], codes in range, exactly 2
   K3 and no K1 or K2 launches per call. Prints images/s, peak memory and a
   breakdown (encoder, quantize with its K3 launches, decoder) from
   torch.profiler. Then `TwoStageModel.extract_codes` and `forward` on the
   flagship two-stage model at batch 128 (logits [128, 64, 8192] and
   [128, 256, 8192], finite, 2 K3 launches per call), and
   `make_reconstructor` on the 3-level HQ-VAE at batch 32 (3 K3 launches),
   and `make_reconstructor` on the flagship stage-1 at its default f32 (the
   eval_stage1.py path, seeded random f32 weights) at batch 128, twice
   (2 K3 launches on the f32 x f32 route).
6. A reference on a small input: the tiny config, f32, greedy (top-k 1),
   sampled through the CUDA kernels and through the CPU plain versions with
   the same weights: equal codes, pixels within 1e-3; and the same images
   encoded on both: `extract_codes` equal, reconstructions within 1e-3;
   and the flagship level-3 config cut to a tiny size (d 128), greedy at
   every level, with and without `bisect3`: the three levels' codes equal,
   pixels within 1e-3.
7. int8max serving (run right after phase 3, on its model and weights):
   - decode attention's int8 kernel against its plain version with int8
     caches and new rows over all of -128..127 and an f32 or bf16 q, at
     phase 2's positions, the int8 kernel's stage edges (pos 15..17,
     31..33, 47..49, 63 at T=64 B=128), partly filled row steps (pos 9,
     14, 40), round edges (63..65, 127..129 and stage edges at T=160 B=8),
     batch 1024 at pos 33 and 63, and head dim 32 (48 heads): caches
     bit-equal, y (in the int8 values' units, dequantized by a V scale of
     1/127) allclose at 1e-5 (f32 q) / 2e-2 (bf16 q); a q with a NaN and
     an infinity gives NaN in y exactly where the plain version does;
     then timed at pos 33, B 128, beside the
     bf16 kernel (no single PyTorch call attends over an int8 cache: its
     library time is null; bf16 SDPA over the dequantized cache is printed
     for context), and at pos 33, B 1024;
   - the A8W8 products on the card against the CPU on the same int8
     inputs (`_int_mm` at the flagship's fused-QKV and MLP gemm shapes,
     the int8 convolution at the decoder's largest, 128 channels at 256^2
     on 2 images): int32 results equal;
   - calibration at the flagship: KV scales from one bf16 sampling run at
     batch 128 (`calibrate_kv_scales`), stage-2 activation scales from the
     teacher-forced forward on that run's codes (the same generator seed)
     and decode scales from `decode_code` on them; saved to
     build/int8max_scales.pkl and loaded back bit for bit;
   - `make_pipelined_sampler` in int8max (all four switches) and in bf16
     on the same labels, batch 128: one fill call and two steady calls,
     each with codes in [0, 8192), pixels [128, 256, 256, 3] finite in
     [0, 1], 756 decode-attention launches (all on the int8 variant in
     int8max) and 128 sampling launches, and int8 gemms and convolutions
     counted (int8max) or none (bf16); samples/s and peak memory; then the
     int8max AR loop and int8 decode broken down under torch.profiler; one
     steady call of each mode at batch 1024 (samples/s, peak memory); one
     steady call at batch 128 in int8max without the spatial gemms
     (bench.py's BENCH_INT8_SPATIAL=0), with the same checks;
   - the bf16 run's codes through `make_hierarchical_scorer` in bf16 and
     in int8max: top-1 agreement of the per-step logits and their mean KL
     (numbers to record; the weights are random).

8. The 3-level family at full width (after phase 7's model is freed): the
   flagship level-3 config (12 spatial layers, d 1536, three 8192-code
   levels, parallel-add) with seeded random bf16 weights,
   `make_pixel_sampler_multilevel(top-k 2048, T 1.0 a level)` on 128
   labels, twice, then once with `bisect3`: codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], exactly 756 K1 and 192 K2
   launches a call (all 192 with `bisect3` in the third); samples/s and
   peak memory; then the AR loop and the stage-1 decode broken down as in
   phase 3.

Prints one JSON line of per-kernel numbers, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises, so the script exits
non-zero without that line; so it does without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
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
# encode paths, and every codebook split they take (2, 1, 8 on 132 SMs).
LEVEL3 = ROOT / 'configs/imagenet/stage1/hqvae-pixelshuffle-top8x8-level3.yaml'
N_CODES = 8192
K3_SHAPES = (('flagship top = 3-level middle', 8192, 1024),
             ('flagship bottom = 3-level bottom', 32768, 256),
             ('3-level top, batch 32', 2048, 4096))
B_LEVEL3 = 32
NEAR_TIE = 1e-5
# Names of the port's kernels as the profiler reports them.
PORT_KERNELS = ('decode_attention_kernel', 'decode_attention_int8_kernel',
                'sample_topk_kernel', 'vq_')
# int8max: the batch at which the cache's size matters, and the artifact.
B_LARGE = 1024
SCALES_PATH = ROOT / 'build' / 'int8max_scales.pkl'


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

def k1_bytes(pos: int, batch: int, int8: bool) -> int:
    """Bytes K1 must move at `pos` with a bf16 q: q, k_new, v_new and the
    2 * pos cache rows read once; the two new rows and y written once. The
    caches and the new rows are int8 or bf16."""
    c = 1 if int8 else 2
    return batch * D * (2 + 2 * c + 2 * pos * c + 2 * c + 2)


def k1_flops(pos: int, batch: int) -> int:
    """q.k and a.v over the pos + 1 rows."""
    return 2 * 2 * (pos + 1) * batch * D


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
    n_bytes = k1_bytes(pos, B, int8=False)
    rate = n_bytes / (kernel / 1e3)   # bytes per second
    print(f'K1 bf16 pos {pos} B {B}: kernel {kernel:.5f} ms moves the '
          f'bound\'s {n_bytes / 2**20:.2f} MiB at {rate / 1e12:.3f} TB/s '
          f'({rate / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} '
          f'TB/s)')
    return kernel, plain, library, bound(n_bytes, k1_flops(pos, B))


# K1-int8 check cases: (L, T, B, heads, positions). Every position of
# K1_CASES; on the flagship cache the int8 kernel's stage edges +-1
# (stages of 16 buffer rows, the new token's row first) and positions whose
# last step of 8 rows is partly filled (9, 14, 40); its round edges (64
# rows) +-1 and stage edges on a longer cache; the pipelined batch 1024 (4
# heads a block); and head dim 32 (48 heads of d 1536) through the stages
# and rounds.
K1_INT8_CASES = ((L, T, B, NH, (0, 1, 7, 8, 9, 14, 15, 16, 17, 31, 32, 33,
                                40, 47, 48, 49, 63)),
                 (2, 160, 8, NH, (63, 64, 65, 79, 80, 81, 127, 128, 129,
                                  159)),
                 (2, T, B_LARGE, NH, (33, 63)),
                 (2, 160, 8, 2 * NH, (0, 17, 33, 64, 129, 159)))


def check_decode_attention_int8(da):
    """K1's int8 kernel: int8 caches and new rows over the full range
    -128..127, f32 or bf16 q, at K1_INT8_CASES: caches bit-equal, y within
    the tolerance in units of 1/127. Then a q with a NaN in one head and
    an infinity in another: y NaN exactly where the plain version's is."""
    max_err = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for n_layers, n_rows, batch, n_heads, positions in K1_INT8_CASES:
            for pos in positions:
                g = torch.Generator(device='cuda').manual_seed(pos)

                def randint8(*shape):
                    return torch.randint(-128, 128, shape, generator=g,
                                         device='cuda', dtype=torch.int8)

                kc = randint8(n_layers, n_rows, batch, D)
                vc = randint8(n_layers, n_rows, batch, D)
                kn, vn = randint8(batch, D), randint8(batch, D)
                q = (torch.randn((batch, D), generator=g, device='cuda') *
                     0.02).to(dtype)
                layer = pos % n_layers
                kc1, vc1 = kc.clone(), vc.clone()
                y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer,
                                              pos, n_heads)
                y2 = da.decode_attention_step_plain(q, kn, vn, kc, vc, layer,
                                                    pos, n_heads)
                torch.cuda.synchronize()
                require(torch.equal(kc1, kc) and torch.equal(vc1, vc),
                        f'K1 int8 cache rows differ ({dtype} q, T {n_rows}, '
                        f'B {batch}, pos {pos})')
                # y is in the int8 values' units (|v| <= 128): compare it
                # dequantized by a V scale of 1/127, as the caller scales it
                y1, y2 = y1.float() / 127, y2.float() / 127
                err = (y1 - y2).abs().max().item()
                torch.testing.assert_close(y1, y2, atol=tol, rtol=tol)
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
                print(f'K1 int8 cache, {str(dtype):14s} q T={n_rows:3d} '
                      f'B={batch:4d} hd={D // n_heads} pos={pos:3d}: caches '
                      f'bit-equal, max|y - plain| / 127 = {err:.3e} (tol '
                      f'{tol})')
                del kc, vc, kc1, vc1
    g = torch.Generator(device='cuda').manual_seed(5)
    kc, vc = (torch.randint(-128, 128, (L, T, B, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                            dtype=torch.int8) for _ in range(2))
    hd = D // NH
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, D), generator=g, device='cuda').to(dtype)
        q[0, 3] = float('nan')
        q[1, hd + 5] = float('inf')
        q[2, 2 * hd] = -float('inf')
        y1 = da.decode_attention_step(q, kn, vn, kc.clone(), vc.clone(), 1,
                                      TIMED_POS, NH)
        y2 = da.decode_attention_step_plain(q, kn, vn, kc.clone(),
                                            vc.clone(), 1, TIMED_POS, NH)
        require(torch.equal(y1.isnan(), y2.isnan()) and
                bool(y2.isnan().any()),
                f'K1 int8 cache, {dtype} q: NaN in y '
                f'({int(y1.isnan().sum())}) differs from the plain '
                f'version\'s ({int(y2.isnan().sum())}) for a non-finite q')
        print(f'K1 int8 cache, {str(dtype):14s} q with NaN and inf: '
              f'{int(y1.isnan().sum())} NaN in y, as the plain version')
    return max_err[torch.bfloat16]


def time_decode_attention_int8(da):
    """int8 caches with a bf16 q at pos 33, batch 128, the layer rotating
    over all 12, beside the bf16 kernel on a bf16 cache of the same values
    in the same call. No single PyTorch call attends over an int8 cache,
    so the library time is None; bf16 SDPA over the dequantized cache is
    printed for context."""
    g = torch.Generator(device='cuda').manual_seed(2)
    kc, vc = (torch.randint(-128, 128, (L, T, B, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                            dtype=torch.int8) for _ in range(2))
    q = (torch.randn((B, D), generator=g, device='cuda') * 0.02).bfloat16()
    pos, hd = TIMED_POS, D // NH
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % L, pos, NH), 24)
    kb, vb = kc.bfloat16(), vc.bfloat16()
    knb, vnb = kn.bfloat16(), vn.bfloat16()
    bf16 = time_ms(lambda i: da.decode_attention_step(
        q, knb, vnb, kb, vb, i % L, pos, NH), 240)
    ks = kb[:, :pos + 1].reshape(L, pos + 1, B, NH, hd).permute(
        0, 2, 3, 1, 4).contiguous()
    vs = vb[:, :pos + 1].reshape(L, pos + 1, B, NH, hd).permute(
        0, 2, 3, 1, 4).contiguous()
    qh = q.reshape(B, NH, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    context = time_ms(lambda i: sdpa(qh, ks[i % L], vs[i % L]), 240)
    n_bytes = k1_bytes(pos, B, int8=True)
    bnd = bound(n_bytes, k1_flops(pos, B))
    rate = n_bytes / (kernel / 1e3)
    print(f'K1 int8 cache, bf16 q, pos {pos} B {B}: kernel {kernel:.5f} ms '
          f'({rate / 1e12:.3f} TB/s over the bound\'s {n_bytes / 2**20:.2f} '
          f'MiB), bound {bnd[0]:.5f} ms ({bnd[1]}; kernel '
          f'{kernel / bnd[0]:.2f}x), plain {plain:.4f} ms; the bf16 kernel '
          f'on the same values {bf16:.5f} ms in this call')
    print(f'K1 int8 library time: none (no PyTorch call attends over an '
          f'int8 cache); for context only, bf16 SDPA over the dequantized '
          f'cache {context:.5f} ms')
    return kernel, plain, None, bnd


# Every position the sampler launches K1 at: the spatial step of position
# i writes cache row i and attends over rows < i, i = 1..63
# (sampling/engine.py::_serving_loop), in each of the 12 layers.
K1_POSITIONS = range(1, T)
# The sweep's caches hold one layer per timed call, so that no call finds
# its rows in L2 from an earlier one (at pos 1 a pass over the layers reads
# 94 MB), as on the main path, where every layer's gemms run in between.
SWEEP_LAYERS = 240


def fit_line(xs, ys):
    """Least-squares (a, b) of y = a + b x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) /
         sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def sweep_decode_attention(da):
    """K1 on int8 caches and on bf16 caches of the same values, bf16 q,
    batch 128, at every position of K1_POSITIONS, each beside its bound;
    the fitted fixed and per-row costs; the sum over a batch's 756
    launches beside the summed bound."""
    g = torch.Generator(device='cuda').manual_seed(3)
    shape = (SWEEP_LAYERS, T, B, D)
    kc8, vc8 = (torch.randint(-128, 128, shape, generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    kn8, vn8 = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    q = (torch.randn((B, D), generator=g, device='cuda') * 0.02).bfloat16()
    operands = {'int8': (kn8, vn8, kc8, vc8),
                'bf16': tuple(x.bfloat16() for x in (kn8, vn8, kc8, vc8))}
    times = {cache: [] for cache in operands}
    for pos in K1_POSITIONS:
        line = [f'K1 sweep pos {pos:2d}:']
        for cache, (kn, vn, kc, vc) in operands.items():
            ms = time_ms(lambda i: da.decode_attention_step(
                q, kn, vn, kc, vc, i % SWEEP_LAYERS, pos, NH), 240)
            bnd = bound(k1_bytes(pos, B, cache == 'int8'),
                        k1_flops(pos, B))[0]
            times[cache].append(ms)
            line.append(f'{cache} {ms:.5f} ms ({bnd / ms:.1%} of '
                        f'{bnd:.5f});')
        print(' '.join(line))
    positions = list(K1_POSITIONS)
    for cache in operands:
        bound_sum = L * sum(bound(k1_bytes(p, B, cache == 'int8'),
                                  k1_flops(p, B))[0] for p in positions)
        a, slope = fit_line(positions, times[cache])
        total = L * sum(times[cache])
        print(f'K1 sweep {cache} caches, B {B}: time = {a * 1e3:.3f} us + '
              f'{slope * 1e3:.4f} us x pos (fit over pos {positions[0]}..'
              f'{positions[-1]}); {len(positions) * L} launches of a batch '
              f'sum to {total:.4f} ms against a summed bound of '
              f'{bound_sum:.4f} ms ({bound_sum / total:.1%})')
    del operands, kc8, vc8
    torch.cuda.empty_cache()


def time_decode_attention_int8_large(da):
    """K1-int8 at batch 1024 (the pipelined int8max batch), pos 33, bf16 q,
    the layer rotating over all 12: 12,288 blocks, several waves."""
    g = torch.Generator(device='cuda').manual_seed(4)
    kc, vc = (torch.randint(-128, 128, (L, T, B_LARGE, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B_LARGE, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    q = (torch.randn((B_LARGE, D), generator=g, device='cuda') *
         0.02).bfloat16()
    pos = TIMED_POS
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 120)
    n_bytes = k1_bytes(pos, B_LARGE, int8=True)
    bnd = bound(n_bytes, k1_flops(pos, B_LARGE))
    print(f'K1 int8 cache, bf16 q, pos {pos} B {B_LARGE}: kernel '
          f'{kernel:.5f} ms ({n_bytes / (kernel / 1e3) / 1e12:.3f} TB/s), '
          f'bound {bnd[0]:.5f} ms ({bnd[1]}; {bnd[0] / kernel:.1%} of it)')
    return kernel, bnd


def print_sass_conversions(so: Path, label: str) -> None:
    """Per kernel of the built library `so`, from `cuobjdump -sass`: its
    int-to-float conversions (I2F, I2FP, by opcode) and byte permutes
    (PRMT) in the SASS text."""
    from hqtransformer_tpu_torch.ops import cuda_build
    tool = Path(cuda_build._nvcc()).with_name('cuobjdump')
    if not tool.exists():
        print(f'  {label}: I2F count not measured (no cuobjdump)')
        return
    out = subprocess.run([str(tool), '-sass', str(so)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    parts = re.split(r'\n\s*Function : (\S+)\s*\n', out)
    names = subprocess.run(['c++filt'], input='\n'.join(parts[1::2]),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    print(f'  {label} SASS (cuobjdump):')
    for name, body in zip(names, parts[2::2]):
        ops = re.findall(r'/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?'
                         r'([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)', body)
        conv = {}
        for op in ops:
            if op.startswith('I2F'):
                conv[op] = conv.get(op, 0) + 1
        n_i2f = sum(conv.values())
        n_prmt = sum(op.split('.')[0] == 'PRMT' for op in ops)
        name = name.replace('(anonymous namespace)::', '').split('(')[0]
        detail = ', '.join(f'{k} {v}' for k, v in sorted(conv.items()))
        print(f'    {name.removeprefix("void ")}: {len(ops)} instructions, '
              f'I2F {n_i2f}{f" ({detail})" if detail else ""}, PRMT '
              f'{n_prmt}')


# ---------------------------------------------------------- K2 top-k sample

# Operations of the K2 kernel per logit: the key, two radix-select passes
# (bf16) of a compare and a count each, the max, the value below the k-th,
# the divide, mask, exp, running sum and draw count.
K2_OPS_PER_LOGIT = 12


def k2_rows(kind: str, n: int, v: int, seed: int) -> torch.Tensor:
    """Seeded rows: 'random' N(0, 9); 'ties' integers, with exact ties at
    every rank; 'zeros' 90% +0.0 and -0.0 of random signs, so the k-th
    value is a signed zero for middle k; 'x30' random values scaled 30x,
    whose k-th value lies below row max - 44 for most k."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, v), generator=g) * 3
    if kind == 'ties':
        x = torch.round(x)
    elif kind == 'zeros':
        zero = torch.where(torch.rand((n, v), generator=g) < 0.5, -0.0, 0.0)
        x = torch.where(torch.rand((n, v), generator=g) < 0.9, zero, x)
    elif kind == 'x30':
        x = x * 30
    return x


K2_KINDS = ('random', 'ties', 'zeros', 'x30')


def check_sample_topk(st):
    """Every row kind in both dtypes at V 8192 and 1000, k in {1, 2, 2048,
    V - 1, V}, T 0.95, shared uniforms: the kernel's threshold output equals
    topk_threshold bit for bit; its kept set is the exact top-k within the
    window [max - 44, max] (all of the row for k >= V); every code lies in
    it; k=1 draws an argmax and equals plain; codes equal the plain
    version's except rows whose draw lies within 1e-5 of the row's mass
    from the CDF boundary between the two codes, at most 1% of rows."""
    temp, device = 0.95, 'cuda'
    max_err, worst_frac = 0, 0.0
    for vocab, n in ((V, 640), (1000, 256)):
        for kind_i, kind in enumerate(K2_KINDS):
            raw = k2_rows(kind, n, vocab, seed=vocab + kind_i).to(device)
            u = torch.rand(n, generator=torch.Generator().manual_seed(
                kind_i)).to(device)
            rows = torch.arange(n, device=device)
            for dtype in (torch.bfloat16, torch.float32):
                logits = raw.to(dtype)
                x = st.scaled_logits(logits, temp)
                row_max = x.amax(-1, keepdim=True)
                for k in (1, 2, 2048, vocab - 1, vocab):
                    k_eff = min(k, vocab)
                    thr_out = torch.empty(n, device=device)
                    c1 = st.sample_topk(logits, u, k, temp,
                                        threshold=thr_out).long()
                    c2 = st.sample_topk_plain(logits, u, k, temp).long()
                    thr = st.topk_threshold(x, k)
                    torch.cuda.synchronize()
                    case = f'{kind} {dtype} V={vocab} k={k}'
                    require(torch.equal(thr_out.view(torch.int32),
                                        thr[:, 0].view(torch.int32)),
                            f'K2 threshold differs from topk_threshold '
                            f'({case})')
                    kth = torch.topk(x, k_eff, dim=-1).values[:, -1:]
                    window = kth if k >= vocab else torch.maximum(
                        kth, row_max - st.BISECT_RANGE)
                    kept = x >= window
                    require(torch.equal(kept, x >= thr),
                            f'K2 kept set differs from top-k ({case})')
                    require(kept[rows, c1].all(),
                            f'K2 code outside the kept set ({case})')
                    n_differ, err = compare_draws(x, kept, u, c1, c2, k, case)
                    frac = n_differ / n
                    max_err = max(max_err, err)
                    worst_frac = max(worst_frac, frac)
                    print(f'K2 {kind:6s} {str(dtype):14s} V={vocab:4d} '
                          f'k={k:4d}: threshold bit-equal to topk_threshold; '
                          f'codes in the kept set; {n_differ} of {n} '
                          f'rows differ from plain, all at a CDF boundary')
    return max_err, worst_frac


def compare_draws(x, kept, u, c1, c2, k, case):
    """The kernel's codes c1 against the plain version's c2 on the scaled
    rows x with the kept set `kept`: k=1 draws an argmax on both; codes
    differ only in rows whose draw lies within 1e-5 of the row's mass from
    the CDF boundary between the two codes, at most 1% of rows. Returns
    (rows differing, max |c1 - c2|)."""
    n = x.shape[0]
    if k == 1:
        rows = torch.arange(n, device=x.device)
        require(torch.equal(x[rows, c1], x.amax(-1)),
                f'K2 k=1 drew no argmax ({case})')
        require(torch.equal(c1, c2), f'K2 k=1 differs from plain ({case})')
    differ = torch.nonzero(c1 != c2).flatten()
    if differ.numel():
        x64 = x[differ].double()
        p = torch.where(kept[differ], torch.exp(
            x64 - x64.amax(-1, keepdim=True)), 0.0)
        cdf = torch.cumsum(p, -1)
        total = cdf[:, -1]
        lo = torch.minimum(c1[differ], c2[differ])
        gap = (u[differ].double() * total -
               cdf.gather(1, lo[:, None])[:, 0]).abs() / total
        require((gap <= 1e-5).all(), f'K2 codes differ away from a CDF '
                f'boundary ({case}): {gap.max().item()}')
    require(differ.numel() <= 0.01 * n,
            f'K2 {differ.numel()} of {n} rows differ ({case})')
    return differ.numel(), (c1 - c2).abs().max().item()


def time_sample_topk(st):
    """bf16 at the main path's two shapes at batch 128, k 2048, T 0.95: the
    bottom-group draw [512, 8192] (the JSON entry) and the top draw
    [128, 8192]. The library yardstick draws from the same top-k softmax
    with the same uniforms and no host wait: topk, softmax, cumsum,
    searchsorted. Returns the bottom-group shape's (kernel, plain, library,
    bound)."""
    k, temp = 2048, 0.95
    out = None
    for n in (4 * B, B):
        g = torch.Generator(device='cuda').manual_seed(3)
        logits = (torch.randn((n, V), generator=g, device='cuda') * 3).to(
            torch.bfloat16)
        u = torch.rand(n, generator=g, device='cuda')
        kernel = time_ms(lambda i: st.sample_topk(logits, u, k, temp), 200)
        plain = time_ms(lambda i: st.sample_topk_plain(logits, u, k, temp), 5)

        def library(i):
            vals, idx = torch.topk(st.scaled_logits(logits, temp), k, dim=-1)
            cdf = torch.softmax(vals, dim=-1).cumsum(dim=-1)
            j = torch.searchsorted(cdf, u[:, None]).clamp_max_(k - 1)
            return idx.gather(1, j)

        lib = time_ms(library, 50)
        # bytes: the logits and u read once, the codes written once
        n_bytes = n * V * 2 + n * 8
        bnd = bound(n_bytes, K2_OPS_PER_LOGIT * n * V)
        print(f'K2 bf16 [{n}, {V}] k {k}: kernel {kernel:.5f} ms, plain '
              f'{plain:.4f} ms, topk+softmax+cumsum+searchsorted {lib:.5f} '
              f'ms, bound {bnd[0]:.5f} ms ({bnd[1]}); the kernel takes '
              f'{kernel / bnd[0]:.2f}x its bound')
        out = out or (kernel, plain, lib, bnd)
    return out


# The 3-level sampler's draws at batch 128: the top [B, V], the mids
# [4B, V] and the bottoms [16B, V], bf16, top-k 2048 at temperature 1.0.
K2_LEVEL3_ROWS = (B, 4 * B, 16 * B)
K2_LEVEL3_K, K2_LEVEL3_TEMP = 2048, 1.0


def check_sample_topk_bisect3(st):
    """K2 with bisect3 (the quartile search) at the 3-level draw shapes:
    random and tied rows in bf16 at every shape, random rows in f32 at the
    mids' shape; k in {1, 2048}, T 1.0, shared uniforms. The threshold
    output equals `replay_threshold(bisect3=True)` (the plain replay of
    the kernel's select, `bisection3_replay`) and `topk_threshold3` (the
    quartile search over the logits) bit for bit; the kept set is the
    exact top-k within [max - 44, max]; codes lie in it and equal the
    plain version's but at CDF boundaries (as check_sample_topk). Returns
    the largest code difference."""
    temp, device = K2_LEVEL3_TEMP, 'cuda'
    max_err = 0
    cases = [(n, kind, torch.bfloat16) for n in K2_LEVEL3_ROWS
             for kind in ('random', 'ties')]
    cases.append((4 * B, 'random', torch.float32))
    for i, (n, kind, dtype) in enumerate(cases):
        logits = k2_rows(kind, n, V, seed=100 + i).to(device, dtype)
        u = torch.rand(n, generator=torch.Generator().manual_seed(i)).to(
            device)
        x = st.scaled_logits(logits, temp)
        row_max = x.amax(-1, keepdim=True)
        rows = torch.arange(n, device=device)
        for k in (1, K2_LEVEL3_K):
            thr_out = torch.empty(n, device=device)
            c1 = st.sample_topk(logits, u, k, temp, threshold=thr_out,
                                bisect3=True).long()
            c2 = st.sample_topk_plain(logits, u, k, temp, bisect3=True).long()
            replay = st.replay_threshold(logits, k, temp, bisect3=True)
            direct = st.topk_threshold3(x, k)
            torch.cuda.synchronize()
            case = f'bisect3 {kind} {dtype} [{n}, {V}] k={k}'
            for name, thr in (('bisection3_replay', replay),
                              ('topk_threshold3', direct)):
                require(torch.equal(thr_out.view(torch.int32),
                                    thr[:, 0].view(torch.int32)),
                        f'K2 threshold differs from {name} ({case})')
            kth = torch.topk(x, k, dim=-1).values[:, -1:]
            kept = x >= torch.maximum(kth, row_max - st.BISECT_RANGE)
            require(torch.equal(kept, x >= thr_out[:, None]),
                    f'K2 kept set differs from top-k ({case})')
            require(kept[rows, c1].all(),
                    f'K2 code outside the kept set ({case})')
            n_differ, err = compare_draws(x, kept, u, c1, c2, k, case)
            max_err = max(max_err, err)
            binary = (st.topk_threshold(x, k)[:, 0] != thr_out).sum().item()
            print(f'K2 {case}: threshold bit-equal to bisection3_replay and '
                  f'topk_threshold3 ({binary} of {n} rows end on other bits '
                  f'than the binary search); codes in the kept set; '
                  f'{n_differ} rows differ from plain, all at a CDF boundary')
    return max_err


def time_sample_topk_level3(st):
    """bf16 K2 at the 3-level draw shapes, k 2048, T 1.0, with the binary
    and the quartile search, beside the plain version (quartile) and the
    library yardstick of time_sample_topk. Returns the mids shape's
    (kernel, plain, library, bound) with bisect3, for the JSON line."""
    k, temp = K2_LEVEL3_K, K2_LEVEL3_TEMP
    out = None
    for n in K2_LEVEL3_ROWS:
        g = torch.Generator(device='cuda').manual_seed(5)
        logits = (torch.randn((n, V), generator=g, device='cuda') * 3).to(
            torch.bfloat16)
        u = torch.rand(n, generator=g, device='cuda')
        ms = {False: [], True: []}
        for b3 in (False, True, True, False):  # in turns
            ms[b3].append(time_ms(lambda i: st.sample_topk(
                logits, u, k, temp, bisect3=b3), 200))
        binary, quartile = (sum(ms[b3]) / 2 for b3 in (False, True))
        plain = time_ms(lambda i: st.sample_topk_plain(
            logits, u, k, temp, bisect3=True), 3)

        def library(i):
            vals, idx = torch.topk(st.scaled_logits(logits, temp), k, dim=-1)
            cdf = torch.softmax(vals, dim=-1).cumsum(dim=-1)
            j = torch.searchsorted(cdf, u[:, None]).clamp_max_(k - 1)
            return idx.gather(1, j)

        lib = time_ms(library, 50)
        bnd = bound(n * V * 2 + n * 8, K2_OPS_PER_LOGIT * n * V)
        print(f'K2 bf16 [{n}, {V}] k {k} T {temp}: binary {binary:.5f} ms, '
              f'bisect3 {quartile:.5f} ms ({quartile / binary:.3f}x), plain '
              f'(bisect3) {plain:.4f} ms, topk+softmax+cumsum+searchsorted '
              f'{lib:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); bisect3 '
              f'takes {quartile / bnd[0]:.2f}x its bound')
        if n == 4 * B:
            out = (quartile, plain, lib, bnd)
    return out


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
    # Every pair runs the wgmma kernel: f32 x f32 over 6 pairs of bf16
    # pieces, a mixed pair over 3, bf16 x bf16 over 1; D = 40 and 200 leave
    # a ragged tail of its 64-column chunks, and the small cases have fewer
    # rows and codes than one of its TMA boxes.
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
              f'({pair_list(vq, z_dtype, e_dtype)}): {n_diff} of {n} '
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
              f'({pair_list(vq, dtype, dtype)}): equal to plain, every '
              f'row on the lowest index of its tie')
    return max_err


def pair_list(vq, z_dtype, e_dtype) -> str:
    """The pairs of bf16 pieces (z, codebook) the kernel sums for a dtype
    pair, e.g. '3 pairs: hi.hi hi.mid hi.lo'."""
    names = ('hi', 'mid', 'lo')
    pairs = vq.piece_pairs(vq.kernel_variant(z_dtype, e_dtype))
    return (f'{len(pairs)} pair{"s" if len(pairs) > 1 else ""}: ' +
            ' '.join(f'{names[p]}.{names[q]}' for p, q in pairs))


def extra_peak_mib(fn) -> float:
    """Device memory one call of fn allocates at its peak beyond what is
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def time_vq_argmin(vq, dtype):
    """z and codebooks in `dtype` at each K3_SHAPES shape: first the
    kernel's codes against the plain version's on these inputs (the
    near-tie rule of compare_codes), then the times. The library yardstick
    is cuBLAS SGEMM (TF32 off) + argmin, which writes the [N, K] f32 score
    matrix; the port never calls it. The bound, in either dtype: the
    function's one pass of 2 N K D operations at the highest tensor-core
    rate the kernel runs on, bf16's (a bf16 x bf16 product is exact in
    f32, so bf16 wgmma with f32 accumulation gives the same scores up to
    summation order; f32 scores need no more than one argmin over them
    either, whatever passes a design spends). The design's own floor, its
    passes at that rate (six in f32), is printed on a line of its own.
    Returns (one (ms, plain, lib, bound, memory) per shape, max f64
    gap)."""
    out, max_err = [], 0.0
    name_dt = str(dtype)[6:]
    passes = len(vq.piece_pairs(vq.kernel_variant(dtype, dtype)))
    for name, N, D in K3_SHAPES:
        g = torch.Generator(device='cuda').manual_seed(N + D)
        z = torch.randn((N, D), generator=g, device='cuda').to(dtype)
        e = torch.randn((N_CODES, D), generator=g, device='cuda').to(dtype)
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = vq.codebook_splits(N, N_CODES, n_sms)
        n_diff, err = compare_codes(z, e, vq.vq_argmin(z, e),
                                    vq.vq_argmin_plain(z, e))
        max_err = max(max_err, err)
        print(f'K3 {name} N={N} D={D} {name_dt} '
              f'({pair_list(vq, dtype, dtype)}), {splits} codebook slices: '
              f'{n_diff} of {N} rows differ from plain, each a near-tie')

        def library(i=0):
            ef = e.float()
            return torch.addmm(ef.square().sum(1), z.float(), ef.T,
                               alpha=-2).argmin(1)

        def kernel(i=0):
            return vq.vq_argmin(z, e)

        ms = time_ms(kernel, 10 if passes == 1 else 5)
        plain = time_ms(lambda i: vq.vq_argmin_plain(z, e), 3)
        lib = time_ms(library, 10)
        mem = (extra_peak_mib(kernel), extra_peak_mib(library))
        # bytes: z and e read once, the codes written once; operations:
        # one multiply and one add per (row, code, dim), at the bf16 rate.
        n_bytes = (N + N_CODES) * D * z.element_size() + N * 8
        flops = 2 * N * N_CODES * D
        bnd = bound(n_bytes, flops, BF16_FLOPS_PER_S)
        out.append((ms, plain, lib, bnd, mem))
        print(f'K3 {name} N={N} K={N_CODES} D={D} {name_dt}: kernel '
              f'{ms:.4f} ms ({passes * flops / ms / 1e9:.1f} TFLOP/s over '
              f'{passes} bf16 pass{"es" if passes > 1 else ""}), plain '
              f'{plain:.4f} ms, addmm+argmin {lib:.4f} ms, bound '
              f'{bnd[0]:.4f} ms ({bnd[1]}, one bf16 pass; kernel '
              f'{ms / bnd[0]:.2f}x); extra peak memory kernel '
              f'{mem[0]:.2f} MiB, addmm+argmin {mem[1]:.1f} MiB')
        if passes > 1:
            floor = bound(n_bytes, passes * flops, BF16_FLOPS_PER_S)[0]
            print(f'K3 {name} {name_dt} design floor: {passes} bf16 passes '
                  f'at the bf16 rate {floor:.4f} ms (kernel '
                  f'{ms / floor:.2f}x); not a bound of the function')
        if passes == 1:
            # Yardstick outside the JSON: cuBLAS's bf16 GEMM alone. It is
            # not the same function (no argmin, and it writes the [N, K]
            # matrix).
            gemm = time_ms(lambda i: torch.matmul(z, e.T), 10)
            print(f'K3 {name} yardstick: bf16 cuBLAS z @ e.T alone '
                  f'{gemm:.4f} ms ({flops / gemm / 1e9:.1f} TFLOP/s); the '
                  f'kernel takes {ms / gemm:.2f}x its time')
        del z, e
    return out, max_err


def flagship_entry(shapes):
    """A K3 entry of the JSON line: the mean of one launch at each of the
    flagship's two levels (the first two K3_SHAPES)."""
    flagship = shapes[:2]
    return tuple(sum(t[i] for t in flagship) / 2 for i in range(3)) + (
        (sum(t[3][0] for t in flagship) / 2, flagship[0][3][1]),)


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


# ------------------------------------------------------- int8max serving

def check_int8_products(q8):
    """The A8W8 products on the card against the CPU on the same int8
    inputs: `_int_mm` at the flagship's fused-QKV and first MLP gemm
    shapes (batch 128 rows), and the int8 convolution at the decoder's
    largest (128 channels at 256^2, 2 images, 3x3). int32 results (and the
    convolution's dequantized output) must be equal."""
    g = torch.Generator(device='cuda').manual_seed(12)
    for M, K, N in ((B, D, 3 * D), (B, D, 4 * D)):
        a = torch.randint(-127, 128, (M, K), generator=g, device='cuda',
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=g, device='cuda',
                          dtype=torch.int8)
        card = q8.int_mm(a, w)
        require(torch.equal(card.cpu(), q8.int_mm(a.cpu(), w.cpu())),
                f'int8 gemm [{M}, {K}] x [{K}, {N}] differs from the CPU')
        print(f'int8 gemm [{M}, {K}] x [{K}, {N}]: int32 result equal to '
              f'the CPU\'s')
    x = torch.randn((2, 128, 256, 256), generator=g, device='cuda').bfloat16()
    w = (torch.randn((128, 128, 3, 3), generator=g, device='cuda') *
         0.03).bfloat16()
    bias = torch.randn(128, generator=g, device='cuda') * 0.1
    scale = q8.scale_from_absmax(q8.absmax(x))
    card = q8.Int8Weight.from_float(w, bias, scale)
    cpu = q8.Int8Weight.from_float(w.cpu(), bias.cpu(), scale.cpu())
    require(torch.equal(card.wq.cpu(), cpu.wq), 'int8 conv weights differ')
    xq = q8.quant_per_tensor(x, scale)
    require(torch.equal(xq.cpu(), q8.quant_per_tensor(x.cpu(), scale.cpu())),
            'int8 quantized activations differ from the CPU')
    cols = torch.nn.functional.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([cols[:, i:i + 256, j:j + 256] for i in range(3)
                      for j in range(3)], dim=-1).reshape(-1, 9 * 128)
    acc = q8.int_mm(cols, card.wq)
    require(torch.equal(acc.cpu(), q8.int_mm(cols.cpu(), cpu.wq)),
            'int8 conv int32 products differ from the CPU')
    y = q8.int8_conv2d(x, card, (3, 3), (1, 1), (1, 1))
    y_cpu = q8.int8_conv2d(x.cpu(), cpu, (3, 3), (1, 1), (1, 1))
    require(torch.equal(y.cpu(), y_cpu), 'int8 conv output differs from '
            'the CPU')
    print('int8 conv [2, 128, 256, 256] 3x3 -> 128: int32 products and '
          'bf16 output equal to the CPU\'s')


def calibrate_int8max(model, weights, params, labels):
    """The three calibrations at the flagship, on one bf16 sampling run's
    codes (the KV calibration and the run share a generator seed, so they
    draw the same codes), then the artifact saved and loaded back; returns
    the loaded scales."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.models.twostage import (load_serving_scales,
                                                         save_serving_scales)
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    n_top, win = model.top_res, model.cell_win
    t0 = time.perf_counter()
    scales = model.calibrate_kv_scales(
        weights, torch.Generator(device='cuda').manual_seed(7), labels,
        params)
    codes_t, codes_b = make_hierarchical_sampler(
        model.stage2, n_top * n_top, params)(
            torch.Generator(device='cuda').manual_seed(7), labels)
    raster = cells_to_raster(codes_b, n_top, win)
    scales.update(model.calibrate_stage2_int8(weights, codes_t,
                                              raster.reshape(B, -1), labels))
    scales.update(model.calibrate_int8_decode(
        weights, codes_t.reshape(-1, n_top, n_top),
        raster.reshape(-1, n_top * win, n_top * win)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    SCALES_PATH.parent.mkdir(parents=True, exist_ok=True)
    save_serving_scales(scales, str(SCALES_PATH))
    loaded = load_serving_scales(str(SCALES_PATH))
    require(sorted(loaded) == sorted(scales) and all(
        torch.equal(loaded[k][n], scales[k][n].cpu())
        for k in scales for n in scales[k]),
        'serving scales changed through the artifact')
    counts = ', '.join(f'{k} {len(v)}' for k, v in sorted(loaded.items()))
    print(f'int8max calibration at batch {B}: {seconds:.2f} s ({counts} '
          f'scales), saved to {SCALES_PATH.relative_to(ROOT)} and loaded '
          f'back bit for bit')
    return loaded


def run_pipelined(model, weights, params, labels, int8, scales, name, da, st,
                  q8, prev=None):
    """Calls of make_pipelined_sampler: a fill call unless `prev` codes
    are given, then steady calls (two at batch 128, one at another batch).
    Checks each call's codes, pixels and launch counts; returns the last
    call's codes."""
    sampler = model.make_pipelined_sampler(params=params, int8=int8,
                                           scales=scales)
    gen = torch.Generator(device='cuda').manual_seed(11)
    n = labels.shape[0]
    res = model.config.dataset.image_resolution
    calls = ('steady',) if prev is not None else ('fill', 'steady', 'steady')
    codes = prev
    int8max = int8.kv_cache
    for kind in calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(da.decode_attention_step, st.sample_topk,
                     q8.int8_matmul, q8.int8_conv2d)
        da.decode_attention_step.int8_launches = 0
        t0 = time.perf_counter()
        codes, pixels = sampler(weights, gen, labels,
                                None if kind == 'fill' else codes)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = (da.decode_attention_step.launches,
                  da.decode_attention_step.int8_launches,
                  st.sample_topk.launches, q8.int8_matmul.launches,
                  q8.int8_conv2d.launches)
        k1_int8 = K1_LAUNCHES if int8max else 0
        require(counts[:3] == (K1_LAUNCHES, k1_int8, K2_LAUNCHES),
                f'{name} launches K1, K1 int8, K2 {counts[:3]}, expected '
                f'{(K1_LAUNCHES, k1_int8, K2_LAUNCHES)}')
        require((counts[3] > 0 and counts[4] > 0) if int8max
                else counts[3:] == (0, 0),
                f'{name} int8 gemms, convs {counts[3:]}')
        require(codes[0].shape == (n, 64) and codes[1].shape == (n, 64, 4),
                f'{name} code shapes')
        for c in codes:
            require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                    f'{name} codes outside [0, {N_CODES})')
        require(pixels.shape == (n, res, res, 3), f'{name} pixel shape '
                f'{tuple(pixels.shape)}')
        require(bool(torch.isfinite(pixels).all()), f'{name} pixels not '
                f'finite')
        require(float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
                f'{name} pixels outside [0, 1]')
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'{name} pipelined {kind} call at batch {n}: {seconds:.3f} s, '
              f'{n / seconds:.2f} samples/s, peak {peak:.2f} GiB, launches K1 '
              f'{counts[0]} (int8 {counts[1]}) K2 {counts[2]}, int8 gemms '
              f'{counts[3]}, int8 convs {counts[4]}')
    return codes


def int8max_breakdown(model, weights, params, labels, int8, scales, codes):
    """The int8max AR loop and the int8 stage-1 decode, each timed alone
    and profiled (as phase 3's breakdown)."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    model.load_weights(weights)
    n_top, win = model.top_res, model.cell_win
    sampler = make_hierarchical_sampler(model.stage2, n_top * n_top, params,
                                        int8, scales)
    gen = torch.Generator(device='cuda').manual_seed(13)
    ct = codes[0].reshape(-1, n_top, n_top)
    cb = cells_to_raster(codes[1], n_top, win).reshape(
        -1, n_top * win, n_top * win)

    @torch.inference_mode()
    def decode():
        with model.stage1.int8_decode(scales['stage1/act_scales']):
            return model.stage1.decode_code(ct, cb)

    profile_phases((('int8max AR loop', lambda: sampler(gen, labels)),
                    ('int8 stage-1 decode', decode)))


def int8max_agreement(model, weights, codes, labels, scales, q8):
    """The bf16 run's codes through the scorer in bf16 and in int8max:
    top-1 agreement of the per-step logits and mean KL(bf16 || int8max)
    per step."""
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_scorer

    model.load_weights(weights)
    n_top = model.top_res * model.top_res
    out = {}
    for name, int8 in (('bf16', q8.Int8Serving()), ('int8max', q8.INT8MAX)):
        out[name] = make_hierarchical_scorer(model.stage2, n_top, int8,
                                             scales)(labels, *codes)
    for i, level in enumerate(('top', 'bottom')):
        a, b = out['bf16'][i].float(), out['int8max'][i].float()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        logp, logq = torch.log_softmax(a, -1), torch.log_softmax(b, -1)
        kl = (logp.exp() * (logp - logq)).sum(-1).mean().item()
        require(bool(torch.isfinite(b).all()), 'int8max logits not finite')
        print(f'int8max vs bf16 scorer, {level} logits {tuple(b.shape)}: '
              f'top-1 agreement {agree:.4f}, mean KL {kl:.3e} (random '
              f'weights)')


def run_int8max(da, st, model, weights):
    """Phase 7: int8max serving at the flagship. Returns K1-int8's check
    error, times and launches per int8max batch."""
    from hqtransformer_tpu_torch.ops import int8 as q8
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    k1_err = check_decode_attention_int8(da)
    k1_times = time_decode_attention_int8(da)
    time_decode_attention_int8_large(da)
    check_int8_products(q8)
    params = SamplingParams(top_k_top=2048, top_k_bot=2048,
                            temperature_top=0.95, temperature_bot=0.95)
    n_classes = model.config.stage2.hparams.n_classes
    labels = torch.arange(B, device='cuda') % n_classes
    scales = calibrate_int8max(model, weights, params, labels)
    int8max, bf16 = q8.INT8MAX, q8.Int8Serving()
    codes8 = run_pipelined(model, weights, params, labels, int8max, scales,
                              'int8max', da, st, q8)
    launches = da.decode_attention_step.int8_launches
    codes16 = run_pipelined(model, weights, params, labels, bf16, None,
                               'bf16', da, st, q8)
    # bench.py's other int8 mode (BENCH_INT8_SPATIAL=0): float spatial gemms
    run_pipelined(model, weights, params, labels,
                  q8.Int8Serving(kv_cache=True, depth_gemms=True,
                                 decode_convs=True), scales,
                  'int8 without spatial gemms', da, st, q8, prev=codes8)
    int8max_breakdown(model, weights, params, labels, int8max, scales,
                      codes8)
    large = torch.arange(B_LARGE, device='cuda') % n_classes
    reps = B_LARGE // B
    for name, int8, sc, codes in (('int8max', int8max, scales, codes8),
                                  ('bf16', bf16, None, codes16)):
        prev = tuple(c.repeat(reps, *(1,) * (c.dim() - 1)) for c in codes)
        run_pipelined(model, weights, params, large, int8, sc, name, da, st,
                      q8, prev=prev)
    int8max_agreement(model, weights, codes16, labels, scales, q8)
    return k1_err, k1_times, launches


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


# ------------------------------------------------------ 3-level sampling

LEVEL3_S2 = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8-level3.yaml'
# One draw a level a position, 12 spatial layers x 63 steps of K1.
K2_LEVEL3_LAUNCHES = 3 * 64


def run_level3_sampling(da, st):
    """The 3-level family at full width: the flagship level-3 config
    (12 layers, d 1536, three 8192-code levels, parallel-add) with seeded
    random bf16 weights, make_pixel_sampler_multilevel at top-k 2048 and
    T 1.0 a level on 128 labels: two calls, then one with bisect3. Codes in
    range, pixels [128, 256, 256, 3] finite in [0, 1], 756 K1 and 192 K2
    launches a call (all bisect3 in the third). Then the AR loop and the
    stage-1 decode broken down. Returns (K2 bisect3 launches of the third
    call, samples/s of the second)."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         serving_bf16_params)

    cfg = build_twostage_config(str(LEVEL3_S2))
    model = TwoStageModel(cfg, dtype=torch.bfloat16)
    require((model.code_levels, model.top_res) == (3, 8),
            f'3-level grid {model.code_levels} levels, top '
            f'{model.top_res}x{model.top_res}')
    weights = {s: serving_bf16_params(w)
               for s, w in model.init_weights(seed=0).items()}
    labels = torch.arange(B, device='cuda') % cfg.stage2.hparams.n_classes
    gen = torch.Generator(device='cuda').manual_seed(1)
    res = cfg.dataset.image_resolution
    knobs = dict(top_k=(K2_LEVEL3_K,) * 3, temperature=(K2_LEVEL3_TEMP,) * 3)
    rates = []
    for call, bisect3 in ((1, False), (2, False), (3, True)):
        sampler = model.make_pixel_sampler_multilevel(bisect3=bisect3,
                                                      **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(da.decode_attention_step, st.sample_topk)
        st.sample_topk.bisect3_launches = 0
        t0 = time.perf_counter()
        pixels, codes = sampler(weights, gen, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (da.decode_attention_step.launches,
                    st.sample_topk.launches, st.sample_topk.bisect3_launches)
        want = (K1_LAUNCHES, K2_LEVEL3_LAUNCHES,
                K2_LEVEL3_LAUNCHES if bisect3 else 0)
        require(launches == want, f'3-level launches K1, K2, K2 bisect3 '
                f'{launches}, expected {want}')
        require([tuple(c.shape) for c in codes] ==
                [(B, 64), (B, 64, 4), (B, 64, 16)],
                f'3-level code shapes {[tuple(c.shape) for c in codes]}')
        for c in codes:
            require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                    f'3-level codes outside [0, {N_CODES})')
        require(pixels.shape == (B, res, res, 3),
                f'3-level pixel shape {pixels.shape}')
        require(bool(torch.isfinite(pixels).all()),
                '3-level pixels not finite')
        require(float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
                '3-level pixels outside [0, 1]')
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates.append(B / seconds)
        print(f'3-level sampling call {call} (bisect3 {bisect3}): '
              f'{seconds:.3f} s, {B / seconds:.2f} samples/s at batch {B}, '
              f'peak {peak:.2f} GiB, launches K1={launches[0]} '
              f'K2={launches[1]} (bisect3 {launches[2]}), pixels '
              f'{tuple(pixels.shape)} {pixels.dtype}')
    level3_breakdown(model, weights, knobs, labels, gen)
    return launches[2], rates[1]


def level3_breakdown(model, weights, knobs, labels, gen):
    """The 3-level batch's AR loop (make_multilevel_sampler) and stage-1
    decode, each timed alone and profiled (as phase 3's breakdown)."""
    from hqtransformer_tpu_torch.models.stage2.multilevel import \
        cells_to_level
    from hqtransformer_tpu_torch.sampling.engine import (
        LevelSampling, make_multilevel_sampler)

    model.load_weights(weights)
    n = model.top_res
    sampler = make_multilevel_sampler(model.stage2, n * n, tuple(
        LevelSampling(top_k=k, temperature=t)
        for k, t in zip(knobs['top_k'], knobs['temperature'])))
    tops, mids, bots = sampler(gen, labels)

    @torch.inference_mode()
    def decode():
        return model.stage1.decode_code(
            [tops.reshape(-1, n, n)] +
            [cells_to_level(c, n, w).reshape(-1, n * w, n * w)
             for c, w in ((mids, 2), (bots, 4))])

    profile_phases((('3-level AR loop', lambda: sampler(gen, labels)),
                    ('3-level stage-1 decode', decode)))


def level3_tiny_config():
    """The flagship level-3 config cut to a tiny size, as the CPU tests
    build it but at d 128 (head dim 32, the least K1 takes): 2 spatial
    layers, 4 heads, a 4x4 top, vocabularies (32, 48, 64), the 3-level
    HQ-VAE at 64^2."""
    from hqtransformer_tpu_torch.config import build_twostage_config

    cfg = build_twostage_config(str(LEVEL3_S2))
    cfg.dataset.image_resolution = 64
    s1, s2 = cfg.stage1, cfg.stage2
    s1.hparams.resolution, s1.hparams.ch, s1.hparams.ch_mult = 64, 32, [1, 2]
    s1.hparams.z_channels, s1.hparams.attn_resolutions = 64, [16]
    s1.embed_dim, s1.n_embed, s1.n_embed_levels = 64, 64, [32, 48, 64]
    s2.vocab_sizes_img, s2.vocab_size_img = [32, 48, 64], 64
    hp = s2.hparams
    hp.embed_dim, hp.n_layers, hp.n_heads = 128, 2, 4
    hp.n_classes, hp.ctx_len_img = 10, 16
    return cfg


def check_level3_reference(st):
    """Tiny 3-level config, f32, greedy (top-k 1 at every level, and once
    with bisect3): the CUDA path's codes equal the CPU plain path's with
    the same weights, pixels within 1e-3."""
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel

    cfg = level3_tiny_config()
    labels = torch.arange(8) % cfg.stage2.hparams.n_classes
    cpu = TwoStageModel(cfg, device='cpu')
    weights = cpu.init_weights(seed=4)
    gpu = TwoStageModel(cfg, device='cuda')
    w_gpu = {s: {k: v.cuda() for k, v in w.items()}
             for s, w in weights.items()}
    for bisect3 in (False, True):
        knobs = dict(top_k=(1, 1, 1), bisect3=bisect3)
        ref_px, ref = cpu.make_pixel_sampler_multilevel(**knobs)(
            weights, torch.Generator().manual_seed(0), labels)
        st.sample_topk.launches = 0
        px, codes = gpu.make_pixel_sampler_multilevel(**knobs)(
            w_gpu, torch.Generator(device='cuda').manual_seed(0),
            labels.cuda())
        torch.cuda.synchronize()
        require(st.sample_topk.launches == 3 * 16,
                f'tiny 3-level sampler launched K2 '
                f'{st.sample_topk.launches} times')
        require(all(torch.equal(c.cpu(), r) for c, r in zip(codes, ref)),
                f'tiny 3-level greedy codes differ between the CUDA and the '
                f'CPU path (bisect3 {bisect3})')
        err = (px.cpu() - ref_px).abs().max().item()
        require(err <= 1e-3, f'tiny 3-level greedy pixels differ by {err}')
        print(f'tiny 3-level greedy reference (bisect3 {bisect3}): codes '
              f'equal to the CPU plain path, max|pixels - cpu| = {err:.2e}')


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


def run_encode_f32(vq, da, st):
    """make_reconstructor on the flagship stage-1 HQ-VAE at its default
    f32, as eval_stage1.py runs it (seeded random f32 weights, TF32 off),
    128 images, twice: 2 K3 launches a call, each on the f32 x f32 route.
    Returns the second call's K3 launches and images/s."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)

    cfg = build_twostage_config(str(FLAGSHIP)).stage1
    res = cfg.hparams.resolution
    weights = init_stage1_weights(cfg, seed=4)
    images = seeded_images(B, res, seed=8)
    recon = make_reconstructor(cfg)
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
        require(launches == (2, 0, 0), f'f32 encode launches K3, K1, K2 '
                f'{launches}, expected (2, 0, 0)')
        check_reconstruction(pixels, levels, B, res, (8, 16))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'f32 encode slice call {call}: {seconds:.3f} s, '
              f'{B / seconds:.2f} images/s at batch {B}, peak {peak:.2f} GiB, '
              f'launches K3={launches[0]} '
              f'({pair_list(vq, torch.float32, torch.float32)}), '
              f'pixels {tuple(pixels.shape)} {pixels.dtype}')
    return launches[0], B / seconds


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


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description='Smoke test of the PyTorch/CUDA port on one GPU; with '
        'no arguments, every phase and the result line.')
    ap.add_argument('--k1-only', action='store_true',
                    help='build the kernels, run the K1 checks, timings and '
                    'sweep, and stop (no result line)')
    return ap.parse_args(argv)


def run_k1_only(da):
    """The K1 checks and timings of phases 2 and 7 and the sweep."""
    check_decode_attention(da)
    check_decode_attention_int8(da)
    time_decode_attention(da)
    time_decode_attention_int8(da)
    time_decode_attention_int8_large(da)
    sweep_decode_attention(da)
    print('chip_smoke --k1-only: every K1 check passed')
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
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
    print_sass_conversions(cuda_build.library_path('decode_attention'),
                           'decode_attention')
    if args.k1_only:
        return run_k1_only(da)

    k1_err = check_decode_attention(da)
    k2_err, k2_frac = check_sample_topk(st)
    k3_err = check_vq_argmin(vq)
    k1_times = time_decode_attention(da)
    sweep_decode_attention(da)
    k2_times = time_sample_topk(st)
    k2b_err = check_sample_topk_bisect3(st)
    k2b_times = time_sample_topk_level3(st)
    k3_shapes, k3_served_err = time_vq_argmin(vq, torch.bfloat16)
    k3f_shapes, k3f_served_err = time_vq_argmin(vq, torch.float32)
    launches, samples_per_s, model, weights = run_main_path(da, st)
    k1i_err, k1i_times, k1i_launches = run_int8max(da, st, model, weights)
    k3_launches, images_per_s = run_encode_slice(vq, da, st,
                                                 weights['stage1'])
    run_twostage_encode(vq, da, st, model, weights)
    del model, weights
    torch.cuda.empty_cache()
    k2b_launches, level3_samples_per_s = run_level3_sampling(da, st)
    torch.cuda.empty_cache()
    run_level3(vq, da, st)
    k3f_launches, f32_images_per_s = run_encode_f32(vq, da, st)
    check_small_reference(vq)
    check_level3_reference(st)

    kernels = []
    source = 'hqtransformer_tpu_torch/csrc/'
    for name, src, replaces, n, err, (ms, plain, lib, (bnd, by)) in (
            ('decode_attention', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', launches[0],
             k1_err, k1_times),
            ('decode_attention_int8', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', k1i_launches,
             k1i_err, k1i_times),
            ('sample_topk', source + 'sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236', launches[1],
             k2_err, k2_times),
            ('sample_topk_bisect3', source + 'sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236 (bisect3)',
             k2b_launches, k2b_err, k2b_times),
            ('vq_argmin', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3_launches,
             max(k3_err, k3_served_err), flagship_entry(k3_shapes)),
            ('vq_argmin_f32', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3f_launches,
             max(k3_err, k3f_served_err), flagship_entry(k3f_shapes))):
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': n,
                        'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                        'plain_ms': plain, 'bound_ms': bnd, 'bound_by': by,
                        'library_ms': lib})
    print(f'K2 rows differing from plain at most {k2_frac:.4f}; main path '
          f'{samples_per_s:.2f} samples/s at batch {B}; 3-level sampling '
          f'{level3_samples_per_s:.2f} samples/s at batch {B}; encode slice '
          f'{images_per_s:.2f} images/s at batch {B} in bf16, '
          f'{f32_images_per_s:.2f} in f32')
    print(json.dumps({'kernels': kernels}))
    print(f'nvidia-smi: {nvidia_smi()}')
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
