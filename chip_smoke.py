#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hqtransformer_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Device: prints the card, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions; builds every CUDA kernel from
   hqtransformer_tpu_torch/csrc (one nvcc each, all at once) and prints the
   build time and ptxas report.
2. Kernels against their plain PyTorch versions at the flagship shapes
   (TF32 off for matmuls and convolutions):
   - decode attention, L=12 T=64 B=128 D=1536 24 heads, f32 and bf16,
     pos in {0, 1, 7, 8, 33, 63}: caches bit-equal, y allclose at
     1e-5 (f32) / 2e-2 (bf16);
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
4. A reference on a small input: the tiny config, f32, greedy (top-k 1),
   sampled through the CUDA kernels and through the CPU plain versions with
   the same weights: equal codes, pixels within 1e-3.

Prints one JSON line of per-kernel numbers, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises, so the script exits
non-zero without that line; so it does without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
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

# K1 at the flagship main path: 12 layers, 64 cache rows, batch 128,
# d=1536, 24 heads; 12 launches per spatial step x 63 steps.
L, T, B, D, NH = 12, 64, 128, 1536, 24
K1_LAUNCHES = L * 63
# K2: one top draw [B, V] and one bottom-group draw [4B, V] per position.
V = 8192
K2_LAUNCHES = 2 * 64
TIMED_POS = 33


def require(ok, message) -> None:
    """A check of the run (unlike `assert`, kept under python -O)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {message}')


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------- K1 decode attention

def check_decode_attention(da):
    max_err = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for pos in (0, 1, 7, 8, 33, 63):
            g = torch.Generator(device='cuda').manual_seed(pos)

            def randn(*shape):
                return torch.randn(shape, generator=g,
                                   device='cuda').to(dtype)

            kc, vc = randn(L, T, B, D), randn(L, T, B, D)
            q, kn, vn = randn(B, D), randn(B, D), randn(B, D)
            layer = pos % L
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc, vc
            y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer, pos, NH)
            y2 = da.decode_attention_step_plain(q, kn, vn, kc2, vc2, layer,
                                                pos, NH)
            torch.cuda.synchronize()
            require(torch.equal(kc1, kc2) and torch.equal(vc1, vc2),
                    f'K1 cache rows differ ({dtype}, pos {pos})')
            err = (y1.float() - y2.float()).abs().max().item()
            torch.testing.assert_close(y1.float(), y2.float(), atol=tol,
                                       rtol=tol)
            max_err[dtype] = max(max_err.get(dtype, 0.0), err)
            print(f'K1 {str(dtype):14s} pos={pos:2d}: caches bit-equal, '
                  f'max|y - plain| = {err:.3e} (tol {tol})')
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
    return launches, B / seconds


def breakdown(model, weights, params, labels, gen):
    """Where one batch's time goes: the AR loop (stage 2) and the stage-1
    decode, each timed alone on the host clock, then run once more under
    torch.profiler for the device's busy time and its largest kernels."""
    from torch.profiler import ProfilerActivity, profile
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

    for name, fn in (('AR loop', lambda: sampler(gen, labels)),
                     ('stage-1 decode', decode)):
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
        busy_ms = sum(us for _, us in per_kernel.values()) / 1e3
        print(f'breakdown {name}: {wall_ms:.1f} ms wall; device busy '
              f'{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}) in '
              f'{sum(n for n, _ in per_kernel.values())} kernel runs')
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
        for kname, (n, us) in top:
            print(f'  {us / 1e3:8.2f} ms {n:6d}x  {kname[:90]}')


def check_small_reference():
    """Tiny config, f32, greedy: the CUDA path against the CPU plain path
    with the same weights."""
    from hqtransformer_tpu_torch.config import build_twostage_config
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
    px, (ct, cb) = gpu.make_pixel_sampler(params=greedy)(
        {s: {k: v.cuda() for k, v in w.items()} for s, w in weights.items()},
        torch.Generator(device='cuda').manual_seed(0), labels.cuda())
    require(torch.equal(ct.cpu(), ref_t) and torch.equal(cb.cpu(), ref_b),
            'tiny greedy codes differ between the CUDA and the CPU path')
    err = (px.cpu() - ref_px).abs().max().item()
    require(err <= 1e-3, f'tiny greedy pixels differ by {err}')
    print(f'tiny greedy reference: codes equal to the CPU plain path, '
          f'max|pixels - cpu| = {err:.2e}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hqtransformer_tpu_torch.ops import cuda_build
    from hqtransformer_tpu_torch.ops import decode_attention as da
    from hqtransformer_tpu_torch.ops import sample_topk as st

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
        regs = [line.split('Used ')[1].split(',')[0]
                for line in text.splitlines() if 'registers' in line]
        spills = sum(' 0 bytes spill stores' not in line
                     for line in text.splitlines() if 'spill stores' in line)
        print(f'  {name}: {len(regs)} instantiations, registers '
              f'{", ".join(regs)}; {spills} with spills')

    k1_err = check_decode_attention(da)
    k2_err, k2_frac = check_sample_topk(st)
    k1_times = time_decode_attention(da)
    k2_times = time_sample_topk(st)
    launches, samples_per_s = run_main_path(da, st)
    check_small_reference()

    kernels = []
    for name, src, replaces, n, err, (ms, plain, lib, (bnd, by)) in (
            ('decode_attention', 'hqtransformer_tpu_torch/csrc/'
             'decode_attention.cu', 'hqtransformer_tpu/ops/'
             'pallas_attention.py:200', launches[0], k1_err, k1_times),
            ('sample_topk', 'hqtransformer_tpu_torch/csrc/sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236', launches[1],
             k2_err, k2_times)):
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': n,
                        'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                        'plain_ms': plain, 'bound_ms': bnd, 'bound_by': by,
                        'library_ms': lib})
    print(f'K2 rows differing from plain at most {k2_frac:.4f}; main path '
          f'{samples_per_s:.2f} samples/s at batch {B}')
    print(json.dumps({'kernels': kernels}))
    print(f'nvidia-smi: {nvidia_smi()}')
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
