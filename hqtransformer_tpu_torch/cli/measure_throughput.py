"""Sampling throughput of the port, in ms a sample: the AR loop alone, the
whole sampler (AR loop and stage-1 decode), and the decode as their
difference.

    python -m hqtransformer_tpu_torch.cli.measure_throughput \
        model_path=<config.yaml> batch_size=50 n_loop=6 [device=cpu]

The port's counterpart of the JAX package's root `measure_throughput.py`,
run in a process of its own, with its key=value arguments and defaults:
`model_path` (a config; the weights are seeded random, as throughput does
not depend on them), `batch_size`, `n_loop` loops of about
`samples_per_loop` samples, the first `warmup` discarded, `top_resolution`,
`code_levels` (2 or 3), `dtype`, `cond` (cls or txt: all-zero class ids or
caption ids), `serving`:
- `bf16`: the bf16 serving weights (`serving_bf16_params`) and caches;
- `int8`: an int8 KV cache and A8W8 decode convolutions;
- `int8max`: every int8 switch (`INT8MAX`);
and, for the int8 modes, the calibration split: `scales_out=<file>`
calibrates (KV scales from one sampling run, decode scales from a bf16
call's codes, stage-2 scales from the forward on 64 of them, 32 for three
levels), writes the JAX package's artifact and exits; `scales_in=<file>`
reads one (written here or by the JAX script) and calibrates nothing;
with neither, it calibrates in the measuring process. `profile=<dir>`
writes a `torch.profiler` Chrome trace of one AR loop and one whole call
there (`ar_trace.json`, `e2e_trace.json`), where the JAX script writes a
`jax.profiler` trace. Each trace also holds the program's spans of that
call (`utils/tracing.py`: `sample`, `ar.spatial`, `ar.depth`, `ar.draw`,
`decode`) as a process row of their own, `program spans`, on the trace's
time base, so a gap on the device's rows lines up with the layer the host
was in.

Each loop's ms a sample is printed as it ends; the last line gives the
means over the kept loops. Times are the host clock around work that ends
in a device synchronisation. The card's name and power limit from
`nvidia-smi` are printed beside them. `device` defaults to cuda; `cpu`
runs the kernels' plain versions (a rehearsal, not a device measurement).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import torch

from ..config import build_twostage_config
from ..models.stage2.hierarchical import cells_to_raster
from ..models.stage2.multilevel import cells_to_level
from ..models.twostage import (TwoStageModel, load_serving_scales,
                               save_serving_scales, serving_bf16_params)
from ..ops.int8 import INT8MAX, Int8Serving
from ..sampling.engine import (SamplingParams, make_hierarchical_sampler,
                               make_multilevel_sampler)
from ..utils import tracing

SERVING = {'bf16': Int8Serving(),
           'int8': Int8Serving(kv_cache=True, decode_convs=True),
           'int8max': INT8MAX}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def parse_kv_args(argv: List[str]) -> Dict:
    cfg = dict(model_path='', batch_size=50, n_loop=6, warmup=1,
               top_resolution=8, code_levels=2, dtype='bfloat16',
               cond='cls', samples_per_loop=1000, serving='bf16',
               scales_out='', scales_in='', profile='', device='cuda')
    for a in argv:
        k, v = a.split('=', 1)
        if k not in cfg:
            raise SystemExit(f'unknown argument {k!r}; known: '
                             f'{", ".join(cfg)}')
        cfg[k] = type(cfg[k])(v)
    if cfg['serving'] not in SERVING:
        raise SystemExit(f'serving={cfg["serving"]}: one of '
                         f'{", ".join(SERVING)}')
    return cfg


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    ran instead of a card."""
    if device.type != 'cuda':
        return f'device: {device} (no card: not a device measurement)'
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return f'nvidia-smi: {out.stdout.strip().splitlines()[0]}'


def calibrate(a, model, weights, labels, n_top):
    """The scales of `a['serving']`, as the JAX script's `_calibrate_int8`
    makes them: KV scales from one float sampling run on `labels`, decode
    scales from a bf16 pixel-sampler call's codes in 128-sample chunks,
    and for int8max the stage-2 scales from the teacher-forced forward on
    its first 64 samples (32 at three levels)."""
    t0 = time.perf_counter()

    def mark(stage):
        print(f'[cal +{time.perf_counter() - t0:.0f}s] {stage}', flush=True)

    dev = model.device
    scales = model.calibrate_kv_scales(
        weights, torch.Generator(device=dev).manual_seed(2), labels,
        max_seq_len=n_top)
    mark('kv scales done')
    tr = model.top_res
    gen = torch.Generator(device=dev).manual_seed(3)
    if a['code_levels'] == 2:
        _, (ct, cb) = model.make_pixel_sampler(max_seq_len=n_top)(
            weights, gen, labels)
        mark('calibration sampler done')
        r = tr * model.cell_win
        raster = cells_to_raster(cb, tr, model.cell_win)
        scales.update(model.calibrate_int8_decode(
            weights, ct.reshape(-1, tr, tr), raster.reshape(-1, r, r)))
        nc = min(64, ct.shape[0])
        forward = (ct[:nc], raster[:nc].reshape(nc, -1), labels[:nc])
    else:
        _, (tops, mids, bots) = model.make_pixel_sampler_multilevel(
            max_seq_len=n_top)(weights, gen, labels)
        mark('calibration sampler done')
        maps = [tops, cells_to_level(mids, tr, 2), cells_to_level(bots, tr, 4)]
        scales.update(model.calibrate_int8_decode(weights, [
            m.reshape(-1, tr * w, tr * w) for m, w in zip(maps, (1, 2, 4))]))
        nc = min(32, tops.shape[0])
        forward = ([m[:nc].reshape(nc, -1) for m in maps], labels[:nc])
    mark('decode scales done')
    if a['serving'] == 'int8max':
        scales.update(model.calibrate_stage2_int8(weights, *forward))
        mark('stage2 gemm scales done')
    return scales


def main(argv=None) -> int:
    a = parse_kv_args(sys.argv[1:] if argv is None else argv)
    cfg = build_twostage_config(a['model_path'])
    dtype = DTYPES[a['dtype']]
    model = TwoStageModel(cfg, dtype=dtype, device=a['device'])
    weights = model.init_weights(seed=0)
    if dtype == torch.bfloat16:
        weights = {s: serving_bf16_params(w) for s, w in weights.items()}
    model.load_weights(weights)
    dev = model.device

    n2 = sum(t.numel() for t in weights['stage2'].values())
    print(f'bs{a["batch_size"]}, sampling loops '
          f'{a["warmup"] + 1}-{a["n_loop"]}')
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'device {dev}'
          + (f' ({torch.cuda.get_device_name(dev)})'
             if dev.type == 'cuda' else ''))
    print(card_line(dev))
    print(f'transformer size: {n2 / 1e6:.1f}M')

    bs = a['batch_size']
    n_iter = (a['samples_per_loop'] + bs - 1) // bs
    n_top = a['top_resolution'] ** 2
    if a['cond'] == 'txt':
        def make_labels(n):
            return torch.zeros((n, cfg.stage2.hparams.ctx_len_txt),
                               dtype=torch.long, device=dev)
    else:
        def make_labels(n):
            return torch.zeros((n,), dtype=torch.long, device=dev)

    int8, scales = SERVING[a['serving']], None
    if a['serving'] != 'bf16':
        if dtype != torch.bfloat16:
            raise SystemExit(f'serving={a["serving"]} needs dtype=bfloat16')
        if a['scales_in']:
            scales = load_serving_scales(a['scales_in'])
        else:
            scales = calibrate(a, model, weights, make_labels(min(bs, 256)),
                               n_top)
            if a['scales_out']:
                save_serving_scales(scales, a['scales_out'])
                print(f'wrote serving scales: {a["scales_out"]}')
                return 0

    if a['code_levels'] == 2:
        ar = make_hierarchical_sampler(model.stage2, n_top, SamplingParams(),
                                       int8, scales)
        e2e = model.make_pixel_sampler(max_seq_len=n_top, int8=int8,
                                       scales=scales)
    else:
        ar = make_multilevel_sampler(model.stage2, n_top, int8=int8,
                                     scales=scales)
        e2e = model.make_pixel_sampler_multilevel(max_seq_len=n_top,
                                                  int8=int8, scales=scales)
    labels = make_labels(bs)
    gen = torch.Generator(device=dev).manual_seed(1)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def run_ar():
        model.load_weights(weights)
        ar(gen, labels)
        sync()

    def run_e2e():
        e2e(weights, gen, labels)
        sync()

    def timed_loops(run, label):
        ts = []
        print('-' * 80)
        for loop_idx in range(a['n_loop']):
            t = 0.0
            for _ in range(n_iter):
                t0 = time.perf_counter()
                run()
                t += time.perf_counter() - t0
            per = t / (n_iter * bs) * 1000
            print(f'{loop_idx + 1}/{a["n_loop"]} | {label}: '
                  f'{per:.3f} ms/sample', flush=True)
            if loop_idx >= a['warmup']:
                ts.append(per)
        return ts

    def profiled(run, name):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
        os.makedirs(a['profile'], exist_ok=True)
        t0 = time.time_ns()
        with profile(activities=activities) as prof:
            run()
        spans = [r for r in tracing.spans() if r.start_ns >= t0]
        path = os.path.join(a['profile'], f'{name}_trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace['traceEvents'] += tracing.chrome_events(
            spans, trace.get('baseTimeNanoseconds', 0))
        with open(path, 'w') as f:
            json.dump(trace, f)
        print(f'profiler trace written to {path} ({len(spans)} program '
              f'spans)')

    run_ar()    # warm-up: allocations and the kernels' first launches
    if a['profile']:
        profiled(run_ar, 'ar')
    speeds_ar = timed_loops(run_ar, 'ar')
    run_e2e()
    if a['profile']:
        profiled(run_e2e, 'e2e')
    speeds = timed_loops(run_e2e, 'e2e')

    speeds_decode = [max(0.0, e - r) for e, r in zip(speeds, speeds_ar)]
    n = len(speeds)
    print('-' * 80)
    print(f'bs{bs} | {sum(speeds) / n:.4f} ms/sample '
          f'(ar: {sum(speeds_ar) / n:.4f}, '
          f'decode: {sum(speeds_decode) / n:.4f}) | {card_line(dev)}')
    print('=' * 80)
    return 0


if __name__ == '__main__':
    sys.exit(main())
