"""Class-conditional (or unconditional) sample generation, to the files the
reference's evaluation reads.

    python -m hqtransformer_tpu_torch.cli.sampling_hqmodel -r <out dir> \
        -m <reference .ckpt> [-c <config.yaml>] [--device cpu]

The port's counterpart of the JAX package's root `sampling_hqmodel.py`,
with its arguments: `--total-samples / --num-classes` samples a class, in
batches of `--batch-size`, each written as `samples_(<class + 1>_<batch
index>).pkl` (a pickled f32 [B, 3, H, W] array in [0, 1]) and
`targets_(<class + 1>_<batch index>).npz` (`targets`, int64 [B]). 2-level
models sample with top-k and top-p at both levels; `--code-level 3`
models at all three; level i's temperature is `--temperature *
--temperature-decay ** i`; a `--top-p` of 1 means none.

Differences from the JAX script:
- it runs on the card unless `--device cpu` asks for the CPU;
- its draws come from one `torch.Generator` seeded by `--seed`: the JAX
  script's key stream cannot be reproduced, so the samples differ
  (with `--top-k 1` every draw is the argmax, and the two scripts agree);
- `-m` takes the reference's PyTorch checkpoints only (`.ckpt`, `.pth`,
  `.pt`), not the JAX package's Orbax directories;
- `--attention` is accepted and ignored: the port has one cache layout
  (the packed cache of the decode attention kernel).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..sampling.engine import SamplingParams
from .common import add_model_args, find_config, load_model, save_pickle


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_model_args(ap)
    ap.add_argument('-c', '--config', type=str, default=None,
                    help='model config yaml (defaults to <model-path '
                         'dir>/config.yaml)')
    ap.add_argument('--top-k', type=int, default=2048)
    ap.add_argument('--top-p', type=float, default=1.0)
    ap.add_argument('--temperature', type=float, default=1.0)
    ap.add_argument('--temperature-decay', type=float, default=1.0)
    ap.add_argument('--batch-size', type=int, default=50)
    ap.add_argument('--code-level', type=int, default=2)
    ap.add_argument('--top-resolution', type=int, default=8)
    ap.add_argument('--bot-resolution', type=int, default=16)
    ap.add_argument('--num-classes', type=int, default=1000)
    ap.add_argument('--total-samples', type=int, default=50000)
    ap.add_argument('--attention', choices=['auto', 'packed', 'einsum'],
                    default='auto',
                    help='accepted for the JAX script\'s command lines and '
                         'ignored: the port has one cache layout')
    return ap.parse_args(argv)


def make_sampler(model, args):
    """fn(weights, generator, labels) -> (pixels [B, H, W, 3], codes) with
    the arguments' knobs, at 2 or 3 code levels."""
    temps = [args.temperature * args.temperature_decay ** i
             for i in range(args.code_level)]
    top_p = args.top_p if args.top_p and args.top_p < 1.0 else None
    if args.code_level == 2:
        return model.make_pixel_sampler(params=SamplingParams(
            top_k_top=args.top_k, top_p_top=top_p, top_k_bot=args.top_k,
            top_p_bot=top_p, temperature_top=temps[0],
            temperature_bot=temps[1]))
    return model.make_pixel_sampler_multilevel(
        top_k=(args.top_k,) * 3, top_p=(top_p,) * 3,
        temperature=tuple(temps))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.attention != 'auto':
        print(f'--attention {args.attention}: ignored (the port has one '
              f'cache layout)')
    os.makedirs(args.result_path, exist_ok=True)
    model, weights = load_model(args, find_config(args.config,
                                                  args.model_path))
    sampler = make_sampler(model, args)
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    per_class = args.total_samples // args.num_classes
    n_batches = max(1, per_class // args.batch_size)

    t_start, n_done = time.time(), 0
    for cls_idx in range(args.num_classes):
        for bi in range(n_batches):
            labels = torch.full((args.batch_size,), cls_idx,
                                dtype=torch.long, device=model.device)
            pixels, _ = sampler(weights, generator, labels)
            arr = pixels.float().cpu().numpy().transpose(0, 3, 1, 2)
            name = f'({cls_idx + 1}_{bi})'
            save_pickle(os.path.join(args.result_path,
                                     f'samples_{name}.pkl'), arr)
            np.savez(os.path.join(args.result_path, f'targets_{name}.npz'),
                     targets=np.full((args.batch_size,), cls_idx, np.int64))
            n_done += args.batch_size
        speed = (time.time() - t_start) / n_done * 1000
        print(f'class {cls_idx + 1}/{args.num_classes}: {speed:.2f} '
              f'ms/sample', flush=True)
    print(f'done: {n_done} samples -> {args.result_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
