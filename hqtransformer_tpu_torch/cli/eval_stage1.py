"""Stage-1 reconstruction evaluation: MSE, per-level code usage and rFID.

    python -m hqtransformer_tpu_torch.cli.eval_stage1 -c <stage-1 yaml> \
        -m <reference .ckpt> --data-root <ImageFolder root> \
        [--fid --inception-weights pt_inception-2015-12-05.pth] \
        [--code-usage] [--top-only] [--batch-size 16] [--device cpu]

The port's counterpart of the JAX package's root `eval_stage1.py`, with
its arguments and lines: the validation split (`<data-root>/val/<class>/`
for ImageNet) goes through the port's loader (center crop, batches of
`--batch-size`, the last partial batch dropped), is reconstructed in f32
(one nearest-code search, K3, per code level and batch; again under
`--top-only`), and the script prints `MSE: ... over N images`, `MSE
(top-only recon): ...`, `level i: ...% of K codes used` and `rFID: ...`.

`-m` is a reference checkpoint whose keys are `stage1.`-prefixed (a
two-stage model), `generator.`-prefixed (a stage-1 trainer's; its other
entries are left out) or bare; without it the weights are seeded random
ones. Without `--inception-weights` (or FID_INCEPTION_WEIGHTS) the rFID
uses seeded random Inception weights and means nothing next to published
numbers.

Differences from the JAX script: it runs on the card unless `--device
cpu`; Orbax directories are refused (reference checkpoints only); a
VQGAN's one code map is one level (the JAX script counts one "level" an
image there).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import torch

from ..checkpoint import check_reference_path, load_torch_checkpoint
from ..config import build_stage1_config
from ..data.datasets import DataLoader, LoaderConfig, build_dataset
from ..device import resolve_device
from ..evaluation.fid import InceptionExtractor
from ..evaluation.stage1 import (ReconstructionMetrics, init_stage1_weights,
                                 make_reconstructor)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-c', '--config-path', type=str, required=True)
    ap.add_argument('-m', '--model-path', type=str, default=None)
    ap.add_argument('--data-root', type=str, required=True)
    ap.add_argument('--batch-size', type=int, default=16)
    ap.add_argument('--max-batches', type=int, default=None)
    ap.add_argument('--fid', action='store_true')
    ap.add_argument('--code-usage', action='store_true')
    ap.add_argument('--top-only', action='store_true',
                    help='also evaluate top-code-only reconstructions')
    ap.add_argument('--inception-weights', type=str,
                    default=os.environ.get('FID_INCEPTION_WEIGHTS'))
    ap.add_argument('--device', type=str, default=None,
                    help='torch device (default: cuda; cpu runs the '
                         'kernels\' plain versions)')
    return ap.parse_args(argv)


def stage1_state(path: str):
    """The generator's state dict in a reference checkpoint: its
    `stage1.` entries, else its `generator.` entries, else all of it,
    without BatchNorm counters."""
    sd = load_torch_checkpoint(check_reference_path(path))
    for prefix in ('stage1.', 'generator.'):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
            break
    return {k: v for k, v in sd.items()
            if not k.endswith('num_batches_tracked')}


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = build_stage1_config(args.config_path)
    if args.model_path:
        weights = {k: v.to(device) for k, v in
                   stage1_state(args.model_path).items()}
        print(f'{args.model_path} successfully restored..')
    else:
        weights = init_stage1_weights(cfg.stage1, seed=0, device=device)

    ds = build_dataset(cfg.dataset.dataset or 'imagenet', args.data_root,
                       'val')
    loader = DataLoader(ds, LoaderConfig(
        batch_size=args.batch_size, resolution=cfg.dataset.image_resolution,
        train=False))
    print(loader)
    recon = make_reconstructor(cfg.stage1, torch.float32, device)
    recon_top = (make_reconstructor(cfg.stage1, torch.float32, device,
                                    top_only=True)
                 if args.top_only else None)
    extractor = (InceptionExtractor(args.inception_weights, args.batch_size,
                                    device) if args.fid else None)
    metrics = ReconstructionMetrics(cfg.stage1.n_embed, extractor)

    t_start = time.perf_counter()
    t_load = t_model = 0.0
    batches = iter(loader)
    for bi in itertools.count():
        t0 = time.perf_counter()
        x_np = next(batches, (None,))[0]
        t1 = time.perf_counter()
        t_load += t1 - t0
        if x_np is None:
            break
        x = torch.from_numpy(x_np).to(device)
        dec, codes = recon(weights, x)
        top = recon_top(weights, x)[0] if recon_top is not None else None
        metrics.update(x, dec, codes if args.code_usage else [], top)
        t_model += time.perf_counter() - t1
        if args.max_batches and bi + 1 >= args.max_batches:
            break

    n = metrics.n_images
    print(f'MSE: {metrics.mse:.6f} over {n} images')
    if args.top_only:
        print(f'MSE (top-only recon): {metrics.mse_top:.6f}')
    if args.code_usage:
        for li, frac in enumerate(metrics.code_usage()):
            print(f'level {li}: {frac * 100:.2f}% of '
                  f'{cfg.stage1.n_embed} codes used')
    t0 = time.perf_counter()
    if extractor is not None:
        print(f'rFID: {metrics.rfid():.4f}')
    t_fid = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    print(f'{n} images in {seconds:.2f} s ({n / seconds:.2f} images/s, data '
          f'included) on {device}: loader {t_load:.2f} s, reconstruction '
          f'and features {t_model:.2f} s, rFID {t_fid:.2f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
