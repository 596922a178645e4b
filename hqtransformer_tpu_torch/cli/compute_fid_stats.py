"""Reference FID statistics (an npz of mu and sigma, and with
`--save-acts` the per-image features for PRDC) of a dataset folder.

    python -m hqtransformer_tpu_torch.cli.compute_fid_stats -d imagenet \
        --data-root /data --split val \
        --inception-weights pt_inception-2015-12-05.pth \
        -o stats/imagenet_256_val.npz [--max-samples 50000] [--save-acts]

The port's counterpart of the JAX package's
`scripts/compute_fid_stats.py`, with its arguments and npz, which
`cli.eval_hqmodel --ref-stat-path` (and, with `--save-acts`,
`--ref-feature-path`) reads. It runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..data.datasets import build_dataset
from ..device import resolve_device
from ..evaluation.fid import compute_statistics_from_dataset, make_extractor


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-d', '--dataset', type=str, default='imagenet')
    ap.add_argument('--data-root', type=str, required=True)
    ap.add_argument('--split', type=str, default='val')
    ap.add_argument('-o', '--out', type=str, required=True)
    ap.add_argument('--resolution', type=int, default=256)
    ap.add_argument('--max-samples', type=int, default=None)
    ap.add_argument('--batch-size', type=int, default=100)
    ap.add_argument('--save-acts', action='store_true',
                    help='also store per-image activations (for PRDC)')
    ap.add_argument('--inception-weights', type=str, default=None,
                    help='pt_inception-2015-12-05 torch file; REQUIRED for '
                         'real statistics (seeded random weights otherwise)')
    ap.add_argument('--feature-extractor', type=str, default='inception',
                    choices=['inception', 'pixels'],
                    help="'pixels' = weightless pixel-space features "
                         "(matching eval_hqmodel --feature-extractor)")
    ap.add_argument('--device', type=str, default=None,
                    help='torch device (default: cuda)')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.feature_extractor == 'inception' and not args.inception_weights:
        print('WARNING: no --inception-weights given; statistics use a '
              'randomly initialized Inception and are NOT comparable to '
              'published FID numbers (consider --feature-extractor pixels)',
              file=sys.stderr)

    dataset = build_dataset(args.dataset, args.data_root, args.split)
    extractor = make_extractor(args.feature_extractor,
                               weights_path=args.inception_weights,
                               batch_size=args.batch_size,
                               device=device)
    compute_statistics_from_dataset(dataset, extractor, args.out,
                                    resolution=args.resolution,
                                    max_samples=args.max_samples,
                                    save_acts=args.save_acts)
    print(f'saved {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
