"""Generation evaluation: FID against dataset statistics and PRDC against
reference features, from the sampling CLIs' pickles.

    python -m hqtransformer_tpu_torch.cli.eval_hqmodel -r <result dir> \
        [--ref-stat-path stats.npz] [--ref-feature-path acts.npz] \
        [--inception-weights pt_inception-2015-12-05.pth] \
        [--feature-extractor inception|pixels] [--device cpu]

The port's counterpart of the JAX package's root `eval_hqmodel.py`, with
its arguments and files: the features of every `samples_*.pkl` of the
result directory are cached in `<result dir>/acts.npz` (`acts_pixels.npz`
for the pixel features) with the keys `acts`, `mu` and `sigma`, so that
a cache written by either package is read by the other, and a second
call computes no feature. The `DATASET_*` defaults (paths under
`assets/`, relative to the working directory) are used only where the
file exists, and only for Inception features. It runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..evaluation.fid import (compute_activations_from_files,
                              frechet_distance, make_extractor,
                              mean_covar_numpy)
from ..evaluation.prdc import compute_prdc

_log = logging.getLogger(__name__)

DATASET_STATS_FOR_FID = {
    'imagenet': 'assets/inception_stats/imagenet_256_train.npz',
    'ffhq': 'assets/inception_stats/ffhq_256_train.npz',
    'cc3m': 'assets/inception_stats/cc3m_256_val.npz',
}

DATASET_ACTS_FOR_PRDC = {
    'imagenet': 'assets/inception_features/adm/imagenet_256_10000.npz',
    'ffhq': 'assets/inception_features/shuffled/ffhq_256_train_50000.npz',
}


def compute_fid_prdc(result_path, ref_stat_path=None, ref_feature_path=None,
                     inception_weights=None, max_samples=None,
                     feature_extractor='inception', device=None):
    """{'fid'?, 'precision'?, 'recall'?, 'density'?, 'coverage'?} of the
    result directory's samples, its features cached in acts[_kind].npz."""
    suffix = '' if feature_extractor == 'inception' else \
        f'_{feature_extractor}'
    act_path = Path(result_path) / f'acts{suffix}.npz'
    if not act_path.exists():
        extractor = make_extractor(feature_extractor,
                                   weights_path=inception_weights,
                                   device=device)
        acts = compute_activations_from_files(result_path, extractor,
                                              max_samples=max_samples)
        mu, sigma = mean_covar_numpy(acts)
        np.savez(act_path, acts=acts, mu=mu, sigma=sigma)
        _log.info('activations saved to %s', act_path.as_posix())
    else:
        _log.info('precomputed activations found: %s',
                  act_path.as_posix())

    acts_fake = np.load(act_path)
    metrics = {}
    if ref_stat_path:
        stats_ref = np.load(ref_stat_path)
        fid = frechet_distance(stats_ref['mu'], stats_ref['sigma'],
                               acts_fake['mu'], acts_fake['sigma'])
        metrics['fid'] = fid
        _log.info('FID: %.4f', fid)
    if ref_feature_path:
        ref_features = np.load(ref_feature_path)['acts']
        prdc = compute_prdc(ref_features, acts_fake['acts'], nearest_k=3,
                            device=device)
        _log.info('P=%.4f, R=%.4f, D=%.4f, C=%.4f', prdc['precision'],
                  prdc['recall'], prdc['density'], prdc['coverage'])
        metrics.update(prdc)
    return metrics


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-r', '--result-path', type=str, required=True)
    ap.add_argument('-d', '--ref-dataset', type=str, default='imagenet')
    ap.add_argument('-m', '--metrics', nargs='+', default=['fid', 'prdc'])
    ap.add_argument('--ref-stat-path', type=str, default=None)
    ap.add_argument('--ref-feature-path', type=str, default=None)
    ap.add_argument('--assets-root', type=str, default='assets',
                    help='accepted for the JAX script\'s command lines; '
                         'the defaults are read under assets/')
    ap.add_argument('--inception-weights', type=str,
                    default=os.environ.get('FID_INCEPTION_WEIGHTS'))
    ap.add_argument('--max-samples', type=int, default=None)
    ap.add_argument('--feature-extractor', type=str, default='inception',
                    choices=['inception', 'pixels'],
                    help="'pixels' = weightless pixel-space Frechet "
                         "distance (see evaluation.fid.PixelExtractor)")
    ap.add_argument('--device', type=str, default=None,
                    help='torch device (default: cuda)')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log = logging.getLogger()
    log.setLevel(logging.INFO)
    handlers = [logging.StreamHandler(), logging.FileHandler(
        os.path.join(args.result_path, 'fid_prdc.log'))]
    for h in handlers:
        log.addHandler(h)
    try:
        # the bundled fallbacks are Inception statistics and features:
        # pixel features need explicit paths made with the same extractor
        ref_stat = args.ref_stat_path
        if (ref_stat is None and 'fid' in args.metrics
                and args.feature_extractor == 'inception'):
            cand = DATASET_STATS_FOR_FID.get(args.ref_dataset, '')
            ref_stat = cand if os.path.exists(cand) else None
        ref_feats = args.ref_feature_path
        if (ref_feats is None and 'prdc' in args.metrics
                and args.feature_extractor == 'inception'):
            cand = DATASET_ACTS_FOR_PRDC.get(args.ref_dataset, '')
            ref_feats = cand if os.path.exists(cand) else None

        metrics = compute_fid_prdc(args.result_path, ref_stat, ref_feats,
                                   args.inception_weights, args.max_samples,
                                   feature_extractor=args.feature_extractor,
                                   device=device)
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()
    print({k: round(float(v), 4) for k, v in metrics.items()})
    return 0


if __name__ == '__main__':
    sys.exit(main())
