"""What the sampling CLIs share: the model and its weights from the
arguments, and the pickled outputs."""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Any, Optional, Tuple

import torch

from ..config import build_twostage_config
from ..models.twostage import TwoStageModel, Weights, serving_bf16_params

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The arguments both sampling CLIs read to build the model."""
    ap.add_argument('-r', '--result-path', type=str, required=True)
    ap.add_argument('-m', '--model-path', type=str, default='',
                    help='reference checkpoint (.ckpt, .pth or .pt) with '
                         'stage1. / stage2. keys')
    ap.add_argument('--random-init', action='store_true')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--dtype', choices=list(DTYPES), default='bfloat16')
    ap.add_argument('--device', type=str, default=None,
                    help='torch device (default: cuda; cpu runs the '
                         'kernels\' plain versions)')


def find_config(config: Optional[str], model_path: str) -> str:
    """`config`, else config.yaml next to the checkpoint or one directory
    up, as the JAX CLI looks for it."""
    if config:
        return config
    if model_path:
        base = (os.path.dirname(model_path) if os.path.isfile(model_path)
                else model_path)
        for cand in (os.path.join(base, 'config.yaml'),
                     os.path.join(base, '..', 'config.yaml')):
            if os.path.exists(cand):
                return cand
    raise SystemExit('pass -c/--config (or put config.yaml next to -m)')


def load_model(args: argparse.Namespace, config: str
               ) -> Tuple[TwoStageModel, Weights]:
    """The model of `config` on `args.device` in `args.dtype`, and its
    weights: the checkpoint of `args.model_path` unless `--random-init`,
    else (or without a path) seeded random weights, as the JAX CLIs
    start from `init_variables`. In bf16, stage 2's matrices are stored
    in bf16 (`serving_bf16_params`): its layers cast each matrix to bf16
    where they use it, which gives the same values, and the JAX script's
    compiled loop does that cast once, not at every step."""
    dtype = DTYPES[args.dtype]
    model = TwoStageModel(build_twostage_config(config), dtype,
                          device=args.device)
    if args.model_path and not args.random_init:
        weights = model.load_reference_checkpoint(args.model_path)
        print(f'{args.model_path} (torch) successfully restored..')
    else:
        weights = model.init_weights(args.seed)
    if dtype == torch.bfloat16:
        weights['stage2'] = serving_bf16_params(weights['stage2'])
    return model, weights


def save_pickle(path: str, data: Any) -> None:
    with open(path, 'wb') as fp:
        pickle.dump(data, fp, pickle.HIGHEST_PROTOCOL)
