"""What the two training CLIs share: the device and the process group,
the run directory, the batches of the epochs with a mid-epoch resume, and
the step log line."""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import DataLoader, LoaderConfig, PrefetchLoader
from ..device import resolve_device
from ..parallel.ddp import init_distributed
from ..parallel.tp import ParallelLayout, make_layout


def add_common_args(ap) -> None:
    """The arguments both trainers read, as the JAX scripts name them, and
    `--device`."""
    ap.add_argument('-c', '--config-path', type=str, required=True)
    ap.add_argument('-r', '--result-path', type=str, default='./results')
    ap.add_argument('--data-root', type=str, required=True)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--multihost', action='store_true',
                    help='join the process group torchrun describes in the '
                         'environment (NCCL on cards, gloo on the CPU); '
                         'each process then loads only its shard of the '
                         'global batch')
    ap.add_argument('--max-steps', type=int, default=None,
                    help='total micro-steps (smoke runs)')
    ap.add_argument('--bf16', action='store_true',
                    help='bf16 activations on f32 parameters; losses and '
                         'optimizer state stay f32')
    ap.add_argument('--device', type=str, default=None,
                    help='torch device (default: cuda; cpu runs the '
                         'kernels\' plain versions)')


def setup(args, tp: int = 1) -> Tuple[torch.device, ParallelLayout]:
    """(device, layout): the card (or `--device`), and under `--multihost`
    the process group, this process's card and the ('dp', 'tp') layout
    with tensor-parallel size `tp` (ValueError if tp does not divide the
    world; without `--multihost` the world is this one process)."""
    device = resolve_device(args.device)
    if not args.multihost:
        return device, make_layout(tp)
    layout = init_distributed(device.type, tp=tp)
    if device.type == 'cuda':
        device = torch.device('cuda', layout.local_rank)
    return device, layout


def run_dir_of(args) -> str:
    """<result path>/<config stem>/<date_time>, as the JAX scripts name it."""
    now = datetime.now().strftime('%d%m%Y_%H%M%S')
    return os.path.join(args.result_path,
                        os.path.basename(args.config_path).split('.')[0],
                        now)


def epoch_batches(dataset, loader_cfg: LoaderConfig, seed: int,
                  steps_per_epoch: int, start_step: int
                  ) -> Iterator[Tuple[int, np.ndarray, np.ndarray, bool]]:
    """(epoch, images, labels, last of its epoch) over the epochs from the
    one `start_step` falls in, each loaded with seed `seed + epoch` (so an
    epoch's order is fixed); the first start_step % steps_per_epoch
    batches of that epoch, which a resumed run has consumed, are
    skipped."""
    skip = start_step % steps_per_epoch
    epoch = start_step // steps_per_epoch
    while True:
        loader_cfg.seed = seed + epoch
        held = None
        for x, labels in PrefetchLoader(DataLoader(dataset, loader_cfg)):
            if skip:
                skip -= 1
                continue
            if held is not None:
                yield (epoch,) + held + (False,)
            held = (x, labels)
        if held is not None:
            yield (epoch,) + held + (True,)
        epoch += 1


class StepLog:
    """The step line: every 50 steps and the first, with the images a
    second since the (resumed) start."""

    def __init__(self, logger, start_step: int, total_steps: int,
                 global_bs: int):
        self.logger, self.start = logger, start_step
        self.total, self.global_bs = total_steps, global_bs
        self.t0 = time.time()

    def __call__(self, step: int, metrics) -> Optional[dict]:
        if step % 50 != 0 and step != self.start + 1:
            return None
        m = {k: float(v) for k, v in metrics.items()}
        dt = (time.time() - self.t0) / (step - self.start)
        self.logger.line(f'step {step}/{self.total} '
                         f'({self.global_bs / dt:.1f} img/s) ' +
                         ' '.join(f'{k}={v:.4f}'
                                  for k, v in sorted(m.items())))
        self.logger.scalars(m, step)
        return m
