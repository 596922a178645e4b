"""The learning-rate schedule: linear warmup, an optional plateau (the
buffer), then cosine annealing to `min_lr`, or the step decay of
`sched_type: const`.

Counterpart of `hqtransformer_tpu/train/scheduler.py`. `build_schedule`
returns a plain function `lr(update_index)` of the number of optimizer
updates applied so far; the optimizer calls it before each update (see
`train/optim.py`). The arithmetic is the JAX function's, in float32:

- the update with index t uses the reference scheduler's value at t + 1
  (PyTorch schedulers step once at construction);
- warmup: base * multiplier * min(1, t / warmup) (`start_from_zero`), else
  base * (1 + (multiplier - 1) * min(1, t / warmup)), held through the
  buffer; the multiplier grows with the world size under the 'linear' and
  'sqrt' warmup modes;
- then cosine from base to min_lr over final - warmup - buffer updates, or,
  for 'const', base * 0.1 ** floor(t' / period) with the period half that
  horizon (the intent of the reference's StepLR branch, which cannot run
  as written).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[int], float]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def build_schedule(base_lr: float,
                   steps_per_epoch: int,
                   final_steps: int,
                   warmup_epoch: float = 0.0,
                   buffer_epoch: float = 0.0,
                   multiplier: float = 1.0,
                   min_lr: float = 0.0,
                   mode: str = 'fix',
                   start_from_zero: bool = True,
                   world_size: Optional[int] = None,
                   sched_type: str = 'cosine') -> Schedule:
    """lr(update_index) -> float, as the JAX `build_schedule` computes it."""
    warmup_steps = warmup_epoch * steps_per_epoch
    buffer_steps = buffer_epoch * steps_per_epoch
    t_max = final_steps - warmup_steps - buffer_steps
    if sched_type not in ('cosine', 'const', None):
        raise NotImplementedError(f'{sched_type} is not supported')
    if warmup_steps > 0:
        if mode == 'linear':
            multiplier = max(1.0, multiplier * world_size)
        elif mode == 'sqrt':
            multiplier = max(1.0, multiplier * math.sqrt(world_size))
        elif mode == 'fix':
            multiplier = max(1.0, multiplier)
        elif mode != 'none':
            raise NotImplementedError(f'{mode} is not a valid warmup policy')

    def schedule(update_index: int) -> float:
        step = _f32(float(update_index)) + 1.0
        if warmup_steps > 0:
            frac = torch.minimum(_f32(1.0), step / warmup_steps)
            if start_from_zero:
                warm_lr = base_lr * multiplier * frac
            else:
                warm_lr = base_lr * (1.0 + (multiplier - 1.0) * frac)
        else:
            warm_lr = _f32(base_lr)
        cos_step = torch.clamp_min(step - warmup_steps - buffer_steps, 0.0)
        if sched_type == 'const':
            period = max(1.0, float(int(t_max) // 2))
            after_lr = base_lr * torch.pow(_f32(0.1),
                                           torch.floor(cos_step / period))
        else:
            after_lr = min_lr + (base_lr - min_lr) * (1.0 + torch.cos(
                math.pi * torch.minimum(cos_step, _f32(t_max)) / t_max)) / 2
        lr = warm_lr if step <= warmup_steps + buffer_steps else after_lr
        return float(lr)

    return schedule


def build_schedule_from_config(opt_cfg, steps_per_epoch: int,
                               final_steps: int,
                               world_size: Optional[int] = None) -> Schedule:
    """The schedule of an `OptConfig`: its `warmup` (stage 2) or
    `warmup_config` (stage 1)."""
    w = opt_cfg.warmup if opt_cfg.warmup is not None else opt_cfg.warmup_config
    return build_schedule(opt_cfg.base_lr, steps_per_epoch, final_steps,
                          warmup_epoch=w.warmup_epoch,
                          buffer_epoch=w.buffer_epoch,
                          multiplier=w.multiplier, min_lr=w.min_lr,
                          mode=w.mode, start_from_zero=w.start_from_zero,
                          world_size=world_size,
                          sched_type=getattr(opt_cfg, 'sched_type',
                                             'cosine'))
