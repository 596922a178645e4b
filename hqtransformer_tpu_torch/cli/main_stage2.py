"""Stage-2 HQ-Transformer training: `main_stage2.py`'s arguments and
behaviour, on the card unless `--device` says otherwise.

  python -m hqtransformer_tpu_torch.cli.main_stage2 \\
      -c configs/imagenet/stage2/hqtransformer-l12-top8x8.yaml -r results/ \\
      --data-root /data/imagenet --stage1-ckpt stage1.ckpt [--bf16] \\
      [--remat] [--max-steps N] [--resume results/.../ckpt]
  torchrun --nproc-per-node 4 -m hqtransformer_tpu_torch.cli.main_stage2 \\
      ... --multihost      # data-parallel over 4 cards
  torchrun --nproc-per-node 4 -m hqtransformer_tpu_torch.cli.main_stage2 \\
      ... --multihost --tp 2   # tp 2 x dp 2 (`parallel/tp.py`)

A run writes <result path>/<config stem>/<date_time>/: `train.log`,
`config.yaml`, `ckpt/<step>/state.pt` (the step, the stage-2 parameters
and the optimizer state; `--resume <that ckpt dir>` continues the step
count and skips the batches an interrupted epoch consumed), and the
sampler-ready `ckpt_full/<step>.ckpt` (both stages in the reference's key
layout, for `cli.sampling_hqmodel -m`). `--stage1-ckpt` takes a reference
`.ckpt` (keys under 'generator.' or 'stage1.', or bare) or a stage-1
training directory of the port (`<run>/ckpt`); without it stage 1 is
random. Validation (the teacher-forced losses on up to 8 batches of the
'val' split, when there is one) runs at the end of every `test_freq`-th
epoch. `--tp N` shards stage 2 over groups of N processes of one host
(Megatron rules, `parallel/tp.py`), as the JAX script's mesh does: dp is
the world over N, the global batch `local_batch_size` x dp, each dp rank
loads its shard (the tp ranks of a dp group the same one), the schedule
reads the world size (every process, as JAX passes its device count),
and rank 0 logs and writes whole tensors. A tp that does not divide the
world, the heads, a width or a vocabulary raises ValueError.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import (latest_step, load_torch_checkpoint,
                          restore_checkpoint, save_checkpoint,
                          save_reference_bundle)
from ..config import build_twostage_config
from ..data.datasets import DataLoader, LoaderConfig, build_dataset
from ..data.tokenizers import create_tokenizer
from ..models.twostage import TwoStageModel, build_stage2
from ..parallel.ddp import cleanup
from ..parallel.tp import check_tp_sizes
from ..train.scheduler import build_schedule_from_config
from ..train.stage2 import (decay_mask, init_train_state, load_train_state,
                            make_optimizer, make_train_step,
                            train_state_dict)
from ..utils.logging import RunLogger
from .training import StepLog, add_common_args, epoch_batches, run_dir_of, \
    setup


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_common_args(ap)
    ap.add_argument('--stage1-ckpt', type=str, default=None,
                    help='stage-1 weights: a reference .ckpt or a stage-1 '
                         'training directory of the port')
    ap.add_argument('--tp', type=int, default=1,
                    help='tensor-parallel size: processes (of one host) '
                         'sharing one replica of stage 2')
    ap.add_argument('--vocab-dir', type=str, default=None)
    ap.add_argument('--resume', type=str, default=None,
                    help='ckpt directory of a previous stage-2 run')
    ap.add_argument('--remat', action='store_true',
                    help='recompute the main blocks\' activations in the '
                         'backward pass (less memory, the same gradients)')
    return ap.parse_args(argv)


def stage1_state(path: str) -> Dict[str, torch.Tensor]:
    """The stage-1 state dict of `path`: a port stage-1 training directory
    (its latest step's generator parameters and EMA buffers) or a
    reference checkpoint (keys under 'generator.' or 'stage1.' taken with
    the prefix removed, else all of them)."""
    if os.path.isdir(path):
        tree = restore_checkpoint(path, latest_step(path))
        return {**tree['gen_params'], **tree['ema']}
    sd = load_torch_checkpoint(path)
    for prefix in ('generator.', 'stage1.'):
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
    return sd


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cfg = build_twostage_config(args.config_path)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    with torch.device('meta'):
        check_tp_sizes(build_stage2(cfg, dtype), args.tp)
    device, layout = setup(args, args.tp)
    rank, world, dp = layout.rank, layout.world, layout.dp
    run_dir = run_dir_of(args)
    logger = RunLogger(run_dir, cfg, enabled=rank == 0)
    logger.line(f'device: {device}, {world} process(es), dp {dp} tp '
                f'{layout.tp}')

    model = TwoStageModel(cfg, dtype, device=str(device), remat=args.remat,
                          layout=layout)
    weights = model.init_weights(args.seed)
    if args.stage1_ckpt:
        weights['stage1'] = stage1_state(args.stage1_ckpt)
        logger.line(f'stage1 restored from {args.stage1_ckpt}')
    else:
        logger.line('WARNING: training stage-2 against a RANDOM stage-1 '
                    '(pass --stage1-ckpt for real runs)')
    model.load_weights(weights)      # once: the trainer owns the modules
    del weights
    stage1 = model.stage1.requires_grad_(False)
    stage2 = model.stage2

    # ------------------------------------------------------------- data
    s2 = cfg.stage2
    use_txt = bool(s2.use_txt_cond)
    tokenizer = None
    if use_txt:
        tokenizer = create_tokenizer(cfg.dataset.tokenizer_type,
                                     vocab_dir=args.vocab_dir,
                                     dropout=cfg.dataset.bpe_pdrop,
                                     generator=random.Random(
                                         args.seed + layout.dp_rank))
    res = cfg.dataset.image_resolution
    name = cfg.dataset.dataset or 'imagenet'
    local_bs = cfg.experiment.local_batch_size
    global_bs = local_bs * dp
    train_ds = build_dataset(name, args.data_root, 'train', tokenizer,
                             cfg.dataset.context_length)
    steps_per_epoch = max(1, len(train_ds) // global_bs)
    total_steps = args.max_steps or steps_per_epoch * cfg.experiment.epochs
    logger.line(f'{len(train_ds)} images, {steps_per_epoch} steps/epoch, '
                f'{total_steps} steps, global batch {global_bs}, '
                f'dp {dp} tp {layout.tp}')
    if len(train_ds) < global_bs:
        raise ValueError(f'dataset ({len(train_ds)} images) smaller than '
                         f'one global batch ({global_bs}); reduce '
                         f'local_batch_size')

    # --------------------------------------------------------- training
    schedule = build_schedule_from_config(cfg.optimizer, steps_per_epoch,
                                          total_steps, world_size=world)
    grad_accm = max(1, cfg.experiment.total_batch_size // global_bs)
    if grad_accm > 1:
        logger.line(f'gradient accumulation x{grad_accm} '
                    f'(effective batch {global_bs * grad_accm})')
    opt = make_optimizer(cfg.optimizer, schedule, grad_accm,
                         mask=decay_mask(stage2))
    multilevel = 'multilevel-hq' in s2.type
    loss_kwargs = dict(weight_bottom=s2.weight_bottom or 4.0,
                       weight_img=s2.weight_img, weight_txt=s2.weight_txt,
                       temp_soft_labels=s2.temp_soft_labels,
                       use_cond=bool(s2.use_cls_cond or use_txt),
                       multilevel=multilevel)
    train_step = make_train_step(stage2, stage1, opt, layout=layout,
                                 **loss_kwargs)
    state = init_train_state(stage2, opt)
    start_step = 0
    if args.resume:
        start_step = latest_step(args.resume)
        load_train_state(state, restore_checkpoint(args.resume, start_step),
                         layout)
        logger.line(f'resumed from {args.resume} @ step {start_step}')

    def to_device(x_np, labels_np):
        return (torch.from_numpy(np.asarray(x_np)).to(device),
                torch.from_numpy(np.asarray(labels_np)).long().to(device))

    def run_validation(step: int, max_batches: int = 8) -> None:
        try:
            valid_ds = build_dataset(name, args.data_root, 'val', tokenizer,
                                     cfg.dataset.context_length)
        except (FileNotFoundError, AssertionError):
            return
        vcfg = LoaderConfig(batch_size=min(cfg.experiment.valid_batch_size,
                                           max(1, len(valid_ds))),
                            resolution=res, dataset_name=name, train=False)
        all_m: Dict[str, list] = {}
        with torch.no_grad():
            for bi, batch in enumerate(DataLoader(valid_ds, vcfg)):
                _, m = train_step.loss_fn(*to_device(*batch), soft=False)
                for k, v in m.items():
                    all_m.setdefault(k, []).append(float(v))
                if bi + 1 >= max_batches:
                    break
        if all_m:
            means = {k: float(np.mean(v)) for k, v in all_m.items()}
            logger.line('valid ' + ' '.join(f'{k}={v:.4f}'
                                            for k, v in sorted(means.items()))
                        + f' @ step {step}')
            logger.scalars(means, step, 'valid')

    def save(step: int) -> None:
        save_checkpoint(os.path.join(run_dir, 'ckpt'),
                        train_state_dict(state, layout), step, layout)

    loader_cfg = LoaderConfig(batch_size=local_bs, resolution=res,
                              dataset_name=name, train=True, seed=args.seed,
                              shard_index=layout.dp_rank, shard_count=dp)
    if start_step % steps_per_epoch:
        logger.line(f'resume mid-epoch: skipping '
                    f'{start_step % steps_per_epoch} consumed batches')
    step = start_step
    log = StepLog(logger, start_step, total_steps, global_bs)
    if step < total_steps:
        for epoch, x_np, labels_np, last in epoch_batches(
                train_ds, loader_cfg, args.seed, steps_per_epoch,
                start_step):
            state, metrics = train_step(state, *to_device(x_np, labels_np))
            step += 1
            log(step, metrics)
            if step >= total_steps:
                break
            # the first dp group (rank 0 and its tp ranks) validates
            if last and (epoch + 1) % cfg.experiment.test_freq == 0 \
                    and layout.dp_rank == 0:
                run_validation(step)
            if last and (epoch + 1) % cfg.experiment.save_ckpt_freq == 0:
                save(step)
                logger.line(f'checkpoint saved @ step {step}')

    save(step)
    bundle = save_reference_bundle(
        os.path.join(run_dir, 'ckpt_full', f'{step}.ckpt'),
        stage1.state_dict(), stage2.state_dict(), step, layout)
    logger.line(f'sampler-ready checkpoint {bundle}')
    logger.line(f'final checkpoint saved @ step {step}')
    logger.close()
    if args.multihost:
        cleanup()
    return 0


if __name__ == '__main__':
    sys.exit(main())
