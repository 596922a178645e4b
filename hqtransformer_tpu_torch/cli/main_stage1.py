"""Stage-1 HQ-VAE training: `main_stage1.py`'s arguments and behaviour,
on the card unless `--device` says otherwise.

  python -m hqtransformer_tpu_torch.cli.main_stage1 \\
      -c configs/imagenet/stage1/hqvae-pixelshuffle-top8x8.yaml \\
      -r results/ --data-root /data/imagenet [--lpips-vgg vgg16.pth \\
      --lpips-lins lpips_lins.pth] [--fast-gan-step] [--bf16] \\
      [--max-steps N] [--resume results/.../ckpt] [--eval]
  torchrun --nproc-per-node 4 -m hqtransformer_tpu_torch.cli.main_stage1 \\
      ... --multihost      # data-parallel over 4 cards

A run writes <result path>/<config stem>/<date_time>/: `train.log`,
`config.yaml` and `ckpt/<step>/state.pt` (the step, the generator's
parameters and EMA buffers, the discriminator's parameters, both
optimizers' states and the restart generator's state; `--resume <that
ckpt dir>` continues the step count and skips the batches an interrupted
epoch consumed; `cli.main_stage2 --stage1-ckpt` reads that directory).
Validation (reconstruction MSE on up to 8 'val' batches, and image grids
where TensorBoard is installed) runs at the end of every `test_freq`-th
epoch and at the end. Without `--lpips-vgg` the perceptual loss is off,
as in JAX. The curriculum's `bottom_start` is not applied, as the JAX
script passes None. `--eval` validates the (restored) model and stops.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..config import build_stage1_config
from ..data.datasets import DataLoader, LoaderConfig, build_dataset
from ..evaluation.stage1 import init_stage1_weights
from ..models.stage1.generator import build_generator
from ..models.stage1.lpips import (init_lpips, load_torch_lpips_lins,
                                   load_torch_vgg16)
from ..parallel.ddp import cleanup
from ..train.scheduler import build_schedule_from_config
from ..train.stage1 import (init_discriminator, init_stage1_state,
                            load_stage1_state, make_discriminator,
                            make_stage1_optimizer, make_stage1_train_step,
                            stage1_state_dict)
from ..utils.logging import RunLogger
from .training import StepLog, add_common_args, epoch_batches, run_dir_of, \
    setup


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_common_args(ap)
    ap.add_argument('--eval', action='store_true',
                    help='validate the (restored) model and stop')
    ap.add_argument('--resume', type=str, default=None,
                    help='ckpt directory of a previous stage-1 run')
    ap.add_argument('--lpips-vgg', type=str, default=None,
                    help='torchvision vgg16 state_dict (.pth) for LPIPS')
    ap.add_argument('--lpips-lins', type=str, default=None,
                    help='LPIPS linear-head weights (.pth)')
    ap.add_argument('--fast-gan-step', action='store_true',
                    help='reuse the generator phase\'s reconstruction for '
                         'the discriminator step (one generator forward a '
                         'step; the reference runs two)')
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device, layout = setup(args)
    rank, world = layout.rank, layout.world
    cfg = build_stage1_config(args.config_path)
    run_dir = run_dir_of(args)
    logger = RunLogger(run_dir, cfg, enabled=rank == 0,
                       img_logging_freq=cfg.experiment.img_logging_freq)
    logger.line(f'device: {device}, {world} process(es)')

    # ------------------------------------------------------------- data
    res = cfg.dataset.image_resolution
    name = cfg.dataset.dataset or 'imagenet'
    local_bs = cfg.experiment.local_batch_size
    global_bs = local_bs * world
    train_ds = build_dataset(name, args.data_root, 'train')
    valid_ds = build_dataset(name, args.data_root, 'val')
    steps_per_epoch = max(1, len(train_ds) // global_bs)
    total_steps = args.max_steps or steps_per_epoch * cfg.experiment.epochs
    grad_accm = max(1, cfg.experiment.total_batch_size // global_bs)
    if grad_accm > 1:
        logger.line(f'gradient accumulation x{grad_accm} '
                    f'(effective batch {global_bs * grad_accm})')
    logger.line(f'{len(train_ds)} train images, {steps_per_epoch} steps/'
                f'epoch, {total_steps} total steps, global batch '
                f'{global_bs}')

    # ------------------------------------------------------------ model
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    with torch.device('meta'):
        generator = build_generator(cfg.stage1, dtype,
                                    ema_distributed=world > 1)
    generator = generator.to_empty(device=device)
    generator.load_state_dict(init_stage1_weights(cfg.stage1, args.seed,
                                                  device))
    hd = cfg.stage1.hparams_disc
    discriminator = init_discriminator(make_discriminator(hd, dtype),
                                       args.seed + 1, device)
    lpips, perceptual_weight = None, 1.0
    if args.lpips_vgg:
        lpips = init_lpips(0, dtype, device)
        load_torch_vgg16(lpips, torch.load(args.lpips_vgg,
                                           map_location='cpu'))
        if args.lpips_lins:
            load_torch_lpips_lins(lpips, torch.load(args.lpips_lins,
                                                    map_location='cpu'))
        logger.line('LPIPS weights loaded')
    else:
        perceptual_weight = 0.0
        logger.line('WARNING: no --lpips-vgg given; perceptual loss '
                    'DISABLED (reference uses pretrained VGG16 LPIPS)')

    schedule = build_schedule_from_config(cfg.optimizer, steps_per_epoch,
                                          total_steps, world_size=world)
    g_opt = make_stage1_optimizer(cfg.optimizer, schedule, grad_accm)
    d_opt = make_stage1_optimizer(cfg.optimizer, schedule, grad_accm)
    state = init_stage1_state(generator, discriminator, g_opt, d_opt)
    rng = torch.Generator(device=device).manual_seed(args.seed)
    start_step = 0
    if args.resume:
        start_step = latest_step(args.resume)
        tree = restore_checkpoint(args.resume, start_step)
        load_stage1_state(state, tree)
        rng.set_state(tree['rng'])
        logger.line(f'resumed from {args.resume} @ step {start_step}')

    train_step = make_stage1_train_step(
        generator, discriminator, lpips, g_opt, d_opt, hd,
        bottom_start=None,
        residual_l1_weight=hd.residual_l1_weight or 0.0,
        perceptual_weight=perceptual_weight,
        faithful_double_forward=not args.fast_gan_step,
        distributed=world > 1)

    def run_validation(step: int, max_batches: int = 8) -> None:
        vcfg = LoaderConfig(batch_size=min(cfg.experiment.valid_batch_size,
                                           max(1, len(valid_ds))),
                            resolution=res, dataset_name=name, train=False)
        recs, first = [], None
        with torch.no_grad():
            for bi, (x_np, _) in enumerate(DataLoader(valid_ds, vcfg)):
                x = torch.from_numpy(x_np).to(device)
                dec = generator(x)[0].float()
                recs.append(float(torch.mean(torch.square(x - dec))))
                if first is None:
                    first = (x_np * 0.5 + 0.5, torch.clamp(
                        dec * 0.5 + 0.5, 0, 1).cpu().numpy())
                if bi + 1 >= max_batches:
                    break
        if recs:
            logger.line(f'valid/rec_loss {np.mean(recs):.5f} @ step {step}')
            logger.scalars({'rec_loss': float(np.mean(recs))}, step, 'valid')
        if first is not None:
            logger.images('valid/input', first[0], step)
            logger.images('valid/recon', first[1], step)

    def save(step: int) -> None:
        if rank == 0:
            tree = stage1_state_dict(state)
            tree['rng'] = rng.get_state()
            save_checkpoint(os.path.join(run_dir, 'ckpt'), tree, step)

    if args.eval:
        if rank == 0:
            run_validation(start_step)
        logger.close()
        if args.multihost:
            cleanup()
        return 0

    if len(train_ds) < global_bs:
        raise ValueError(f'dataset ({len(train_ds)} images) smaller than '
                         f'one global batch ({global_bs}); reduce '
                         f'local_batch_size')
    loader_cfg = LoaderConfig(batch_size=local_bs, resolution=res,
                              dataset_name=name, train=True, seed=args.seed,
                              shard_index=rank, shard_count=world)
    if start_step % steps_per_epoch:
        logger.line(f'resume mid-epoch: skipping '
                    f'{start_step % steps_per_epoch} consumed batches')
    step = start_step
    log = StepLog(logger, start_step, total_steps, global_bs)
    if step < total_steps:
        for epoch, x_np, _, last in epoch_batches(
                train_ds, loader_cfg, args.seed, steps_per_epoch,
                start_step):
            state, metrics = train_step(state,
                                        torch.from_numpy(x_np).to(device),
                                        rng)
            step += 1
            log(step, metrics)
            if step >= total_steps:
                break
            if last and (epoch + 1) % cfg.experiment.test_freq == 0 \
                    and rank == 0:
                run_validation(step)
            if last and (epoch + 1) % cfg.experiment.save_ckpt_freq == 0:
                save(step)
                logger.line(f'checkpoint saved @ step {step}')

    if rank == 0:
        run_validation(step)
    save(step)
    logger.line(f'final checkpoint saved @ step {step}')
    logger.close()
    if args.multihost:
        cleanup()
    return 0


if __name__ == '__main__':
    sys.exit(main())
