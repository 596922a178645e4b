"""A rank of the data-parallel check in `test_torch_train_cli.py`: joins a
gloo process group, trains a tiny model for 2 steps on its half of each
batch and saves what it holds. Imports nothing of JAX."""

import sys

import numpy as np
import torch

from hqtransformer_tpu_torch.parallel.ddp import cleanup, init_distributed


def batches(res, n, batch, seed):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, (batch, res, res, 3)).astype(np.float32),
             rng.randint(0, 10, (batch,))) for _ in range(n)]


def train(kind, rank, world, out, steps=2, batch=4, layout=None):
    """Train `kind` ('stage1' or 'stage2', tiny configs) for `steps` steps
    on rows rank::world of each seeded batch and save the parameters and
    EMA buffers to `out` (rank 0). `layout`: the process group's
    (`init_distributed`), None for one process."""
    torch.manual_seed(0)
    torch.set_num_threads(1)
    if kind == 'stage2':
        from hqtransformer_tpu_torch.config import build_twostage_config
        from hqtransformer_tpu_torch.models.twostage import TwoStageModel
        from hqtransformer_tpu_torch.train import stage2 as ts
        from hqtransformer_tpu_torch.train.scheduler import build_schedule
        cfg = build_twostage_config('configs/tiny/stage2-tiny.yaml')
        tm = TwoStageModel(cfg, device='cpu')
        tm.load_weights(tm.init_weights(0))
        tm.stage1.requires_grad_(False)
        opt = ts.make_optimizer(cfg.optimizer, build_schedule(1e-3, 2, 10),
                                mask=ts.decay_mask(tm.stage2))
        step = ts.make_train_step(tm.stage2, tm.stage1, opt, layout=layout)
        state = ts.init_train_state(tm.stage2, opt)
        for x, y in batches(32, steps, batch, 5):
            state, _ = step(state, torch.from_numpy(x[rank::world]),
                            torch.from_numpy(y[rank::world]))
        held = dict(tm.stage2.state_dict())
    else:
        from hqtransformer_tpu_torch.config import build_stage1_config
        from hqtransformer_tpu_torch.evaluation.stage1 import \
            init_stage1_weights
        from hqtransformer_tpu_torch.models.stage1.generator import \
            build_generator
        from hqtransformer_tpu_torch.train import stage1 as t1
        from hqtransformer_tpu_torch.train.scheduler import build_schedule
        cfg = build_stage1_config('configs/tiny/stage1-tiny.yaml')
        gen = build_generator(cfg.stage1, ema_distributed=world > 1)
        gen.load_state_dict(init_stage1_weights(cfg.stage1, 0, 'cpu'))
        disc = t1.init_discriminator(
            t1.make_discriminator(cfg.stage1.hparams_disc), 1)
        sched = build_schedule(1e-3, 2, 10)
        g_opt, d_opt = (t1.make_stage1_optimizer(cfg.optimizer, sched)
                        for _ in range(2))
        step = t1.make_stage1_train_step(
            gen, disc, None, g_opt, d_opt, cfg.stage1.hparams_disc,
            perceptual_weight=0.0, distributed=world > 1)
        state = t1.init_stage1_state(gen, disc, g_opt, d_opt)
        for x, _ in batches(32, steps, batch, 6):
            state, _ = step(state, torch.from_numpy(x[rank::world]))
        held = {**gen.state_dict(), **{f'disc.{k}': v for k, v in
                                       disc.state_dict().items()}}
    if rank == 0:
        torch.save(held, out)


def main(argv):
    kind, rank, world, port, out = argv
    rank, world = int(rank), int(world)
    layout = init_distributed('cpu', f'tcp://127.0.0.1:{port}', rank, world)
    try:
        train(kind, rank, world, out, layout=layout)
    finally:
        cleanup()


if __name__ == '__main__':
    main(sys.argv[1:])
