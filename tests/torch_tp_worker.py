"""A rank of the tensor-parallel checks in `test_torch_tp.py`: four gloo
processes, tp 2 x dp 2, on the CPU. Imports nothing of JAX.

    python tests/torch_tp_worker.py <rank> <world> <port> <cli port> \\
        <resume port> <dir>

`<dir>/inputs.pt` holds what the test prepared (the tiny HierarchicalGPT's
weights converted from JAX, its batches, the scorer's codes, the PNG
tree); each rank writes `<dir>/rank<r>.pt` with what it computed:
- 'train': the loss of each of 3 steps (the mean over the dp ranks) and
  the gathered parameters after steps 2 and 3; the gathered training
  state after step 2 goes to `<dir>/ckpt` (`save_checkpoint`);
- 'remat', 'soft': the gathered parameters after one step of the tiny
  two-stage config with `remat`, and with soft labels;
- 'text': the gathered parameters after one step of the tiny config
  conditioned on captions (`text_step`);
- 'codes2', 'codes3': this rank's dp shard of the 2-level and 3-level
  samplers' codes for one generator seed; 'variants': those of the
  bidirectional and top2bot depth modes and the flat baselines
  (`variant_codes`);
- 'scores': this rank's dp shard of the scorer's logits;
then `cli.main_stage2 --tp 2` runs 2 steps and resumes to 3 under
torchrun's environment variables (`<dir>/cli`).
"""

import os
import sys

import torch
from torch import nn

from hqtransformer_tpu_torch.config import (Stage2Hparams,
                                            build_twostage_config,
                                            parse_model_type)
from hqtransformer_tpu_torch.models.stage2.hierarchical import \
    HierarchicalGPT
from hqtransformer_tpu_torch.models.twostage import TwoStageModel
from hqtransformer_tpu_torch.parallel import ddp
from hqtransformer_tpu_torch.parallel.tp import (gather_state, shard_module,
                                                 shard_state)
from hqtransformer_tpu_torch.sampling.engine import (
    LevelSampling, SamplingParams, make_hierarchical_sampler,
    make_hierarchical_scorer, make_igpt_sampler, make_multilevel_sampler,
    make_txt2img_sampler)
from hqtransformer_tpu_torch.train import stage2 as ts
from hqtransformer_tpu_torch.train.scheduler import build_schedule
from hqtransformer_tpu_torch.config import OptConfig

TP = 2
TINY2 = 'configs/tiny/stage2-tiny.yaml'
LEVEL3 = 'configs/imagenet/stage2/hqtransformer-l12-top8x8-level3.yaml'
OPT = dict(betas=[0.9, 0.95], weight_decay=1e-4, grad_clip_norm=0.05)


def parallel_model():
    """`tests/test_parallel.py::tiny_model`, in the port."""
    hp = Stage2Hparams(embed_dim=64, n_layers=2, n_heads=4, ctx_len_img=16,
                       n_classes=10, embedding_type='transformer1',
                       resid_pdrop=0.0)
    return HierarchicalGPT(vocab_size_top=32, vocab_size_bot=32,
                           ratio_bot2top=4, use_cls_cond=True,
                           model_type=parse_model_type(
                               'hq-transformer/parallel'), hparams=hp,
                           vocab_size_txt=16)


class FakeStage1(nn.Module):
    """`tests/test_parallel.py::_FakeStage1` in torch: codes from the
    images' values, the same f32 arithmetic."""

    def get_codes(self, images):
        flat = images.reshape(images.shape[0], -1)
        ct = (flat[:, :16].abs() * 1000).to(torch.int32) % 32
        cb = (flat[:, :64].abs() * 999).to(torch.int32) % 32
        return ct, cb


def sharded(sd, layout):
    """The tiny HierarchicalGPT holding this rank's shards of `sd`."""
    with torch.device('meta'):
        model = parallel_model()
    shard_module(model, layout)
    model = model.to_empty(device='cpu')
    model.load_state_dict({k: v.clone() for k, v in
                           shard_state(sd, layout).items()}, strict=True,
                          assign=True)
    return model.eval()


def gathered(state, layout):
    """Copies of the whole parameters (`gather_state` passes the
    replicated ones through, which later steps move in place)."""
    return {k: v.clone() for k, v in gather_state(
        {k: p.detach() for k, p in state.params.items()}, layout).items()}


def optimizer(model):
    return ts.make_optimizer(OptConfig(**OPT), build_schedule(
        1e-3, 2, 10, warmup_epoch=1.0), mask=ts.decay_mask(model))


def train(inputs, layout, out):
    """3 steps of the tiny HierarchicalGPT at tp 2 x dp 2; the checkpoint
    after step 2."""
    model = sharded(inputs['parallel_sd'], layout)
    opt = optimizer(model)
    step = ts.make_train_step(model, FakeStage1(), opt, layout=layout,
                              weight_bottom=4.0)
    state = ts.init_train_state(model, opt)
    losses, params = [], []
    for i, images in enumerate(inputs['train_images']):
        state, m = step(state, layout.rows(images),
                        layout.rows(inputs['train_labels']))
        losses.append(float(ddp.all_reduce_mean(m['loss'],
                                                layout.dp_group)))
        params.append(gathered(state, layout))
        if i == 1:
            from hqtransformer_tpu_torch.checkpoint import save_checkpoint
            save_checkpoint(os.path.join(out, 'ckpt'),
                            ts.train_state_dict(state, layout), state.step,
                            layout)
    return {'losses': losses, 'params2': params[1], 'params3': params[2]}


def tiny_batch(seed, n=8, res=32):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, res, res, 3, generator=g) * 2 - 1,
            torch.arange(n) % 10)


def _rows(layout, x):
    return x if layout is None else layout.rows(x)


def one_step(layout, remat=False, soft=None):
    """One step of the tiny two-stage config (seeded weights) under
    `layout` (tp 2 x dp 2; None: one process on the whole batch), the
    whole parameters after it."""
    cfg = build_twostage_config(TINY2)
    tm = TwoStageModel(cfg, device='cpu', remat=remat, layout=layout)
    tm.load_weights(tm.init_weights(0))
    tm.stage1.requires_grad_(False)
    opt = optimizer(tm.stage2)
    step = ts.make_train_step(tm.stage2, tm.stage1, opt, layout=layout,
                              temp_soft_labels=soft)
    state = ts.init_train_state(tm.stage2, opt)
    images, labels = tiny_batch(3)
    state, _ = step(state, _rows(layout, images), _rows(layout, labels))
    return gathered(state, layout)


VARIANTS = ('bidirectional', 'top2bot', 'igpt', 'transformer1d')


def variant(kind):
    """The tiny config with caption conditioning ('text': 8 ids of a
    vocabulary of 32; its training step reads the stage-1 codes), or at
    d 64 and vocabulary 64 in another depth mode ('bidirectional',
    'top2bot') or as a flat baseline ('igpt' over the 16 top codes,
    class-conditioned; 'transformer1d' over the 64 bottom codes after a
    16-token prefix), as the port's tests of those paths cut it."""
    cfg = build_twostage_config(TINY2)
    s2 = cfg.stage2
    if kind != 'text':
        s2.vocab_size_img, s2.hparams.embed_dim = 64, 64
    if kind == 'bidirectional':
        s2.type = 'hq-transformer/bidirectional4'
    elif kind == 'top2bot':
        s2.type = 'hq-transformer'
    elif kind == 'text':
        s2.use_cls_cond, s2.use_txt_cond = False, True
        s2.vocab_size_txt, s2.hparams.ctx_len_txt = 32, 8
    elif kind == 'igpt':
        s2.type, s2.use_cls_cond = 'top', True
    else:
        s2.type, s2.use_cls_cond = 'bottom', False
        s2.hparams.ctx_len_img, s2.hparams.ctx_len_txt = 64, 16
    return cfg


def variant_codes(layout):
    """{kind: codes} of the VARIANTS' samplers (seeded weights, top-k 16,
    one generator seed each) on 8 labels (Transformer1d: 8 prefixes of 16
    top codes); this rank's dp shard under `layout`, the whole batch
    without one."""
    labels = torch.arange(8) % 10
    out = {}
    for i, kind in enumerate(VARIANTS):
        tm = TwoStageModel(variant(kind), device='cpu', layout=layout)
        tm.load_weights(tm.init_weights(2 + i))
        gen = torch.Generator().manual_seed(20 + i)
        if kind == 'igpt':
            codes = (make_igpt_sampler(tm.stage2, 16, top_k=16)(gen,
                                                                labels),)
        elif kind == 'transformer1d':
            prefix = (torch.arange(8 * 16) * 7 % 64).reshape(8, 16)
            codes = (make_txt2img_sampler(tm.stage2, 64, top_k=16)(
                gen, prefix),)
        else:
            codes = make_hierarchical_sampler(
                tm.stage2, 16, SamplingParams(top_k_top=16, top_k_bot=16))(
                gen, labels)
        out[kind] = codes
    return out


def text_step(layout):
    """One step of the caption-conditioned tiny config (image and text
    losses, weight 1 each) on 8 images and their 8-id captions; the whole
    parameters after it (gathered under `layout`)."""
    tm = TwoStageModel(variant('text'), device='cpu', layout=layout)
    tm.load_weights(tm.init_weights(5))
    tm.stage1.requires_grad_(False)
    opt = optimizer(tm.stage2)
    step = ts.make_train_step(tm.stage2, tm.stage1, opt, layout=layout,
                              weight_img=1.0, weight_txt=1.0)
    state = ts.init_train_state(tm.stage2, opt)
    images, _ = tiny_batch(6)
    ids = torch.randint(0, 32, (8, 8), generator=torch.Generator()
                        .manual_seed(6))
    state, _ = step(state, _rows(layout, images), _rows(layout, ids))
    return gathered(state, layout)


def level3_config():
    """`tests/test_torch_multilevel.py::tiny_config` ('parallel-add')."""
    cfg = build_twostage_config(LEVEL3)
    cfg.dataset.image_resolution = 64
    s1 = cfg.stage1
    s1.hparams.resolution, s1.hparams.ch = 64, 32
    s1.hparams.ch_mult, s1.hparams.z_channels = [1, 2], 64
    s1.hparams.attn_resolutions = [16]
    s1.embed_dim, s1.n_embed, s1.n_embed_levels = 64, 64, [32, 48, 64]
    s2 = cfg.stage2
    s2.decoding_type = 'parallel-add'
    s2.vocab_sizes_img, s2.vocab_size_img = [32, 48, 64], 64
    s2.hparams.embed_dim, s2.hparams.n_layers = 64, 2
    s2.hparams.n_heads, s2.hparams.n_classes = 4, 10
    s2.hparams.ctx_len_img = 16
    return cfg


def sample(inputs, layout):
    model = sharded(inputs['parallel_sd'], layout)
    labels = torch.arange(8) % 10
    codes2 = make_hierarchical_sampler(
        model, 16, SamplingParams(top_k_top=16, top_k_bot=16))(
        torch.Generator().manual_seed(7), labels)
    scores = make_hierarchical_scorer(model, 16)(
        inputs['score_labels'], inputs['score_top'], inputs['score_cells'])
    tm = TwoStageModel(level3_config(), device='cpu', layout=layout)
    tm.load_weights(tm.init_weights(1))
    codes3 = make_multilevel_sampler(
        tm.stage2, 16, (LevelSampling(top_k=8),) * 3)(
        torch.Generator().manual_seed(8), labels)
    return {'codes2': codes2, 'codes3': codes3, 'scores': scores}


def run_cli(inputs, rank, world, port, resume_port, out):
    """`cli.main_stage2 --tp 2`, 2 steps, then resumed to 3, each under
    torchrun's environment."""
    from hqtransformer_tpu_torch.checkpoint import latest_step  # noqa
    from hqtransformer_tpu_torch.cli import main_stage2
    result = os.path.join(out, 'cli')
    args = ['-c', TINY2, '-r', result, '--data-root', inputs['tree'],
            '--device', 'cpu', '--multihost', '--tp', str(TP)]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    main_stage2.main(args + ['--max-steps', '2'])
    run = os.path.join(result, 'stage2-tiny')
    first = os.path.join(run, sorted(os.listdir(run))[0], 'ckpt')
    os.environ['MASTER_PORT'] = str(resume_port)
    main_stage2.main(args + ['--max-steps', '3', '--resume', first])


def main(argv):
    rank, world, port, cli_port, resume_port = (int(a) for a in argv[:5])
    out = argv[5]
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out, 'inputs.pt'), weights_only=False)
    layout = ddp.init_distributed('cpu', f'tcp://127.0.0.1:{port}', rank,
                                  world, tp=TP)
    try:
        held = {'layout': (layout.dp_rank, layout.tp_rank),
                'train': train(inputs, layout, out),
                'remat': one_step(layout, remat=True),
                'soft': one_step(layout, soft=1.0),
                'text': text_step(layout), 'variants': variant_codes(layout),
                **sample(inputs, layout)}
    finally:
        ddp.cleanup()
    torch.save(held, os.path.join(out, f'rank{rank}.pt'))
    run_cli(inputs, rank, world, cli_port, resume_port, out)


if __name__ == '__main__':
    main(sys.argv[1:])
