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
- int8 serving, once the test has written `<dir>/int8_inputs.pt` (the
  scorer's bf16 weights and codes) and the tp-1 artifacts:
  'int8_codes', this rank's dp shard of every sampler's codes with f32
  activations and the int8 KV cache, its scales read from
  `<dir>/kv_<kind>.pkl` (`int8_cache_codes`); 'a8w8', a row-parallel
  and a vocabulary-sharded bf16 A8W8 product and an int32 sum over the
  tp group (`a8w8_products`); 'calib', the KV and activation scales
  calibrated at tp 2 x dp 2 (`calibrations`); 'bf16_scores' and
  'int8_scores', the bf16 scorer's logits in bf16 and in int8max with
  the tp-1 artifact `<dir>/scores8.pkl` (`int8_scores`);
then `cli.main_stage2 --tp 2` runs 2 steps and resumes to 3 under
torchrun's environment variables (`<dir>/cli`).
"""

import os
import sys
import time

import torch
from torch import nn

from hqtransformer_tpu_torch.config import (Stage2Hparams,
                                            build_twostage_config,
                                            parse_model_type)
from hqtransformer_tpu_torch.models.stage2.hierarchical import \
    HierarchicalGPT
from hqtransformer_tpu_torch.models.stage2.layers import QuantizableLinear
from hqtransformer_tpu_torch.models.twostage import (TwoStageModel, _kv_scales,
                                                     load_serving_scales)
from hqtransformer_tpu_torch.ops import int8 as q8
from hqtransformer_tpu_torch.parallel import ddp
from hqtransformer_tpu_torch.parallel.tp import (gather_state, shard_module,
                                                 shard_state)
from hqtransformer_tpu_torch.sampling.engine import (
    LevelSampling, SamplingParams, _flat_sampler, make_hierarchical_sampler,
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


# ------------------------------------------------------------ int8 serving

KV_KINDS = ('2-level', '3-level') + VARIANTS
INT8_INPUTS = 'int8_inputs.pt'    # the scorer's weights and codes
KV_CACHE = q8.Int8Serving(kv_cache=True)


def _labels(kind):
    """The whole batch's labels of a sampler case (Transformer1d: 8
    prefixes of 16 top codes)."""
    if kind == 'transformer1d':
        return (torch.arange(8 * 16) * 7 % 64).reshape(8, 16)
    return torch.arange(8) % 10


def kv_case_model(kind, layout, sd=None):
    """The f32 stage-2 model of an int8-cache case under `layout` (None:
    tp 1): the tiny HierarchicalGPT with `sd` ('2-level', as `sample`),
    the 3-level tiny config, or a VARIANTS model, with their samplers'
    seeded weights."""
    if kind == '2-level':
        if layout is not None:
            return sharded(sd, layout)
        model = parallel_model()
        model.load_state_dict(sd)
        return model.eval()
    if kind == '3-level':
        tm = TwoStageModel(level3_config(), device='cpu', layout=layout)
        tm.load_weights(tm.init_weights(1))
    else:
        tm = TwoStageModel(variant(kind), device='cpu', layout=layout)
        tm.load_weights(tm.init_weights(2 + VARIANTS.index(kind)))
    return tm.stage2


def kv_case_sampler(kind, model, int8=q8.Int8Serving(), scales=None,
                    return_caches=False):
    """The case's sampler (top-k 16; 8 a level for 3 levels), as
    `sample` and `variant_codes` build them."""
    if kind == '3-level':
        return make_multilevel_sampler(model, 16, (LevelSampling(top_k=8),)
                                       * 3, int8, scales, return_caches)
    if kind in ('igpt', 'transformer1d'):
        n = 16 if kind == 'igpt' else 64
        if return_caches:
            return _flat_sampler(model, n, 16, None, 1.0, int8, scales, True)
        make = make_igpt_sampler if kind == 'igpt' else make_txt2img_sampler
        return make(model, n, top_k=16, int8=int8, scales=scales)
    return make_hierarchical_sampler(
        model, 16, SamplingParams(top_k_top=16, top_k_bot=16), int8, scales,
        return_caches)


def kv_scales_tp1(sd):
    """{kind: the int8 KV-cache scales of one f32 sampling run at tp 1}
    (the caches of a run with another seed than the served one's,
    reduced by `_kv_scales`)."""
    out = {}
    for i, kind in enumerate(KV_KINDS):
        sampler = kv_case_sampler(kind, kv_case_model(kind, None, sd),
                                  return_caches=True)
        _, caches = sampler(torch.Generator().manual_seed(40 + i),
                            _labels(kind))
        out[kind] = _kv_scales(caches)
    return out


def int8_cache_codes(layout, sd, scales):
    """{kind: codes} of every case's sampler with f32 activations and the
    int8 KV cache (`scales[kind]`: whole, tp 1's), one generator seed a
    case; this rank's dp shard under `layout`."""
    out = {}
    for i, kind in enumerate(KV_KINDS):
        model = kv_case_model(kind, layout, sd)
        codes = kv_case_sampler(kind, model, KV_CACHE, scales[kind])(
            torch.Generator().manual_seed(30 + i), _labels(kind))
        out[kind] = codes if isinstance(codes, tuple) else (codes,)
    return out


A8W8_SHAPES = dict(rows=20, width=64, out=48, vocab=96)


def a8w8_products(layout):
    """Seeded bf16 A8W8 products, the rank's part under `layout` (None:
    tp 1): 'row', a row-parallel `proj` [48, 64] on x [20, 64] (the rank's
    columns of x, the whole x's activation scale); 'vocab', a
    vocabulary-sharded `head_bot` [96, 48] on h [20, 48] (its logits
    gathered); 'int32', the tp group's sum of int32 values past f32's
    24-bit mantissa (tp 1: the sum computed here)."""
    n = A8W8_SHAPES
    g = torch.Generator().manual_seed(12)
    mod = nn.ModuleDict({
        'proj': QuantizableLinear(n['width'], n['out']),
        'head_bot': QuantizableLinear(n['out'], n['vocab'], bias=False)})
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    mod = mod.bfloat16()
    x = torch.randn(n['rows'], n['width'], generator=g).bfloat16()
    h = torch.randn(n['rows'], n['out'], generator=g).bfloat16()
    x_scale = q8.scale_from_absmax(q8.absmax(x))
    h_scale = q8.scale_from_absmax(q8.absmax(h))
    parts = torch.tensor([2 ** 28 + 7, 2 ** 27 + 3], dtype=torch.int32)
    if layout is None:
        int32 = parts.sum().reshape(1).to(torch.int32)
    else:
        tp = layout.tp_group
        shard_module(mod, layout)
        cols = n['width'] // tp.size
        x = x[:, tp.rank * cols:(tp.rank + 1) * cols]
        int32 = tp.sum_int32(parts[tp.rank:tp.rank + 1])
    with torch.inference_mode():
        mod['proj'].q8 = mod['proj'].quantize(x_scale)
        mod['head_bot'].q8 = mod['head_bot'].quantize(h_scale)
        return {'row': mod['proj'](x, int8=True),
                'vocab': mod['head_bot'](h, int8=True), 'int32': int32}


def calibrations(layout):
    """The int8 scales calibrated under `layout` (None: tp 1), f32:
    {'2-level' | '3-level': {collection: {name: scale}}}, the KV scales of
    a sampling run and the activation scales of the teacher-forced
    forward on seeded codes, of the tiny two-stage config and the 3-level
    tiny config."""
    labels = torch.arange(8) % 10
    g = torch.Generator().manual_seed(10)
    tm = TwoStageModel(build_twostage_config(TINY2), device='cpu',
                       layout=layout)
    weights = tm.init_weights(0)
    two = tm.calibrate_kv_scales(
        weights, torch.Generator().manual_seed(9), labels,
        SamplingParams(top_k_top=16, top_k_bot=16))
    two.update(tm.calibrate_stage2_int8(
        weights, torch.randint(0, 256, (8, 16), generator=g),
        torch.randint(0, 256, (8, 64), generator=g), labels))
    tm = TwoStageModel(level3_config(), device='cpu', layout=layout)
    weights = tm.init_weights(1)
    three = tm.calibrate_kv_scales(weights, torch.Generator().manual_seed(11),
                                   labels, (LevelSampling(top_k=8),) * 3)
    maps = [torch.randint(0, v, (8, t), generator=g)
            for v, t in ((32, 16), (48, 64), (64, 256))]
    three.update(tm.calibrate_stage2_int8(weights, maps, labels))
    return {'2-level': two, '3-level': three}


def int8_scores(inputs, layout, path):
    """The tiny two-stage config's bf16 scorer (weights from JAX) on the
    scorer's codes, in bf16 and in int8max with the scales artifact at
    `path`: {'bf16_scores' | 'int8_scores': (logits_top, logits_bot)},
    this rank's dp shard."""
    tm = TwoStageModel(build_twostage_config(TINY2), dtype=torch.bfloat16,
                       device='cpu', layout=layout)
    tm.load_weights(inputs['bf16_weights'])
    scales = load_serving_scales(path)
    args = (inputs['score_labels'], inputs['score8_top'],
            inputs['score8_cells'])
    return {'bf16_scores': make_hierarchical_scorer(tm.stage2, 16)(*args),
            'int8_scores': make_hierarchical_scorer(
                tm.stage2, 16, q8.INT8MAX, scales)(*args)}


def wait_for(path, seconds=300):
    """Wait until `path` exists (the test writes it, then renames it into
    place); raise TimeoutError after `seconds`."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > seconds:
            raise TimeoutError(f'{path} did not appear in {seconds} s')
        time.sleep(0.2)


def int8_serving(inputs, layout, out):
    """Every int8-serving result of this rank (the module docstring), once
    the test has written the tp-1 artifacts and `<dir>/INT8_INPUTS`."""
    path = os.path.join(out, INT8_INPUTS)
    wait_for(path)
    inputs = {**inputs, **torch.load(path, weights_only=False)}
    scales = {kind: load_serving_scales(os.path.join(out, f'kv_{kind}.pkl'))
              for kind in KV_KINDS}
    return {'int8_codes': int8_cache_codes(layout, inputs['parallel_sd'],
                                           scales),
            'a8w8': a8w8_products(layout), 'calib': calibrations(layout),
            **int8_scores(inputs, layout, os.path.join(out, 'scores8.pkl'))}


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
    parts = {'train': lambda: {'train': train(inputs, layout, out)},
             'remat': lambda: {'remat': one_step(layout, remat=True)},
             'soft': lambda: {'soft': one_step(layout, soft=1.0)},
             'text': lambda: {'text': text_step(layout)},
             'variants': lambda: {'variants': variant_codes(layout)},
             'sample': lambda: sample(inputs, layout),
             'int8 serving': lambda: int8_serving(inputs, layout, out)}
    held = {'layout': (layout.dp_rank, layout.tp_rank)}
    try:
        for name, part in parts.items():
            t0 = time.perf_counter()
            held.update(part())
            print(f'rank {rank}: {name} {time.perf_counter() - t0:.1f} s',
                  flush=True)
    finally:
        ddp.cleanup()
    torch.save(held, os.path.join(out, f'rank{rank}.pt'))
    t0 = time.perf_counter()
    run_cli(inputs, rank, world, cli_port, resume_port, out)
    print(f'rank {rank}: cli {time.perf_counter() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
