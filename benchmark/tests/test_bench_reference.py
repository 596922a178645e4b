"""The benchmark's plain reference against the port on the CPU, at tiny
sizes, in float32: the 2- and 3-level stage-2 teacher-forced forwards,
both stage-1 decoders, the 2-level encoder's codes, and the training
step."""

import json
import math
from pathlib import Path

import pytest
import torch

from hqbench import program, weights
from reference import stage1 as ref1, stage2 as ref2, train as ref_train

DATA = Path(__file__).resolve().parent / 'data'
CPU = torch.device('cpu')


def _model(name):
    cfg = json.loads((DATA / f'{name}.json').read_text())
    cfg['precision'] = 'float32'
    model = program.model(cfg, CPU)
    w = weights.make(weights.plan(model), 3, CPU, serving=False)
    model.load_weights(w)
    return cfg['model'], model, w


def _to_raster(x, side, win):
    """Logits [B, N, win^2, V] in cell order -> raster [B, N win^2, V]."""
    B, V = x.shape[0], x.shape[-1]
    x = x.reshape(B, side, side, win, win, V).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, V)


def test_two_levels():
    cfg, model, w = _model('tiny-l2')
    g = torch.Generator().manual_seed(0)
    B, N, V = 3, 16, 256
    top = torch.randint(0, V, (B, N), generator=g)
    bots = torch.randint(0, V, (B, N, 4), generator=g)
    labels = torch.randint(0, 10, (B,), generator=g)
    side = math.isqrt(N)
    raster = ref2.cells_to_raster(bots, side, 2).reshape(B, -1)
    with torch.no_grad():
        lt, lb = model.stage2(top, raster, labels)
        rt, rb = ref2.forward_2level(w['stage2'], cfg['stage2'], labels, top,
                                     bots)
        torch.testing.assert_close(rt, lt, atol=2e-5, rtol=0)
        torch.testing.assert_close(_to_raster(rb, side, 2), lb, atol=2e-5,
                                   rtol=0)
        maps = [top.reshape(B, side, side), raster.reshape(B, 8, 8)]
        pixels = (model.stage1.decode_code(*maps) * 0.5 + 0.5).clamp(0, 1)
        torch.testing.assert_close(ref1.decode(w['stage1'], maps), pixels,
                                   atol=1e-5, rtol=0)
        images = torch.rand((B, 32, 32, 3), generator=g) * 2 - 1
        for a, b in zip(model.stage1.get_codes(images),
                        ref1.encode_2level(w['stage1'], images)):
            assert torch.equal(a, b)


def test_three_levels():
    cfg, model, w = _model('tiny-level3')
    g = torch.Generator().manual_seed(1)
    B, N, V = 2, 16, 64
    codes = [torch.randint(0, V, (B, N) + s, generator=g)
             for s in ((), (4,), (16,))]
    labels = torch.randint(0, 10, (B,), generator=g)
    maps = [codes[0]] + [ref2.cells_to_raster(c, 4, 2 ** i).reshape(B, -1)
                         for i, c in enumerate(codes) if i]
    with torch.no_grad():
        got = model.stage2(maps, labels)
        ref = ref2.forward_3level(w['stage2'], cfg['stage2'], labels, *codes)
        torch.testing.assert_close(ref[0], got[0], atol=2e-5, rtol=0)
        for li in (1, 2):
            torch.testing.assert_close(_to_raster(ref[li], 4, 2 ** li),
                                       got[li], atol=2e-5, rtol=0)
        sides = [m.reshape(B, 4 * 2 ** i, 4 * 2 ** i)
                 for i, m in enumerate(maps)]
        pixels = (model.stage1.decode_code(sides) * 0.5 + 0.5).clamp(0, 1)
        torch.testing.assert_close(ref1.decode(w['stage1'], sides), pixels,
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['tiny-l2', 'tiny-level3'])
def test_greedy_samples_have_no_gap(name):
    """The port's greedy sampler in float32: every served code is the
    reference's argmax on its own codes."""
    cfg, model, w = _model(name)
    labels = torch.tensor([1, 7])
    gen = torch.Generator().manual_seed(2)
    if name == 'tiny-l2':
        from hqtransformer_tpu_torch.sampling.engine import SamplingParams
        fn = model.make_pixel_sampler(params=SamplingParams(
            top_k_top=1, top_k_bot=1))
    else:
        fn = model.make_pixel_sampler_multilevel(top_k=(1, 1, 1))
    _, codes = fn(w, gen, labels)
    with torch.no_grad():
        ref = ref2.forward(w['stage2'], cfg['stage2'], labels, list(codes))
    for logits, c in zip(ref, codes):
        best = logits.amax(-1)
        assert torch.allclose(logits.gather(-1, c[..., None].long())[..., 0],
                              best, atol=1e-5, rtol=0)


def test_training_step():
    """Three float32 steps of the port's train step against the
    reference's: losses, the first clipped gradient and the change."""
    from hqtransformer_tpu_torch.train import stage2 as tr2
    from hqtransformer_tpu_torch.train.scheduler import \
        build_schedule_from_config
    cfg, model, w = _model('tiny-l2')
    w = weights.make(weights.plan(model), 3, CPU, serving=False)
    conf = model.config
    schedule = build_schedule_from_config(conf.optimizer, 100, 1000, 8)
    opt = tr2.make_optimizer(conf.optimizer, schedule, 1,
                             mask=tr2.decay_mask(model.stage2))
    step = tr2.make_train_step(model.stage2,
                               model.stage1.requires_grad_(False), opt)
    state = tr2.init_train_state(model.stage2, opt)
    g = torch.Generator().manual_seed(4)
    batches = [(torch.rand((2, 32, 32, 3), generator=g) * 2 - 1,
                torch.randint(0, 10, (2,), generator=g)) for _ in range(3)]
    start = {k: p.detach().clone() for k, p in state.params.items()}
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(state, x, y)[1]['loss']))
        if i == 0:
            grad = {k: float(m.norm()) / (1 - opt.b1)
                    for k, m in state.opt_state.mu.items()}
    codes = []
    for x, y in batches:
        code_t, code_b = ref1.encode_2level(w['stage1'], x)
        codes.append(([code_t.reshape(2, -1), ref2.raster_to_cells(
            code_b.reshape(2, -1), 4, 2)], y))
    ref = ref_train.train_steps(w['stage2'], cfg, codes, warmup_steps=100.0)
    assert ref['losses'] == pytest.approx(losses, rel=1e-5)
    for k, v in ref['first_grad'].items():
        assert grad[k] == pytest.approx(v, rel=1e-3, abs=1e-9), k
    # leaves whose gradient is nought to rounding (a key's bias under the
    # softmax) move under Adam by round-off alone: left out, as the
    # benchmark leaves them out
    median = sorted(ref['first_grad'].values())[len(grad) // 2]
    moved = [k for k, v in ref['first_grad'].items() if v >= 1e-3 * median]
    assert 'blocks.0.attn.key.bias' not in moved
    for k in moved:
        change = float((state.params[k].detach() - start[k]).norm())
        assert change == pytest.approx(ref['change'][k], rel=2e-2), k
