"""The benchmark's plain text reference (`reference/stage2_txt.py`) against
the port on the CPU, at the tiny text configuration (`data/tiny-txt.json`),
in float32: the teacher-forced forward, and the greedy text sampler's codes
as the reference's argmax on their own codes."""

import json
import math
from pathlib import Path

import torch

from hqbench import program, weights
from reference import stage2 as ref2, stage2_txt as ref_txt

DATA = Path(__file__).resolve().parent / 'data'
CPU = torch.device('cpu')


def _model():
    cfg = json.loads((DATA / 'tiny-txt.json').read_text())
    cfg['precision'] = 'float32'
    model = program.model(cfg, CPU)
    w = weights.make(weights.plan(model), 3, CPU, serving=False)
    model.load_weights(w)
    return cfg['model'], model, w


def _ids(g, B, S=8):
    ids = torch.randint(1, 32, (B, S), generator=g)
    ids[0, 3:] = 0            # a caption padded with the pad id
    return ids


def test_text_forward():
    cfg, model, w = _model()
    g = torch.Generator().manual_seed(0)
    B, N, V = 3, 16, 64
    top = torch.randint(0, V, (B, N), generator=g)
    bots = torch.randint(0, V, (B, N, 4), generator=g)
    ids = _ids(g, B)
    side = math.isqrt(N)
    raster = ref2.cells_to_raster(bots, side, 2).reshape(B, -1)
    with torch.no_grad():
        lt, lb, _ = model.stage2(top, raster, ids)
        rt, rb = ref_txt.forward_2level(w['stage2'], cfg['stage2'], ids, top,
                                        bots)
    torch.testing.assert_close(rt, lt, atol=2e-5, rtol=0)
    rb = rb.reshape(B, side, side, 2, 2, V).permute(0, 1, 3, 2, 4, 5)
    torch.testing.assert_close(rb.reshape(B, -1, V), lb, atol=2e-5, rtol=0)


def test_greedy_text_samples_have_no_gap():
    """The port's greedy text sampler in float32: every served code is the
    reference's argmax on its own codes and caption."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams
    cfg, model, w = _model()
    ids = _ids(torch.Generator().manual_seed(1), 2)
    fn = model.make_pixel_sampler(params=SamplingParams(top_k_top=1,
                                                        top_k_bot=1))
    _, codes = fn(w, torch.Generator().manual_seed(2), ids)
    with torch.no_grad():
        ref = ref_txt.forward(w['stage2'], cfg['stage2'], ids, list(codes))
    for logits, c in zip(ref, codes):
        best = logits.amax(-1)
        assert torch.allclose(logits.gather(-1, c[..., None].long())[..., 0],
                              best, atol=1e-5, rtol=0)
