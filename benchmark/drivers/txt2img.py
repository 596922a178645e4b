"""The text-to-image driver: caption-conditioned generation through the
port's end-to-end sampler, `TwoStageModel.make_pixel_sampler` with caption
ids [B, ctx_len_txt] as its labels, as the txt2img CLI calls it:
fn(weights, generator, ids) -> (pixels, codes), bf16 serving weights.

Traffic file keys: `batch`, made of `captions` x `candidates` rows (the
candidates of a caption are adjacent rows sharing its ids, as the CLI's
`--clip-rerank` draws them); `caption_len` [lo, hi]: each caption's length
uniform on lo..hi tokens, its ids uniform over the text vocabulary but the
tokenizer's pad id 0, padded with 0 to ctx_len_txt (the model attends over
every row, as it does for real captions); `top_k`, `temperature` (both
levels); `decode_chunk`; `caption_batches` (a ring of that many caption
batches, made on the device from the seed before the window).

Set-up, window, kept rows and the comparison are `sample.py`'s, whose
helpers this driver imports, but for where the kept rows wait: in host
memory, so that the device's peak does not grow with the calls a run
completes (a faster program would read a higher peak). The reference
takes them back to the device after the window. The reference is the
text model's (`reference/stage2_txt.py`): its logits judge each served token
(`topk_gap`), its float32 stage-1 decode the pixels (`pixel_rel_rms`).
The faults are `sample.py`'s (`token`, `state`, `half_batch`) and
`caption`: each row served under the caption of the next group of
`candidates` rows, while the check holds it to its own.
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import torch

from hqbench import check, counts, program
from hqbench import weights as hqweights
from hqbench.manifest import load_module
from hqbench.run_context import Outcome, Run
from hqbench.spans import Spans, patched, swapped
from hqbench.trace import profile
from reference import lowp, stage1 as ref1, stage2 as ref2
from reference import stage2_txt as ref_txt

sample = load_module(Path(__file__).with_name('sample.py'),
                     'hqbench_driver_sample')
numbers = sample.numbers   # the names of the numbers a cell compares
PAD_ID = 0                 # the caption tokenizer's pad id


def captions(traffic: dict, s2: dict, generator: torch.Generator
             ) -> torch.Tensor:
    """The ring of caption batches [caption_batches, batch, ctx_len_txt]
    on the generator's device: each caption's ids repeated over its
    `candidates` adjacent rows."""
    n, c = int(traffic['captions']), int(traffic['candidates'])
    if n * c != int(traffic['batch']):
        raise ValueError(f'{n} captions x {c} candidates is not the batch '
                         f'{traffic["batch"]}')
    ring = int(traffic['caption_batches'])
    ctx = int(s2['hparams']['ctx_len_txt'])
    lo, hi = (int(x) for x in traffic['caption_len'])
    dev = generator.device
    lens = torch.randint(lo, hi + 1, (ring, n, 1), generator=generator,
                         device=dev)
    ids = torch.randint(PAD_ID + 1, int(s2['vocab_size_txt']),
                        (ring, n, ctx), generator=generator, device=dev)
    ids = ids.masked_fill(torch.arange(ctx, device=dev) >= lens, PAD_ID)
    return ids.repeat_interleave(c, dim=1)


def _caption_fault(fn, candidates: int):
    """Each row served under the next caption group's ids."""
    def call(weights, generator, ids):
        return fn(weights, generator, ids.roll(candidates, 0))
    return call


def run(r: Run) -> Outcome:
    from hqtransformer_tpu_torch.models import twostage
    out = Outcome()
    traffic, config = r.cell.traffic, r.cell.config
    s2 = config['model']['stage2']
    B = int(traffic['batch'])
    dev = r.device
    model = program.model(config, dev)
    weights = hqweights.make(hqweights.plan(model), r.seed, dev,
                             serving=True)
    gen = torch.Generator(device=dev).manual_seed(int(r.seed) % 2 ** 63)
    ids = captions(traffic, s2, gen)
    picker = torch.Generator().manual_seed(int(r.seed) % 2 ** 63)
    spans = Spans(dev)
    with contextlib.ExitStack() as stack:
        if r.trace:
            real = twostage.make_hierarchical_sampler
            stack.enter_context(swapped(
                twostage, 'make_hierarchical_sampler', lambda *a, **k:
                spans.wrap('ar_loop', real(*a, **k))))
            stack.enter_context(patched(model.stage1, 'decode_code', spans,
                                        'decode'))
            stack.enter_context(patched(model.stage2, 'spatial_prefill',
                                        spans, 'prefill'))
        if r.fault not in (None, 'caption'):
            sample._install_fault(r.fault, model, stack)
        sampler = sample._sampler(model, 2, traffic)
        if r.fault == 'half_batch':
            sampler = sample._half_batch(sampler)
        elif r.fault == 'caption':
            sampler = _caption_fault(sampler, int(traffic['candidates']))
        # one call loads every kernel the window runs
        sampler(weights, gen, ids[-1])
        program.sync(dev)
        out.setup_s = time.perf_counter() - r.t_start

        rows = int(r.cell.workload['check_rows'])
        kept = []          # (ids, codes, pixels) of served rows, on the host
        calls = []         # (seconds, samples, profiled)
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = t_last = time.perf_counter()
        i, profiled_s = 0, 0.0
        # a traced run's window leaves out the profiled call and the
        # profiler's own work after it
        while i == 0 or t_last - t0 - profiled_s < r.seconds:
            cap = ids[i % ids.shape[0]]
            pick = torch.randperm(B, generator=picker)[:rows].to(dev)

            def one():
                pixels, codes = sampler(weights, gen, cap)
                program.sync(dev)
                kept.append((cap[pick].cpu(), [c[pick].cpu() for c in codes],
                             pixels[pick].cpu()))
                return B
            t_call = time.perf_counter()
            profiled = r.trace and i == sample.PROFILED_CALL
            if profiled:
                out.trace = profile(one, dev)
            else:
                spans.on = r.trace
                one()
                spans.on = False
            t_last = time.perf_counter()
            profiled_s += (t_last - t_call) * profiled
            calls.append((t_last - t_call, B, profiled))
            out.attempted += B
            i += 1
        out.window_s = t_last - t0
        out.units = out.attempted
        if dev.type == 'cuda':
            out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        del sampler
    del model
    program.free(dev)

    out.rates['samples_per_s'] = out.units / out.window_s
    out.rates['peak_mem_gib'] = out.memory_peak_bytes / 2 ** 30
    out.spans = dict(spans.durations)
    if r.trace and kept:
        out.info.update(shape_info(config, traffic, weights, kept[0][0],
                                   kept[0][1], calls))
    out.checks, out.info['control'] = compare(r, config, weights, kept,
                                              picker)
    return out


def sample_flops(weights, config: dict, prefix: int, cells: int,
                 ratio: int) -> int:
    """FLOPs of one sample: the text reference's teacher-forced stage-2
    forward over the prefix's and the cells' rows (`prefix` caption rows,
    `cells` cells of 1 + `ratio` codes), and the stage-1 decode, counted on
    shapes alone (meta tensors), as `counts.stage2_forward_flops` counts
    the class-conditional model's."""
    s2 = config['model']['stage2']
    w = counts._meta(weights['stage2'])
    with torch.device('meta'):
        ids = torch.zeros((1, prefix), dtype=torch.long)
        codes = [torch.zeros((1, cells), dtype=torch.long),
                 torch.zeros((1, cells, ratio), dtype=torch.long)]
    side = math.isqrt(cells)
    return counts._count(lambda: ref_txt.forward(w, s2, ids, codes)) + \
        counts.decode_flops(weights['stage1'],
                            [side, side * math.isqrt(ratio)])


def shape_info(config, traffic, weights, ids, codes, calls) -> dict:
    """What the per-layer readers need: `sample.py`'s keys, from the
    config and the shapes of served codes (top [B, N], bottoms
    [B, N, r]), and `prefix`, the caption's rows."""
    s2 = config['model']['stage2']
    hp = s2['hparams']
    n, r = codes[1].shape[1:]
    prefix = ids.shape[1]
    return {'batch': int(traffic['batch']), 'positions': n,
            'layers': int(hp['n_layers']), 'width': int(hp['embed_dim']),
            'vocab': int(s2['vocab_size_img']), 'draw_rows': [1, r],
            'prefix': prefix,
            'flops_per_unit': sample_flops(weights, config, prefix, n, r),
            'calls': calls}


def compare(r: Run, config: dict, weights, kept, picker):
    """The reference's numbers on the kept rows, and with `r.control` the
    control's (else {}), as `sample.compare` makes them."""
    limits = r.cell.workload['limits']
    s2 = config['model']['stage2']
    knobs = sample._knobs(r.cell.traffic)
    if not kept:
        return {'calls': check.number(0, -1)}, {}
    ids, codes, pixels = sample._rows(kept, int(r.cell.workload['check_rows']),
                                      picker)
    ids, pixels = ids.to(r.device), pixels.to(r.device)
    codes = [c.to(r.device) for c in codes]
    vocab = int(s2['vocab_size_img'])
    numbers = {'codes_out_of_range': check.number(
        check.out_of_range(codes, [vocab] * 2),
        limits['codes_out_of_range'])}
    if numbers['codes_out_of_range']['value']:
        return numbers, {}
    side = math.isqrt(codes[0].shape[1])
    w1 = weights['stage1']
    ctl_gen = torch.Generator(device=ids.device).manual_seed(
        int(r.seed) % 2 ** 63)
    got, ctl_got, ref_px, ctl_px = [], [], [], []
    with torch.no_grad(), lowp.no_tf32():
        for i in range(0, ids.shape[0], sample.REF_ROWS):
            sl = slice(i, i + sample.REF_ROWS)
            block = [c[sl] for c in codes]
            ref = ref_txt.forward(weights['stage2'], s2, ids[sl], block)
            got.append(sample._draw_numbers(ref, block, knobs))
            maps = [block[0].reshape(-1, side, side),
                    ref2.cells_to_raster(block[1], side,
                                         math.isqrt(block[1].shape[-1]))]
            ref_px.append(ref1.decode(w1, maps))
            if r.control:
                rnd = lowp.PRECISIONS[r.control]
                ctl = ref_txt.forward(weights['stage2'], s2, ids[sl], block,
                                      rnd)
                drawn = [check.draw(lg, *knobs, ctl_gen) for lg in ctl]
                ctl_got.append(sample._draw_numbers(ref, drawn, knobs))
                ctl_px.append(ref1.decode(w1, maps, rnd))
                del ctl
            del ref
    ref_px = torch.cat(ref_px)
    for name in got[0]:
        numbers[name] = check.number(max(g[name] for g in got),
                                     limits[name])
    numbers['pixel_rel_rms'] = check.number(
        check.rel_rms(pixels.float(), ref_px), limits['pixel_rel_rms'])
    control = {}
    if r.control:
        control = {name: check.number(max(g[name] for g in ctl_got),
                                      limits[name]) for name in ctl_got[0]}
        control['pixel_rel_rms'] = check.number(
            check.rel_rms(torch.cat(ctl_px), ref_px),
            limits['pixel_rel_rms'])
    return numbers, control
