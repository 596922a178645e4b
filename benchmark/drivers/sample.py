"""The sampling driver: class-conditional generation through the port's
end-to-end sampler, `TwoStageModel.make_pixel_sampler` (2 code levels) or
`make_pixel_sampler_multilevel` (3), as the sampling CLI calls it:
fn(weights, generator, labels) -> (pixels, codes), bf16 serving weights.

Traffic file keys: `batch`; `top_k`, `temperature` and, optionally,
`top_p` (every level; with `top_p` the draws leave the sampling kernel
for plain ops, as the port routes them); `decode_chunk`; `label_batches`
(a ring of that many label batches, uniform over the classes, made on
the device from the seed before the window).

One caller, closed loop: calls back to back, each ending in a
synchronisation (the CLI reads every batch's pixels back). Set-up makes
the weights and labels, builds the sampler and warms it up with one
call. The window runs whole calls until `seconds` have passed;
samples_per_s is the samples completed over the time from the window's
start to the last completion.

The comparison, on the window's own draws: `check_rows` rows drawn from
the seed among the rows the window's calls served. The reference's
teacher-forced logits over their codes judge every served token: in
the reference's top-k set (`topk_gap`) and, with `top_p`, in its nucleus
at the temperature (`topp_excess`); its float32 stage-1 decode of the
same codes judges the pixels (`pixel_rel_rms`). The control draws in the
program's place at each position of the same codes, by the same rule,
from the reference's logits in the lower precision.
"""

from __future__ import annotations

import math
import time

import torch

from hqbench import check, program
from hqbench import weights as hqweights
from hqbench.run_context import Outcome, Run
from hqbench.spans import Spans, patched, swapped
from hqbench.trace import profile
from reference import lowp, stage1 as ref1, stage2 as ref2

PROFILED_CALL = 1      # the window call the traced run profiles
NUMBERS = ('codes_out_of_range', 'topk_gap', 'pixel_rel_rms')
REF_ROWS = 4           # rows of one reference block


def _levels(config: dict) -> int:
    return 3 if config['model']['stage2']['type'].startswith(
        'multilevel-hq') else 2


def numbers(traffic: dict) -> tuple:
    """The names of the numbers a cell of this traffic compares."""
    return NUMBERS + (('topp_excess',) if traffic.get('top_p') is not None
                      else ())


def _knobs(traffic: dict):
    """(top_k, temperature, top_p or None) of every level."""
    p = traffic.get('top_p')
    return (int(traffic['top_k']), float(traffic['temperature']),
            None if p is None else float(p))


def _sampler(model, levels: int, traffic: dict):
    """The sampler with the traffic's knobs."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams
    k, T, p = _knobs(traffic)
    chunk = int(traffic['decode_chunk'])
    if levels == 3:
        return model.make_pixel_sampler_multilevel(
            top_k=(k,) * 3, top_p=(p,) * 3, temperature=(T,) * 3,
            decode_chunk=chunk)
    return model.make_pixel_sampler(params=SamplingParams(
        top_k_top=k, top_k_bot=k, top_p_top=p, top_p_bot=p,
        temperature_top=T, temperature_bot=T), decode_chunk=chunk)


def _install_fault(fault: str, model, stack) -> None:
    """Faults the harness tests plant in the timed path."""
    from hqtransformer_tpu_torch.sampling import engine
    if fault == 'token':
        draw = engine.sample_from_logits

        def altered(generator, logits, **kw):
            return (draw(generator, logits, **kw) + 1) % logits.shape[-1]
        stack.enter_context(swapped(engine, 'sample_from_logits', altered))
    elif fault == 'state':
        def unchanged(x, k_caches, v_caches, pos, int8=False):
            return model.stage2.ln_f(x)
        stack.enter_context(swapped(model.stage2, 'spatial_step', unchanged))
    elif fault != 'half_batch':
        raise ValueError(f'no fault {fault!r} for sampling')


def _half_batch(fn):
    """The batch's second half left out: its rows are the first half's."""
    def call(weights, generator, labels):
        B = labels.shape[0]
        pixels, codes = fn(weights, generator, labels[:B // 2])
        return (torch.cat([pixels, pixels]),
                tuple(torch.cat([c, c]) for c in codes))
    return call


def run(r: Run) -> Outcome:
    import contextlib
    from hqtransformer_tpu_torch.models import twostage
    out = Outcome()
    traffic, config = r.cell.traffic, r.cell.config
    levels = _levels(config)
    B = int(traffic['batch'])
    dev = r.device
    model = program.model(config, dev)
    plan = hqweights.plan(model)
    weights = hqweights.make(plan, r.seed, dev, serving=True)
    n_classes = int(config['model']['stage2']['hparams']['n_classes'])
    gen = torch.Generator(device=dev).manual_seed(int(r.seed) % 2 ** 63)
    labels = torch.randint(0, n_classes, (int(traffic['label_batches']), B),
                           generator=gen, device=dev)
    picker = torch.Generator().manual_seed(int(r.seed) % 2 ** 63)
    spans = Spans(dev)
    with contextlib.ExitStack() as stack:
        if r.trace:
            make_loop = ('make_multilevel_sampler' if levels == 3 else
                         'make_hierarchical_sampler')
            real = getattr(twostage, make_loop)
            stack.enter_context(swapped(twostage, make_loop, lambda *a, **k:
                                      spans.wrap('ar_loop', real(*a, **k))))
            stack.enter_context(patched(model.stage1, 'decode_code', spans,
                                        'decode'))
        if r.fault:
            _install_fault(r.fault, model, stack)
        sampler = _sampler(model, levels, traffic)
        if r.fault == 'half_batch':
            sampler = _half_batch(sampler)
        # one call loads every kernel the window runs
        sampler(weights, gen, labels[-1])
        program.sync(dev)
        out.setup_s = time.perf_counter() - r.t_start

        rows = int(r.cell.workload['check_rows'])
        kept = []          # (labels, codes, pixels) of served rows
        calls = []         # (seconds, samples, profiled)
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = t_last = time.perf_counter()
        i, profiled_s = 0, 0.0
        # a traced run's window leaves out the profiled call and the
        # profiler's own work after it
        while i == 0 or t_last - t0 - profiled_s < r.seconds:
            lab = labels[i % labels.shape[0]]
            pick = torch.randperm(B, generator=picker)[:rows].to(dev)

            def one():
                pixels, codes = sampler(weights, gen, lab)
                program.sync(dev)
                kept.append((lab[pick], [c[pick] for c in codes],
                             pixels[pick].clone()))
                return B
            t_call = time.perf_counter()
            profiled = r.trace and i == PROFILED_CALL
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
        out.info.update(_shape_info(config, traffic, weights, kept[0][1],
                                    calls))
    out.checks, out.info['control'] = compare(r, config, weights, kept,
                                              levels, picker)
    return out


def _shape_info(config, traffic, weights, codes, calls) -> dict:
    """What the per-layer readers need, from the config and the shapes of
    served codes (top [B, N], then each level's [B, N, n]): a call's
    positions N, the rows a position draws per sample (1, 4 or 1, 4, 16)
    and the model FLOPs of a sample."""
    from hqbench import counts
    s2 = config['model']['stage2']
    n = codes[0].shape[1]
    code_lens = [1] + [c.shape[-1] for c in codes[1:]]
    side = math.isqrt(n)
    sides = [side] + [side * math.isqrt(k) for k in code_lens[1:]]
    flops = counts.stage2_forward_flops(weights['stage2'], s2, n, code_lens) \
        + counts.decode_flops(weights['stage1'], sides)
    hp = s2['hparams']
    return {'batch': int(traffic['batch']), 'positions': n,
            'layers': int(hp['n_layers']), 'width': int(hp['embed_dim']),
            'vocab': int(s2['vocab_size_img']), 'draw_rows': code_lens,
            'flops_per_unit': flops, 'calls': calls}


def _rows(kept, rows: int, picker):
    """`rows` of the window's kept rows, drawn from the seed; the labels
    and per-level codes stacked."""
    labels = torch.cat([k[0] for k in kept])
    codes = [torch.cat([k[1][li] for k in kept]) for li in
             range(len(kept[0][1]))]
    pixels = torch.cat([k[2] for k in kept])
    pick = torch.randperm(labels.shape[0], generator=picker)[:rows]
    pick = pick.to(labels.device)
    return labels[pick], [c[pick] for c in codes], pixels[pick]


def _draw_numbers(ref, served, knobs) -> dict:
    """The draw's numbers of one block: served codes against the
    reference's logits, level by level (the widest)."""
    k, T, p = knobs
    got = {'topk_gap': max(check.topk_gap(lg, c, k)
                           for lg, c in zip(ref, served))}
    if p is not None:
        got['topp_excess'] = max(check.topp_excess(lg, c, k, T, p)
                                 for lg, c in zip(ref, served))
    return got


def compare(r: Run, config: dict, weights, kept, levels: int, picker):
    """The reference's numbers on the kept rows, and with `r.control` the
    control's (else {})."""
    limits = r.cell.workload['limits']
    s2 = config['model']['stage2']
    vocab = int(s2['vocab_size_img'])
    knobs = _knobs(r.cell.traffic)
    if not kept:
        return {'calls': check.number(0, -1)}, {}
    labels, codes, pixels = _rows(kept, int(r.cell.workload['check_rows']),
                                  picker)
    numbers = {'codes_out_of_range': check.number(
        check.out_of_range(codes, [vocab] * levels),
        limits['codes_out_of_range'])}
    if numbers['codes_out_of_range']['value']:
        return numbers, {}
    side = math.isqrt(codes[0].shape[1])
    w1 = weights['stage1']
    ctl_gen = torch.Generator(device=labels.device).manual_seed(
        int(r.seed) % 2 ** 63)
    got, ctl_got, ref_px, ctl_px = [], [], [], []
    with torch.no_grad(), lowp.no_tf32():
        for i in range(0, labels.shape[0], REF_ROWS):
            sl = slice(i, i + REF_ROWS)
            block = [c[sl] for c in codes]
            ref = ref2.forward(weights['stage2'], s2, labels[sl], block)
            got.append(_draw_numbers(ref, block, knobs))
            maps = [block[0].reshape(-1, side, side)] + [
                ref2.cells_to_raster(c, side, 2 ** li)
                for li, c in enumerate(block) if li]
            ref_px.append(ref1.decode(w1, maps))
            if r.control:
                rnd = lowp.PRECISIONS[r.control]
                ctl = ref2.forward(weights['stage2'], s2, labels[sl], block,
                                   rnd)
                drawn = [check.draw(lg, *knobs, ctl_gen) for lg in ctl]
                ctl_got.append(_draw_numbers(ref, drawn, knobs))
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
