"""The training driver: stage-2 training steps through the port's
`train/stage2.py::make_train_step`, as `cli.main_stage2 --bf16` builds it
(bf16 activations on float32 parameters; the frozen stage 1's codes from
K3; AdamW with the configuration's optimizer and decay mask; the
warmup-cosine schedule), on images made on the device from the seed.

Traffic file keys: `batch` (the configuration's local batch);
`data_parallel` and `train_images` (the deployment the schedule is read
for: each card takes `batch` images of a global batch of batch x
data_parallel, one update a step, so `accum_steps` is 1); `image_batches`
(a ring of that many batches of images uniform in [-1, 1) and labels
uniform over the classes, made on the device from the seed); `checked_steps`
(the first steps the reference follows); `sync_every` (the window's steps
between synchronisations: the CLI reads its metrics back every 50 steps);
`tf32_cudnn` and `tf32_matmul` (the card's TF32 settings as the CLI leaves
them).

Set-up builds one train step with its model and optimizer state and
drives it through its first `checked_steps` steps on distinct batches,
reading each step's loss, the first step's gradient (from Adam's first
moment after one update, mu / (1 - b1)) and every parameter's change
after the last of them. The same object then runs the window: blocks of
`sync_every` whole steps, each block ending in a synchronisation, until
`seconds` have passed; train_images_per_s is the images of the window's
steps over the time from its start to the last block's end.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import torch

from hqbench import check, program
from hqbench import weights as hqweights
from hqbench.run_context import Outcome, Run
from hqbench.spans import Spans, patched, swapped
from hqbench.trace import profile
from reference import lowp, stage1 as ref1, stage2 as ref2
from reference import train as ref_train

PROFILED_STEPS = 3         # steps the traced run profiles, after one block
NUMBERS = ('codes_rows_missing', 'code_gap', 'code_mismatch', 'grad_gap',
           'change_gap')       # the numbers compared, each with its limit
SMALL_GRAD = 1e-3          # leaves below this share of the median gradient


def numbers(traffic: dict) -> tuple:
    """The names of the numbers a cell of this traffic compares."""
    return NUMBERS


def _steps_per_epoch(traffic: dict) -> int:
    return int(traffic['train_images']) // (int(traffic['batch']) *
                                            int(traffic['data_parallel']))


def _install_fault(fault: str, opt, stack) -> None:
    """Faults the harness tests plant in the timed path."""
    from hqtransformer_tpu_torch.train import stage2 as tr2
    if fault == 'state':
        stack.enter_context(swapped(opt, 'update', lambda *a, **k: True))
    elif fault == 'token':
        codes_of = tr2.stage1_codes

        def altered(stage1, images, temp=None):
            codes, softs = codes_of(stage1, images, temp)
            vocab = stage1.quantize_b.n_embed
            return [codes[0], (codes[1] + 1) % vocab], softs
        stack.enter_context(swapped(tr2, 'stage1_codes', altered))
    elif fault != 'half_batch':
        raise ValueError(f'no fault {fault!r} for training')


def run(r: Run) -> Outcome:
    from hqtransformer_tpu_torch.train import stage2 as tr2
    from hqtransformer_tpu_torch.train.scheduler import \
        build_schedule_from_config
    out = Outcome()
    traffic, config = r.cell.traffic, r.cell.config
    dev = r.device
    torch.backends.cuda.matmul.allow_tf32 = bool(traffic['tf32_matmul'])
    torch.backends.cudnn.allow_tf32 = bool(traffic['tf32_cudnn'])
    model = program.model(config, dev)
    cfg = model.config
    plan = hqweights.plan(model)
    model.load_weights(hqweights.make(plan, r.seed, dev, serving=False))
    stage1 = model.stage1.requires_grad_(False)
    stage2 = model.stage2
    spe = _steps_per_epoch(traffic)
    schedule = build_schedule_from_config(
        cfg.optimizer, spe, spe * cfg.experiment.epochs,
        world_size=int(traffic['data_parallel']))
    opt = tr2.make_optimizer(cfg.optimizer, schedule, 1,
                             mask=tr2.decay_mask(stage2))
    s2 = cfg.stage2
    B = int(traffic['batch'])
    res = cfg.dataset.image_resolution
    n_classes = int(s2.hparams.n_classes)
    gen = torch.Generator(device=dev).manual_seed(int(r.seed) % 2 ** 63)
    n_ring = int(traffic['image_batches'])
    images = torch.rand((n_ring, B, res, res, 3), generator=gen,
                        device=dev) * 2 - 1
    labels = torch.randint(0, n_classes, (n_ring, B), generator=gen,
                           device=dev)
    spans = Spans(dev)
    n_checked = int(traffic['checked_steps'])
    with contextlib.ExitStack() as stack:
        if r.trace:
            stack.enter_context(patched(tr2, 'stage1_codes', spans,
                                        'stage1_codes'))
            stack.enter_context(patched(opt, 'update', spans, 'optimizer'))
        if r.fault:
            _install_fault(r.fault, opt, stack)
        train_step = tr2.make_train_step(
            stage2, stage1, opt, weight_bottom=s2.weight_bottom or 4.0,
            weight_img=s2.weight_img, weight_txt=s2.weight_txt,
            temp_soft_labels=s2.temp_soft_labels, use_cond=True,
            multilevel=False)
        state = tr2.init_train_state(stage2, opt)

        def step(i):
            x, y = images[i % n_ring], labels[i % n_ring]
            if r.fault == 'half_batch':
                x, y = x[:B // 2], y[:B // 2]
            return train_step(state, x, y)

        start = {k: p.detach().clone() for k, p in state.params.items()}
        losses, first_grad, codes = [], None, []
        encode = tr2.stage1_codes

        def kept(stage1, images, temp=None):
            out = encode(stage1, images, temp)
            codes.append([c.clone() for c in out[0]])
            return out
        with swapped(tr2, 'stage1_codes', kept):
            for i in range(n_checked):
                _, metrics = step(i)
                losses.append(float(metrics['loss']))
                if i == 0:
                    first_grad = {k: float(torch.linalg.vector_norm(m)) /
                                  (1 - opt.b1)
                                  for k, m in state.opt_state.mu.items()}
        change = {k: float(torch.linalg.vector_norm(
            p.detach() - start[k])) for k, p in state.params.items()}
        del start
        program.sync(dev)
        out.setup_s = time.perf_counter() - r.t_start

        calls = []
        every = int(traffic['sync_every'])
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = t_last = time.perf_counter()
        i, profiled_s = n_checked, 0.0
        # a traced run's window leaves out the profiled steps and the
        # profiler's own work after them
        while i == n_checked or t_last - t0 - profiled_s < r.seconds:
            t_call = time.perf_counter()
            profiled = r.trace and out.trace is None and i > n_checked
            k = PROFILED_STEPS if profiled else every

            def steps(first=i, k=k):
                for j in range(first, first + k):
                    step(j)
                program.sync(dev)
                return B * k
            if profiled:
                out.trace = profile(steps, dev)
            else:
                spans.on = r.trace
                steps()
                spans.on = False
            t_last = time.perf_counter()
            profiled_s += (t_last - t_call) * profiled
            calls.append((t_last - t_call, B * k, profiled))
            i += k
            out.attempted += B * k
        out.window_s = t_last - t0
        out.units = out.attempted
        if dev.type == 'cuda':
            out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        del train_step, state
    del model, stage1, stage2, opt
    program.free(dev)

    out.rates['train_images_per_s'] = out.units / out.window_s
    out.rates['peak_mem_gib'] = out.memory_peak_bytes / 2 ** 30
    out.spans = dict(spans.durations)
    got = {'losses': losses, 'first_grad': first_grad, 'change': change,
           'codes': codes}
    weights = hqweights.make(plan, r.seed, dev, serving=False)
    if r.trace:
        out.info.update(_shape_info(config, traffic, weights, calls))
    batches = [(images[i], labels[i]) for i in range(n_checked)]
    out.checks, out.info['control'] = compare(r, config, weights, batches,
                                              got, spe)
    return out


def _shape_info(config, traffic, weights, calls) -> dict:
    """What the per-layer readers need: the step's K3 searches and FLOPs
    per image (3 x the stage-2 forward and the frozen encoder's)."""
    from hqbench import counts
    m = config['model']
    res = int(m['dataset']['image_resolution'])
    w1 = weights['stage1']
    top, bottom = counts.code_sides(w1, res)
    n = top * top
    flops = 3 * counts.stage2_forward_flops(
        weights['stage2'], m['stage2'], n, (1, (bottom // top) ** 2)) \
        + counts.encode_flops(w1, res)
    B = int(traffic['batch'])
    e_t, e_b = w1['quantize_t.embedding'], w1['quantize_b.embedding']
    # bf16 z (the model's activations) against the f32 EMA codebooks
    k3 = [(B * n, e_t.shape[0], e_t.shape[1], 2, 4),
          (B * bottom * bottom, e_b.shape[0], e_b.shape[1], 2, 4)]
    return {'batch': B, 'flops_per_unit': flops, 'k3_calls': k3,
            'calls': calls}


def compare(r: Run, config: dict, weights, batches, got: dict, spe: int):
    """The reference's numbers against the program's readings, and with
    `r.control` the control's (else {}). The program's codes of the
    checked steps are judged by the reference's float32 latent; the
    reference's stage-2 steps then run on those codes, so that the
    stage-2 numbers measure the stage-2 step alone."""
    limits = r.cell.workload['limits']
    model = config['model']
    opt = model['optimizer']
    warmup = opt.get('warmup') or opt.get('warmup_config') or {}
    warm = float(warmup.get('warmup_epoch', 1.0)) * spe
    w1, w2 = weights['stage1'], weights['stage2']
    B = batches[0][0].shape[0]
    missing = sum(B - c[0].shape[0] for c in got['codes'])
    numbers = {'codes_rows_missing': check.number(
        missing, limits['codes_rows_missing'])}
    if missing:
        return numbers, {}
    rnd = lowp.PRECISIONS[r.control] if r.control else None
    gaps, ctl_gaps, steps = [], [], []
    with lowp.no_tf32(), torch.no_grad():
        for (images, labels), (code_t, code_b) in zip(batches, got['codes']):
            z = ref1.latent_2level(w1, images)
            side = math.isqrt(code_t.shape[1])
            maps = (code_t.reshape(B, side, side),
                    code_b.reshape(B, 2 * side, 2 * side))
            gaps.append(ref1.code_gaps(w1, z, *maps))
            if rnd is not None:
                ctl_gaps.append(ref1.code_gaps(
                    w1, z, *ref1.encode_2level(w1, images, rnd)))
            steps.append(([code_t, ref2.raster_to_cells(code_b, side, 2)],
                          labels))
    with lowp.no_tf32():
        ref = ref_train.train_steps(w2, model, steps, warm)
        ctl = ref_train.train_steps(w2, model, steps, warm, rnd) \
            if rnd is not None else None

    def judged(side, code_readings):
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(side['losses'], ref['losses']))
        grad, _ = check.leaf_gap(side['first_grad'], ref['first_grad'],
                                 ref['first_grad'])
        median = sorted(ref['first_grad'].values())[
            len(ref['first_grad']) // 2]
        moved = [k for k, v in ref['first_grad'].items()
                 if v >= SMALL_GRAD * median]
        change, _ = check.leaf_gap(side['change'], ref['change'], moved)
        return {'code_gap': max(g for g, _ in code_readings),
                'code_mismatch': max(m for _, m in code_readings),
                'loss_gap': loss, 'grad_gap': grad, 'change_gap': change}
    readings = judged(got, gaps)
    numbers.update({k: check.number(readings[k], limits[k])
                    for k in NUMBERS if k in readings})
    # the losses' gap separates from no control or fault reading: shown,
    # not compared (PERF.md)
    print(f'loss_gap (not compared): {readings["loss_gap"]!r}',
          file=sys.stderr)
    control = judged(ctl, ctl_gaps) if ctl else {}
    return numbers, {k: check.number(control[k], limits[k])
                     for k in NUMBERS if k in control}
