"""Stage-1 training: reconstruction, LPIPS and PatchGAN losses with the
adaptive discriminator weight, EMA codebook updates, and the two-optimizer
GAN step.

Counterpart of `hqtransformer_tpu/train/stage1.py`. One step:
1. generator phase: encode with one EMA codebook step (`update_ema`),
   decode, nll = rec + perceptual_weight * LPIPS, g = -mean D(dec); the
   adaptive weight d_weight = |d nll / dw| / (|d g / dw| + 1e-4), clipped
   to [0, 1e4], times `disc_weight`, both gradients w.r.t.
   `decoder.conv_out.weight` by `torch.autograd.grad` on the one forward
   (under data parallelism averaged over the ranks first, so d_weight is
   the global batch's, as in JAX); loss = nll + d_weight * factor * g +
   codebook_weight * quantizer loss [+ residual_l1_weight * the residual
   term]; factor is `disc_factor` from step `disc_start` on
   (`adopt_weight`); Adam on the generator's parameters;
2. discriminator phase: in the faithful mode (the reference's: Lightning
   runs the training step once per optimizer) the updated generator
   encodes again, a second EMA step, and its reconstruction is the fake;
   in the fast mode the first phase's; d_loss = factor * hinge (or
   vanilla) loss of D(x) and D(fake); Adam on the discriminator's.
`bottom_start` (the curriculum's bypass branch: the top codes' own
reconstruction joins the losses as `use_recon_top`, `use_perceptual_top`,
`use_adversarial_top` say) is fixed when the step is built, as in JAX.

The trainer owns the modules' parameters and EMA buffers
(`Stage1State`); the step moves them in place, counts the micro-step and
returns the metrics as device tensors. Losses reduce in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Stage1HparamsDisc
from ..models.stage1.layers import NLayerDiscriminator
from ..models.stage1.lpips import LPIPS
from ..parallel.ddp import all_reduce_mean, average_gradients
from .optim import OptState, Optimizer, grads_of, named_trainable
from .scheduler import Schedule

EMA_BUFFERS = ('embedding', 'cluster_size', 'embedding_avg')


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) +
                  torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) +
                  torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    """0 before step `threshold`, else `weight` (the disc warmup gate)."""
    return 0.0 if global_step < threshold else weight


def ema_buffers(generator: nn.Module) -> Dict[str, torch.Tensor]:
    """name -> EMA codebook buffer of `generator` (the modules' own)."""
    return {k: b for k, b in generator.named_buffers()
            if k.rsplit('.', 1)[-1] in EMA_BUFFERS}


@dataclass
class Stage1State:
    step: int
    gen_params: Dict[str, nn.Parameter]
    ema: Dict[str, torch.Tensor]
    disc_params: Dict[str, nn.Parameter]
    gen_opt_state: OptState
    disc_opt_state: OptState


def init_stage1_state(generator: nn.Module, discriminator: nn.Module,
                      gen_optimizer: Optimizer,
                      disc_optimizer: Optimizer) -> Stage1State:
    gp, dp = named_trainable(generator), named_trainable(discriminator)
    return Stage1State(0, gp, ema_buffers(generator), dp,
                       gen_optimizer.init(gp), disc_optimizer.init(dp))


def make_discriminator(hd: Stage1HparamsDisc,
                       dtype: torch.dtype = torch.float32
                       ) -> NLayerDiscriminator:
    return NLayerDiscriminator(input_nc=hd.disc_in_channels,
                               n_layers=hd.disc_num_layers,
                               norm_type=hd.norm_type, dtype=dtype)


def init_discriminator(discriminator: NLayerDiscriminator, seed: int,
                       device=None) -> NLayerDiscriminator:
    """`discriminator` on `device` with seeded random weights at flax's
    default scales, drawn on the CPU (the same on every device):
    lecun-normal convolutions, zero biases; the norms as built (unit
    scales, zero shifts, BatchNorm statistics 0 and 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in discriminator.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) *
                               fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return discriminator.to(device)


def make_stage1_optimizer(opt_cfg, schedule: Schedule,
                          accum_steps: int = 1) -> Optimizer:
    """Adam (the config's betas, default (0.9, 0.999); eps 1e-8), after
    clipping to `grad_clip_norm` when it is set, accumulating
    `accum_steps` micro-steps an update."""
    betas = opt_cfg.betas or [0.9, 0.999]
    return Optimizer(schedule, betas[0], betas[1], eps=1e-8,
                     clip_norm=opt_cfg.grad_clip_norm,
                     accum_steps=accum_steps)


def generator_forward(generator: nn.Module, x: torch.Tensor,
                      rng: Optional[torch.Generator], bypass: bool):
    """Encode with one EMA step and decode: ([reconstruction (both codes),
    and with `bypass` the top codes' own], the quantizer losses, the
    residual term) by the generator's type."""
    name = type(generator).__name__
    if name in ('SimRQGAN2Generator', 'VQGAN2Generator'):
        quant_t, quant_b, diff_t, diff_b, code = generator.encode(
            x, update_ema=True, generator=rng)
        decs = [generator.decode(quant_t, quant_b)]
        if bypass and name == 'SimRQGAN2Generator':
            decs.append(generator.decode(quant_t, torch.zeros_like(quant_b)))
        elif bypass:
            decs.append(generator.decode(quant_t, quant_b,
                                         bottom_bypass=True))
        resid = (torch.mean(torch.abs(code[2])) if name ==
                 'SimRQGAN2Generator' else x.new_zeros(()))
        return decs, [diff_t, diff_b], resid
    if name == 'HQVAEGenerator':
        quant, diffs, _, resids = generator.encode(x, generator=rng,
                                                   update_ema=True)
        return ([generator.decode(quant)], list(diffs),
                sum(torch.mean(r) for r in resids))
    quant, diff, _ = generator.encode(x, update_ema=True, generator=rng)
    return [generator.decode(quant)], [diff], x.new_zeros(())


def make_stage1_train_step(generator: nn.Module, discriminator: nn.Module,
                           lpips: Optional[LPIPS],
                           gen_optimizer: Optimizer,
                           disc_optimizer: Optimizer,
                           hd: Stage1HparamsDisc, *,
                           bottom_start: Optional[int] = None,
                           residual_l1_weight: float = 0.0,
                           disc_loss_type: str = 'hinge',
                           disc_factor: float = 1.0,
                           perceptual_weight: float = 1.0,
                           faithful_double_forward: bool = True,
                           distributed: bool = False) -> Callable:
    """step(state, x, rng) -> (state, metrics); x NHWC in [-1, 1], `rng`
    a torch.Generator on x's device (it draws the codebook restarts)."""
    d_loss_fn = hinge_d_loss if disc_loss_type == 'hinge' else vanilla_d_loss
    use_bypass = bottom_start is not None and bottom_start > 0
    w_last = generator.decoder.conv_out.weight

    def lpips_of(x, d):
        return lpips(x, d).float()

    def nll_and_g(decs, x):
        decs = [d.float() for d in decs]
        dec_tb = decs[0]
        if len(decs) > 1 and hd.use_recon_top:
            rec = 0.5 * (torch.mean(torch.square(x - decs[1])) +
                         torch.mean(torch.square(x - dec_tb)))
        else:
            rec = torch.mean(torch.square(x - dec_tb))
        if lpips is not None and perceptual_weight > 0:
            p_loss = lpips_of(x, dec_tb)
            if len(decs) > 1 and hd.use_perceptual_top:
                p_loss = 0.5 * (p_loss + lpips_of(x, decs[1]))
        else:
            p_loss = x.new_zeros(())
        nll = rec + perceptual_weight * p_loss

        def g_of(d):
            return -torch.mean(discriminator(d).float())
        if len(decs) > 1 and hd.use_adversarial_top:
            g_loss = 0.5 * (g_of(decs[1]) + g_of(dec_tb))
        else:
            g_loss = g_of(dec_tb)
        return nll, g_loss, rec, p_loss

    def train_step(state: Stage1State, x: torch.Tensor,
                   rng: Optional[torch.Generator] = None):
        # generator phase
        decs, qdiffs, resid = generator_forward(generator, x, rng,
                                                use_bypass)
        nll, g_loss, rec, p_loss = nll_and_g(decs, x)
        grad_nll = torch.autograd.grad(nll, w_last, retain_graph=True)[0]
        grad_g = torch.autograd.grad(g_loss, w_last, retain_graph=True)[0]
        if distributed:
            grad_nll, grad_g = all_reduce_mean(grad_nll), \
                all_reduce_mean(grad_g)
        d_weight = torch.linalg.vector_norm(grad_nll) / \
            (torch.linalg.vector_norm(grad_g) + 1e-4)
        d_weight = torch.clamp(d_weight, 0.0, 1e4).detach() * hd.disc_weight
        factor = adopt_weight(disc_factor, state.step, hd.disc_start)
        qloss = sum(qdiffs)
        loss = nll + d_weight * factor * g_loss + hd.codebook_weight * qloss
        if residual_l1_weight > 0.0:
            loss = loss + residual_l1_weight * resid
        grads = grads_of(loss, state.gen_params)
        if distributed:
            average_gradients(grads)
        fake = decs[0].detach()
        del decs
        gen_optimizer.update(grads, state.gen_opt_state, state.gen_params)
        metrics = {'total_loss': loss, 'quant_loss': qloss, 'nll_loss': nll,
                   'rec_loss': rec, 'p_loss': p_loss, 'd_weight': d_weight,
                   'disc_factor': torch.tensor(factor), 'g_loss': g_loss,
                   'resid_l1_loss': resid}

        # discriminator phase
        if faithful_double_forward:
            with torch.no_grad():
                fake = generator_forward(generator, x, rng, False)[0][0]
        logits_real = discriminator(x).float()
        logits_fake = discriminator(fake).float()
        d_loss = factor * d_loss_fn(logits_real, logits_fake)
        d_grads = grads_of(d_loss, state.disc_params)
        if distributed:
            average_gradients(d_grads)
        disc_optimizer.update(d_grads, state.disc_opt_state,
                              state.disc_params)
        metrics.update(disc_loss=d_loss, logits_real=logits_real.mean(),
                       logits_fake=logits_fake.mean())
        state.step += 1
        return state, {k: torch.as_tensor(v).detach()
                       for k, v in metrics.items()}

    return train_step


def stage1_state_dict(state: Stage1State) -> dict:
    """The training checkpoint's tree (the JAX `Stage1State`'s fields)."""
    def plain(d):
        return {k: v.detach() for k, v in d.items()}
    return {'step': state.step, 'gen_params': plain(state.gen_params),
            'ema': plain(state.ema), 'disc_params': plain(state.disc_params),
            'gen_opt_state': state.gen_opt_state.state_dict(),
            'disc_opt_state': state.disc_opt_state.state_dict()}


def load_stage1_state(state: Stage1State, tree: Mapping) -> Stage1State:
    """Restore `stage1_state_dict`'s tree into `state` in place (the names
    must be the same)."""
    device = next(iter(state.gen_params.values())).device
    with torch.no_grad():
        for field in ('gen_params', 'ema', 'disc_params'):
            ours, theirs = getattr(state, field), tree[field]
            if set(ours) != set(theirs):
                raise KeyError(f'checkpoint {field} differ from the '
                               f'model\'s: {sorted(set(ours) ^ set(theirs))[:10]}')
            for k, t in ours.items():
                t.copy_(theirs[k])
    state.gen_opt_state = OptState.from_state_dict(tree['gen_opt_state'],
                                                   device)
    state.disc_opt_state = OptState.from_state_dict(tree['disc_opt_state'],
                                                    device)
    state.step = int(tree['step'])
    return state
