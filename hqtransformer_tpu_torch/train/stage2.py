"""Stage-2 training: the losses, AdamW with its decay mask, and the train
step.

Counterpart of `hqtransformer_tpu/train/stage2.py`. The frozen stage 1
gives the codes (and, with `temp_soft_labels`, the soft code maps) under
`torch.no_grad()`; the stage-2 model's teacher-forced logits give the
weighted cross-entropies, reduced in f32:
- 2 levels: CE(top) + w_bottom CE(bottom), and with text conditioning
  that times `weight_img` plus the text CE times `weight_txt` (1 +
  w_bottom);
- 3 levels: the level losses weighted 4**level, the text CE likewise.
The optimizer is `train/optim.py::Optimizer` as optax's
clip_by_global_norm + adamw(mask=decay_mask) [+ MultiSteps]: weight decay
on the Linear and convolution weights only.

The trainer owns the modules' parameters (`TrainState.params`, the
stage-2 model's `named_parameters`); `train_step(state, images, labels)`
moves them in place and returns the state with its micro-step count
advanced, and the step's metrics as device tensors. Under a parallel
layout (`parallel/tp.py::ParallelLayout`) the gradients are averaged over
the dp group before the update (`parallel/ddp.py`); under tensor
parallelism the parameters, gradients and moments are this rank's shards
(the losses read the gathered logits, so they are unchanged), the clip's
norm is summed over the tp group, and `train_state_dict` /
`load_train_state` gather and cut them, so a checkpoint holds whole
tensors and resumes at any tp size. Stage 1 is replicated: every tp rank
encodes its dp shard. Like the JAX step, it runs the stage-2 model
deterministic: no dropout. A step is the span `train.step` around
`train.stage1_codes`, `train.forward` (the model and the loss),
`train.backward` and `train.optimizer` (`utils/tracing.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.ddp import average_gradients
from ..parallel.tp import (ParallelLayout, gather_state, shard_state,
                           sharded_names)
from ..utils import tracing
from .optim import OptState, Optimizer, decayed, grads_of, named_trainable
from .scheduler import Schedule

Metrics = Dict[str, torch.Tensor]


def log_prob_from_logits(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Log-softmax with the reference's +1e-7 guard inside the log."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return x - m - torch.log(torch.sum(torch.exp(x - m), dim=dim,
                                       keepdim=True) + 1e-7)


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE of logits [..., K] against soft targets [..., K], in f32."""
    target = target.float()
    unif = torch.ones_like(target) / target.shape[-1]
    target = label_smoothing * unif + (1 - label_smoothing) * target
    loss = torch.sum(-target * log_prob_from_logits(logits.float()), dim=-1)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Mean CE over every position, the log-softmax and mean in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, codes[..., None].long())[..., 0].mean()


def hierarchical_loss(logits: Sequence[torch.Tensor],
                      codes: Sequence[torch.Tensor],
                      softs: Optional[Sequence[torch.Tensor]],
                      labels: Optional[torch.Tensor] = None,
                      weight_bottom: float = 4.0,
                      weight_img: Optional[float] = None,
                      weight_txt: Optional[float] = None
                      ) -> Tuple[torch.Tensor, Metrics]:
    """CE(top) + w_bottom CE(bottom) [+ the text CE, the image loss times
    `weight_img` and the text one times weight_txt (1 + w_bottom)]."""
    logits_top, logits_bot = logits[0], logits[1]
    ct, cb = codes
    st, sb = softs if softs is not None else (None, None)
    if st is not None:
        loss_top = soft_target_cross_entropy(logits_top, st)
        loss_bot = soft_target_cross_entropy(logits_bot, sb)
    else:
        loss_top = cross_entropy(logits_top, ct)
        loss_bot = cross_entropy(logits_bot, cb)
    loss_img = loss_top + weight_bottom * loss_bot
    metrics = {'loss_top': loss_top, 'loss_bot': loss_bot,
               'loss_img': loss_img}
    if len(logits) > 2 and weight_txt is not None:
        loss_txt = cross_entropy(logits[2], labels[:, 1:])
        w_image = 1.0 + weight_bottom
        loss = loss_img * weight_img + loss_txt * (weight_txt * w_image)
        metrics['loss_txt'] = loss_txt
    else:
        loss = loss_img
    metrics['loss'] = loss
    return loss, metrics


def multilevel_loss(logits: Sequence[torch.Tensor],
                    codes: Sequence[torch.Tensor],
                    softs: Optional[Sequence[torch.Tensor]],
                    labels: Optional[torch.Tensor] = None,
                    weight_img: Optional[float] = None,
                    weight_txt: Optional[float] = None
                    ) -> Tuple[torch.Tensor, Metrics]:
    """The level losses weighted 4**level [+ the text CE]."""
    n_levels = len(codes)
    metrics = {}
    loss_img = 0.0
    for i in range(n_levels):
        if softs is not None:
            li = soft_target_cross_entropy(logits[i], softs[i])
        else:
            li = cross_entropy(logits[i], codes[i])
        metrics[f'loss_level{i}'] = li
        loss_img = loss_img + (4 ** i) * li
    if len(logits) > n_levels and weight_txt is not None:
        loss_txt = cross_entropy(logits[-1], labels[:, 1:])
        loss = loss_img * weight_img + loss_txt * weight_txt
        metrics['loss_txt'] = loss_txt
    else:
        loss = loss_img
    metrics['loss'] = loss
    return loss, metrics


def decay_mask(model: nn.Module) -> Set[str]:
    """The parameter names weight decay applies to: the Linear and
    convolution weights (JAX's `kernel` leaves); not biases, norms,
    embeddings, `sos`, `sos_depth` or `pos_emb_bot`."""
    return set(decayed(model))


@dataclass
class TrainState:
    """step: micro-steps taken; params: the stage-2 model's parameters by
    name (the modules' own); opt_state: the optimizer's state."""
    step: int
    params: Dict[str, nn.Parameter]
    opt_state: OptState


def init_train_state(model2: nn.Module, optimizer: Optimizer) -> TrainState:
    params = named_trainable(model2)
    return TrainState(0, params, optimizer.init(params))


def make_optimizer(opt_cfg, schedule: Schedule, accum_steps: int = 1,
                   mask: Optional[Set[str]] = None) -> Optimizer:
    """AdamW (betas and weight decay from `opt_cfg`, eps 1e-8) on the
    `mask` names (a `decay_mask`; None decays every parameter), after
    clipping to `grad_clip_norm` when it is set, accumulating `accum_steps`
    micro-steps an update."""
    return Optimizer(schedule, opt_cfg.betas[0], opt_cfg.betas[1], eps=1e-8,
                     weight_decay=opt_cfg.weight_decay,
                     decay=None if mask is None else mask.__contains__,
                     clip_norm=opt_cfg.grad_clip_norm,
                     accum_steps=accum_steps)


def stage1_codes(stage1: nn.Module, images: torch.Tensor,
                 temp_soft_labels: Optional[float] = None):
    """The frozen stage 1's codes of images [B, H, W, 3] in [-1, 1], each
    level [B, T] in raster order (top first), and with `temp_soft_labels`
    its soft code maps [B, T, K] (else None), under `torch.no_grad()`: one
    K3 launch a level, none for soft codes."""
    B = images.shape[0]
    with torch.no_grad():
        if temp_soft_labels is not None:
            codes, softs = stage1.get_soft_codes(images, temp_soft_labels)
            softs = [s.reshape(B, -1, s.shape[-1]) for s in softs]
        else:
            codes, softs = stage1.get_codes(images), None
        return [c.reshape(B, -1) for c in codes], softs


def make_loss_fn(model2: nn.Module, stage1: nn.Module, *,
                 weight_bottom: float = 4.0,
                 weight_img: Optional[float] = None,
                 weight_txt: Optional[float] = None,
                 temp_soft_labels: Optional[float] = None,
                 use_cond: bool = True,
                 multilevel: bool = False) -> Callable:
    """loss_fn(images, labels, soft=True) -> (loss, metrics); `soft=False`
    takes hard codes even with soft-label training (validation)."""

    def loss_fn(images: torch.Tensor, labels: torch.Tensor,
                soft: bool = True):
        with tracing.span('train.stage1_codes'):
            codes, softs = stage1_codes(stage1, images,
                                        temp_soft_labels if soft else None)
        cond = labels if use_cond else None
        with tracing.span('train.forward'):
            if multilevel:
                return multilevel_loss(model2(codes, cond), codes, softs,
                                       labels, weight_img=weight_img,
                                       weight_txt=weight_txt)
            return hierarchical_loss(model2(codes[0], codes[1], cond), codes,
                                     softs, labels,
                                     weight_bottom=weight_bottom,
                                     weight_img=weight_img,
                                     weight_txt=weight_txt)

    return loss_fn


def make_train_step(model2: nn.Module, stage1: nn.Module,
                    optimizer: Optimizer, *,
                    layout: Optional[ParallelLayout] = None,
                    **loss_kwargs) -> Callable:
    """train_step(state, images, labels) -> (state, metrics): one
    micro-step (`make_loss_fn`'s keyword arguments) on this rank's images
    and labels (its dp shard), the gradients averaged over the dp group of
    `layout` and the clip's norm summed over its tp group (the module
    docstring). `train_step.loss_fn` is the loss function it
    differentiates."""
    loss_fn = make_loss_fn(model2, stage1, **loss_kwargs)
    dp_group = layout.dp_group if layout is not None and layout.dp > 1 \
        else None
    sum_squares = None
    if layout is not None and layout.tp > 1:
        sum_squares = layout.sum_squares(sharded_names(model2))

    @tracing.span('train.step')
    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor):
        loss, metrics = loss_fn(images, labels)
        with tracing.span('train.backward'):
            grads = grads_of(loss, state.params)
        if dp_group is not None:
            average_gradients(grads, dp_group)
        with tracing.span('train.optimizer'):
            optimizer.update(grads, state.opt_state, state.params,
                             sum_squares)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    train_step.loss_fn = loss_fn
    return train_step


def _per_param(opt: Mapping, fn: Callable) -> dict:
    """An optimizer state dict with `fn` applied to its per-parameter
    dicts (mu, nu and the accumulator)."""
    return {k: fn(v) if k in ('mu', 'nu', 'acc') and v is not None else v
            for k, v in opt.items()}


def train_state_dict(state: TrainState,
                     layout: Optional[ParallelLayout] = None) -> dict:
    """The training checkpoint's tree: the step, the parameters and the
    optimizer state, whole tensors under tensor parallelism (gathered
    over the tp group: every rank calls it)."""
    params = {k: p.detach() for k, p in state.params.items()}
    return {'step': state.step,
            'params': gather_state(params, layout),
            'opt_state': _per_param(state.opt_state.state_dict(),
                                    lambda d: gather_state(d, layout))}


def load_train_state(state: TrainState, tree: Mapping,
                     layout: Optional[ParallelLayout] = None) -> TrainState:
    """Restore `train_state_dict`'s tree (whole tensors, saved at any tp
    size) into `state`, cut to this rank's shards (parameters copied in
    place; the names must be the same)."""
    if set(tree['params']) != set(state.params):
        raise KeyError(f'checkpoint parameters differ from the model\'s: '
                       f'{sorted(set(tree["params"]) ^ set(state.params))[:10]}')
    params = shard_state(tree['params'], layout)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
    device = next(iter(state.params.values())).device
    state.opt_state = OptState.from_state_dict(
        _per_param(tree['opt_state'], lambda d: shard_state(d, layout)),
        device)
    state.step = int(tree['step'])
    return state
