"""The stage-2 training step in plain float32 PyTorch: the teacher-forced
loss on given codes, its gradients, the clip by the global norm and one
AdamW update.

Loss (2 levels): CE(top) + weight_bottom * CE(bottom), each the mean over
every position of -log softmax(logits)[code]. AdamW as optax computes
it: g clipped to the global norm `grad_clip_norm`; mu = b1 mu + (1 - b1)
g, nu = b2 nu + (1 - b2) g^2; u = mu / (1 - b1^t) / (sqrt(nu / (1 -
b2^t)) + eps), plus weight_decay * p on the linear layers' weights; p -=
lr(t) u. The learning rate of update t (from 0) during the linear warmup
from zero is base_lr * (t + 1) / warmup_steps.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from . import stage2
from .lowp import F32, Precision

Weights = Dict[str, torch.Tensor]
LINEAR = ('query', 'key', 'value', 'proj', 'mlp.0', 'mlp.2')


def decayed(name: str, leaf: torch.Tensor) -> bool:
    """Weight decay applies to the linear layers' weights (the heads'
    included), not to embeddings, biases or norms."""
    module = name.rsplit('.', 1)[0]
    return (name.endswith('.weight') and leaf.dim() == 2 and
            (module.startswith('head') or module.endswith(LINEAR)))


def loss_2level(w2: Weights, cfg2: dict, labels: torch.Tensor,
                codes: Sequence[torch.Tensor],
                rnd: Precision = F32) -> torch.Tensor:
    logits_top, logits_bot = stage2.forward_2level(w2, cfg2, labels, *codes,
                                                   rnd=rnd)

    def ce(logits, target):
        logp = F.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, target[..., None].long()).mean()
    return ce(logits_top, codes[0]) + \
        float(cfg2.get('weight_bottom') or 4.0) * ce(logits_bot, codes[1])


class AdamW:
    """See the module docstring; state per leaf name."""

    def __init__(self, opt: dict, warmup_steps: float):
        self.b1, self.b2 = opt['betas']
        self.eps = 1e-8
        self.wd = opt['weight_decay']
        self.clip = opt.get('grad_clip_norm')
        self.base_lr = opt['base_lr']
        self.warmup_steps = warmup_steps
        self.t = 0
        self.mu: Weights = {}
        self.nu: Weights = {}

    def lr(self, t: int) -> float:
        if t + 1 > self.warmup_steps:
            raise ValueError('the reference follows the warmup only')
        return self.base_lr * (t + 1) / self.warmup_steps

    def clipped(self, grads: Weights) -> Weights:
        if not self.clip:
            return grads
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.clamp(self.clip / norm, max=1.0)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def update(self, params: Weights, grads: Weights) -> Weights:
        """Move params in place; returns the clipped gradients."""
        g = self.clipped(grads)
        lr = self.lr(self.t)
        self.t += 1
        for k, p in params.items():
            mu = self.mu.get(k, torch.zeros_like(p))
            nu = self.nu.get(k, torch.zeros_like(p))
            mu = self.b1 * mu + (1 - self.b1) * g[k]
            nu = self.b2 * nu + (1 - self.b2) * g[k] * g[k]
            self.mu[k], self.nu[k] = mu, nu
            u = (mu / (1 - self.b1 ** self.t)) / (
                torch.sqrt(nu / (1 - self.b2 ** self.t)) + self.eps)
            if self.wd and decayed(k, p):
                u = u + self.wd * p
            p -= lr * u
        return g


def train_steps(w2: Weights, cfg: dict, batches, warmup_steps: float,
                rnd: Precision = F32) -> dict:
    """Run len(batches) training steps from the weights w2 (copied) on
    batches [(codes, labels)], codes a top [B, N] and each cell's bottoms
    [B, N, 4]. Returns each step's loss, and by leaf name the norms of the
    first step's clipped gradient and of the change after the last
    step."""
    cfg2 = cfg['stage2']
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in w2.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(cfg['optimizer'], warmup_steps)
    losses, first_grad = [], None
    for codes, labels in batches:
        loss = loss_2level(params, cfg2, labels, codes, rnd)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        g = opt.update(params, grads)
        if first_grad is None:
            first_grad = norms(g)
        losses.append(float(loss.detach()))
        del grads, g, loss
    change = norms({k: params[k].detach() - start[k] for k in params})
    return {'losses': losses, 'first_grad': first_grad, 'change': change}


def norms(leaves: Weights) -> Dict[str, float]:
    """The L2 norm of every leaf, by name."""
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in leaves.items()}
