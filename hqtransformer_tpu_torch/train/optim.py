"""The optimizers of both trainers, as the optax chains of the JAX package
compute them.

`Optimizer` is `optax.chain(clip_by_global_norm(clip), adamw(schedule, b1,
b2, eps, weight_decay, mask))`, wrapped in `optax.MultiSteps(k)` when
`accum_steps` k > 1; with `weight_decay` 0 and no mask it is the chain of
`optax.adam` (stage 1). Its state holds the optax state's tensors:

- `count`, the updates applied (Adam's bias-correction count, and the
  index the schedule is read at: `schedule(count)` before each update);
- `mu`, `nu`, Adam's moments, f32, one per parameter;
- `mini_step` and `acc`, MultiSteps' micro-step within an update and its
  running mean of the micro-steps' gradients (acc + (g - acc) / (n + 1),
  optax's Welford form).

One update, per parameter (optax's order of operations):
  g <- g / |g| * clip where |g| >= clip (|g| the global norm);
  mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g g + b2 nu;
  u <- (mu / (1 - b1^count')) / (sqrt(nu / (1 - b2^count')) + eps)
       (+ weight_decay * p where the mask picks p);
  p <- p + u * (-lr).
Parameters move in place under `torch.no_grad()`; the trainers' `step`
counts micro-steps, this state's `count` the updates applied. Under
tensor parallelism each rank holds its shards' moments and accumulator,
and `update(..., sum_squares=)` makes the clip's norm global (the sharded
gradients' squares summed over the tp group, the replicated ones counted
once: `ParallelLayout.sum_squares`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import torch

from .scheduler import Schedule


@dataclass
class OptState:
    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    mini_step: int = 0
    acc: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        return {'count': self.count, 'mu': self.mu, 'nu': self.nu,
                'mini_step': self.mini_step, 'acc': self.acc}

    @classmethod
    def from_state_dict(cls, sd: Mapping, device=None) -> 'OptState':
        def move(d):
            return None if d is None else {k: v.to(device)
                                           for k, v in d.items()}
        return cls(int(sd['count']), move(sd['mu']), move(sd['nu']),
                   int(sd['mini_step']), move(sd['acc']))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on `like`'s device: dividing by it is IEEE
    division on every device (a Python float divisor becomes a product by
    its reciprocal on CUDA)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Optimizer:
    """See the module docstring. `decay` picks the parameter names that
    weight decay applies to (None: all of them)."""

    def __init__(self, schedule: Schedule, b1: float, b2: float,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decay: Optional[Callable[[str], bool]] = None,
                 clip_norm: Optional[float] = None, accum_steps: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay = decay
        self.clip_norm = clip_norm if clip_norm and clip_norm > 0 else None
        self.accum_steps = accum_steps

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        acc = ({k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()} if self.accum_steps > 1
               else None)
        return OptState(0, zeros, {k: v.clone() for k, v in zeros.items()},
                        0, acc)

    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor],
               sum_squares: Optional[Callable] = None) -> bool:
        """Fold `grads` (name -> f32 gradient) into `state` and, on the
        last micro-step of an update, move `params`. Returns whether the
        parameters moved. `sum_squares(names, squares)` sums the squared
        gradients for the clip's norm (by default, stacked and summed)."""
        names = list(params)
        with torch.no_grad():
            g = [grads[k].float() for k in names]
            if self.accum_steps > 1:
                acc = [state.acc[k] for k in names]
                n = state.mini_step + 1
                # acc + (g - acc) / n
                diff = torch._foreach_sub(g, acc)
                torch._foreach_div_(diff, _scalar(float(n), acc[0]))
                torch._foreach_add_(acc, diff)
                if state.mini_step < self.accum_steps - 1:
                    state.mini_step += 1
                    return False
                self._apply(names, acc, state, params, sum_squares)
                for a in acc:
                    a.zero_()
                state.mini_step = 0
            else:
                self._apply(names, g, state, params, sum_squares)
        return True

    def _apply(self, names: List[str], g: List[torch.Tensor],
               state: OptState, params: Mapping[str, torch.Tensor],
               sum_squares: Optional[Callable] = None) -> None:
        """One update from gradients `g` (read, not written)."""
        ref = g[0]
        if self.clip_norm is not None:
            squares = [torch.sum(x * x) for x in g]
            norm = torch.sqrt(torch.stack(squares).sum()
                              if sum_squares is None
                              else sum_squares(names, squares))
            clipped = torch._foreach_mul(
                torch._foreach_div(g, norm), _scalar(self.clip_norm, ref))
            keep = norm < self.clip_norm
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        b1, b2 = self.b1, self.b2
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        # mu <- (1 - b1) g + b1 mu ; nu <- (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        count = state.count + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = one - torch.pow(torch.tensor(b1, dtype=torch.float32), count)
        bc2 = one - torch.pow(torch.tensor(b2, dtype=torch.float32), count)
        mu_hat = torch._foreach_div(mu, bc1.to(ref.device))
        nu_hat = torch._foreach_div(nu, bc2.to(ref.device))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        p = [params[k] for k in names]
        if self.weight_decay:
            for i, k in enumerate(names):
                if self.decay is None or self.decay(k):
                    upd[i].add_(p[i].detach() * self.weight_decay)
        lr = torch.tensor(-self.schedule(state.count), dtype=torch.float32,
                          device=ref.device)
        torch._foreach_mul_(upd, lr)
        torch._foreach_add_(p, upd)
        state.count = count


def named_trainable(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """name -> parameter of `module`'s parameters that take gradients."""
    return {k: p for k, p in module.named_parameters() if p.requires_grad}


def grads_of(loss: torch.Tensor, params: Mapping[str, torch.Tensor],
             retain_graph: bool = False) -> Dict[str, torch.Tensor]:
    """name -> d loss / d param; zeros where the loss does not reach a
    parameter (as `jax.grad` gives)."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names],
                             retain_graph=retain_graph, allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if gk is None else gk)
            for k, gk in zip(names, gs)}


def decayed(module: torch.nn.Module) -> Iterable[str]:
    """The names of the Linear and convolution weights of `module`: the
    parameters JAX's `decay_mask` picks (its `kernel` leaves)."""
    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d,
                          torch.nn.ConvTranspose2d)):
            yield f'{name}.weight' if name else 'weight'
