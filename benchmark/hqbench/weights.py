"""Seeded random weights, made on the device in a few large calls.

The rule is the JAX initialisers' scales (a frozen copy of the port's
`random_state`): linear and convolution weights lecun-normal over the
fan-in their kernel has in flax (all axes but the output's; a
conv-transpose's is Cin Cout k k), zero biases, unit norm scales, N(0, 1)
EMA codebooks (`embedding_avg` a copy, `cluster_size` zero), N(0, 0.02)
for every other leaf (embeddings, `sos_depth`; a learned codebook, which
no cell uses, too). Every normal leaf is a
slice of one `torch.randn` over their total size, drawn from a generator
on the device seeded with the run's seed, then scaled in place: the same
seed gives the same weights.

`serving=True` stores stage 2's matrices (ndim >= 2) in bfloat16, as the
sampling CLIs serve them; everything else stays float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

Weights = Dict[str, Dict[str, torch.Tensor]]
SEED_SALT = 0x5EED


def _leaves(module: nn.Module) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, rule, std) of every state-dict entry: rule 'normal'
    (with std), 'zeros', 'ones' or 'copy:<name>'."""
    out, seen = [], set()
    for prefix, m in module.named_modules():
        p = f'{prefix}.' if prefix else ''
        names = {n for n, _ in m.named_parameters(recurse=False)} | \
            {n for n, _ in m.named_buffers(recurse=False)}
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight.shape
            fan_in = (w[0] * w[1] * w[2] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            out.append((p + 'weight', tuple(w), 'normal', fan_in ** -0.5))
            if m.bias is not None:
                out.append((p + 'bias', tuple(m.bias.shape), 'zeros', 0.0))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            out.append((p + 'weight', tuple(m.weight.shape), 'ones', 0.0))
            out.append((p + 'bias', tuple(m.bias.shape), 'zeros', 0.0))
        elif {'embedding', 'embedding_avg', 'cluster_size'} <= names:
            shape = tuple(m.embedding.shape)
            out.append((p + 'embedding', shape, 'normal', 1.0))
            out.append((p + 'embedding_avg', shape, 'copy:' + p + 'embedding',
                        0.0))
            out.append((p + 'cluster_size', (shape[0],), 'zeros', 0.0))
        seen.update(name for name, *_ in out)
    for name, t in module.state_dict().items():
        if name not in seen:
            out.append((name, tuple(t.shape), 'normal', 0.02))
    return out


def make_state(leaves: List[Tuple[str, tuple, str, float]],
               generator: torch.Generator,
               bf16_matrices: bool = False) -> Dict[str, torch.Tensor]:
    """The seeded state dict of `leaves` (`plan`'s) on the generator's
    device."""
    dev = generator.device
    normal = [(n, s, std) for n, s, rule, std in leaves if rule == 'normal']
    total = sum(torch.Size(s).numel() for _, s, _ in normal)
    flat = torch.randn(total, generator=generator, device=dev)
    state, off = {}, 0
    for name, shape, std in normal:
        n = torch.Size(shape).numel()
        state[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, shape, rule, _ in leaves:
        if rule == 'zeros':
            state[name] = torch.zeros(shape, device=dev)
        elif rule == 'ones':
            state[name] = torch.ones(shape, device=dev)
        elif rule.startswith('copy:'):
            state[name] = state[rule[5:]].clone()
    if bf16_matrices:
        mats = [k for k, v in state.items() if v.dim() >= 2]
        packed = torch.cat([state[k].reshape(-1) for k in mats]).to(
            torch.bfloat16) if mats else None
        off = 0
        for k in mats:
            n = state[k].numel()
            state[k] = packed[off:off + n].view(state[k].shape)
            off += n
    return state


Plan = Dict[str, List[Tuple[str, tuple, str, float]]]


def plan(model) -> Plan:
    """The leaves of a `TwoStageModel`'s two stages, whole (not a
    tensor-parallel shard)."""
    return {'stage1': _leaves(model.stage1),
            'stage2': _leaves(model.full_stage2)}


def make(leaves: Plan, seed: int, device: torch.device,
         serving: bool) -> Weights:
    """{'stage1': ..., 'stage2': ...} from `seed` on `device`; with
    `serving`, stage 2's matrices in bfloat16."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ SEED_SALT) % 2 ** 63)
    return {'stage1': make_state(leaves['stage1'], gen),
            'stage2': make_state(leaves['stage2'], gen, serving)}
