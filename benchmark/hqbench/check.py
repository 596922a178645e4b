"""The numbers that decide `correct`, and the verdict on them.

- `topk_gap`: over every served token, the widest gap by which the
  reference's logit of the served token lies below the reference's k-th
  largest logit at that position (0 where every served token lies in the
  reference's top-k set).
- `topp_excess`: over every served token, the reference's probability
  mass (top-k cut, over the temperature, softmax) ranked strictly above
  the served token, less p, where that is positive (0 where every served
  token lies in the reference's nucleus).
- `draw`: the tokens a control (the reference in a lower precision) draws
  in the program's place, by plain top-k, temperature and top-p.
- `rel_rms`: the root mean square of a - b over that of b about its mean.
- `leaf_gap`: the worst leaf's gap between two norms, |n_a - n_b|, over
  the larger of the leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch


def _served(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    return logits.gather(-1, served[..., None].long())[..., 0]


def _topk_cut(logits: torch.Tensor, k: int) -> torch.Tensor:
    """logits [..., V] below their k-th largest set to -inf."""
    kth = logits.topk(min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float('-inf'))


def topk_gap(ref_logits: torch.Tensor, served: torch.Tensor, k: int) -> float:
    """ref_logits [..., V] (f32), served codes [...]."""
    kth = ref_logits.topk(min(k, ref_logits.shape[-1]), dim=-1).values[..., -1]
    return float((kth - _served(ref_logits, served)).clamp_min(0).max())


def _probs(logits: torch.Tensor, k: int, temperature: float) -> torch.Tensor:
    return torch.softmax(_topk_cut(logits.float() / temperature, k), dim=-1)


def topp_excess(ref_logits: torch.Tensor, served: torch.Tensor, k: int,
                temperature: float, p: float) -> float:
    """ref_logits [..., V] (f32), served codes [...]."""
    probs = _probs(ref_logits, k, temperature)
    got = _served(probs, served)
    above = (probs * (probs > got[..., None])).sum(-1)
    return float((above - p).clamp_min(0).max())


def draw(logits: torch.Tensor, k: int, temperature: float,
         p: Optional[float], generator: torch.Generator) -> torch.Tensor:
    """One token per position of logits [..., V]: temperature, top-k,
    softmax, then (with p) the nucleus: a token stays where the mass
    ranked before it is under p."""
    probs = _probs(logits, k, temperature)
    if p is not None:
        srt, order = probs.sort(dim=-1, descending=True, stable=True)
        drop = (srt.cumsum(-1) - srt) >= p
        probs = probs.scatter(-1, order, srt.masked_fill(drop, 0.0))
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.sqrt(((a - b) ** 2).mean()) /
                 torch.sqrt(((b - b.mean()) ** 2).mean()).clamp_min(1e-30))


def leaf_gap(got: Mapping[str, float], ref: Mapping[str, float],
             names: Iterable[str]) -> Tuple[float, str]:
    """(the worst gap, its leaf) over `names`."""
    names = list(names)
    median = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ''
    for k in names:
        gap = abs(got[k] - ref[k]) / max(ref[k], median, 1e-30)
        if gap >= worst:
            worst, which = gap, k
    return worst, which


def out_of_range(codes: Sequence[torch.Tensor], vocab: Sequence[int]) -> int:
    return int(sum(int(((c < 0) | (c >= v)).sum())
                   for c, v in zip(codes, vocab)))


Numbers = Dict[str, Dict[str, float]]


def verdict(numbers: Numbers) -> bool:
    """Print each compared number beside its limit as the last lines on
    standard error; correct when none is over its limit (and none is
    NaN; an empty comparison is not correct)."""
    ok = bool(numbers)
    for name, n in numbers.items():
        good = n['value'] <= n['limit']
        ok = ok and good
        print(f'check {name}: {n["value"]!r} (limit {n["limit"]!r})'
              f'{"" if good else " OVER"}', file=sys.stderr)
    return ok


def judge(out, control: bool) -> bool:
    """The verdict of a run on the numbers it compared; with `control`,
    on the control's numbers, which then take the program's place in
    `out.checks` (the program's go to `out.info['program']`)."""
    if control:
        out.info['program'] = out.checks
        out.checks = out.info['control']
    out.correct = verdict(out.checks)
    return out.correct


def number(value: float, limit: float) -> Dict[str, float]:
    return {'value': float(value), 'limit': float(limit)}
