"""Tensor parallelism of stage 2: the Megatron rules of the JAX package's
'tp' mesh axis over processes, beside the 'dp' groups.

The port's counterpart of `hqtransformer_tpu/parallel/mesh.py`'s
`make_mesh`, `_order_host_major`, `_check_tp_within_host` and
`_spec_for_path`. JAX shards one program over a ('dp', 'tp') device mesh
and GSPMD inserts the collectives; here every process holds its tp rank's
shard of the stage-2 parameters and the forward passes call the
collectives themselves (Megatron's "f" and "g"):

- column-parallel `query`, `key`, `value` and `mlp.0` (weight dim 0 and
  bias): a rank computes its heads and its quarter of the MLP; their
  replicated input passes `TPGroup.copy` (identity forward, all-reduce of
  the gradient backward);
- row-parallel `proj` and `mlp.2` (weight dim 1): the partial products
  are summed by `TPGroup.row_linear` (all-reduce forward, identity
  backward), the replicated bias added once after the sum;
- vocabulary-sharded heads `head*` (weight dim 0) and feature-sharded
  token tables `tok_emb*` (weight dim 1): their outputs are gathered
  along the last dim (`TPGroup.gather`: the rank's slice placed into
  zeros of the full width and all-reduced; backward, the rank's slice of
  the gradient), so the residual stream, the losses and the draws see
  whole tensors on every rank;
- everything else (LayerNorms, `pos_emb*`, `sos*`, `pred_emb_top`,
  `pos_emb_emb`) is replicated.

`shard_dim` is that rule, parameter by parameter (the tests hold it to
`_spec_for_path` through the JAX export names); `shard_module` cuts a
model built at full size into a rank's shards, `shard_state` and
`gather_state` do the same for state dicts. Only `all_reduce` (a sum, or a
max for int8 scales; and `new_group`, once) is used, so the same code runs
on NCCL across cards and on gloo, with CPU tensors or with CUDA tensors of
several processes on one card. NCCL sums bf16 in bf16; gloo sums it in
f32 (`all_reduce`); int32 is summed as int32, exactly, by both
(`TPGroup.sum_int32`, the row-parallel A8W8 product's partial sums).

`ParallelLayout` orders the ranks host-major and puts each run of `tp`
consecutive ranks in one tp group, which must stay within one host; the
dp groups take one rank of each tp group. With tp 1 and dp 1 no group is
made and no path changes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

COLUMN = ('query', 'key', 'value', 'mlp_0')
ROW = ('proj', 'mlp_2')
HALF = (torch.float16, torch.bfloat16)


def _segments(name: str) -> List[str]:
    """The flax path of a torch parameter name's owner: a ModuleList index
    joins its list ('head_levels.0' -> 'head_levels_0', 'mlp.0' ->
    'mlp_0'), as the JAX modules name their submodules."""
    segs: List[str] = []
    for part in name.split('.')[:-1]:
        if part.isdigit() and segs:
            segs[-1] = f'{segs[-1]}_{part}'
        else:
            segs.append(part)
    return segs


def shard_dim(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim of stage-2 parameter `name` (shape `shape`) that tensor
    parallelism splits, or None where it is replicated: JAX's
    `_spec_for_path` in torch's layout (nn.Linear weights are [out, in],
    flax kernels [in, out])."""
    segs = _segments(name)
    parent = segs[-1] if segs else ''
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight' and len(shape) == 2:
        if parent in COLUMN or parent.startswith('head'):
            return 0
        if parent in ROW or parent.startswith('tok_emb'):
            return 1
        return None
    if leaf == 'bias' and parent in COLUMN:
        return 0
    return None


def check_tp_sizes(module: nn.Module, tp: int) -> None:
    """Raise ValueError naming the size unless `tp` divides every sharded
    dim of `module` (built at full size) and every attention layer's
    heads."""
    if tp < 1:
        raise ValueError(f'--tp {tp}: the tensor-parallel size must be >= 1')
    if tp == 1:
        return
    for name, m in module.named_modules():
        heads = getattr(m, 'n_heads', None)
        if heads is not None and heads % tp:
            raise ValueError(f'--tp {tp} does not divide the {heads} heads '
                             f'of {name}')
    for name, p in module.named_parameters():
        d = shard_dim(name, p.shape)
        if d is not None and p.shape[d] % tp:
            what = ('vocabulary' if _segments(name)[-1].startswith('head')
                    else 'width')
            raise ValueError(f'--tp {tp} does not divide the {what} '
                             f'{p.shape[d]} of {name} {tuple(p.shape)}')


def sharded_names(module: nn.Module) -> Set[str]:
    """The names of `module`'s parameters that tensor parallelism splits."""
    return {k for k, p in module.named_parameters()
            if shard_dim(k, p.shape) is not None}


# ---------------------------------------------------------------- collectives

def _sums_in_f32(x: torch.Tensor, group) -> bool:
    """Whether `x` is summed over `group` in f32: f16 and bf16 under gloo,
    whose reductions do not take them on CUDA tensors. NCCL sums them in
    their own dtype, which keeps the traffic at two bytes a value."""
    return x.dtype in HALF and dist.get_backend(group) == 'gloo'


def all_reduce(x: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or `op`) of `x` over `group`, as a new contiguous tensor in
    x's dtype (under gloo, f16 and bf16 reduced in f32 and rounded once;
    every other dtype, int32 included, reduced in its own)."""
    y = x.float() if _sums_in_f32(x, group) else \
        x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


class _Copy(torch.autograd.Function):
    """Megatron's "f": identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The last dim's shards joined: the rank's slice placed into zeros of
    the full width and all-reduced; backward, the rank's slice of the
    gradient (the same on every rank, which computes the same loss)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        n = x.shape[-1]
        ctx.span = (rank * n, (rank + 1) * n)
        full = x.new_zeros(*x.shape[:-1], n * size,
                           dtype=torch.float32 if _sums_in_f32(x, group)
                           else x.dtype)
        full[..., rank * n:(rank + 1) * n] = x
        dist.all_reduce(full, group=group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.span
        return g[..., lo:hi], None, None, None


@dataclass(eq=False)
class TPGroup:
    """One tp group as a process sees it: the group, this process's rank
    in it and its size; the collectives the sharded modules call."""
    group: object
    rank: int
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; all-reduces the gradient (before column-parallel
        layers that read a replicated input)."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[..., n] shards -> [..., n * size] on every rank."""
        return _Gather.apply(x, self.group, self.rank, self.size)

    def sum_int32(self, x: torch.Tensor) -> torch.Tensor:
        """The exact sum over the group of int32 partial products (the
        row-parallel A8W8 gemm's), in int32 under gloo and NCCL alike."""
        if x.dtype != torch.int32:
            raise TypeError(f'sum_int32 takes int32, not {x.dtype}')
        return all_reduce(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group (int8 scales: a row-parallel
        weight's per-output-channel absmax, a sharded input's)."""
        return all_reduce(x, self.group, dist.ReduceOp.MAX)

    def row_linear(self, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
        """The row-parallel x @ w.T + b: each rank's partial product in
        x's dtype (on bf16 a bf16 gemm, accumulated in f32 and rounded to
        bf16, as GSPMD's partial dots are), summed over the group, then the
        bias added and rounded (`layers.linear`'s bias rounding, after the
        reduction). On bf16 each partial product is rounded once more than
        tp 1's whole product."""
        y = self.reduce(F.linear(x, w))
        return y if b is None else y + b.to(y.dtype)


# ------------------------------------------------------------------- layout

def order_host_major(hosts: Sequence[int]) -> List[int]:
    """The ranks sorted by (host, rank); hosts[r] is rank r's host."""
    return sorted(range(len(hosts)), key=lambda r: (hosts[r], r))


def check_tp_within_host(hosts: Sequence[int], order: Sequence[int],
                         tp: int) -> None:
    """Raise ValueError if a run of `tp` consecutive ranks of `order`
    spans hosts: the per-layer collectives must stay within one host."""
    for start in range(0, len(order), tp):
        row = {hosts[r] for r in order[start:start + tp]}
        if len(row) > 1:
            per_host = len(hosts) // max(1, len(set(hosts)))
            raise ValueError(f'--tp {tp}: the tp group of ranks '
                             f'{list(order[start:start + tp])} spans hosts '
                             f'{sorted(row)}; choose tp <= the processes '
                             f'of one host ({per_host})')


@dataclass(eq=False)
class ParallelLayout:
    """The ('dp', 'tp') layout of this process: world = dp * tp; its rank
    in the world, its dp and tp ranks, its card (`local_rank`), and the
    groups: `tp_group` (a TPGroup, None for tp 1) and `dp_group` (the
    process group its gradients are averaged over; None for dp 1, the
    default group for tp 1)."""
    dp: int = 1
    tp: int = 1
    rank: int = 0
    local_rank: int = 0
    dp_rank: int = 0
    tp_rank: int = 0
    tp_group: Optional[TPGroup] = None
    dp_group: object = None
    order: List[int] = field(default_factory=lambda: [0])

    @property
    def world(self) -> int:
        return self.dp * self.tp

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's dp shard of a global batch x [B, ...]."""
        if self.dp == 1:
            return x
        if x.shape[0] % self.dp:
            raise ValueError(f'a batch of {x.shape[0]} does not split over '
                             f'{self.dp} data-parallel ranks')
        b = x.shape[0] // self.dp
        return x[self.dp_rank * b:(self.dp_rank + 1) * b]

    def sum_squares(self, sharded: Set[str]) -> Callable:
        """fn(names, squares) -> the global sum of the squared gradients:
        the sharded parameters' summed over the tp group, the replicated
        ones counted once."""
        def total(names: Sequence[str], squares: Sequence[torch.Tensor]):
            part = [s for k, s in zip(names, squares) if k in sharded]
            rest = [s for k, s in zip(names, squares) if k not in sharded]
            out = torch.stack(rest).sum() if rest else 0.0
            if part:
                out = out + all_reduce(torch.stack(part).sum(),
                                       self.tp_group.group)
            return out
        return total

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def _hosts(world: int, rank: int) -> List[int]:
    """Every rank's host index, from torchrun's GROUP_RANK (or rank //
    LOCAL_WORLD_SIZE): one all-reduce of a [world] vector."""
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    host = int(os.environ.get('GROUP_RANK', rank // max(1, local_world)))
    device = (torch.device('cuda', torch.cuda.current_device())
              if dist.get_backend() == 'nccl' else torch.device('cpu'))
    v = torch.zeros(world, dtype=torch.float64, device=device)
    v[rank] = host
    dist.all_reduce(v)
    return [int(h) for h in v.tolist()]


def make_layout(tp: int = 1, local_rank: int = 0) -> ParallelLayout:
    """The layout of the default process group (one process, dp 1 tp 1,
    when there is none) with tensor-parallel size `tp`. Raises ValueError
    if tp does not divide the world or a tp group would span hosts."""
    if tp < 1:
        raise ValueError(f'--tp {tp}: the tensor-parallel size must be >= 1')
    if not (dist.is_available() and dist.is_initialized()):
        if tp != 1:
            raise ValueError(f'--tp {tp} does not divide the world of 1 '
                             f'process (start one process a tp rank, '
                             f'torchrun with --multihost)')
        return ParallelLayout(local_rank=local_rank)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f'--tp {tp} does not divide the world of {world} '
                         f'processes')
    dp = world // tp
    if world == 1:
        return ParallelLayout(local_rank=local_rank)
    hosts = _hosts(world, rank)
    order = order_host_major(hosts)
    if tp > 1:
        check_tp_within_host(hosts, order, tp)
    pos = order.index(rank)
    dp_rank, tp_rank = divmod(pos, tp)
    tp_group = dp_group = None
    if tp > 1:      # every process creates every group, in the same order
        for d in range(dp):
            g = dist.new_group(order[d * tp:(d + 1) * tp])
            if d == dp_rank:
                tp_group = TPGroup(g, tp_rank, tp)
        if dp > 1:
            for t in range(tp):
                g = dist.new_group(order[t::tp])
                if t == tp_rank:
                    dp_group = g
    elif dp > 1:
        dp_group = dist.group.WORLD
    return ParallelLayout(dp, tp, rank, local_rank, dp_rank, tp_rank,
                          tp_group, dp_group, order)


# ------------------------------------------------------ modules and states

def _narrow(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def shard_module(module: nn.Module, layout: ParallelLayout) -> nn.Module:
    """Cut `module` (stage 2 built at full size, on any device, meta
    included) into this rank's shards in place, and give its modules their
    roles: every SelfAttention its local heads and the group (its input
    `copy`), the row-parallel and vocabulary-sharded Linears `tp` and
    `tp_mode` ('row' / 'vocab'), the feature-sharded tables `tp`.
    `module.layout` is set whenever the world is larger than one process
    (the samplers read its dp shard). Raises ValueError for a tp that does
    not divide a sharded dim or the heads."""
    if layout.world > 1:
        module.layout = layout
    tp = layout.tp_group
    if tp is None:
        return module
    check_tp_sizes(module, tp.size)
    for name, m in module.named_modules():
        for pname, p in list(m.named_parameters(recurse=False)):
            full = f'{name}.{pname}' if name else pname
            d = shard_dim(full, p.shape)
            if d is None:
                continue
            setattr(m, pname, nn.Parameter(
                _narrow(p.data, d, tp.rank, tp.size).clone(),
                requires_grad=p.requires_grad))
        parent = (_segments(f'{name}.weight') or [''])[-1]
        if hasattr(m, 'n_heads'):
            m.n_heads //= tp.size
            m.tp = tp
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
            if parent in ROW or parent.startswith('head'):
                m.tp = tp
                m.tp_mode = 'row' if parent in ROW else 'vocab'
        elif isinstance(m, nn.Embedding) and parent.startswith('tok_emb'):
            m.embedding_dim = m.weight.shape[1]
            m.tp = tp
    return module


def shard_state(state: Mapping[str, torch.Tensor],
                layout: Optional[ParallelLayout]) -> Dict[str, torch.Tensor]:
    """A full stage-2 state dict (or a dict of per-parameter tensors of
    the same shapes: Adam's moments) cut to this rank's shards (copies);
    unchanged without tensor parallelism."""
    tp = None if layout is None else layout.tp_group
    if tp is None:
        return dict(state)
    out = {}
    for k, v in state.items():
        d = shard_dim(k, v.shape)
        out[k] = v if d is None else \
            _narrow(v, d, tp.rank, tp.size).contiguous().clone()
    return out


def gather_state(state: Mapping[str, torch.Tensor],
                 layout: Optional[ParallelLayout]) -> Dict[str, torch.Tensor]:
    """Inverse of `shard_state`, on every rank of the tp group (a
    collective: every rank calls it with the same names, in the same
    order)."""
    tp = None if layout is None else layout.tp_group
    if tp is None:
        return dict(state)
    out = {}
    for k, v in state.items():
        v = v.detach()
        # the shard's shape names the same dim as the full tensor's
        d = shard_dim(k, v.shape)
        if d is None:
            out[k] = v
            continue
        moved = v.movedim(d, -1)
        out[k] = tp.gather(moved).movedim(-1, d).contiguous()
    return out
