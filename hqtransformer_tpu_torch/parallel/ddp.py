"""Data parallelism over processes: one process a card (or a CPU process
with gloo), each with a slice of the global batch.

The port's counterpart of `hqtransformer_tpu/parallel/mesh.py`'s 'dp'
axis. JAX shards one global batch over a device mesh and XLA reduces the
gradients and the EMA codebook statistics; here each rank's loader reads
its own shard (`LoaderConfig(shard_index=rank, shard_count=world)`), the
trainers average the gradients over the ranks before every update
(`average_gradients`) and sum the EMA statistics (`ops/quantize.py::
ema_update`, `distributed=True`), so every rank holds the same parameters
and codebooks, those of one process on the whole batch.

`init_distributed` starts the process group: NCCL on cards, gloo on the
CPU; by default from the environment `torchrun` gives each process (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or from an explicit
address, rank and world size. It returns the ('dp', 'tp') layout
(`parallel/tp.py`): with tensor parallelism the gradients are averaged
over the dp group only (`average_gradients(grads, layout.dp_group)`), the
tp ranks of a dp group holding the shards of one replica. Stage 1 stays data-parallel over the
whole world (`main_stage1.py`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .tp import ParallelLayout, make_layout


def init_distributed(device_type: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     tp: int = 1) -> ParallelLayout:
    """Start the default process group (NCCL for 'cuda', gloo otherwise)
    and return its layout with tensor-parallel size `tp`
    (`parallel/tp.py::make_layout`: ValueError if tp does not divide the
    world). Without `init_method`, the rank, world size and rendezvous
    come from torchrun's environment; a process on a card takes card
    LOCAL_RANK (with an explicit address, its rank)."""
    env = init_method is None
    if env:
        rank = int(os.environ['RANK'])
        world_size = int(os.environ['WORLD_SIZE'])
        local_rank = int(os.environ.get('LOCAL_RANK', rank))
        init_method = 'env://'
    else:
        local_rank = rank
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if device_type == 'cuda':
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return make_layout(tp, local_rank)


def average_gradients(grads: Dict[str, torch.Tensor],
                      group=None) -> None:
    """Replace every gradient by its mean over the ranks of `group` (the
    default group when None): one all-reduce of a flat buffer per
    dtype."""
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for names in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=group)
        flat /= torch.tensor(float(n), dtype=flat.dtype, device=flat.device)
        offset = 0
        for k in names:
            size = grads[k].numel()
            grads[k] = flat[offset:offset + size].view_as(grads[k])
            offset += size


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / torch.tensor(float(dist.get_world_size(group)),
                            dtype=x.dtype, device=x.device)


def cleanup() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
