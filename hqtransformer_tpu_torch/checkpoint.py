"""Reading the PyTorch reference's checkpoints, and the port's training
checkpoints.

Counterpart of `hqtransformer_tpu/checkpoint.py::load_torch_checkpoint` and
of the key split in `TwoStageModel.load_reference_checkpoint`
(`hqtransformer_tpu/models/twostage.py`). The port's modules already use
the reference's key layout, so a reference state dict needs no renaming:
its `stage1.` and `stage2.` prefixes split it into the two stages' state
dicts, fp16 and bf16 tensors become f32, and the BatchNorm counters
(`num_batches_tracked`), which no module of the port holds, are dropped,
as the JAX converter skips them. `TwoStageModel.load_reference_checkpoint`
then checks every key and shape against its modules.

The JAX package also restores its own Orbax checkpoint directories; Orbax
is a JAX library, and the port reads none: its models load from reference
files (`.ckpt`, `.pth`, `.pt`, `REFERENCE_SUFFIXES`).

Training checkpoints (the counterparts of the JAX `save_checkpoint`,
`restore_checkpoint` and `latest_step`) are the port's own: a tree of
tensors, ints and dicts (a trainer's state, `train/stage2.py::
train_state_dict`, `train/stage1.py::stage1_state_dict`) saved with
`torch.save` as `<dir>/<step>/state.pt`. The sampler-ready bundle of a
stage-2 run (`save_reference_bundle`) is a reference-layout `.ckpt`, its
state dict under 'stage1.' and 'stage2.' keys, which
`TwoStageModel.load_reference_checkpoint` and the sampling CLIs read.
Under a parallel layout (`parallel/tp.py`) both hold whole tensors (the
stage-2 shards gathered over the tp group), rank 0 writes them, and every
rank waits on a barrier until the file is there.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from .parallel.tp import ParallelLayout, gather_state

REFERENCE_SUFFIXES = ('.ckpt', '.pth', '.pt')
STAGES = ('stage1', 'stage2')


def check_reference_path(path: str) -> str:
    """`path` if it names a reference checkpoint file, else ValueError: an
    Orbax directory is the JAX package's format, and a stage-2 run of the
    port leaves its sampler-ready `.ckpt` under `ckpt_full/`."""
    if not str(path).endswith(REFERENCE_SUFFIXES):
        raise ValueError(
            f'{path!r}: the port reads the reference\'s PyTorch checkpoints '
            f'({", ".join(REFERENCE_SUFFIXES)}) only; Orbax checkpoint '
            f'directories are the JAX package\'s (a stage-2 training run of '
            f'the port writes ckpt_full/<step>.ckpt)')
    return path


def widen(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`sd` with its fp16 and bf16 tensors converted to f32."""
    return {k: v.float() if v.dtype in (torch.float16, torch.bfloat16)
            else v for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a Lightning `.ckpt` (its 'state_dict' entry) or
    of a bare saved state dict, on the CPU, `widen`ed. The file is
    unpickled in full (Lightning files pickle their hyper-parameters
    too): load only trusted files."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    return widen(ckpt.get('state_dict', ckpt))


def split_reference_state(sd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'stage1': ..., 'stage2': ...}: the entries of `sd` under each
    stage's prefix, the prefix removed; `num_batches_tracked` counters and
    keys of neither stage (a stage-1 trainer's discriminator, say) are
    left out."""
    out = {stage: {} for stage in STAGES}
    for key, value in sd.items():
        stage, _, name = key.partition('.')
        if stage in out and not name.endswith('num_batches_tracked'):
            out[stage][name] = value
    return out


STATE_FILE = 'state.pt'


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    layout: Optional[ParallelLayout] = None) -> str:
    """Save a training state's tree (tensors moved to the CPU) as
    `<path>/<step>/state.pt`; returns that file. Under `layout` (whose
    tree holds whole tensors: `train_state_dict(state, layout)`) rank 0
    writes and every rank waits for it."""
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, Mapping):
            return {k: cpu(v) for k, v in x.items()}
        return x
    d = os.path.join(os.path.abspath(path), str(step))
    out = os.path.join(d, STATE_FILE)
    if layout is None or layout.rank == 0:
        os.makedirs(d, exist_ok=True)
        torch.save(cpu(tree), out + '.tmp')
        os.replace(out + '.tmp', out)
    if layout is not None:
        layout.barrier()
    return out


def restore_checkpoint(path: str, step: int = 0) -> Any:
    """The tree `save_checkpoint` wrote for `step` under `path`, on the
    CPU. It unpickles: load only checkpoints you wrote."""
    return torch.load(os.path.join(os.path.abspath(path), str(step),
                                   STATE_FILE),
                      map_location='cpu', weights_only=False)


def latest_step(path: str) -> int:
    """The largest step with a saved state under `path`; raises
    FileNotFoundError naming the layout when there is none."""
    steps = [int(p) for p in os.listdir(path) if p.isdigit() and
             os.path.exists(os.path.join(path, p, STATE_FILE))]
    if not steps:
        raise FileNotFoundError(
            f'no checkpoint steps under {path} (expected <step>/{STATE_FILE}'
            f' as the port\'s trainers write under <run>/ckpt; pass that '
            f'ckpt directory, not the run directory)')
    return max(steps)


def save_reference_bundle(path: str, stage1: Mapping[str, torch.Tensor],
                          stage2: Mapping[str, torch.Tensor],
                          step: int = 0,
                          layout: Optional[ParallelLayout] = None) -> str:
    """Write both stages' state dicts as one reference-layout `.ckpt` at
    `path`: {'state_dict': {'stage1.<k>' | 'stage2.<k>': f32 tensor},
    'global_step': step}. Under `layout` `stage2` is this rank's shards:
    every rank calls it, the shards are gathered, rank 0 writes."""
    stage2 = gather_state(stage2, layout)
    if layout is None or layout.rank == 0:
        sd = {f'{stage}.{k}': v.detach().float().cpu()
              for stage, state in (('stage1', stage1), ('stage2', stage2))
              for k, v in state.items()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({'state_dict': sd, 'global_step': step}, path)
    if layout is not None:
        layout.barrier()
    return path
