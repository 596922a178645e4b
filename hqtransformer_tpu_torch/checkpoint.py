"""Reading the PyTorch reference's checkpoints.

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
is a JAX library, and the port reads reference files (`.ckpt`, `.pth`,
`.pt`) only (`REFERENCE_SUFFIXES`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

REFERENCE_SUFFIXES = ('.ckpt', '.pth', '.pt')
STAGES = ('stage1', 'stage2')


def check_reference_path(path: str) -> str:
    """`path` if it names a reference checkpoint file, else ValueError: an
    Orbax directory is the JAX package's format, and the port has no
    training checkpoints of its own yet."""
    if not str(path).endswith(REFERENCE_SUFFIXES):
        raise ValueError(
            f'{path!r}: the port reads the reference\'s PyTorch checkpoints '
            f'({", ".join(REFERENCE_SUFFIXES)}) only; Orbax checkpoint '
            f'directories are the JAX package\'s, and the port has no '
            f'training checkpoints of its own yet')
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
