"""JAX variables -> the port's state dicts.

Turns the JAX package's flax variables (nested dicts of arrays, with the
`params` and `ema` collections) into a flat state dict in the PyTorch
reference's key layout, which is the layout of the port's modules. This is
the port's own copy of the mapping that the JAX package's
`checkpoint.export_torch_state_dict` applies:

* list entries `blocks_3`, `mlp_0`, `down_1_block_0`, `down_0_downsample`,
  `up_3_block_0`, `mid_block_1`, `quantizers_2` become `blocks.3`, `mlp.0`,
  `down.1.block.0`, `down.0.downsample`, `up.3.block.0`, `mid.block_1`,
  `quantizers.2`;
* a Dense kernel [I, O] becomes a weight [O, I]; a conv kernel HWIO becomes
  OIHW (`transpose(3, 2, 0, 1)`), except the conv-transpose upsamplers,
  which already keep the torch layout;
* `scale` (norms) and `embedding` (nn.Embed) become `weight`;
* `ema` leaves (the quantizer codebooks) keep their names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PATTERNS = [
    (re.compile(r'^(down|up)_(\d+)_(block|attn)_(\d+)$'),
     lambda m: f'{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}'),
    (re.compile(r'^(down|up)_(\d+)_(downsample|upsample)$'),
     lambda m: f'{m.group(1)}.{m.group(2)}.{m.group(3)}'),
    (re.compile(r'^mid_(block_1|attn_1|block_2)$'),
     lambda m: f'mid.{m.group(1)}'),
    (re.compile(r'^(downsamples|upsamples|quantizers|blocks|depths|'
                r'emb_blocks|tok_emb_levels|tok_emb_depth_levels|'
                r'pos_emb_depths|ln_levels|head_levels)_(\d+)$'),
     lambda m: f'{m.group(1)}.{m.group(2)}'),
    (re.compile(r'^upsample_t_0$'), lambda m: 'upsample_t.0'),
    (re.compile(r'^main_(\d+)$'), lambda m: f'main.{m.group(1)}'),
    (re.compile(r'^mlp_(\d+)$'), lambda m: f'mlp.{m.group(1)}'),
]


def _segment(seg: str) -> str:
    for pat, repl in _PATTERNS:
        m = pat.match(seg)
        if m:
            return repl(m)
    return seg


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables {'params': ..., 'ema': ...} -> {torch key: f32 tensor}.
    Raises on any other collection."""
    out: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        if col not in ('params', 'ema'):
            raise ValueError(f'cannot convert collection {col!r}')
        for path, leaf in _leaves(tree):
            arr = np.asarray(leaf, dtype=np.float32)
            segs = [_segment(s) for s in path[:-1]]
            name = path[-1]
            base = '.'.join(segs)

            def key(tail: str) -> str:
                return f'{base}.{tail}' if base else tail

            if col == 'ema':
                out[key(name)] = arr
            elif name == 'kernel' and arr.ndim == 4:
                seg_last = segs[-1] if segs else ''
                if (seg_last.startswith('upsample')
                        and 'upsample_t.0' not in seg_last):
                    out[key('weight')] = arr   # conv-transpose: torch layout
                else:
                    out[key('weight')] = arr.transpose(3, 2, 0, 1)
            elif name == 'kernel':
                out[key('weight')] = arr.T
            elif name == 'scale':
                out[key('weight')] = arr
            elif name == 'embedding':
                if segs and segs[-1].split('.')[-1].startswith('quantize'):
                    out[key('embedding.weight')] = arr
                else:
                    out[key('weight')] = arr
            else:
                out[key(name)] = arr
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}

