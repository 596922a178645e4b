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
* `scale` (norms) and `embedding` (nn.Embed) become `weight`, but a
  learned codebook becomes its quantizer's `embedding.weight`; the JAX
  export names that of an N-level HQ-VAE level `quantizers.<n>.weight`,
  which is not the reference's layout;
* `ema` leaves (the EMA codebooks) keep their names.

`convert_scales` carries the int8 serving collections (`act_scales`,
`kv_scales`) to the port's module names by the same segment mapping, and
`export_scales` takes them back to flax paths.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

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


# The inverse of _PATTERNS, matched at the start of a port module name.
_INVERSE = [
    (re.compile(r'^(down|up)\.(\d+)\.(block|attn)\.(\d+)(?=\.|$)'),
     r'\1_\2_\3_\4'),
    (re.compile(r'^(down|up)\.(\d+)\.(downsample|upsample)(?=\.|$)'),
     r'\1_\2_\3'),
    (re.compile(r'^mid\.(block_1|attn_1|block_2)(?=\.|$)'), r'mid_\1'),
    (re.compile(r'^(downsamples|upsamples|quantizers|blocks|depths|'
                r'emb_blocks|tok_emb_levels|tok_emb_depth_levels|'
                r'pos_emb_depths|ln_levels|head_levels|upsample_t|main|mlp)'
                r'\.(\d+)(?=\.|$)'), r'\1_\2'),
]

# The int8 serving collections: {'stage/collection': flax tree}, the JAX
# package's artifact. An act_scales leaf is a module's 'scale'; kv_scales
# leaves are an attention layer's 'k' and 'v'.
SCALE_COLLECTIONS = ('stage1/act_scales', 'stage2/kv_scales',
                     'stage2/act_scales')


def _segment(seg: str) -> str:
    for pat, repl in _PATTERNS:
        m = pat.match(seg)
        if m:
            return repl(m)
    return seg


def _flax_path(name: str) -> List[str]:
    """A port module name -> its flax path segments."""
    segs = []
    while name:
        for pat, repl in _INVERSE:
            m = pat.match(name)
            if m:
                segs.append(m.expand(repl))
                name = name[m.end():].removeprefix('.')
                break
        else:
            seg, _, name = name.partition('.')
            segs.append(seg)
    return segs


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
                # a learned codebook is its quantizer's nn.Embedding, in
                # quantize, quantize_t / _b and quantizers.<n> alike
                if segs and segs[-1].startswith('quantize'):
                    out[key('embedding.weight')] = arr
                else:
                    out[key('weight')] = arr
            else:
                out[key(name)] = arr
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}



def convert_scales(scales: Mapping[str, Any]) -> Dict[str, Dict[str,
                                                                torch.Tensor]]:
    """JAX serving scales {'stage1/act_scales' | 'stage2/kv_scales' |
    'stage2/act_scales': flax tree} -> {same key: {port name: f32 tensor}}:
    'blocks_0/attn/query/scale' becomes 'blocks.0.attn.query' and
    'blocks_0/attn/k' 'blocks.0.attn.k'. Collections absent stay absent;
    others raise."""
    out = {}
    for key, tree in scales.items():
        if key not in SCALE_COLLECTIONS:
            raise ValueError(f'cannot convert scale collection {key!r}')
        act = key.endswith('act_scales')
        coll = {}
        for path, leaf in _leaves(tree):
            segs = [_segment(s) for s in path]
            if act:
                if segs[-1] != 'scale':
                    raise ValueError(f'{key}: unexpected leaf {path}')
                segs = segs[:-1]
            coll['.'.join(segs)] = torch.from_numpy(
                np.array(leaf, dtype=np.float32))
        out[key] = coll
    return out


def export_scales(scales: Mapping[str, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, Dict[str, Any]]:
    """The inverse of convert_scales: the port's collections -> flax trees
    of f32 numpy arrays, the JAX package's artifact layout."""
    out = {}
    for key, coll in scales.items():
        if key not in SCALE_COLLECTIONS:
            raise ValueError(f'cannot export scale collection {key!r}')
        tree: Dict[str, Any] = {}
        for name, t in coll.items():
            path = _flax_path(name)
            if key.endswith('act_scales'):
                path.append('scale')
            node = tree
            for seg in path[:-1]:
                node = node.setdefault(seg, {})
            node[path[-1]] = t.detach().float().cpu().numpy()
        out[key] = tree
    return out


def fid_inception_state_from_jax(variables: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's FID-Inception variables {'params', 'batch_stats'}
    -> the port's state dict (the pt_inception-2015-12-05 layout): the
    inverse of `hqtransformer_tpu.evaluation.inception.
    load_torch_fid_inception`. Conv kernels HWIO -> OIHW, BatchNorm
    scale / bias / mean / var -> weight / bias / running_mean /
    running_var, the fc kernel transposed."""
    names = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
             ('batch_stats', 'mean'): 'running_mean',
             ('batch_stats', 'var'): 'running_var'}
    out: Dict[str, torch.Tensor] = {}
    for col in ('params', 'batch_stats'):
        for path, leaf in _leaves(variables[col]):
            arr = np.asarray(leaf, dtype=np.float32)
            base = '.'.join(path[:-1])
            if path[-1] == 'kernel':
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                out[f'{base}.weight'] = arr
            elif path[:-1] == ('fc',):
                out[f'fc.{path[-1]}'] = arr
            else:
                out[f'{base}.{names[col, path[-1]]}'] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
