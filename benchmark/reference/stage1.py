"""Stage 1 of HQ-Transformer (the HQ-VAE) in plain float32 PyTorch: its
encoder, its nearest-code search and its decoder, for the 2-level
`simrqgan2` and the N-level `hqvae` with the pixel-shuffle resampler.

Weights are a state dict in the reference key layout; the network's
structure is read from the keys (`encoder.down.<i>.block.<j>`,
`decoder.up.<i>.attn.<j>`, `nin_shortcut`, `upsample`, ...). Blocks:
GroupNorm of 32 groups (eps 1e-6), swish, 3x3 convolutions, a 1x1
shortcut where the width changes; single-head attention over the
positions with 1x1 q, k, v and output convolutions, scale C^-1/2; the
encoder's stride-2 4x4 input convolution, its downsampling a (0, 1, 0, 1)
zero pad and a stride-2 3x3 convolution; the decoder's upsampling nearest
2x and a 3x3 convolution. Images and pixels are NHWC; code maps
[B, h, w].

The 2-level model codes the bottom latent z [B, 16, 16, C] in two
levels: the top codes are the nearest to z pixel-unshuffled by 2 (a
4C-wide codebook, `quantize_t`), the bottom ones the nearest to z less the
top codes' vectors pixel-shuffled back (`quantize_b`); the decoder reads
[shuffled top vectors, bottom vectors] through `post_quant_conv_b`. The
N-level model sums the levels' vectors, shuffling the running sum up one
level at a time (`quantizers.<l>`), and decodes the sum.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .lowp import F32, Precision

Weights = Dict[str, torch.Tensor]


def _w(w: Weights, name: str) -> torch.Tensor:
    return w[name].float()


def conv(w: Weights, name: str, x: torch.Tensor, rnd: Precision,
         stride: int = 1, padding: int = None) -> torch.Tensor:
    k = w[f'{name}.weight'].shape[-1]
    return F.conv2d(rnd(x), rnd(_w(w, f'{name}.weight')),
                    _w(w, f'{name}.bias'), stride,
                    k // 2 if padding is None else padding)


def norm(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, 32, _w(w, f'{name}.weight'), _w(w, f'{name}.bias'),
                        1e-6)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def resblock(w: Weights, name: str, x: torch.Tensor,
             rnd: Precision) -> torch.Tensor:
    h = conv(w, f'{name}.conv1', swish(norm(w, f'{name}.norm1', x)), rnd)
    h = conv(w, f'{name}.conv2', swish(norm(w, f'{name}.norm2', h)), rnd)
    if f'{name}.nin_shortcut.weight' in w:
        x = conv(w, f'{name}.nin_shortcut', x, rnd)
    return x + h


def attnblock(w: Weights, name: str, x: torch.Tensor,
              rnd: Precision) -> torch.Tensor:
    B, C, H, W = x.shape
    h = norm(w, f'{name}.norm', x)
    q, k, v = (conv(w, f'{name}.{p}', h, rnd).reshape(B, C, H * W)
               for p in 'qkv')
    att = torch.softmax(rnd(q).transpose(1, 2) @ rnd(k) * C ** -0.5, dim=-1)
    out = (rnd(v) @ rnd(att).transpose(1, 2)).reshape(B, C, H, W)
    return x + conv(w, f'{name}.proj_out', out, rnd)


def _count(w: Weights, prefix: str) -> int:
    """How many numbered children `<prefix>.<i>.` the keys have."""
    n = 0
    while any(k.startswith(f'{prefix}.{n}.') for k in w):
        n += 1
    return n


def _level(w: Weights, name: str, h: torch.Tensor,
           rnd: Precision) -> torch.Tensor:
    """A level's resblocks, each followed by its attention block where the
    level has them."""
    for j in range(_count(w, f'{name}.block')):
        h = resblock(w, f'{name}.block.{j}', h, rnd)
        if f'{name}.attn.{j}.q.weight' in w:
            h = attnblock(w, f'{name}.attn.{j}', h, rnd)
    return h


def _mid(w: Weights, name: str, h: torch.Tensor,
         rnd: Precision) -> torch.Tensor:
    if f'{name}.mid.block_1.conv1.weight' not in w:
        return h
    h = resblock(w, f'{name}.mid.block_1', h, rnd)
    if f'{name}.mid.attn_1.q.weight' in w:
        h = attnblock(w, f'{name}.mid.attn_1', h, rnd)
    return resblock(w, f'{name}.mid.block_2', h, rnd)


def encoder(w: Weights, x: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """Images NCHW -> the encoder's output NCHW."""
    if w['encoder.conv_in.weight'].shape[-1] == 4:    # initial downsample
        h = conv(w, 'encoder.conv_in', x, rnd, stride=2, padding=1)
    else:
        h = conv(w, 'encoder.conv_in', x, rnd)
    for i in range(_count(w, 'encoder.down')):
        h = _level(w, f'encoder.down.{i}', h, rnd)
        if f'encoder.down.{i}.downsample.conv.weight' in w:
            h = conv(w, f'encoder.down.{i}.downsample.conv',
                     F.pad(h, (0, 1, 0, 1)), rnd, stride=2, padding=0)
    h = _mid(w, 'encoder', h, rnd)
    return conv(w, 'encoder.conv_out', swish(norm(w, 'encoder.norm_out', h)),
                rnd)


def decoder(w: Weights, z: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """Latent NCHW -> pixels NCHW in about [-1, 1]."""
    h = _mid(w, 'decoder', conv(w, 'decoder.conv_in', z, rnd), rnd)
    for i in reversed(range(_count(w, 'decoder.up'))):
        h = _level(w, f'decoder.up.{i}', h, rnd)
        if f'decoder.up.{i}.upsample.conv.weight' in w:
            h = conv(w, f'decoder.up.{i}.upsample.conv',
                     F.interpolate(h, scale_factor=2, mode='nearest'), rnd)
    return conv(w, 'decoder.conv_out', swish(norm(w, 'decoder.norm_out', h)),
                rnd)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _shuffle(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixel shuffle by 2: [B, H, W, 4C] -> [B, 2H, 2W, C], channel
    c * 4 + i * 2 + j going to (2h + i, 2w + j, c)."""
    return _nhwc(F.pixel_shuffle(_nchw(x), 2))


def _unshuffle(x: torch.Tensor) -> torch.Tensor:
    return _nhwc(F.pixel_unshuffle(_nchw(x), 2))


def _pixels(w: Weights, quant: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """Decoder input NHWC -> pixels NHWC in [0, 1], as the samplers clamp
    them."""
    out = decoder(w, conv(w, 'post_quant_conv_b', _nchw(quant), rnd), rnd)
    return torch.clamp(_nhwc(out) * 0.5 + 0.5, 0.0, 1.0)


def _codebook(w: Weights, name: str) -> torch.Tensor:
    return _w(w, f'{name}.embedding')


def decode_2level(w: Weights, code_t: torch.Tensor, code_b: torch.Tensor,
                  rnd: Precision = F32) -> torch.Tensor:
    """Pixels [B, H, W, 3] in [0, 1] of code maps code_t [B, h, w] and
    code_b [B, 2h, 2w]."""
    q_t = F.embedding(code_t.long(), _codebook(w, 'quantize_t'))
    q_b = F.embedding(code_b.long(), _codebook(w, 'quantize_b'))
    return _pixels(w, torch.cat([_shuffle(q_t), q_b], dim=-1), rnd)


def decode_levels(w: Weights, codes: Sequence[torch.Tensor],
                  rnd: Precision = F32) -> torch.Tensor:
    """Pixels [B, H, W, 3] in [0, 1] of the N-level code maps, top first,
    each twice the side of the one above."""
    quant = 0
    for level, code in enumerate(codes):
        quant = quant + F.embedding(code.long(),
                                    _codebook(w, f'quantizers.{level}'))
        if level < len(codes) - 1:
            quant = _shuffle(quant)
    return _pixels(w, quant, rnd)


def _distances(flat: torch.Tensor, codebook: torch.Tensor,
               rnd: Precision) -> torch.Tensor:
    """Squared distances [N, K] of the rows flat [N, C] to the codes."""
    return (flat * flat).sum(1, keepdim=True) - \
        2 * rnd(flat) @ rnd(codebook).T + (codebook * codebook).sum(1)[None]


def nearest(z: torch.Tensor, codebook: torch.Tensor,
            rnd: Precision = F32) -> torch.Tensor:
    """The nearest code of each row of z [..., C] in codebook [K, C] by
    squared distance, the lowest index on a tie."""
    flat = z.reshape(-1, z.shape[-1])
    return torch.argmin(_distances(flat, codebook, rnd), dim=1).reshape(
        z.shape[:-1])


def latent_2level(w: Weights, images: torch.Tensor,
                  rnd: Precision = F32) -> torch.Tensor:
    """The bottom latent z [B, h, w, C] of images [B, H, W, 3] in
    [-1, 1]."""
    return _nhwc(conv(w, 'quant_conv_b', encoder(w, _nchw(images), rnd),
                      rnd))


def encode_2level(w: Weights, images: torch.Tensor, rnd: Precision = F32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codes (code_t [B, h/2, w/2], code_b [B, h, w]) of images
    [B, H, W, 3] in [-1, 1]."""
    z = latent_2level(w, images, rnd)
    e_t, e_b = _codebook(w, 'quantize_t'), _codebook(w, 'quantize_b')
    code_t = nearest(_unshuffle(z), e_t, rnd)
    code_b = nearest(z - _shuffle(F.embedding(code_t, e_t)), e_b, rnd)
    return code_t, code_b


def code_gaps(w: Weights, z: torch.Tensor, code_t: torch.Tensor,
              code_b: torch.Tensor) -> Tuple[float, float]:
    """Judge 2-level codes (code_t [B, h/2, w/2], code_b [B, h, w]) by the
    reference's latent z [B, h, w, C]: at every position the gap between
    the squared distance of the given code and the nearest one's, over the
    nearest one's; the bottom level's residual taken under the given top
    codes. Returns (the widest gap, the share of codes not the nearest)."""
    e_t, e_b = _codebook(w, 'quantize_t'), _codebook(w, 'quantize_b')
    worst, differ, total = 0.0, 0, 0
    for x, e, code in ((_unshuffle(z), e_t, code_t),
                       (z - _shuffle(F.embedding(code_t.long(), e_t)), e_b,
                        code_b)):
        d = _distances(x.reshape(-1, x.shape[-1]), e, F32)
        best = d.min(dim=1)
        got = d.gather(1, code.reshape(-1, 1).long())[:, 0]
        worst = max(worst, float(((got - best.values) /
                                  best.values.abs()).max()))
        differ += int((code.reshape(-1) != best.indices).sum())
        total += code.numel()
    return worst, differ / total


def decode(w: Weights, codes: List[torch.Tensor],
           rnd: Precision = F32) -> torch.Tensor:
    """Pixels of the code maps of either model (2 maps: `simrqgan2`)."""
    if len(codes) == 2 and 'quantize_t.embedding' in w:
        return decode_2level(w, *codes, rnd=rnd)
    return decode_levels(w, codes, rnd=rnd)
