"""Spatial resampling in NHWC layout, the port's copy of
`hqtransformer_tpu/ops/resample.py`: pixel (un)shuffle, average pooling,
nearest upsampling, and the stride-k kernel-k conv and conv-transpose as a
pixel (un)shuffle and one product.

Pixel (un)shuffle keep the channel order of torch.nn.PixelShuffle so that
top-codebook dimensions transfer 1:1: the channel index of a
[B, H, W, C*r*r] map is c*r*r + i*r + j. The conv weights are in torch's
layouts (Conv2d OIHW, ConvTranspose2d [Cin, Cout, k, k]), the layouts of
the port's state dicts.
"""

from __future__ import annotations

import torch


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H*r, W*r, C] -> [B, H, W, C*r*r]."""
    B, Hr, Wr, C = x.shape
    H, W = Hr // r, Wr // r
    x = x.reshape(B, H, r, W, r, C).permute(0, 1, 3, 5, 2, 4)  # B,H,W,C,i,j
    return x.reshape(B, H, W, C * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C*r*r] -> [B, H*r, W*r, C] (inverse of pixel_unshuffle)."""
    B, H, W, Cr2 = x.shape
    C = Cr2 // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)  # B,H,i,W,j,C
    return x.reshape(B, H * r, W * r, C)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/k, W/k, C], the mean of each k x k window."""
    B, H, W, C = x.shape
    return x.reshape(B, H // k, k, W // k, k, C).mean(dim=(2, 4))


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*scale, W*scale, C], each pixel repeated (torch's
    interpolate(mode='nearest') at an integer scale)."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def space_to_depth_conv(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-k, kernel-k, unpadded conv of NHWC x with an OIHW weight
    [Cout, Cin, k, k]: each output pixel sees one disjoint k x k patch, so
    it is the product of the pixel-unshuffled map, whose (c, i, j) channel
    order is the weight's flattened order, with the weight."""
    return pixel_unshuffle(x, k) @ weight.reshape(weight.shape[0], -1).T \
        + bias


def depth_to_space_conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-k, kernel-k, unpadded conv-transpose of NHWC x with a weight
    [Cin, Cout, k, k]: each input pixel paints a disjoint k x k patch,
    out[h*k + i, w*k + j, o] = sum_c x[h, w, c] weight[c, o, i, j], which is
    one product and a pixel shuffle; the bias is added after the shuffle."""
    return pixel_shuffle(x @ weight.reshape(weight.shape[0], -1), k) + bias
