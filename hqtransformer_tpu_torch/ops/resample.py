"""Pixel (un)shuffle in NHWC layout, with the channel order of
torch.nn.PixelShuffle so that top-codebook dimensions transfer 1:1: the
channel index of a [B, H, W, C*r*r] map is c*r*r + i*r + j."""

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
