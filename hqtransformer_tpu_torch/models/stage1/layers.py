"""VQGAN-style conv encoder and decoder: GroupNorm-32 (eps 1e-6), swish,
3x3 resblocks, single-head spatial attention with 1x1-conv QKV, asymmetric
stride-2 downsampling, nearest 2x upsampling.

Counterpart of `hqtransformer_tpu/models/stage1/layers.py` (`Encoder`,
`Decoder` and their blocks). The JAX modules run NHWC; these run NCHW,
PyTorch's conv layout, and the generator converts at its public functions.
Parameter names follow the PyTorch reference (`down.0.block.0.conv1.weight`,
`up.3.block.0.conv1.weight`, `mid.attn_1.q.weight`, ...).

Convolutions run in their input's dtype (weights may be stored in bf16);
GroupNorm computes in f32 and returns the input dtype; attention scores and
softmax are f32. Dropout is left out: the JAX package's training runs these
modules deterministic too.

The maps stay channels-last (NHWC in memory) from the first conv to the
last, as the generator hands them in: outside autograd, GroupNorm and the
swish after it run as one kernel on the card
(`ops/group_norm.py::group_norm_swish`), which keeps that layout, and
`AttnBlock` reads the map's pixels as views.

Training adds `Decoder(ret_pre_out=True)` and the PatchGAN discriminator
(`NLayerDiscriminator`, `nn.Sequential` names `main.<i>`, NHWC in and out)
with its three norms: GroupNorm, `ActNorm` (JAX's per-channel affine,
its scale named `weight` as the JAX export names it) and `FrozenBatchNorm`
(JAX's BatchNorm runs on its running statistics, `use_running_average`,
so this one never updates them and holds no batch counter).

The convolutions the JAX package builds through its `conv()` helper (its
`QuantizableConv`: the 'same' convs, the stride-2 `Downsample` conv and the
encoder's stride-2 `conv_in`) are `QuantizableConv2d` here: with `q8` set
(the generator's `int8_decode` sets it on all of them during an int8max
serving call) they run A8W8 (`ops/int8.py::int8_conv2d`).

Reproduced quirks, both of which decide where attention blocks sit:
- the encoder's `curr_res` starts at `resolution` even when
  `use_init_downsample` has already halved the map, so at the flagship
  config no level of the encoder has attention (only `mid.attn_1`);
- the decoder's `curr_res` does count `use_init_downsample` (it starts at
  resolution / 2**len(ch_mult) then), and with `use_init_downsample` level
  0 upsamples too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import group_norm as gn
from ...ops.int8 import Int8Weight, int8_conv2d


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32 groups, eps 1e-6, affine) computed in f32, and with
    `swish` the swish of its result. An input that needs a gradient takes
    `gn.group_norm_swish_plain` (F.group_norm, under autograd); any other
    goes to `gn.group_norm_swish` (the kernel on the card), whose output
    is channels-last."""

    def __init__(self, channels: int):
        super().__init__(num_groups=32, num_channels=channels, eps=1e-6)

    def forward(self, x: torch.Tensor, swish: bool = False) -> torch.Tensor:
        if torch.is_grad_enabled() and (x.requires_grad or
                                        self.weight.requires_grad or
                                        self.bias.requires_grad):
            return gn.group_norm_swish_plain(x, self.weight, self.bias,
                                             self.eps, swish)
        return gn.group_norm_swish(x, self.weight, self.bias, self.eps, swish)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes in its input's dtype: the JAX
    package's `TorchConvTranspose` (VQGAN2's 'deconv2d' upsample, k 4,
    stride 2, padding 1), whose kernel is already in torch's layout
    [Cin, Cout, k, k]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding)


class QuantizableConv2d(Conv2d):
    """Conv2d with the A8W8 path of int8max serving: with `q8` set, the
    input is quantized per tensor (static scale, else max|x| / 127) and
    convolved with the per-output-channel int8 weight, in int32. Always
    dense (no groups, no dilation), the JAX package's condition for its
    int8 branch."""

    q8: Optional[Int8Weight] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.q8 is None:
            return super().forward(x)
        return int8_conv2d(x, self.q8, self.kernel_size, self.stride,
                           self.padding)


def conv(cin: int, cout: int, kernel: int) -> QuantizableConv2d:
    """Stride-1 conv with 'same' padding."""
    return QuantizableConv2d(cin, cout, kernel, padding=kernel // 2)


class Upsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class Downsample(nn.Module):
    """Stride-2 3x3 conv after asymmetric (0, 1, 0, 1) zero padding, or a
    2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.conv = (QuantizableConv2d(channels, channels, 3, stride=2)
                     if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is None:
            return F.avg_pool2d(x, 2, 2)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class ResnetBlock(nn.Module):
    """norm-swish-conv twice, with a 1x1 shortcut when the width changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = conv(cin, cout, 3)
        self.norm2 = GroupNorm(cout)
        self.conv2 = conv(cout, cout, 3)
        if cin != cout:
            self.nin_shortcut = conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, swish=True))
        h = self.conv2(self.norm2(h, swish=True))
        if hasattr(self, 'nin_shortcut'):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over spatial positions, scale C**-0.5."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = conv(channels, channels, 1)
        self.k = conv(channels, channels, 1)
        self.v = conv(channels, channels, 1)
        self.proj_out = conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        # views in either layout: a channels-last map's [B, C, HW] is one
        q = self.q(h).reshape(B, C, H * W).transpose(1, 2)     # [B, HW, C]
        k = self.k(h).reshape(B, C, H * W)                     # [B, C, HW]
        v = self.v(h).reshape(B, C, H * W).transpose(1, 2)     # [B, HW, C]
        att = torch.matmul(q.float(), k.float()) * (C ** -0.5)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Encoder(nn.Module):
    """Downsampling encoder: x [B, in_channels, H, W] -> [B, z_channels
    (twice that with double_z), h, w]."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], in_channels: int,
                 resolution: int, z_channels: int, double_z: bool = False,
                 use_init_downsample: bool = False,
                 use_mid_block: bool = True, use_attn: bool = True):
        super().__init__()
        n_levels = len(ch_mult)
        if use_init_downsample:
            self.conv_in = QuantizableConv2d(in_channels, ch, 4, stride=2,
                                             padding=1)
        else:
            self.conv_in = conv(in_channels, ch, 3)

        curr_res = resolution   # the quirk: init downsample not counted
        block_in = ch
        self.down = nn.ModuleList()
        for i_level in range(n_levels):
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if use_attn and curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            level.downsample = None
            if i_level != n_levels - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)

        self.mid = None
        if use_mid_block:
            self.mid = nn.Module()
            self.mid.block_1 = ResnetBlock(block_in, block_in)
            self.mid.attn_1 = AttnBlock(block_in) if use_attn else None
            self.mid.block_2 = ResnetBlock(block_in, block_in)

        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv(block_in,
                             2 * z_channels if double_z else z_channels, 3)

    def forward(self, x: torch.Tensor, ret_bottom: bool = False):
        """With ret_bottom, also returns the input of the last downsample
        (h_prev)."""
        h = self.conv_in(x)
        h_prev = None
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if level.downsample is not None:
                h_prev = h
                h = level.downsample(h)
        if self.mid is not None:
            h = self.mid.block_1(h)
            if self.mid.attn_1 is not None:
                h = self.mid.attn_1(h)
            h = self.mid.block_2(h)
        h = self.conv_out(self.norm_out(h, swish=True))
        return (h, h_prev) if ret_bottom else h


class Decoder(nn.Module):
    """Upsampling decoder: z [B, z_channels, h, w] -> [B, out_ch, H, W]."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int],
                 num_res_blocks: int, attn_resolutions: Sequence[int],
                 resolution: int, z_channels: int,
                 use_init_downsample: bool = False,
                 use_mid_block: bool = True, use_attn: bool = True):
        super().__init__()
        n_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (
            n_levels if use_init_downsample else n_levels - 1)
        self.conv_in = conv(z_channels, block_in, 3)

        self.mid = None
        if use_mid_block:
            self.mid = nn.Module()
            self.mid.block_1 = ResnetBlock(block_in, block_in)
            self.mid.attn_1 = AttnBlock(block_in) if use_attn else None
            self.mid.block_2 = ResnetBlock(block_in, block_in)

        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if use_attn and curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            level.upsample = None
            if i_level != 0 or use_init_downsample:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)

        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv(block_in, out_ch, 3)

    def forward(self, z: torch.Tensor, ret_pre_out: bool = False):
        """With ret_pre_out, also returns the features conv_out reads (the
        adaptive GAN weight differentiates through that last conv)."""
        h = self.conv_in(z)
        if self.mid is not None:
            h = self.mid.block_1(h)
            if self.mid.attn_1 is not None:
                h = self.mid.attn_1(h)
            h = self.mid.block_2(h)
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if level.upsample is not None:
                h = level.upsample(h)
        pre = self.norm_out(h, swish=True)
        out = self.conv_out(pre)
        return (out, pre) if ret_pre_out else out


class ActNorm(nn.Module):
    """Per-channel affine weight * (x + loc) of NCHW maps; loc starts at 0
    and weight at 1, as in JAX (no data-dependent init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)[:, None, None]
        return w * (x + self.loc.to(x.dtype)[:, None, None])


class FrozenBatchNorm(nn.Module):
    """BatchNorm (eps 1e-5) on its running statistics, which it never
    updates: flax's BatchNorm with use_running_average=True, computed in
    f32 and returned in the input dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(), False,
                            0.0, 1e-5).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator: a k 4 stride 2 conv and leaky ReLU(0.2),
    n_layers - 1 more stride-2 convs and one stride-1 conv, each with its
    norm ('bn', 'gn' or 'actnorm'; convs before a norm biased only under
    'actnorm', as in JAX), then a k 4 conv to one logit channel. Images
    NHWC [B, H, W, C] in, logits NHWC [B, h, w, 1] out, in `dtype`."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = 'bn', dtype: torch.dtype = torch.float32):
        super().__init__()
        norms = {'bn': FrozenBatchNorm, 'gn': GroupNorm, 'actnorm': ActNorm}
        if norm_type not in norms:
            raise ValueError(f'{norm_type} is not supported..')
        norm = norms[norm_type]
        use_bias = norm_type == 'actnorm'
        self.dtype = dtype
        layers = [Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * nf_prev, ndf * nf_mult, 4,
                              stride=2 if n < n_layers else 1, padding=1,
                              bias=use_bias),
                       norm(ndf * nf_mult), nn.LeakyReLU(0.2)]
        layers.append(Conv2d(ndf * nf_mult, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.permute(0, 3, 1, 2).to(self.dtype)).permute(
            0, 2, 3, 1)
