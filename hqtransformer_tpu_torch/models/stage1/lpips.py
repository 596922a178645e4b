"""LPIPS perceptual distance: a frozen VGG16 feature stack and learned
1x1 linear heads.

Counterpart of `hqtransformer_tpu/models/stage1/lpips.py`. Inputs are NHWC
images in [-1, 1]; both are shifted and scaled to ImageNet statistics, run
through VGG16's 13 convolutions (ReLU, 2x2 max pools before convs 5, 10,
17 and 24 of torchvision's `features`), and tapped after relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3. Each tap is unit-normalized over channels,
the squared difference of the two images' taps goes through a 1x1 conv
`lin<i>` to one channel and is averaged over space; the five are summed
and averaged over the batch. Convolutions run in `dtype`.

Names follow the JAX export (`net.conv_<seq>.weight`, `lin<i>.weight`), so
a JAX LPIPS's variables load strictly. No weights are in the repository:
`load_torch_vgg16` takes a torchvision VGG16 state dict
(`features.<seq>.*`), `load_torch_lpips_lins` the heads
(`lin<i>.model.1.weight`), `load_reference_lpips` a whole reference LPIPS
(`net.slice<s>.<seq>.*` and the heads). `init_lpips` gives seeded random
weights (He-scaled convolutions, non-negative heads), which are not a
perceptual metric: they only exercise the path.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

# torchvision VGG16 `features` convs: (Sequential index, out channels)
VGG16_CONVS = [(0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
               (14, 256), (17, 512), (19, 512), (21, 512), (24, 512),
               (26, 512), (28, 512)]
TAP_AFTER_CONV = (1, 3, 6, 9, 12)
POOL_BEFORE = (5, 10, 17, 24)
LPIPS_CHNS = [64, 128, 256, 512, 512]
# the reference LPIPS's five VGG slices, as Sequential index ranges
SLICES = [(0, 4), (4, 9), (9, 16), (16, 23), (23, 30)]


class VGG16Features(nn.Module):
    """VGG16's feature convolutions; forward gives the five LPIPS taps
    (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for seq, cout in VGG16_CONVS:
            self.add_module(f'conv_{seq}', Conv2d(cin, cout, 3, padding=1))
            cin = cout

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, (seq, _) in enumerate(VGG16_CONVS):
            if seq in POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(getattr(self, f'conv_{seq}')(x))
            if i in TAP_AFTER_CONV:
                taps.append(x)
        return taps


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x over its channel norm (NCHW)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer('shift', torch.tensor([-.030, -.088, -.188]),
                             persistent=False)
        self.register_buffer('scale', torch.tensor([.458, .448, .450]),
                             persistent=False)
        self.net = VGG16Features()
        for i, c in enumerate(LPIPS_CHNS):
            self.add_module(f'lin{i}', Conv2d(c, 1, 1, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The mean LPIPS distance of NHWC image batches x and y."""
        def feats(im):
            im = ((im - self.shift) / self.scale).permute(0, 3, 1, 2)
            return self.net(im.to(self.dtype))

        val = 0.0
        for i, (a, b) in enumerate(zip(feats(x), feats(y))):
            diff = torch.square(normalize_tensor(a) - normalize_tensor(b))
            val = val + torch.mean(getattr(self, f'lin{i}')(diff),
                                   dim=(2, 3))
        return val.mean()


def init_lpips(seed: int = 0, dtype: torch.dtype = torch.float32,
               device: Optional[str] = None) -> LPIPS:
    """An LPIPS with seeded random weights on `device` (default: the CPU),
    drawn on the CPU (the same on every device): convolutions N(0, 2 /
    fan_in), zero biases, heads |N(0, 1 / C)|; frozen (no parameter takes
    gradients)."""
    model = LPIPS(dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('bias'):
                p.zero_()
                continue
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) *
                    (2.0 / fan_in) ** 0.5)
            if name.startswith('lin'):
                p.abs_().mul_(0.5 ** 0.5)
    return model.to(device).requires_grad_(False)


def _copy(model: LPIPS, name: str, value: torch.Tensor) -> None:
    target = model.get_parameter(name)
    with torch.no_grad():
        target.copy_(value.reshape(target.shape))


def load_torch_vgg16(model: LPIPS, vgg_state_dict: Mapping[str, torch.Tensor]
                     ) -> LPIPS:
    """Copy torchvision VGG16's `features.<seq>.weight` / `.bias` into the
    feature stack."""
    for seq, _ in VGG16_CONVS:
        _copy(model, f'net.conv_{seq}.weight',
              vgg_state_dict[f'features.{seq}.weight'])
        _copy(model, f'net.conv_{seq}.bias',
              vgg_state_dict[f'features.{seq}.bias'])
    return model


def load_torch_lpips_lins(model: LPIPS,
                          lpips_state_dict: Mapping[str, torch.Tensor]
                          ) -> LPIPS:
    """Copy the heads `lin<i>.model.1.weight` (or `lins.<i>.model.1.weight`)
    [1, C, 1, 1]."""
    for i in range(len(LPIPS_CHNS)):
        key = f'lin{i}.model.1.weight'
        if key not in lpips_state_dict:
            key = f'lins.{i}.model.1.weight'
        _copy(model, f'lin{i}.weight', lpips_state_dict[key])
    return model


def load_reference_lpips(model: LPIPS, state_dict: Mapping[str, torch.Tensor]
                         ) -> LPIPS:
    """Copy a whole reference `LPIPS.state_dict()`: the sliced VGG
    `net.slice<s>.<seq>.weight` / `.bias` and the heads."""
    slice_of = {seq: s for s, (lo, hi) in enumerate(SLICES, start=1)
                for seq in range(lo, hi)}
    for seq, _ in VGG16_CONVS:
        s = slice_of[seq]
        _copy(model, f'net.conv_{seq}.weight',
              state_dict[f'net.slice{s}.{seq}.weight'])
        _copy(model, f'net.conv_{seq}.bias',
              state_dict[f'net.slice{s}.{seq}.bias'])
    return load_torch_lpips_lins(model, state_dict)
