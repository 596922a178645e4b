"""The FID variant of InceptionV3, in PyTorch (NCHW).

Counterpart of `hqtransformer_tpu/evaluation/inception.py`: torchvision's
InceptionV3 topology with the FID changes (3x3 average pools that leave
the padding out of the mean, a max pool in Mixed_7c's pool branch, a
1008-way classifier), BatchNorm with eps 1e-3 and frozen statistics,
VALID max pools. Inputs are NHWC in [0, 1]; they are resized to 299 x 299
bilinearly as `jax.image.resize('bilinear')` does it (antialiased when it
shrinks, not when it enlarges) and scaled to [-1, 1].

The parameter and buffer names are those of the public
pt_inception-2015-12-05 state dict (`Conv2d_1a_3x3.conv.weight`,
`Mixed_7c.branch_pool.bn.running_var`, `fc.weight`), which
`load_pt_inception` loads strictly once its `AuxLogits.*` entries and
BatchNorm counters are left out. The weights are not in the repository.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

RESOLUTION = 299
FEATURES = 2048
CLASSES = 1008
BN_EPS = 1e-3


class BatchNorm(nn.Module):
    """Inference BatchNorm over channels with frozen statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_3x3(x):
    """3x3 stride-1 pad-1 average pool, the padding left out of the
    mean."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def max_pool_3x3(x):
    """3x3 stride-2 VALID max pool."""
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(avg_pool_3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool_3x3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(avg_pool_3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([b3, b7, max_pool_3x3(x)], 1)


class InceptionE(nn.Module):
    """Mixed_7b (average pool) and Mixed_7c (max pool, the FID change)."""

    def __init__(self, cin: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.max_pool else avg_pool_3x3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


def resize_to_input(x: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] -> [N, 3, 299, 299], bilinear with half-pixel
    centres, as `jax.image.resize(..., 'bilinear')` resizes: antialiased
    where an axis shrinks (PyTorch's antialiased kernel along an axis
    that grows is the plain bilinear one)."""
    h, w = x.shape[-2:]
    if (h, w) == (RESOLUTION, RESOLUTION):
        return x
    return F.interpolate(x, (RESOLUTION, RESOLUTION), mode='bilinear',
                         align_corners=False,
                         antialias=max(h, w) > RESOLUTION)


class FIDInceptionV3(nn.Module):
    """[N, H, W, 3] in [0, 1] -> pooled features [N, 2048] (and, with
    `return_logits`, the 1008 logits)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.fc = nn.Linear(FEATURES, CLASSES)

    def forward(self, images_nhwc: torch.Tensor, return_logits: bool = False):
        x = resize_to_input(images_nhwc.permute(0, 3, 1, 2).float())
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(max_pool_3x3(x)))
        x = max_pool_3x3(x)
        for name in ('5b', '5c', '5d', '6a', '6b', '6c', '6d', '6e', '7a',
                     '7b', '7c'):
            x = getattr(self, f'Mixed_{name}')(x)
        feats = x.mean(dim=(2, 3))
        if return_logits:
            return feats, self.fc(feats)
        return feats


def pt_inception_state(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A pt_inception-2015-12-05 state dict without what this module does
    not hold (`AuxLogits.*`, BatchNorm's `num_batches_tracked`), in f32."""
    return {k: v.float() for k, v in state_dict.items()
            if not k.startswith('AuxLogits.')
            and not k.endswith('num_batches_tracked')}


def load_pt_inception(model: FIDInceptionV3,
                      state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a pt_inception-2015-12-05 state dict into `model`: every key
    and shape must match."""
    model.load_state_dict(pt_inception_state(state_dict), strict=True)


def he_scaled_state(seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the pt_inception layout (on the CPU, f32)
    that keep the features from collapsing: conv weights of std
    sqrt(2 / fan-in), BatchNorm scales near 1, shifts and means near 0,
    variances near 1, fc of std sqrt(1 / 2048). (The public weights are
    not in the repository; flax's default initialisation gives features
    of std ~4e-4.)"""
    g = torch.Generator().manual_seed(seed)
    with torch.device('meta'):
        model = FIDInceptionV3()
    state = {}
    for name, t in model.state_dict().items():
        shape = t.shape
        if name.endswith('conv.weight'):
            fan_in = shape[1] * shape[2] * shape[3]
            v = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif name.endswith(('bn.weight', 'running_var')):
            v = 1.0 + 0.1 * torch.rand(shape, generator=g) - 0.05
        elif name.endswith(('bn.bias', 'running_mean')):
            v = 0.05 * torch.randn(shape, generator=g)
        elif name == 'fc.weight':
            v = torch.randn(shape, generator=g) / FEATURES ** 0.5
        else:
            v = 0.01 * torch.randn(shape, generator=g)
        state[name] = v
    return state
