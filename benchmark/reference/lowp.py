"""Operand rounding of the reference's matrix products.

`F32` leaves every operand as it is: the reference proper. `FP8` rounds
both operands of every product (linear layers, attention products,
convolutions) to float8 e4m3 with one scale a tensor, amax / 448, and
multiplies the rounded values in float32: what an fp8 tensor core
computes, one precision below the bfloat16 that the served
configurations state. It is the benchmark's control: a correct
comparison has to tell it from the program. The rounding passes
gradients straight through, so the training step runs in it too.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FP8_MAX = 448.0


class Precision:
    """The operand rounding of one reference run."""

    name = 'f32'

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8(Precision):
    name = 'fp8'

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
            q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()


F32 = Precision()
FP8 = Fp8()
PRECISIONS = {'f32': F32, 'fp8': FP8}


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Float32 products in float32 (TF32 off for matmuls and convolutions)
    inside the block; the settings as they were after it."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
