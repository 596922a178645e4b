"""Stage-1 reconstruction: images -> codes -> pixels, and the numbers
`eval_stage1.py` reports on it.

Counterpart of the `recon` and `recon_top` closures and the per-batch
accumulation of `eval_stage1.py`: `make_reconstructor(...)(weights,
images)` gives pixels clipped to [-1, 1] and the per-level code maps;
`ReconstructionMetrics` sums the per-image MSE and each level's code counts
over batches, giving the MSE over the set and the fraction of each
codebook used. The dataset loader and the command line are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..config import Stage1Config
from ..device import resolve_device
from ..models.stage1.generator import build_generator
from ..models.twostage import random_state


def _generator(stage1_cfg: Stage1Config, dtype: torch.dtype,
               device: torch.device):
    with torch.device('meta'):
        gen = build_generator(stage1_cfg, dtype)
    return gen.to_empty(device=device).eval()


def init_stage1_weights(stage1_cfg: Stage1Config, seed: int,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Seeded random f32 stage-1 weights on the device (CUDA unless
    asked): the repo holds no trained weights."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_state(_generator(stage1_cfg, torch.float32, device), gen)


def make_reconstructor(stage1_cfg: Stage1Config,
                       dtype: torch.dtype = torch.float32,
                       device: Optional[Union[str, torch.device]] = None,
                       top_only: bool = False) -> Callable:
    """fn(weights, images [B, H, W, 3] in [-1, 1]) -> (pixels [B, H, W, 3]
    clipped to [-1, 1], per-level code maps [B, h, w], top first).
    `weights` is a stage-1 state dict; `dtype` the activation dtype. The
    device is CUDA unless asked, and there every level's nearest-code
    search is one K3 launch. Every stage-1 type is taken. top_only
    (the 2-level HQ-VAE) decodes the top codes alone, with zeros for the
    bottom quantization."""
    device = resolve_device(device)
    gen = _generator(stage1_cfg, dtype, device)
    if top_only and not hasattr(gen, 'forward_topbottom'):
        raise ValueError(f'top_only needs the 2-level HQ-VAE, not '
                         f'{stage1_cfg.type!r}')

    @torch.inference_mode()
    def reconstruct(weights: Dict[str, torch.Tensor], images: torch.Tensor):
        gen.load_state_dict({k: v.to(device) for k, v in weights.items()},
                            strict=True, assign=True)
        images = images.to(device)
        if top_only:
            (dec, _, _), _, codes = gen.forward_topbottom(images)
        else:
            dec, _, codes = gen(images)
        return torch.clamp(dec, -1.0, 1.0), code_levels(codes)

    return reconstruct


def code_levels(codes) -> List[torch.Tensor]:
    """The per-level code maps, top first, in a generator's forward output:
    a VQGAN's one map; a 2-level generator's (code_t, code_b[, resid]); an
    N-level one's codes and then the residual loss."""
    if isinstance(codes, torch.Tensor):
        return [codes]
    return list(codes[:2] if isinstance(codes, tuple) else codes[:-1])


def reconstruction_mse(images: torch.Tensor,
                       pixels: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error [B], in f32."""
    return (pixels.float() - images.float()).square().mean(dim=(1, 2, 3))


def code_usage(counts: Sequence[torch.Tensor]) -> List[float]:
    """The fraction of each level's codebook with a nonzero count."""
    return [float((c > 0).float().mean()) for c in counts]


class ReconstructionMetrics:
    """Sums over batches what `eval_stage1.py` prints: the MSE over all
    images and, for each level, the codes used out of `n_embed`."""

    def __init__(self, n_embed: int):
        self.n_embed = n_embed
        self.mse_sum = 0.0
        self.n_images = 0
        self.counts: List[torch.Tensor] = []

    def update(self, images: torch.Tensor, pixels: torch.Tensor,
               codes: Sequence[torch.Tensor]) -> None:
        self.mse_sum += float(reconstruction_mse(images.to(pixels.device),
                                                 pixels).sum())
        self.n_images += images.shape[0]
        for li, c in enumerate(codes):
            binc = torch.bincount(c.reshape(-1), minlength=self.n_embed)
            if li == len(self.counts):
                self.counts.append(binc)
            else:
                self.counts[li] = self.counts[li] + binc

    @property
    def mse(self) -> float:
        return self.mse_sum / self.n_images

    def code_usage(self) -> List[float]:
        return code_usage(self.counts)
