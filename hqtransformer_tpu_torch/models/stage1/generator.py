"""The paper's 2-level HQ-VAE, decode side.

Counterpart of `hqtransformer_tpu/models/stage1/generator.py::
SimRQGAN2Generator.decode` and `decode_code` with the pixel-shuffle
resampler: the top code map is looked up and pixel-shuffled to the bottom
grid (an 8x8x1024 map becomes 16x16x256 at the flagship config),
concatenated with the bottom codes' vectors, mixed by the 1x1
`post_quant_conv_b` and decoded to pixels.

Code maps come in as [B, H, W] and pixels go out NHWC [B, H, W, 3], the JAX
package's layouts; the convolutions inside run NCHW. Encoding waits for the
port of the nearest-code kernel, so the encoder and `quant_conv_b` are not
part of this module.
"""

from __future__ import annotations

import torch
from torch import nn

from ...config import Stage1Config, parse_resample
from ...ops.resample import pixel_shuffle
from .layers import Conv2d, Decoder
from .quantizer import EMAVectorQuantizer


class SimRQGAN2Generator(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int, hparams, hparams_aux,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        spec = parse_resample(hparams_aux.upsample)
        if spec.kind != 'pixelshuffle':
            raise NotImplementedError(
                f'upsample {hparams_aux.upsample!r} is not ported')
        if hparams_aux.decoding_type != 'concat':
            raise NotImplementedError(
                f'decoding type {hparams_aux.decoding_type!r} is not ported')
        hp = hparams
        self.window = spec.window
        self.dtype = dtype
        self.decoder = Decoder(hp.ch, hp.out_ch, hp.ch_mult,
                               hp.num_res_blocks, hp.attn_resolutions,
                               hp.resolution, hp.z_channels,
                               hp.use_init_downsample, hp.use_mid_block,
                               hp.use_attn)
        top_dim = embed_dim * spec.window * spec.window
        self.quantize_t = EMAVectorQuantizer(n_embed, top_dim)
        self.quantize_b = EMAVectorQuantizer(n_embed, embed_dim)
        self.post_quant_conv_b = Conv2d(2 * embed_dim, hp.z_channels, 1)

    def decode(self, quant_t: torch.Tensor,
               quant_b: torch.Tensor) -> torch.Tensor:
        """quant_t [B, h, w, C*r*r], quant_b [B, h*r, w*r, C] (NHWC) ->
        pixels [B, H, W, out_ch] in roughly [-1, 1]."""
        quant = torch.cat([pixel_shuffle(quant_t, self.window), quant_b],
                          dim=-1)
        z = self.post_quant_conv_b(quant.permute(0, 3, 1, 2).to(self.dtype))
        return self.decoder(z).permute(0, 2, 3, 1)

    def decode_code(self, code_t: torch.Tensor,
                    code_b: torch.Tensor) -> torch.Tensor:
        """Pixels [B, H, W, 3] from code maps code_t [B, Ht, Wt] and
        code_b [B, Hb, Wb]."""
        return self.decode(self.quantize_t.get_codebook_entry(code_t),
                           self.quantize_b.get_codebook_entry(code_b))


def build_generator(cfg: Stage1Config,
                    dtype: torch.dtype = torch.float32) -> SimRQGAN2Generator:
    """Generator for `stage1.type`; the slice ports the EMA-codebook
    `simrqgan2`."""
    if cfg.type != 'simrqgan2' or not cfg.ema_update:
        raise NotImplementedError(
            f'stage-1 type {cfg.type!r} (ema_update={cfg.ema_update}) is '
            f'not ported')
    return SimRQGAN2Generator(cfg.n_embed, cfg.embed_dim, cfg.hparams,
                              cfg.hparams_aux, dtype)
