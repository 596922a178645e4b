"""Stage-1 generators with the pixel-shuffle resampler: the paper's 2-level
HQ-VAE (`SimRQGAN2Generator`) and the N-level HQ-VAE (`HQVAEGenerator`).

Counterparts of `hqtransformer_tpu/models/stage1/generator.py::
SimRQGAN2Generator` and `HQVAEGenerator`, for inference. Encoding runs
images through the `Encoder` and the 1x1 `quant_conv_b`, then quantizes a
pyramid of residuals, top level first: each level's map is the bottom map
pixel-unshuffled, less the pixel-shuffled quantization of the levels above
(an 8x8x1024 top map over a 16x16x256 bottom map at the flagship config).
Each level's nearest-code search is one launch of the K3 kernel on a card.
Decoding looks the codes up, brings them to the bottom grid and decodes to
pixels.

Images come in and pixels go out NHWC [B, H, W, 3], code maps are
[B, H, W], the JAX package's layouts; the convolutions inside run NCHW. The
EMA update (training), soft codes and the other resamplers are not ported.

`int8_decode(act_scales)` makes the decoder's convolutions A8W8 for the
duration of one int8max serving call (the JAX package's HQT_INT8_DECODE
inside `int8_decode_scope`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ...config import Stage1Config, parse_resample
from ...ops.resample import pixel_shuffle, pixel_unshuffle
from ...ops.int8 import Int8Weight
from .layers import Conv2d, Decoder, Encoder, QuantizableConv2d
from .quantizer import EMAVectorQuantizer


def _pixelshuffle_window(hparams_aux) -> int:
    spec = parse_resample(hparams_aux.upsample)
    if spec.kind != 'pixelshuffle':
        raise NotImplementedError(
            f'upsample {hparams_aux.upsample!r} is not ported')
    return spec.window


def _backbone(hp):
    """(encoder, decoder) of the stage-1 hyper-parameters `hp`."""
    encoder = Encoder(hp.ch, hp.ch_mult, hp.num_res_blocks,
                      hp.attn_resolutions, hp.in_channels, hp.resolution,
                      hp.z_channels, hp.double_z, hp.use_init_downsample,
                      hp.use_mid_block, hp.use_attn)
    decoder = Decoder(hp.ch, hp.out_ch, hp.ch_mult, hp.num_res_blocks,
                      hp.attn_resolutions, hp.resolution, hp.z_channels,
                      hp.use_init_downsample, hp.use_mid_block, hp.use_attn)
    return encoder, decoder


class _Stage1Base(nn.Module):
    """Encoder, quant_conv_b and decoder, with NHWC at the boundaries."""

    @contextlib.contextmanager
    def int8_decode(self, act_scales: Mapping[str, torch.Tensor]
                    ) -> Iterator[None]:
        """Quantize every `QuantizableConv2d` of the decoder once, and run
        them A8W8 until the context exits: with the static scale
        `act_scales['decoder.<name>']` where there is one, else with
        max|x| / 127 of each call, as the JAX QuantizableConv. Raises for
        activations that are not bf16."""
        if self.dtype != torch.bfloat16:
            raise ValueError(f'int8 convolutions run on bf16 activations; '
                             f'this model computes in {self.dtype}')
        convs = [(f'decoder.{name}', m)
                 for name, m in self.decoder.named_modules()
                 if isinstance(m, QuantizableConv2d)]
        try:
            for name, m in convs:
                m.q8 = Int8Weight.from_float(m.weight, m.bias,
                                             act_scales.get(name))
            yield
        finally:
            for _, m in convs:
                m.q8 = None

    def _encode_map(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, in_ch] -> bottom latent [B, h, w, embed_dim]."""
        h = self.encoder(x.permute(0, 3, 1, 2).to(self.dtype))
        return self.quant_conv_b(h).permute(0, 2, 3, 1)

    def _decode_map(self, quant: torch.Tensor) -> torch.Tensor:
        """Latent [B, h, w, C] -> pixels [B, H, W, out_ch]."""
        z = self.post_quant_conv_b(quant.permute(0, 3, 1, 2).to(self.dtype))
        return self.decoder(z).permute(0, 2, 3, 1)


class SimRQGAN2Generator(_Stage1Base):
    """The paper's 2-level HQ-VAE: top codes on the bottom latent
    pixel-unshuffled, bottom codes on the residual; the decoder reads the
    concatenation [pixel_shuffle(quant_t), quant_b]."""

    def __init__(self, n_embed: int, embed_dim: int, hparams, hparams_aux,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if hparams_aux.decoding_type != 'concat':
            raise NotImplementedError(
                f'decoding type {hparams_aux.decoding_type!r} is not ported')
        hp = hparams
        self.window = _pixelshuffle_window(hparams_aux)
        self.shared_codebook = bool(hparams_aux.shared_codebook)
        self.dtype = dtype
        self.encoder, self.decoder = _backbone(hp)
        self.quant_conv_b = Conv2d(hp.z_channels, embed_dim, 1)
        self.quantize_t = EMAVectorQuantizer(
            n_embed, embed_dim * self.window * self.window)
        # a shared codebook searches the bottom residual in quantize_t too,
        # and there is no quantize_b (the JAX package creates none)
        self.quantize_b = None if self.shared_codebook else \
            EMAVectorQuantizer(n_embed, embed_dim)
        self.post_quant_conv_b = Conv2d(2 * embed_dim, hp.z_channels, 1)

    @property
    def _bottom_quantizer(self) -> EMAVectorQuantizer:
        return self.quantize_t if self.quantize_b is None else self.quantize_b

    def encode(self, x: torch.Tensor):
        """Images [B, H, W, 3] -> (quant_t, quant_b, diff_t, diff_b,
        (code_t, code_b, resid_b)); quant_* are NHWC, resid_b is the bottom
        latent less the upsampled top quantization."""
        h_b = self._encode_map(x)
        quant_t, diff_t, code_t = self.quantize_t(
            pixel_unshuffle(h_b, self.window))
        h_b = h_b - pixel_shuffle(quant_t, self.window)
        quant_b, diff_b, code_b = self._bottom_quantizer(h_b)
        return quant_t, quant_b, diff_t, diff_b, (code_t, code_b, h_b)

    def decode(self, quant_t: torch.Tensor,
               quant_b: torch.Tensor) -> torch.Tensor:
        """quant_t [B, h, w, C*r*r], quant_b [B, h*r, w*r, C] (NHWC) ->
        pixels [B, H, W, out_ch] in roughly [-1, 1]."""
        return self._decode_map(torch.cat(
            [pixel_shuffle(quant_t, self.window), quant_b], dim=-1))

    def forward(self, x: torch.Tensor):
        """Images -> (pixels, (diff_t, diff_b, mean|resid_b|), (code_t,
        code_b, resid_b))."""
        quant_t, quant_b, diff_t, diff_b, codes = self.encode(x)
        dec = self.decode(quant_t, quant_b)
        return dec, (diff_t, diff_b, codes[2].abs().mean()), codes

    def forward_topbottom(self, x: torch.Tensor):
        """((dec_t, dec_b, dec_tb), (diff_t, diff_b), codes): the pixels of
        the top codes alone, the bottom codes alone and both."""
        quant_t, quant_b, diff_t, diff_b, codes = self.encode(x)
        dec_t = self.decode(quant_t, torch.zeros_like(quant_b))
        dec_b = self.decode(torch.zeros_like(quant_t), quant_b)
        dec_tb = self.decode(quant_t, quant_b)
        return (dec_t, dec_b, dec_tb), (diff_t, diff_b), codes

    def get_codes(self, x: torch.Tensor):
        """Images -> (code_t [B, Ht, Wt], code_b [B, Hb, Wb])."""
        codes = self.encode(x)[4]
        return codes[0], codes[1]

    def decode_code(self, code_t: Optional[torch.Tensor],
                    code_b: Optional[torch.Tensor]) -> torch.Tensor:
        """Pixels [B, H, W, 3] from code maps code_t [B, Ht, Wt] and
        code_b [B, Hb, Wb]; a level given as None decodes as zeros in
        place of its code vectors."""
        if code_t is None and code_b is None:
            raise ValueError('decode_code needs the codes of a level')
        w = self.window
        quant_t = quant_b = None
        if code_t is not None:
            quant_t = self.quantize_t.get_codebook_entry(code_t)
        if code_b is not None:
            quant_b = self._bottom_quantizer.get_codebook_entry(code_b)
        if quant_t is None:
            B, Hb, Wb, C = quant_b.shape
            quant_t = quant_b.new_zeros(B, Hb // w, Wb // w, C * w * w)
        if quant_b is None:
            B, Ht, Wt, C = quant_t.shape
            quant_b = quant_t.new_zeros(B, Ht * w, Wt * w, C // (w * w))
        return self.decode(quant_t, quant_b)


class HQVAEGenerator(_Stage1Base):
    """N-level HQ-VAE: residual quantization over a pyramid of pixel
    (un)shuffles; quantizers[0] is the top (coarsest) level."""

    def __init__(self, n_embed_levels: Sequence[int], embed_dim: int,
                 hparams, hparams_aux, dtype: torch.dtype = torch.float32):
        super().__init__()
        if hparams_aux.decoding_type not in ('add', 'concat'):
            raise NotImplementedError(
                f'decoding type {hparams_aux.decoding_type!r} is not ported')
        hp = hparams
        self.window = _pixelshuffle_window(hparams_aux)
        self.code_levels = int(hparams_aux.code_levels)
        self.latent_dim = hp.attn_resolutions[0]
        self.dtype = dtype
        self.encoder, self.decoder = _backbone(hp)
        self.quant_conv_b = Conv2d(hp.z_channels, embed_dim, 1)
        r2 = self.window * self.window
        self.quantizers = nn.ModuleList(
            EMAVectorQuantizer(n_embed_levels[ci],
                               embed_dim * r2 ** (self.code_levels - ci - 1))
            for ci in range(self.code_levels))
        self.post_quant_conv_b = Conv2d(embed_dim, hp.z_channels, 1)

    def encode(self, x: torch.Tensor):
        """Images -> (quant [B, h, w, embed_dim], diffs, codes top first,
        the residuals of every level but the top)."""
        h_map = [self._encode_map(x)]
        for _ in range(self.code_levels - 1):
            h_map.insert(0, pixel_unshuffle(h_map[0], self.window))
        resids, diffs, codes = [], [], []
        recon = 0
        for qi, quantizer in enumerate(self.quantizers):
            resid = h_map[qi] - recon
            quant, diff, code = quantizer(resid)
            recon = quant + recon
            if qi < self.code_levels - 1:
                recon = pixel_shuffle(recon, self.window)
            resids.append(resid)
            diffs.append(diff)
            codes.append(code)
        return recon, diffs, codes, resids[1:]

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Bottom-grid latent [B, h, w, embed_dim] -> pixels."""
        return self._decode_map(quant)

    def forward(self, x: torch.Tensor):
        """Images -> (pixels, diffs, codes + [sum of the residuals'
        means])."""
        quant, diffs, codes, resids = self.encode(x)
        resid_loss = sum(r.mean() for r in resids)
        return self.decode(quant), diffs, list(codes) + [resid_loss]

    def get_codes(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Images -> per-level code maps [B, H, W], top first."""
        return self.encode(x)[2]

    def decode_code(self, codes: Sequence[Optional[torch.Tensor]]
                    ) -> torch.Tensor:
        """Pixels from per-level code maps, top first; a level given as
        None contributes zeros."""
        B = next(c.shape[0] for c in codes if c is not None)
        quant = 0
        for hi, (code, quantizer) in enumerate(zip(codes, self.quantizers)):
            if code is not None:
                level = quantizer.get_codebook_entry(code)
            else:
                n = self.latent_dim // self.window ** (
                    self.code_levels - hi - 1)
                level = torch.zeros((B, n, n, quantizer.dim),
                                    dtype=quantizer.embedding.dtype,
                                    device=quantizer.embedding.device)
            quant = quant + level
            if hi < self.code_levels - 1:
                quant = pixel_shuffle(quant, self.window)
        return self.decode(quant)


def build_generator(cfg: Stage1Config, dtype: torch.dtype = torch.float32
                    ) -> nn.Module:
    """Generator for `stage1.type`: the EMA-codebook `simrqgan2` and
    `hqvae` are ported."""
    if not cfg.ema_update:
        raise NotImplementedError('only EMA codebooks are ported')
    if cfg.type == 'simrqgan2':
        return SimRQGAN2Generator(cfg.n_embed, cfg.embed_dim, cfg.hparams,
                                  cfg.hparams_aux, dtype)
    if cfg.type == 'hqvae':
        levels = cfg.hparams_aux.code_levels
        n_embed_levels = (list(cfg.n_embed_levels) if cfg.n_embed_levels
                          else [cfg.n_embed] * levels)
        return HQVAEGenerator(n_embed_levels[:levels], cfg.embed_dim,
                              cfg.hparams, cfg.hparams_aux, dtype)
    raise NotImplementedError(f'stage-1 type {cfg.type!r} is not ported')
