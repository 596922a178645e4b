"""Stage-1 generators: the plain VQGAN (`VQGANGenerator`), the VQ-VAE-2
style two-codebook baseline (`VQGAN2Generator`), the paper's 2-level HQ-VAE
(`SimRQGAN2Generator`) and the N-level HQ-VAE (`HQVAEGenerator`).

Counterparts of `hqtransformer_tpu/models/stage1/generator.py`. The
HQ-VAEs encode images through the `Encoder` and the 1x1
`quant_conv_b`, then quantize a pyramid of residuals, top level first:
each level's map is the bottom map resampled down, less the upsampled
quantization of the levels above. The resampler is `hparams_aux.upsample`
(`resamplers`): pixel (un)shuffle, average pooling down and nearest up
('nearest', and 'avgpool' when unset), or a stride-k conv down and
conv-transpose up ('conv<k>'). Every nearest-code search is one launch of
the K3 kernel on a card. Decoding looks the codes up, brings them to the
bottom grid and decodes to pixels. `get_soft_codes` gives the soft code
distributions that soft-label stage-2 training reads (off K3, as in JAX).

Images come in and pixels go out NHWC [B, H, W, 3], code maps are
[B, H, W], the JAX package's layouts; the convolutions inside take NCHW
shapes on channels-last memory (`_nchw` is a view), so the encoder and the
decoder keep NHWC memory from their first conv to their last.
Training: `encode(x, update_ema=True, generator=g)` takes one EMA step in
every EMA codebook it searches (restarts drawn from `g`), and
`decode(..., ret_pre_out=True)` also returns the decoder's features before
its `conv_out` (NHWC).

`int8_decode(act_scales)` makes the generator's quantizable convolutions
A8W8 for the duration of one int8max serving call (the JAX package's
HQT_INT8_DECODE inside `int8_decode_scope`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ...config import ResampleSpec, Stage1Config, parse_resample
from ...ops import resample as rs
from ...ops.int8 import Int8Weight
from .layers import (Conv2d, ConvTranspose2d, Decoder, Encoder,
                     QuantizableConv2d)
from .quantizer import make_quantizer


def top_embed_dim(spec: ResampleSpec, embed_dim: int,
                  levels_above: int = 1) -> int:
    """Codebook dim of a level `levels_above` resamplings above the bottom:
    only pixel-unshuffling multiplies it, by window**2 a level."""
    if spec.kind == 'pixelshuffle':
        return embed_dim * (spec.window * spec.window) ** levels_above
    return embed_dim


class ConvDown(Conv2d):
    """Stride-k, kernel-k conv downsample of NHWC maps ('conv<k>'), as a
    pixel unshuffle and one product (`ops/resample.py`); weight OIHW."""

    def __init__(self, channels: int, window: int):
        super().__init__(channels, channels, window, stride=window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rs.space_to_depth_conv(x, self.weight.to(x.dtype),
                                      self.bias.to(x.dtype),
                                      self.kernel_size[0])


class ConvTransposeUp(nn.ConvTranspose2d):
    """Stride-k, kernel-k conv-transpose upsample of NHWC maps
    ('conv<k>'), as one product and a pixel shuffle; weight in torch's
    ConvTranspose2d layout [Cin, Cout, k, k], the bias added after the
    shuffle."""

    def __init__(self, channels: int, window: int):
        super().__init__(channels, channels, window, stride=window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rs.depth_to_space_conv_transpose(x, self.weight.to(x.dtype),
                                                self.bias.to(x.dtype),
                                                self.kernel_size[0])


class Resample(nn.Module):
    """A parameter-free resampler of NHWC maps: fn(x, window)."""

    def __init__(self, fn: Callable[[torch.Tensor, int], torch.Tensor],
                 window: int):
        super().__init__()
        self.fn = fn
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x, self.window)


def resamplers(spec: ResampleSpec, channels: int):
    """(down, up) NHWC resamplers of a spec, as the JAX package dispatches
    them: average pooling and nearest upsampling for 'avgpool' and
    'nearest', pixel (un)shuffle for 'pixelshuffle', the conv modules (of
    `channels` in and out) for 'conv'."""
    w = spec.window
    if spec.kind == 'conv':
        return ConvDown(channels, w), ConvTransposeUp(channels, w)
    if spec.kind == 'pixelshuffle':
        return Resample(rs.pixel_unshuffle, w), Resample(rs.pixel_shuffle, w)
    return Resample(rs.avg_pool, w), Resample(rs.upsample_nearest, w)


def _encoder(hp) -> Encoder:
    """The encoder of the stage-1 hyper-parameters `hp`."""
    return Encoder(hp.ch, hp.ch_mult, hp.num_res_blocks, hp.attn_resolutions,
                   hp.in_channels, hp.resolution, hp.z_channels, hp.double_z,
                   hp.use_init_downsample, hp.use_mid_block, hp.use_attn)


def _backbone(hp):
    """(encoder, decoder) of the stage-1 hyper-parameters `hp`."""
    decoder = Decoder(hp.ch, hp.out_ch, hp.ch_mult, hp.num_res_blocks,
                      hp.attn_resolutions, hp.resolution, hp.z_channels,
                      hp.use_init_downsample, hp.use_mid_block, hp.use_attn)
    return _encoder(hp), decoder


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _decoded(decoder: Decoder, z: torch.Tensor, ret_pre_out: bool):
    """decoder(z) NHWC, and with `ret_pre_out` its pre-conv_out features
    NHWC too."""
    if ret_pre_out:
        out, pre = decoder(z, ret_pre_out=True)
        return _nhwc(out), _nhwc(pre)
    return _nhwc(decoder(z))


class _Stage1Base(nn.Module):
    """Encoder, quant_conv_b and decoder, with NHWC at the boundaries."""

    @contextlib.contextmanager
    def int8_decode(self, act_scales: Mapping[str, torch.Tensor]
                    ) -> Iterator[None]:
        """Quantize every `QuantizableConv2d` of the generator once, and
        run them A8W8 until the context exits, as JAX's
        `int8_decode_scope` switches every `QuantizableConv` (all that its
        `conv()` builds: the encoder's, the decoder's, VQGAN2's
        `decoder_top`): with the static scale `act_scales[<full module
        name>]` where there is one, else with max|x| / 127 of each call.
        A decode runs the decoder's alone. Raises for activations that
        are not bf16."""
        if self.dtype != torch.bfloat16:
            raise ValueError(f'int8 convolutions run on bf16 activations; '
                             f'this model computes in {self.dtype}')
        convs = [(name, m) for name, m in self.named_modules()
                 if isinstance(m, QuantizableConv2d)]
        try:
            for name, m in convs:
                m.q8 = Int8Weight.from_float(m.weight, m.bias,
                                             act_scales.get(name))
            yield
        finally:
            for _, m in convs:
                m.q8 = None

    @property
    def _bottom_quantizer(self):
        """The 2-level generators' bottom codebook: quantize_b, or
        quantize_t under a shared codebook."""
        return self.quantize_t if self.quantize_b is None else self.quantize_b

    def _encode_map(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, H, W, in_ch] -> bottom latent [B, h, w, embed_dim]."""
        return _nhwc(self.quant_conv_b(self.encoder(_nchw(x).to(self.dtype))))

    def _decode_map(self, quant: torch.Tensor, ret_pre_out: bool = False):
        """Latent [B, h, w, C] -> pixels [B, H, W, out_ch] (and the
        decoder's pre-conv_out features, with `ret_pre_out`)."""
        z = self.post_quant_conv_b(_nchw(quant).to(self.dtype))
        return _decoded(self.decoder, z, ret_pre_out)


class VQGANGenerator(_Stage1Base):
    """Plain VQGAN: encoder, 1x1 quant_conv, one codebook, 1x1
    post_quant_conv, decoder."""

    def __init__(self, n_embed: int, embed_dim: int, ema_update: bool,
                 hparams, dtype: torch.dtype = torch.float32,
                 ema_distributed: bool = False):
        super().__init__()
        hp = hparams
        self.dtype = dtype
        self.encoder, self.decoder = _backbone(hp)
        self.quantize = make_quantizer(ema_update, embed_dim, n_embed,
                                       ema_distributed=ema_distributed)
        self.quant_conv = Conv2d(hp.z_channels, embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, hp.z_channels, 1)

    def encode(self, x: torch.Tensor, update_ema: bool = False,
               generator: Optional[torch.Generator] = None):
        """Images [B, H, W, 3] -> (quant [B, h, w, embed_dim], loss, codes
        [B, h, w])."""
        h = self.quant_conv(self.encoder(_nchw(x).to(self.dtype)))
        return self.quantize(_nhwc(h), update_ema, generator)

    def decode(self, quant: torch.Tensor, ret_pre_out: bool = False):
        """quant [B, h, w, embed_dim] -> pixels [B, H, W, out_ch]."""
        z = self.post_quant_conv(_nchw(quant).to(self.dtype))
        return _decoded(self.decoder, z, ret_pre_out)

    def forward(self, x: torch.Tensor):
        """Images -> (pixels, loss, codes [B, h, w])."""
        quant, diff, code = self.encode(x)
        return self.decode(quant), diff, code

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        """Code map [B, h, w] -> pixels."""
        return self.decode(self.quantize.get_codebook_entry(code))

    def get_codes(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> codes [B, h * w] in raster order."""
        return self.encode(x)[2].reshape(x.shape[0], -1)


class VQGAN2Generator(_Stage1Base):
    """VQ-VAE-2 style two-codebook baseline. The top codes quantize the
    encoder's output; a small `decoder_top` brings their quantization to
    the grid of the encoder's last downsample input, which it joins
    (`decoding_type` 'concat' or 'sum') before the bottom codes quantize
    it. The decoder reads the top quantization upsampled ('deconv2d': a
    k 4, stride 2 conv-transpose; 'nearest': a 3x3 conv then nearest 2x)
    joined with the bottom one. The JAX package gives it no decode_code and
    no get_codes, and neither does the port."""

    def __init__(self, n_embed: int, embed_dim: int, ema_update: bool,
                 hparams, hparams_aux, dtype: torch.dtype = torch.float32,
                 ema_distributed: bool = False):
        super().__init__()
        hp, aux = hparams, hparams_aux
        if aux.decoding_type not in ('concat', 'sum'):
            raise ValueError(f'decoding type {aux.decoding_type!r}: VQGAN2 '
                             f'joins its levels by concat or sum')
        self.concat = aux.decoding_type == 'concat'
        self.dtype = dtype
        self.encoder = _encoder(hp)
        self.decoder = Decoder(hp.ch, hp.out_ch, hp.ch_mult[:-1],
                               hp.num_res_blocks,
                               (hp.attn_resolutions[0] * 2,), hp.resolution,
                               hp.z_channels, hp.use_init_downsample,
                               hp.use_mid_block, hp.use_attn)
        self.decoder_top = Decoder(hp.ch, hp.z_channels, (1, hp.ch_mult[-1]),
                                   hp.num_res_blocks, hp.attn_resolutions,
                                   hp.attn_resolutions[0] * 2, hp.z_channels,
                                   False, hp.use_mid_block, hp.use_attn)
        self.quantize_t = make_quantizer(ema_update, embed_dim, n_embed,
                                         ema_distributed=ema_distributed)
        self.quantize_b = None if aux.shared_codebook else \
            make_quantizer(ema_update, embed_dim, n_embed,
                           ema_distributed=ema_distributed)
        half = hp.z_channels // (2 if self.concat else 1)
        # the encoder's last downsample input has ch * ch_mult[-2] channels
        bottom = hp.ch * hp.ch_mult[-2]
        self.quant_conv_t = Conv2d(hp.z_channels, embed_dim, 1)
        self.quant_conv_b = Conv2d(
            bottom + hp.z_channels if self.concat else bottom, embed_dim, 1)
        if aux.upsample == 'deconv2d':
            self.upsample_t = ConvTranspose2d(embed_dim, half, 4, stride=2,
                                              padding=1)
        elif aux.upsample == 'nearest':
            self.upsample_t = nn.Sequential(
                Conv2d(embed_dim, half, 3, padding=1),
                nn.Upsample(scale_factor=2, mode='nearest'))
        else:
            raise ValueError(f'{aux.upsample!r} is not a VQGAN2 upsample '
                             f'mode')
        self.post_quant_conv_t = Conv2d(embed_dim, hp.z_channels, 1)
        self.post_quant_conv_b = Conv2d(embed_dim, half, 1)

    def _join(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, b], dim=1) if self.concat else a + b

    def encode(self, x: torch.Tensor, update_ema: bool = False,
               generator: Optional[torch.Generator] = None):
        """Images -> (quant_t, quant_b, diff_t, diff_b, (code_t, code_b)),
        quant_* NHWC."""
        h_t, h_b = self.encoder(_nchw(x).to(self.dtype), ret_bottom=True)
        quant_t, diff_t, code_t = self.quantize_t(
            _nhwc(self.quant_conv_t(h_t)), update_ema, generator)
        d_b = self.decoder_top(self.post_quant_conv_t(_nchw(quant_t)))
        quant_b, diff_b, code_b = self._bottom_quantizer(
            _nhwc(self.quant_conv_b(self._join(h_b, d_b))), update_ema,
            generator)
        return quant_t, quant_b, diff_t, diff_b, (code_t, code_b)

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor,
               bottom_bypass: bool = False, ret_pre_out: bool = False):
        """quant_t, quant_b (NHWC) -> pixels; `bottom_bypass` decodes zeros
        in place of the bottom (after its post_quant_conv_b)."""
        up = self.upsample_t(_nchw(quant_t).to(self.dtype))
        quant_b = self.post_quant_conv_b(_nchw(quant_b).to(self.dtype))
        if bottom_bypass:
            quant_b = torch.zeros_like(quant_b)
        return _decoded(self.decoder, self._join(up, quant_b), ret_pre_out)

    def forward(self, x: torch.Tensor, bottom_bypass: bool = False):
        """Images -> (pixels, (diff_t, diff_b), (code_t, code_b))."""
        quant_t, quant_b, diff_t, diff_b, codes = self.encode(x)
        return (self.decode(quant_t, quant_b, bottom_bypass),
                (diff_t, diff_b), codes)


class SimRQGAN2Generator(_Stage1Base):
    """The paper's 2-level HQ-VAE: top codes on the bottom latent resampled
    down (`down_t`), bottom codes on the residual less the top quantization
    resampled up (`upsample_t`); the decoder reads the concatenation
    [upsample_t(quant_t), quant_b]."""

    def __init__(self, n_embed: int, embed_dim: int, ema_update: bool,
                 hparams, hparams_aux, dtype: torch.dtype = torch.float32,
                 ema_distributed: bool = False):
        super().__init__()
        if hparams_aux.decoding_type != 'concat':
            raise ValueError(f'decoding type {hparams_aux.decoding_type!r}: '
                             f'SimRQGAN2 decodes a concatenation')
        hp = hparams
        self.spec = parse_resample(hparams_aux.upsample)
        self.dtype = dtype
        self.encoder, self.decoder = _backbone(hp)
        self.down_t, self.upsample_t = resamplers(self.spec, embed_dim)
        self.quant_conv_b = Conv2d(hp.z_channels, embed_dim, 1)
        restart = bool(hparams_aux.restart_unused_codes)
        self.quantize_t = make_quantizer(
            ema_update, top_embed_dim(self.spec, embed_dim), n_embed,
            restart, ema_distributed)
        # a shared codebook searches the bottom residual in quantize_t too,
        # and there is no quantize_b (the JAX package creates none)
        self.quantize_b = None if hparams_aux.shared_codebook else \
            make_quantizer(ema_update, embed_dim, n_embed, restart,
                           ema_distributed)
        self.post_quant_conv_b = Conv2d(2 * embed_dim, hp.z_channels, 1)

    def encode(self, x: torch.Tensor, update_ema: bool = False,
               generator: Optional[torch.Generator] = None):
        """Images [B, H, W, 3] -> (quant_t, quant_b, diff_t, diff_b,
        (code_t, code_b, resid_b)); quant_* are NHWC, resid_b is the bottom
        latent less the upsampled top quantization."""
        h_b = self._encode_map(x)
        quant_t, diff_t, code_t = self.quantize_t(self.down_t(h_b),
                                                  update_ema, generator)
        h_b = h_b - self.upsample_t(quant_t)
        quant_b, diff_b, code_b = self._bottom_quantizer(h_b, update_ema,
                                                         generator)
        return quant_t, quant_b, diff_t, diff_b, (code_t, code_b, h_b)

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor,
               ret_pre_out: bool = False):
        """quant_t at the top grid, quant_b at the bottom grid (NHWC) ->
        pixels [B, H, W, out_ch] in roughly [-1, 1]."""
        return self._decode_map(torch.cat(
            [self.upsample_t(quant_t), quant_b], dim=-1), ret_pre_out)

    def forward(self, x: torch.Tensor, bottom_bypass: bool = False):
        """Images -> (pixels, (diff_t, diff_b, mean|resid_b|), (code_t,
        code_b, resid_b)); with `bottom_bypass` (the `bottom_start`
        curriculum), pixels is (pixels of the top codes alone, pixels)."""
        quant_t, quant_b, diff_t, diff_b, codes = self.encode(x)
        dec = self.decode(quant_t, quant_b)
        if bottom_bypass:
            dec = (self.decode(quant_t, torch.zeros_like(quant_b)), dec)
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

    def get_soft_codes(self, x: torch.Tensor, temp: float = 1.0,
                       stochastic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Images -> ((code_t, code_b), (soft_t [B, Ht, Wt, K], soft_b
        [B, Hb, Wb, K])): each level's softmax(-d / temp) over its codebook,
        and its nearest codes or, with `stochastic`, codes drawn from it
        with the generator's noise (the top level's first)."""
        h_b = self._encode_map(x)
        quant_t, _, code_t, soft_t = self.quantize_t.get_soft_codes(
            self.down_t(h_b), temp, stochastic, generator)
        h_b = h_b - self.upsample_t(quant_t)
        _, _, code_b, soft_b = self._bottom_quantizer.get_soft_codes(
            h_b, temp, stochastic, generator)
        return (code_t, code_b), (soft_t, soft_b)

    def decode_code(self, code_t: Optional[torch.Tensor],
                    code_b: Optional[torch.Tensor]) -> torch.Tensor:
        """Pixels [B, H, W, 3] from code maps code_t [B, Ht, Wt] and
        code_b [B, Hb, Wb]; a level given as None decodes as zeros in
        place of its code vectors."""
        if code_t is None and code_b is None:
            raise ValueError('decode_code needs the codes of a level')
        w = self.spec.window
        r2 = w * w if self.spec.kind == 'pixelshuffle' else 1
        quant_t = quant_b = None
        if code_t is not None:
            quant_t = self.quantize_t.get_codebook_entry(code_t)
        if code_b is not None:
            quant_b = self._bottom_quantizer.get_codebook_entry(code_b)
        if quant_t is None:
            B, Hb, Wb, C = quant_b.shape
            quant_t = quant_b.new_zeros(B, Hb // w, Wb // w, C * r2)
        if quant_b is None:
            B, Ht, Wt, C = quant_t.shape
            quant_b = quant_t.new_zeros(B, Ht * w, Wt * w, C // r2)
        return self.decode(quant_t, quant_b)


class HQVAEGenerator(_Stage1Base):
    """N-level HQ-VAE: residual quantization over a pyramid of resamplings;
    quantizers[0] is the top (coarsest) level. downsamples[ci] takes the
    map ci levels above the bottom one level up; upsamples[ci] takes level
    ci's quantization to level ci + 1."""

    def __init__(self, n_embed_levels: Sequence[int], embed_dim: int,
                 ema_update: bool, hparams, hparams_aux,
                 dtype: torch.dtype = torch.float32,
                 ema_distributed: bool = False):
        super().__init__()
        if hparams_aux.decoding_type not in ('add', 'concat'):
            raise ValueError(f'decoding type {hparams_aux.decoding_type!r}: '
                             f'the HQ-VAE takes add or concat')
        hp = hparams
        self.spec = parse_resample(hparams_aux.upsample)
        self.code_levels = int(hparams_aux.code_levels)
        self.latent_dim = hp.attn_resolutions[0]
        self.dtype = dtype
        self.encoder, self.decoder = _backbone(hp)
        pairs = [resamplers(self.spec, embed_dim)
                 for _ in range(self.code_levels - 1)]
        self.downsamples = nn.ModuleList(d for d, _ in pairs)
        self.upsamples = nn.ModuleList(u for _, u in pairs)
        self.quant_conv_b = Conv2d(hp.z_channels, embed_dim, 1)
        restart = bool(hparams_aux.restart_unused_codes)
        self.quantizers = nn.ModuleList(
            make_quantizer(ema_update,
                           top_embed_dim(self.spec, embed_dim,
                                         self.code_levels - ci - 1),
                           n_embed_levels[ci], restart, ema_distributed)
            for ci in range(self.code_levels))
        self.post_quant_conv_b = Conv2d(embed_dim, hp.z_channels, 1)

    def encode(self, x: torch.Tensor, soft_codes: bool = False,
               temp: float = 1.0, stochastic: bool = False,
               generator: Optional[torch.Generator] = None,
               update_ema: bool = False):
        """Images -> (quant [B, h, w, embed_dim], diffs, codes top first,
        the residuals of every level but the top); with `soft_codes`,
        (quant, diffs, soft codes [B, H, W, K] top first, codes,
        residuals), each level quantized by `get_soft_codes(temp,
        stochastic, generator)`; with `update_ema`, each EMA codebook takes
        one step (restarts drawn from `generator`)."""
        h_map = [self._encode_map(x)]
        for down in self.downsamples:
            h_map.insert(0, down(h_map[0]))
        resids, diffs, codes, softs = [], [], [], []
        recon = 0
        for qi, quantizer in enumerate(self.quantizers):
            resid = h_map[qi] - recon
            if soft_codes:
                quant, diff, code, soft = quantizer.get_soft_codes(
                    resid, temp, stochastic, generator)
                softs.append(soft)
            else:
                quant, diff, code = quantizer(resid, update_ema, generator)
            recon = quant + recon
            if qi < self.code_levels - 1:
                recon = self.upsamples[qi](recon)
            resids.append(resid)
            diffs.append(diff)
            codes.append(code)
        if soft_codes:
            return recon, diffs, softs, codes, resids[1:]
        return recon, diffs, codes, resids[1:]

    def decode(self, quant: torch.Tensor, ret_pre_out: bool = False):
        """Bottom-grid latent [B, h, w, embed_dim] -> pixels."""
        return self._decode_map(quant, ret_pre_out)

    def forward(self, x: torch.Tensor):
        """Images -> (pixels, diffs, codes + [sum of the residuals'
        means])."""
        quant, diffs, codes, resids = self.encode(x)
        resid_loss = sum(r.mean() for r in resids)
        return self.decode(quant), diffs, list(codes) + [resid_loss]

    def get_codes(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Images -> per-level code maps [B, H, W], top first."""
        return self.encode(x)[2]

    def get_soft_codes(self, x: torch.Tensor, temp: float = 1.0,
                       stochastic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Images -> (codes, soft codes), per level, top first."""
        _, _, softs, codes, _ = self.encode(x, True, temp, stochastic,
                                            generator)
        return codes, softs

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
                n = self.latent_dim // self.spec.window ** (
                    self.code_levels - hi - 1)
                codebook = quantizer.codebook
                level = codebook.new_zeros((B, n, n, quantizer.dim))
            quant = quant + level
            if hi < self.code_levels - 1:
                quant = self.upsamples[hi](quant)
        return self.decode(quant)


def build_generator(cfg: Stage1Config, dtype: torch.dtype = torch.float32,
                    ema_distributed: bool = False) -> nn.Module:
    """Generator for `stage1.type` ('vqgan', 'vqgan2', 'simrqgan2',
    'hqvae'), with the EMA or the learned codebook as `ema_update` says;
    `ema_distributed` sums the EMA statistics over the data-parallel
    ranks."""
    common = dict(embed_dim=cfg.embed_dim, ema_update=cfg.ema_update,
                  hparams=cfg.hparams, dtype=dtype,
                  ema_distributed=ema_distributed)
    if cfg.type == 'vqgan':
        return VQGANGenerator(cfg.n_embed, **common)
    if cfg.type == 'vqgan2':
        return VQGAN2Generator(cfg.n_embed, hparams_aux=cfg.hparams_aux,
                               **common)
    if cfg.type == 'simrqgan2':
        return SimRQGAN2Generator(cfg.n_embed, hparams_aux=cfg.hparams_aux,
                                  **common)
    if cfg.type == 'hqvae':
        levels = cfg.hparams_aux.code_levels
        n_embed_levels = (list(cfg.n_embed_levels) if cfg.n_embed_levels
                          else [cfg.n_embed] * levels)
        return HQVAEGenerator(n_embed_levels[:levels],
                              hparams_aux=cfg.hparams_aux, **common)
    raise ValueError(f'stage-1 type {cfg.type!r} is not supported')
