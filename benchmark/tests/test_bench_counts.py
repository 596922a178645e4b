"""The yardstick's counts against hand counts at tiny shapes."""

import json
from pathlib import Path

import pytest
import torch

from hqbench import counts

DATA = Path(__file__).resolve().parent / 'data'


def test_kernel_counts_by_hand():
    # K1 at row 3, batch 2, width 8, bf16: q 16 B, k_new and v_new 32,
    # 2 x 3 cache rows 96, the new rows written 32, y 16: 192 B a row
    assert counts.k1_bytes(3, 2, 8) == 2 * 8 * (2 + 4 + 12 + 4 + 2)
    assert counts.k1_flops(3, 2, 8) == 2 * 2 * 4 * 2 * 8
    assert counts.k2_bytes(5, 16) == 5 * 16 * 2 + 5 * 8
    assert counts.k2_ops(5, 16) == 12 * 5 * 16
    assert counts.k3_bytes(10, 6, 4, 2, 4) == 10 * 4 * 2 + 6 * 4 * 4 + 80
    assert counts.k3_flops(10, 6, 4) == 2 * 10 * 6 * 4
    # the bound is the larger of the two times
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.k3_bound_s(1, 1, 1, 2, 2) == pytest.approx(
        (2 + 2 + 8) / 3.35e12)


def _state(cfg):
    from hqbench import program, weights
    model = program.model(cfg, torch.device('cpu'))
    return weights.make(weights.plan(model), 0, torch.device('cpu'), False)


def test_stage2_flops_by_hand():
    cfg = json.loads((DATA / 'tiny-l2.json').read_text())
    cfg['precision'] = 'float32'
    s2 = cfg['model']['stage2']
    D, L = s2['hparams']['embed_dim'], s2['hparams']['n_layers']
    V = s2['vocab_size_img']
    N = s2['hparams']['ctx_len_img']
    w = _state(cfg)
    block = 2 * 12 * D * D                   # q, k, v, proj, 2 MLP gemms
    attn = lambda t: 2 * 2 * t * t * D       # q.k and a.v, every position
    spatial = L * (N * block + attn(N))
    depth = N * 4 * (5 * block + attn(5))    # 4 depth blocks of 5 tokens
    heads = N * 5 * 2 * D * V
    got = counts.stage2_forward_flops(w['stage2'], s2, N, (1, 4))
    assert got == spatial + depth + heads


def test_decode_flops_by_hand():
    """One 3x3 convolution of C channels at S^2 is 2 * 9 * C * C * S^2;
    the tiny decoder's count is the sum over its layers."""
    cfg = json.loads((DATA / 'tiny-l2.json').read_text())
    cfg['precision'] = 'float32'
    w1 = _state(cfg)['stage1']
    got = counts.decode_flops(w1, (4, 8))

    def conv(cin, cout, k, s):
        return 2 * k * k * cin * cout * s * s

    def res(cin, cout, s):
        return conv(cin, cout, 3, s) + conv(cout, cout, 3, s) + (
            conv(cin, cout, 1, s) if cin != cout else 0)

    def attn(c, s):
        return 4 * conv(c, c, 1, s) + 2 * 2 * (s * s) ** 2 * c

    # tiny: z 64, ch 32, ch_mult [1, 2], 1 resblock (2 a decoder level),
    # attention at 8, initial downsample: latent 8 -> 32 pixels
    want = conv(128, 64, 1, 8)                     # post_quant_conv_b
    want += conv(64, 64, 3, 8)                     # conv_in
    want += res(64, 64, 8) + attn(64, 8) + res(64, 64, 8)      # mid
    want += 2 * (res(64, 64, 8) + attn(64, 8))     # up.1 at 8
    want += conv(64, 64, 3, 16)                    # its upsample
    want += res(64, 32, 16) + res(32, 32, 16)      # up.0 at 16
    want += conv(32, 32, 3, 32)                    # its upsample
    want += conv(32, 3, 3, 32)                     # conv_out
    assert got == want
