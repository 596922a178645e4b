"""GroupNorm-swish of the stage-1 modules (`ops/group_norm.py`) on the CPU:
the plain version repeats the modules' former arithmetic bit for bit, an
input that needs a gradient keeps F.group_norm, the kernel's grid covers
every served shape, and a tiny SimRQGAN2 and HQ-VAE keep their maps
channels-last through encode and decode. The CUDA kernel itself is checked
against the plain version on the card by `chip_smoke.py --gn-only`.
"""

import dataclasses

import pytest

torch = pytest.importorskip('torch')
import torch.nn.functional as F  # noqa: E402

from hqtransformer_tpu_torch.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu_torch.evaluation.stage1 import \
    init_stage1_weights  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.generator import \
    build_generator  # noqa: E402
from hqtransformer_tpu_torch.models.stage1.layers import \
    GroupNorm  # noqa: E402
from hqtransformer_tpu_torch.ops import group_norm as gn  # noqa: E402
from hqtransformer_tpu_torch.utils import tracing  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
EPS = 1e-6
H100_SMS = 132


@pytest.fixture(autouse=True)
def one_thread():
    """The maps here are small: one thread runs them faster than many
    threads contending for a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def former(x, weight, bias, with_swish):
    """The modules' arithmetic before the kernel: `GroupNorm.forward`, then
    `swish`, as they were written."""
    y = F.group_norm(x.float(), 32, weight.float(), bias.float(),
                     EPS).to(x.dtype)
    return y * torch.sigmoid(y) if with_swish else y


def inputs(c, dtype, channels_last, seed=0):
    """A [2, c, 5, 7] map whose channels have means in [-3, 3] and spreads
    in [0.5, 2], with a weight and bias of c, in `dtype`."""
    g = torch.Generator().manual_seed(seed)
    mean = torch.rand(c, 1, 1, generator=g) * 6 - 3
    std = torch.rand(c, 1, 1, generator=g) * 1.5 + 0.5
    x = (torch.randn(2, c, 5, 7, generator=g) * std + mean).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    weight = (torch.rand(c, generator=g) + 0.5).to(dtype)
    bias = (torch.randn(c, generator=g) * 0.5).to(dtype)
    return x, weight, bias


@pytest.mark.parametrize('c', [64, 128, 256, 512])
@pytest.mark.parametrize('channels_last', [False, True],
                         ids=['nchw', 'channels_last'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_plain_repeats_former_arithmetic(dtype, channels_last, c):
    """2 to 16 channels a group: the plain version equals the former
    arithmetic bit for bit, in x's layout, with and without swish; the
    module and the wrapper give it too, channels-last, and count a layout
    copy exactly for an NCHW input."""
    x, weight, bias = inputs(c, dtype, channels_last)
    norm = GroupNorm(c).requires_grad_(False)
    norm.weight.copy_(weight)
    norm.bias.copy_(bias)
    for with_swish in (False, True):
        want = former(x, weight, bias, with_swish)
        plain = gn.group_norm_swish_plain(x, weight, bias, EPS, with_swish)
        assert plain.dtype == dtype
        assert gn.is_channels_last(plain) == channels_last
        assert torch.equal(plain, want)
        before = tracing.counter('gn.layout_copies')
        out = norm(x, swish=with_swish)
        assert tracing.counter('gn.layout_copies') - before == \
            (0 if channels_last else 1)
        assert gn.is_channels_last(out) and out.dtype == dtype
        assert torch.equal(out, want)
        assert torch.equal(gn.group_norm_swish(x, weight, bias, EPS,
                                               with_swish), want)


@pytest.mark.parametrize('with_swish', [False, True])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_gradient_keeps_f_group_norm(monkeypatch, dtype, with_swish):
    """An input (or affine) that needs a gradient under grad mode takes
    F.group_norm and swish, never the wrapper; its output and the gradients
    of x, weight and bias equal F.group_norm's. Under no_grad the same
    module goes to the wrapper."""
    x, weight, bias = inputs(128, dtype, True, seed=3)
    x = x.float().requires_grad_(True)
    norm = GroupNorm(128)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    seen = []
    real = gn.group_norm_swish

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(gn, 'group_norm_swish', spy)
    xd = x.detach().to(dtype).requires_grad_(True)
    out = norm(xd, swish=with_swish)
    assert not seen and out.grad_fn is not None
    w = norm.weight.detach().clone().requires_grad_(True)
    b = norm.bias.detach().clone().requires_grad_(True)
    xr = x.detach().to(dtype).requires_grad_(True)
    ref = F.group_norm(xr.float(), 32, w, b, EPS).to(dtype)
    if with_swish:
        ref = ref * torch.sigmoid(ref)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    out.backward(g.to(dtype))
    ref.backward(g.to(dtype))
    assert torch.equal(xd.grad, xr.grad)
    assert torch.equal(norm.weight.grad, w.grad)
    assert torch.equal(norm.bias.grad, b.grad)
    # only the parameters need a gradient: still F.group_norm
    assert norm(xd.detach(), swish=with_swish).grad_fn is not None
    assert not seen
    with torch.no_grad():
        norm(xd, swish=with_swish)
    assert len(seen) == 1


# (batch, channels, height, width) of every GroupNorm the flagship and the
# 3-level decode chunks (batch 128) and the training encode (batch 64) run
SERVED = sorted({(128, c, h, h) for c, h in (
    (512, 16), (512, 32), (512, 64), (256, 64), (256, 128), (128, 128),
    (128, 256))} | {(64, c, h, h) for c, h in (
        (128, 128), (128, 64), (256, 64), (256, 32), (512, 32), (512, 16))})


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('b,c,h,w', SERVED + [(1, 32, 3, 5), (2, 64, 1, 1)])
def test_tile_plan_covers_map(b, c, h, w, dtype):
    """Tiles of whole passes of the block's threads cover the map, and the
    grid holds at least four blocks an SM of an H100 unless every tile is
    one pass already."""
    tile, tiles = gn.tile_plan(b, h * w, c, dtype, H100_SMS)
    rows = gn.THREADS // (c * dtype.itemsize // 16)
    assert tile % rows == 0 and tile >= rows
    assert (tiles - 1) * tile < h * w <= tiles * tile
    assert tile * c <= max(gn.BLOCK_ELEMENTS, rows * c)
    assert tile == rows or b * tiles >= gn.BLOCKS_PER_SM * H100_SMS


def _tiny(kind):
    cfg = build_twostage_config(CFG).stage1
    if kind == 'hqvae':
        aux = dataclasses.replace(cfg.hparams_aux, code_levels=3)
        cfg = dataclasses.replace(cfg, type='hqvae',
                                  n_embed_levels=[64, 128, 256],
                                  hparams_aux=aux)
    return cfg


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('kind', ['simrqgan2', 'hqvae'])
def test_generator_keeps_channels_last(kind, dtype):
    """Encode and decode_code of a tiny generator outside autograd: every
    GroupNorm input, the encoder's and the decoder's outputs are
    channels-last, no layout copy is counted, and the pixels come out
    NHWC-contiguous."""
    cfg = _tiny(kind)
    gen = build_generator(cfg, dtype)
    gen.load_state_dict(init_stage1_weights(cfg, seed=0, device='cpu'))
    layouts = []
    for m in gen.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(
                lambda m, args: layouts.append(('norm', gn.is_channels_last(
                    args[0]))))
    for m in (gen.encoder, gen.decoder):
        m.register_forward_hook(
            lambda m, args, out: layouts.append((type(m).__name__,
                                                 gn.is_channels_last(out))))
    res = cfg.hparams.resolution
    images = torch.rand(2, res, res, 3,
                        generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = tracing.counter('gn.layout_copies')
    with torch.no_grad():
        codes = gen.get_codes(images)
        pixels = (gen.decode_code(list(codes)) if kind == 'hqvae'
                  else gen.decode_code(*codes))
    assert tracing.counter('gn.layout_copies') == before
    assert pixels.shape == (2, res, res, 3) and pixels.is_contiguous()
    assert ('Encoder', True) in layouts and ('Decoder', True) in layouts
    assert sum(name == 'norm' for name, _ in layouts) > 10
    assert all(ok for _, ok in layouts), layouts


@pytest.mark.parametrize('kind', ['simrqgan2', 'hqvae'])
def test_int8_decode_keeps_channels_last(kind):
    """int8max's decode (every conv A8W8, `int8_decode`) of a tiny bf16
    generator: the int8 convs run, every GroupNorm input is channels-last,
    no layout copy is counted, and the pixels come out NHWC-contiguous."""
    cfg = _tiny(kind)
    gen = build_generator(cfg, torch.bfloat16)
    gen.load_state_dict(init_stage1_weights(cfg, seed=0, device='cpu'))
    layouts = []
    for m in gen.decoder.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(
                lambda m, args: layouts.append(gn.is_channels_last(args[0])))
    res = cfg.hparams.resolution
    images = torch.rand(2, res, res, 3,
                        generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        codes = gen.get_codes(images)
        before = {name: tracing.counter(name) for name in
                  ('gn.layout_copies', 'int8.conv2d_launches')}
        with gen.int8_decode({}):
            pixels = (gen.decode_code(list(codes)) if kind == 'hqvae'
                      else gen.decode_code(*codes))
    assert tracing.counter('gn.layout_copies') == before['gn.layout_copies']
    assert tracing.counter('int8.conv2d_launches') > \
        before['int8.conv2d_launches']
    assert pixels.shape == (2, res, res, 3) and pixels.is_contiguous()
    assert len(layouts) > 10 and all(layouts)
