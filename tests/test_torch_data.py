"""The port's data pipeline (`hqtransformer_tpu_torch/data/`) against
Pillow and the JAX package's Pillow pipeline, on images made from numpy
seeds and written to `tmp_path`:

- `data/png.py` decodes what Pillow decodes, equal arrays, modes,
  palettes and `info['transparency']`: files Pillow writes in every
  supported mode, and files written by `chip_smoke.encode_png` with
  every row filter forced on some rows;
- `data/transforms.py` is bit-equal to Pillow's resize and to the JAX
  package's `valid_transform` / `train_transform` ('imagenet' and
  'ffhq', the same RandomState seed) in the modes L, LA, RGB, RGBA, P
  and CMYK, enlarging and shrinking along either axis, odd sizes;
- the loader gives the JAX loader's batches and labels bit for bit
  (train and valid, two shards, `PrefetchLoader`), with Pillow and with
  the port's PNG decoder; `build_dataset`, `ConcatDataset` and
  `CC3MTextOnly` index as JAX's do.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from hqtransformer_tpu.data import datasets as jax_data
from hqtransformer_tpu.data import transforms as jax_transforms
from hqtransformer_tpu.data.tokenizers import \
    create_tokenizer as jax_tokenizer

from hqtransformer_tpu_torch.data import datasets, png, transforms
from hqtransformer_tpu_torch.data import tokenizers

from chip_smoke import encode_png

MODES = ('L', 'LA', 'RGB', 'RGBA', 'P', 'CMYK')
BANDS = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4, 'CMYK': 4}
# (width, height): square, landscape, portrait, odd, and smaller than
# the 32-pixel output on one or both axes
SIZES = ((32, 32), (47, 31), (29, 53), (64, 40), (21, 26), (101, 33))


def pil_image(mode, size, seed):
    """A seeded random image in `mode`: smooth gradients plus noise, alpha
    over its whole range."""
    rng = np.random.RandomState(seed)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(w + h - 2, 1),
                     rng.randint(0, 256, (h, w))], -1)
    arr = np.clip(base + rng.randint(-40, 41, base.shape), 0,
                  255).astype(np.uint8)
    if mode == 'P':
        return Image.fromarray(arr[..., :3]).convert(
            'P', palette=Image.ADAPTIVE, colors=37)
    if mode in ('CMYK', 'RGBA'):
        return Image.fromarray(arr, mode)
    if mode == 'LA':
        return Image.fromarray(arr[..., [0, 3]], 'LA')
    return Image.fromarray(arr[..., :BANDS[mode]].squeeze(-1)
                           if mode == 'L' else arr[..., :3], mode)


def decoded(im):
    """The port's item for a PIL image: its pixels in its mode."""
    palette = (np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
               if im.mode == 'P' else None)
    return png.DecodedImage(np.asarray(im), im.mode, palette, {})


def pillow_decode(blob):
    im = Image.open(io.BytesIO(blob))
    im.load()
    return im


def assert_same_decode(blob):
    ref = pillow_decode(blob)
    ours = png.decode_png(blob)
    assert ours.mode == ref.mode
    np.testing.assert_array_equal(ours.array, np.asarray(ref))
    if ref.mode == 'P':
        pal = np.asarray(ref.getpalette(), np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(ours.palette, pal[:len(ours.palette)])
    assert ours.info.get('transparency') == ref.info.get('transparency')


# ---------------------------------------------------------------- PNG

PILLOW_FILES = [('RGB', {}), ('L', {}), ('RGBA', {}), ('LA', {}),
                ('P', {}), ('P', {'bits': 1}), ('P', {'bits': 2}),
                ('P', {'bits': 4}), ('P', {'transparency': 5}),
                ('P', {'transparency': bytes(range(0, 256, 7))}),
                ('L', {'transparency': 9}),
                ('RGB', {'transparency': (1, 2, 3)})]


@pytest.mark.parametrize('mode,options', PILLOW_FILES,
                         ids=[f'{m}-{sorted(o)}' for m, o in PILLOW_FILES])
def test_png_decode_matches_pillow_on_its_files(mode, options):
    im = pil_image('RGBA' if mode == 'LA' else mode, (53, 37), seed=1)
    if mode == 'LA':
        im = im.convert('LA')
    if options.get('bits'):
        im = im.convert('RGB').convert('P', palette=Image.ADAPTIVE,
                                       colors=2 ** options['bits'])
    buf = io.BytesIO()
    im.save(buf, 'PNG', **options)
    assert_same_decode(buf.getvalue())


FILTER_CASES = [('L', 8), ('LA', 8), ('RGB', 8), ('RGBA', 8), ('P', 8),
                ('P', 4), ('P', 2), ('P', 1)]


@pytest.mark.parametrize('mode,bits', FILTER_CASES,
                         ids=[f'{m}{b}' for m, b in FILTER_CASES])
def test_png_decode_undoes_every_filter(mode, bits):
    """Files whose rows use the five filter types in turn and at random,
    from seeded noise (odd width, so the last byte of a packed row is
    partly padding)."""
    rng = np.random.RandomState(bits)
    h, w = 45, 31
    if mode == 'P':
        arr = rng.randint(0, 2 ** bits, (h, w))
        palette = rng.randint(0, 256, (2 ** bits, 3))
    else:
        arr = rng.randint(0, 256, (h, w, BANDS[mode])).squeeze()
        palette = None
    filters = [0, 1, 2, 3, 4] + list(rng.randint(0, 5, 40))
    blob = encode_png(arr, mode, filters, palette, bits)
    assert_same_decode(blob)
    np.testing.assert_array_equal(png.decode_png(blob).array, arr)


def test_png_decode_refuses_what_it_does_not_read():
    im = pil_image('RGB', (9, 7), seed=2)
    for options in ({'interlace': 1},):
        buf = io.BytesIO()
        im.save(buf, 'PNG', **options)
        blob = buf.getvalue()
        if pillow_decode(blob).info.get('interlace'):
            with pytest.raises(ValueError, match='interlaced'):
                png.decode_png(blob)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, 'PNG')
    with pytest.raises(ValueError, match='16-bit'):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match='not a PNG'):
        png.decode_png(b'GIF89a' + bytes(20))


# ---------------------------------------------------------- transforms

@pytest.mark.parametrize('mode', MODES)
def test_resize_matches_pillow(mode):
    """Pillow's BICUBIC resize (NEAREST for P, premultiplied for RGBA and
    LA) and convert('RGB'), enlarging and shrinking along either axis or
    both, one axis unchanged."""
    for k, size in enumerate(SIZES):
        im = pil_image(mode, size, seed=k)
        w, h = size
        for out in ((32, 32), (w, 2 * h + 1), (max(1, w // 3), h),
                    (3 * w, max(1, h // 2)), (w + 1, h - 1), (7, 61)):
            ref = im.resize(out, Image.BICUBIC)
            ours = transforms.resize(decoded(im), out)
            np.testing.assert_array_equal(ours.array, np.asarray(ref),
                                          err_msg=f'{size} -> {out}')
            np.testing.assert_array_equal(transforms.to_rgb(ours),
                                          np.asarray(ref.convert('RGB')))


@pytest.mark.parametrize('mode', MODES)
def test_transforms_match_jax(mode):
    """valid_transform, and train_transform for 'imagenet' and 'ffhq'
    from the same RandomState seed, bit-equal to JAX's on the same
    image; the crops leave the image (zeros) where it is smaller than the
    output."""
    for k, size in enumerate(SIZES):
        im = pil_image(mode, size, seed=10 + k)
        ours = decoded(im)
        np.testing.assert_array_equal(
            transforms.valid_transform(ours, 32),
            jax_transforms.valid_transform(im, 32))
        for dataset in ('imagenet', 'ffhq'):
            for seed in range(3):
                a = transforms.train_transform(
                    ours, 32, np.random.RandomState(seed), dataset)
                b = jax_transforms.train_transform(
                    im, 32, np.random.RandomState(seed), dataset)
                np.testing.assert_array_equal(a, b, err_msg=dataset)
        np.testing.assert_array_equal(
            transforms.to_rgb(transforms.crop(ours, (-3, -2, 40, 45))),
            np.asarray(im.crop((-3, -2, 40, 45)).convert('RGB')))


# --------------------------------------------------------------- loader

def write_tree(root, n_per_class=5):
    """An ImageFolder tree (train and val, 3 classes) of PNGs of every
    mode but CMYK (which PNG cannot hold), a palette PNG with a tRNS
    chunk and one JPEG, at mixed sizes."""
    modes = ('RGB', 'L', 'RGBA', 'P', 'LA', 'RGB')
    k = 0
    for split in ('train', 'val'):
        for cls in ('c0', 'c1', 'c2'):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n_per_class):
                im = pil_image(modes[k % len(modes)], SIZES[k % len(SIZES)],
                               seed=k)
                im.save(d / f'{i}.png')
                k += 1
    pil_image('RGB', (40, 36), seed=99).save(root / 'train' / 'c1' / 'x.jpg')
    pil_image('P', (37, 45), seed=98).save(root / 'val' / 'c2' / 't.png',
                                           transparency=3)
    return root


def assert_loaders_equal(ours, theirs):
    assert len(ours) == len(theirs)
    n = 0
    for (xa, ya), (xb, yb) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        n += 1
    return n


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp('tree'))


@pytest.mark.parametrize('train', [True, False], ids=['train', 'valid'])
def test_loader_matches_jax(tree, train):
    """Every batch and label bit-equal to JAX's, whole and in two shards,
    with the drop_remainder default and without it, and behind
    `PrefetchLoader`."""
    ours_ds = datasets.build_dataset('imagenet', str(tree), 'train')
    jax_ds = jax_data.build_dataset('imagenet', str(tree), 'train')
    assert len(ours_ds) == len(jax_ds) == 16
    for shard in ((0, 1), (0, 2), (1, 2)):
        for drop in (True, False):
            kw = dict(batch_size=3, resolution=32, train=train, seed=5,
                      num_workers=4, drop_remainder=drop,
                      shard_index=shard[0], shard_count=shard[1])
            n = assert_loaders_equal(
                datasets.DataLoader(ours_ds, datasets.LoaderConfig(**kw)),
                jax_data.DataLoader(jax_ds, jax_data.LoaderConfig(**kw)))
            items = 16 // shard[1]
            assert n == (items // 3 if drop else -(-items // 3))
    kw = dict(batch_size=4, resolution=32, train=train, seed=1)
    assert_loaders_equal(
        datasets.PrefetchLoader(datasets.DataLoader(
            ours_ds, datasets.LoaderConfig(**kw)), prefetch=2),
        jax_data.PrefetchLoader(jax_data.DataLoader(
            jax_ds, jax_data.LoaderConfig(**kw)), prefetch=2))


def test_loader_without_pillow(tree, monkeypatch, caplog):
    """Where Pillow cannot be imported, PNG files go through the port's
    decoder, with the same batches (valid transform, the val split: PNG
    files only); the loader names its decoder in its repr and in one log
    line; any other file raises ImportError naming the file and Pillow."""
    jax_ds = jax_data.build_dataset('imagenet', str(tree), 'val')
    kw = dict(batch_size=5, resolution=32, train=False)
    expected = list(jax_data.DataLoader(jax_ds, jax_data.LoaderConfig(**kw)))
    monkeypatch.setattr(datasets, '_pillow', lambda: None)
    with caplog.at_level('INFO'):
        loader = datasets.DataLoader(
            datasets.build_dataset('imagenet', str(tree), 'val'),
            datasets.LoaderConfig(**kw))
    assert 'data.png' in repr(loader) and 'Pillow is absent' in repr(loader)
    assert sum('decoder' in r.getMessage() for r in caplog.records) == 1
    assert_loaders_equal(loader, expected)
    with pytest.raises(ImportError, match=r'x\.jpg.*Pillow'):
        datasets.load_image(str(tree / 'train' / 'c1' / 'x.jpg'))


def test_prefetch_loader_raises_the_loader_error(tree, monkeypatch):
    monkeypatch.setattr(datasets, '_pillow', lambda: None)
    loader = datasets.PrefetchLoader(datasets.DataLoader(
        datasets.build_dataset('imagenet', str(tree), 'train'),
        datasets.LoaderConfig(batch_size=16, resolution=32)))
    with pytest.raises(ImportError, match='Pillow'):
        list(loader)


def test_build_dataset_cc3m_concat_and_text_only(tmp_path):
    """cc3m / cc15m tsvs, ffhq and imagefolder file lists: the same
    lengths and items as JAX's (captions as BPE-16k ids, the port's
    tokenizer against the `tokenizers` package's), the CC15M train split
    a ConcatDataset indexed across its parts, CC3MTextOnly's items, and
    the loader stacking token labels; an unknown name raises."""
    pytest.importorskip('tokenizers')
    captions = ['a photo of a cat', 'Two dogs!', 'café au lait', '']
    for sub, n in (('cc3m', 3), ('cc12m', 4)):
        (tmp_path / sub / 'img').mkdir(parents=True)
        for split, rows in (('train', n), ('val', 2)):
            lines = []
            for i in range(rows):
                rel = f'img/{split}{i}.png'
                pil_image('RGB', SIZES[i], seed=i).save(tmp_path / sub / rel)
                lines.append(f'{rel}\t{captions[i % 4]} {sub} {i}')
            lines.append('malformed line without a tab')
            (tmp_path / sub / f'{split}_list.txt').write_text(
                '\n'.join(lines) + '\n')
    (tmp_path / 'ffhq' / 'train').mkdir(parents=True)
    for i in range(3):
        pil_image('L', (33, 33), seed=i).save(
            tmp_path / 'ffhq' / 'train' / f'{i:05d}.png')
    ours_tok = tokenizers.create_tokenizer('bpe16k_huggingface')
    jax_tok = jax_tokenizer('bpe16k_huggingface')
    cases = [('cc3m', tmp_path / 'cc3m', 'train'),
             ('cc3m', tmp_path / 'cc3m', 'val'),
             ('cc15m', tmp_path, 'train'), ('cc15m', tmp_path, 'val'),
             ('ffhq', tmp_path / 'ffhq', 'train'),
             ('imagefolder', tmp_path / 'ffhq', 'val')]
    for name, root, split in cases:
        ours = datasets.build_dataset(name, str(root), split, ours_tok, 16)
        theirs = jax_data.build_dataset(name, str(root), split, jax_tok, 16)
        assert type(ours).__name__ == type(theirs).__name__
        assert len(ours) == len(theirs) > 0, (name, split)
        for i in range(len(ours)):
            (img, label), (pil, ref) = ours[i], theirs[i]
            np.testing.assert_array_equal(img.array, np.asarray(pil))
            np.testing.assert_array_equal(label, ref)
            assert np.asarray(label).dtype == np.asarray(ref).dtype
    cc15m = datasets.build_dataset('cc15m', str(tmp_path), 'train',
                                   ours_tok, 16)
    assert isinstance(cc15m, datasets.ConcatDataset) and len(cc15m) == 7
    assert cc15m.cum == [3, 7]
    kw = dict(batch_size=2, resolution=32, train=True, seed=2)
    assert_loaders_equal(
        datasets.DataLoader(cc15m, datasets.LoaderConfig(**kw)),
        jax_data.DataLoader(jax_data.build_dataset(
            'cc15m', str(tmp_path), 'train', jax_tok, 16),
            jax_data.LoaderConfig(**kw)))
    ours = datasets.CC3MTextOnly(str(tmp_path / 'cc3m'), 'train_list.txt',
                                 ours_tok, 8)
    theirs = jax_data.CC3MTextOnly(str(tmp_path / 'cc3m'), 'train_list.txt',
                                   jax_tok, 8)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        assert ours[i][0] == theirs[i][0] == i
        np.testing.assert_array_equal(ours[i][1], theirs[i][1])
    with pytest.raises(ValueError, match='not a supported dataset'):
        datasets.build_dataset('lsun', str(tmp_path))


def test_loader_len_ignores_drop_remainder(tree):
    """JAX's quirk, kept: `len` counts full batches of a shard whatever
    drop_remainder says."""
    ds = datasets.build_dataset('imagenet', str(tree), 'train')
    for drop in (True, False):
        cfg = datasets.LoaderConfig(batch_size=3, drop_remainder=drop,
                                    shard_count=2)
        assert len(datasets.DataLoader(ds, cfg)) == 2
    assert os.path.basename(ds.samples[0][0]) == '0.png'
