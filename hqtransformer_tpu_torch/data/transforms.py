"""Image transforms on decoded uint8 arrays, equal to the JAX package's
Pillow transforms bit for bit.

Counterpart of `hqtransformer_tpu/data/transforms.py`: train = resize of
the shorter side + random crop (random resized crop + horizontal flip for
FFHQ), valid = resize + center crop, both -> float32 [-1, 1] HWC. The JAX
functions take PIL images; these take a `DecodedImage` (pixels in the
file's mode) and reproduce what Pillow does to it:

- `Image.resize(..., BICUBIC)` is Pillow's two-pass fixed-point resample:
  filter a = -0.5 with its support widened by the scale when shrinking,
  coefficients normalised in double precision and rounded to 22 fraction
  bits, the horizontal pass first (rounded and clipped to uint8), then
  the vertical one, a pass skipped where its size is unchanged. Each pass
  is one float64 product with the integer coefficients, which is exact
  (every partial sum is an integer below 2**53).
- Pillow's per-mode rules, which JAX inherits because it resizes before
  `convert('RGB')`: a 'P' image resizes by NEAREST whatever is asked;
  'RGBA' and 'LA' resize premultiplied ('RGBa', 'La'); 'L' resizes in one
  band and 'CMYK' in four, converted to RGB at the end.
- `Image.crop` fills outside the image with zeros; `convert('RGB')` maps
  a palette, replicates grey and drops alpha, and converts CMYK by
  Pillow's integer formula.

Random draws come from the caller's numpy `RandomState`, in JAX's order.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from .png import DecodedImage

PRECISION_BITS = 22
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0
_PREMULTIPLIED = {'RGBA', 'LA'}
MODES = ('L', 'LA', 'RGB', 'RGBA', 'P', 'CMYK')
_BAND = 64     # outputs a product of a resize pass


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = _BICUBIC_A
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


@functools.lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int
                  ) -> List[Tuple[int, int, int, np.ndarray]]:
    """The fixed-point bicubic weights of one pass (Pillow's
    `precompute_coeffs` and `normalize_coeffs_8bpc`), as float64 integer
    matrices over bands of the output: [(o0, i0, i1, weights [o, i1 -
    i0])], outputs o0..o0 + o reading inputs i0..i1."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)[None, :]
    w = _bicubic((taps + xmin[:, None] - center[:, None] + 0.5) *
                 (1.0 / filterscale))
    w = np.where(taps < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):              # Pillow's order of summation
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0, 1.0,
                                                      total)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    fixed = np.where(fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5))
    bands = []
    for o0 in range(0, out_size, _BAND):
        o1 = min(o0 + _BAND, out_size)
        i0, i1 = int(xmin[o0]), int((xmin + xmax)[o0:o1].max())
        matrix = np.zeros((o1 - o0, i1 - i0))
        for o in range(o0, o1):
            n = xmax[o]
            matrix[o - o0, xmin[o] - i0:xmin[o] - i0 + n] = fixed[o, :n]
        bands.append((o0, i0, i1, matrix))
    return bands


def _round_clip(acc: np.ndarray) -> np.ndarray:
    acc = np.floor((acc + (1 << (PRECISION_BITS - 1))) /
                   (1 << PRECISION_BITS))
    return np.clip(acc, 0, 255).astype(np.uint8)


def _pass(arr: np.ndarray, out_size: int) -> np.ndarray:
    """One pass over the first axis of [in, rest] uint8 -> [out, rest]."""
    flat = arr.reshape(arr.shape[0], -1).astype(np.float64)
    acc = np.empty((out_size, flat.shape[1]))
    for o0, i0, i1, matrix in _coefficients(arr.shape[0], out_size):
        acc[o0:o0 + matrix.shape[0]] = matrix @ flat[i0:i1]
    return _round_clip(acc).reshape((out_size,) + arr.shape[1:])


def _bicubic_resize(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's 8-bit BICUBIC resample of [H, W, bands] uint8."""
    h, w = arr.shape[:2]
    out = arr
    if width != w:
        out = _pass(out.transpose(1, 0, 2), width).transpose(1, 0, 2)
    if height != h:
        out = _pass(out, height)
    return np.ascontiguousarray(out)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's NEAREST sample positions: a running sum from half a step,
    truncated."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1,
                                                           step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def _premultiply(arr: np.ndarray) -> np.ndarray:
    """'RGBA' -> 'RGBa', 'LA' -> 'La': the colour bands times alpha."""
    alpha = arr[..., -1:].astype(np.int32)
    colour = _muldiv255(arr[..., :-1], alpha)
    return np.concatenate([colour, alpha], -1).astype(np.uint8)


def _unpremultiply(arr: np.ndarray) -> np.ndarray:
    """'RGBa' -> 'RGBA', 'La' -> 'LA'."""
    alpha = arr[..., -1:].astype(np.int32)
    colour = arr[..., :-1].astype(np.int32)
    divided = np.clip(255 * colour // np.maximum(alpha, 1), 0, 255)
    colour = np.where((alpha == 0) | (alpha == 255), colour, divided)
    return np.concatenate([colour, alpha], -1).astype(np.uint8)


def resize(img: DecodedImage, size: Tuple[int, int]) -> DecodedImage:
    """`img.resize(size, Image.BICUBIC)` as Pillow does it, size (w, h)."""
    width, height = size
    if img.size == (width, height):
        return img
    if img.mode not in MODES:
        raise ValueError(f'image mode {img.mode!r} is not supported '
                         f'({", ".join(MODES)})')
    arr = img.array
    if img.mode == 'P':
        h, w = arr.shape
        rows = _nearest_index(h, height)
        cols = _nearest_index(w, width)
        return img._replace(array=arr[rows[:, None], cols[None, :]])
    bands = arr if arr.ndim == 3 else arr[:, :, None]
    if img.mode in _PREMULTIPLIED:
        bands = _premultiply(bands)
    out = _bicubic_resize(bands, width, height)
    if img.mode in _PREMULTIPLIED:
        out = _unpremultiply(out)
    return img._replace(array=out if arr.ndim == 3 else out[:, :, 0])


def crop(img: DecodedImage, box: Tuple[int, int, int, int]
         ) -> DecodedImage:
    """`img.crop(box)`: (left, top, right, bottom), zeros outside."""
    left, top, right, bottom = box
    arr = img.array
    h, w = arr.shape[:2]
    out = np.zeros((bottom - top, right - left) + arr.shape[2:], arr.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = arr[y0:y1, x0:x1]
    return img._replace(array=out)


def flip_left_right(img: DecodedImage) -> DecodedImage:
    return img._replace(array=np.ascontiguousarray(img.array[:, ::-1]))


def to_rgb(img: DecodedImage) -> np.ndarray:
    """`np.asarray(img.convert('RGB'))`: uint8 [H, W, 3]."""
    arr, mode = img.array, img.mode
    if mode == 'RGB':
        return arr
    if mode == 'RGBA':
        return arr[..., :3]
    if mode in ('L', 'LA'):
        grey = arr if mode == 'L' else arr[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1)
    if mode == 'P':
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(img.palette)] = img.palette
        return palette[arr]
    if mode == 'CMYK':
        inv_k = 255 - arr[..., 3:].astype(np.int32)
        return np.clip(inv_k - _muldiv255(arr[..., :3], inv_k), 0,
                       255).astype(np.uint8)
    raise ValueError(f'image mode {mode!r} is not supported '
                     f'({", ".join(MODES)})')


def resize_shorter(img: DecodedImage, size: int) -> DecodedImage:
    w, h = img.size
    if w < h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return resize(img, (nw, nh))


def center_crop(img: DecodedImage, size: int) -> DecodedImage:
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return crop(img, (left, top, left + size, top + size))


def random_crop(img: DecodedImage, size: int, rng: np.random.RandomState
                ) -> DecodedImage:
    w, h = img.size
    left = rng.randint(0, max(1, w - size + 1))
    top = rng.randint(0, max(1, h - size + 1))
    return crop(img, (left, top, left + size, top + size))


def random_resized_crop(img: DecodedImage, size: int,
                        rng: np.random.RandomState,
                        scale=(0.75, 1.0), ratio=(1.0, 1.3333)
                        ) -> DecodedImage:
    """torchvision's RandomResizedCrop, with JAX's draws in JAX's order
    (the FFHQ train transform)."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            return resize(crop(img, (left, top, left + cw, top + ch)),
                          (size, size))
    return center_crop(resize_shorter(img, size), size)


def to_normalized_array(img: DecodedImage) -> np.ndarray:
    """uint8 RGB -> float32 [-1, 1] HWC (Normalize(0.5, 0.5))."""
    arr = np.asarray(to_rgb(img), np.float32) / 255.0
    return arr * 2.0 - 1.0


def train_transform(img: DecodedImage, resolution: int,
                    rng: np.random.RandomState,
                    dataset: str = 'imagenet') -> np.ndarray:
    if dataset in ('ffhq',):
        img = random_resized_crop(img, resolution, rng)
        if rng.rand() < 0.5:
            img = flip_left_right(img)
    else:
        img = resize_shorter(img, resolution)
        img = random_crop(img, resolution, rng)
    return to_normalized_array(img)


def valid_transform(img: DecodedImage, resolution: int) -> np.ndarray:
    img = resize_shorter(img, resolution)
    img = center_crop(img, resolution)
    return to_normalized_array(img)
