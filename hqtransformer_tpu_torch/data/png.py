"""A PNG decoder in `zlib` and numpy, for hosts without Pillow.

It reads non-interlaced PNG files with 8-bit samples (grey, grey + alpha,
RGB, RGBA) or a palette of 1, 2, 4 or 8 bits, and gives what Pillow's
`Image.open` gives for them: the pixels as a uint8 array in the file's
own mode ('L' [H, W], 'LA' [H, W, 2], 'RGB' [H, W, 3], 'RGBA' [H, W, 4],
'P' [H, W] palette indices), the palette ([n, 3] uint8) of a 'P' image,
and Pillow's `info['transparency']` from a `tRNS` chunk.

The five row filters are undone as a wavefront over anti-diagonals of
pixels: the pixel at (r, c) depends on its left, upper and upper-left
neighbours only, so the pixels of one anti-diagonal r + c = d are
independent, and each of the H + W - 1 steps is vectorised over them.
"""

from __future__ import annotations

import functools
import re
import struct
import zlib
from typing import Dict, NamedTuple, Optional

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> (mode, samples a pixel) at bit depth 8
_COLOUR = {0: ('L', 1), 2: ('RGB', 3), 3: ('P', 1), 4: ('LA', 2),
           6: ('RGBA', 4)}
# Pillow's test for a tRNS of one fully transparent palette entry
_SIMPLE_PALETTE = re.compile(b'^\xff*\x00\xff*$')


class DecodedImage(NamedTuple):
    """Decoded pixels: `array` uint8 [H, W] or [H, W, bands] in `mode`
    ('L', 'LA', 'RGB', 'RGBA', 'P', 'CMYK'), `palette` [n, 3] uint8 for
    'P' (else None), and Pillow's `info` entries that the pipeline keeps
    ('transparency')."""
    array: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    info: Optional[Dict] = None

    @property
    def size(self):
        """(width, height), as Pillow's `Image.size`."""
        return self.array.shape[1], self.array.shape[0]


@functools.lru_cache(maxsize=None)
def _predictor_tables():
    """(paeth [2**24], others [4 * 2**16]) uint8: the Paeth predictor of
    every (a, b, c) at index a << 16 | b << 8 | c, and the None, Sub, Up
    and Average predictors of every (a, b) at index type << 16 | a << 8 |
    b, so that a wavefront step is a few table reads."""
    b = np.arange(256, dtype=np.int16)[:, None]
    c = np.arange(256, dtype=np.int16)[None, :]
    paeth = np.empty((256, 256, 256), np.uint8)
    for a in range(256):
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth[a] = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
    a, b = np.arange(256)[:, None], np.arange(256)[None, :]
    others = np.stack([np.zeros((256, 256), np.int64) + 0 * a, a + 0 * b,
                       b + 0 * a, (a + b) >> 1]).astype(np.uint8)
    return paeth.reshape(-1), others.reshape(-1)


def unfilter(data: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. data: the filtered bytes [H, W * bpp]
    (W in filter units of `bpp` bytes), filters: [H] the row filter types
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) -> the raw bytes [H, W *
    bpp] uint8."""
    h = data.shape[0]
    w = data.shape[1] // bpp
    if np.any(filters > 4):
        raise ValueError(f'PNG row filter type {int(filters.max())} is not '
                         f'one of 0..4')
    paeth_table, other_table = _predictor_tables()
    n_diag = h + w - 1
    # skew: pixel (r, c) sits at [r + c + 2, r + 1]; row 0 of the second
    # axis and every c = -1 slot stay zero, the filters' outside pixels
    d_idx = np.arange(n_diag)[:, None]
    r_idx = np.arange(h)[None, :]
    pix = data.reshape(h, w, bpp)
    filtered = pix[r_idx, np.clip(d_idx - r_idx, 0, w - 1)]
    out = np.zeros((n_diag + 2, h + 1, bpp), np.int32)
    kind = filters.astype(np.int32)[:, None]
    is_paeth = kind == 4
    other_base = np.where(is_paeth, 0, kind) << 16
    any_paeth = bool(is_paeth.any())
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        ab = (out[d + 1, lo + 1:hi + 1] << 8) | out[d + 1, lo:hi]
        pred = other_table.take(other_base[lo:hi] + ab)
        if any_paeth:
            pred = np.where(is_paeth[lo:hi], paeth_table.take(
                (ab << 8) | out[d, lo:hi]), pred)
        np.add(filtered[d, lo:hi], pred, out=out[d + 2, lo + 1:hi + 1],
               casting='unsafe', dtype=np.uint8)
    raw = out[r_idx.T + np.arange(w)[None, :] + 2, r_idx.T + 1]
    return raw.astype(np.uint8).reshape(h, w * bpp)


def _unpack(raw: np.ndarray, width: int, bits: int) -> np.ndarray:
    """Palette indices of `bits` bits, packed high bits first in each
    byte, [H, row bytes] -> [H, width]."""
    if bits == 8:
        return raw
    per_byte = 8 // bits
    shifts = (8 - bits * (np.arange(per_byte) + 1)).astype(np.uint8)
    vals = (raw[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(raw.shape[0], -1)[:, :width]


def decode_png(blob: bytes) -> DecodedImage:
    """The pixels of a PNG file's bytes, as Pillow decodes them."""
    if blob[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, palette, trns, idat = 8, None, None, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack('>I4s', blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b'tRNS':
            trns = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError('PNG file without an IHDR chunk')
    width, height, bits, colour, _, filter_method, interlace = header
    if colour not in _COLOUR or filter_method != 0:
        raise ValueError(f'PNG colour type {colour} / filter method '
                         f'{filter_method} is not supported')
    if interlace:
        raise ValueError('interlaced PNG files are not supported')
    if bits != 8 and not (colour == 3 and bits in (1, 2, 4)):
        raise ValueError(f'PNG with {bits}-bit samples of colour type '
                         f'{colour} is not supported (8-bit samples, or a '
                         f'palette of 1, 2, 4 or 8 bits)')
    mode, samples = _COLOUR[colour]
    bpp = samples * bits // 8 if bits == 8 else 1
    row_bytes = (width * samples * bits + 7) // 8
    stream = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if stream.size < height * (row_bytes + 1):
        raise ValueError('PNG image data is truncated')
    rows = stream[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    raw = unfilter(rows[:, 1:], rows[:, 0], bpp)
    info = {}
    if colour == 3:
        if palette is None:
            raise ValueError('palette PNG file without a PLTE chunk')
        array = _unpack(raw, width, bits)
        if trns is not None:
            if _SIMPLE_PALETTE.match(trns):
                if b'\0' in trns:
                    info['transparency'] = trns.find(b'\0')
            else:
                info['transparency'] = trns
    else:
        array = raw.reshape(height, width, samples)
        if samples == 1:
            array = array[:, :, 0]
        if trns is not None and colour == 0:
            info['transparency'] = struct.unpack('>H', trns[:2])[0]
        elif trns is not None and colour == 2:
            info['transparency'] = struct.unpack('>HHH', trns[:6])
    return DecodedImage(np.ascontiguousarray(array), mode, palette, info)
