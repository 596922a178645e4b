"""Datasets and the per-host input pipeline.

Counterpart of `hqtransformer_tpu/data/datasets.py`, with its classes and
quirks: ImageNet (ImageFolder layout), FFHQ / generic file lists, CC3M
(a tsv of image path<TAB>caption) and CC15M (CC3M + CC12M), a thread-pool
loader whose per-item random state is keyed by (seed, dataset index) and
whose order is `RandomState(seed).permutation`, sharded by
`shard_index::shard_count`; `__len__` ignores `drop_remainder`.

Items are `DecodedImage`s (uint8 pixels in the file's mode) instead of PIL
images, and the transforms of `data/transforms.py` reproduce Pillow's on
them. Files are decoded by Pillow where it can be imported, as the JAX
package decodes them; on a host without Pillow, PNG files go through the
port's own decoder (`data/png.py`) and any other file raises ImportError.
`image_decoder()` names the decoder, and every loader says it once.
"""

from __future__ import annotations

import bisect
import logging
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from . import transforms as T
from .png import SIGNATURE, DecodedImage, decode_png

_log = logging.getLogger(__name__)

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.bmp', '.webp')


def _pillow():
    """PIL.Image, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def image_decoder() -> str:
    """The decoder `load_image` uses on this host."""
    image = _pillow()
    if image is not None:
        import PIL
        return f'Pillow {PIL.__version__}'
    return 'hqtransformer_tpu_torch.data.png (PNG only; Pillow is absent)'


def load_image(path: str) -> DecodedImage:
    """The decoded pixels of an image file, in the file's mode."""
    image = _pillow()
    if image is not None:
        with image.open(path) as im:
            im.load()
            palette = None
            if im.mode == 'P':
                palette = np.asarray(im.getpalette(),
                                     np.uint8).reshape(-1, 3)
            info = {k: im.info[k] for k in ('transparency',) if k in im.info}
            return DecodedImage(np.asarray(im), im.mode, palette, info)
    with open(path, 'rb') as f:
        blob = f.read()
    if blob[:len(SIGNATURE)] != SIGNATURE:
        raise ImportError(f'{path}: not a PNG file; decoding other image '
                          f'formats needs Pillow (PIL), which is not '
                          f'installed')
    return decode_png(blob)


class ImageFolderDataset:
    """torchvision-ImageFolder layout: root/<class>/<img>, labels by
    sorted class-directory order."""

    def __init__(self, root: str, split_subdir: str = ''):
        base = os.path.join(root, split_subdir) if split_subdir else root
        classes = sorted(d for d in os.listdir(base)
                         if os.path.isdir(os.path.join(base, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(base, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        return load_image(path), label


class FileListDataset:
    """A flat file list (FFHQ and ImageFolder variants); labels are 0."""

    def __init__(self, root: str, file_list: Optional[str] = None):
        if file_list is not None:
            with open(file_list) as fp:
                names = [ln.strip() for ln in fp if ln.strip()]
            self.paths = [os.path.join(root, n) for n in names]
        else:
            self.paths = []
            for dirpath, _, files in sorted(os.walk(root)):
                for fn in sorted(files):
                    if fn.lower().endswith(IMG_EXTENSIONS):
                        self.paths.append(os.path.join(dirpath, fn))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        return load_image(self.paths[idx]), 0


def _read_tsv(path: str) -> List[Tuple[str, str]]:
    """(image path, caption) of each line with at least two fields."""
    items = []
    with open(path) as fp:
        for ln in fp:
            parts = ln.rstrip('\n').split('\t')
            if len(parts) >= 2:
                items.append((parts[0], parts[1]))
    return items


class CC3MDataset:
    """A tsv of (image path, caption) pairs and a caption tokenizer:
    items are (image, int32 token ids [context_length])."""

    def __init__(self, root: str, tsv_name: str, tokenizer,
                 context_length: int = 64):
        self.root = root
        self.items = _read_tsv(os.path.join(root, tsv_name))
        self.tokenizer = tokenizer
        self.context_length = context_length

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        rel, text = self.items[idx]
        img = load_image(os.path.join(self.root, rel))
        tokens = self.tokenizer.encode_padded(text, self.context_length)
        return img, np.asarray(tokens, np.int32)


class ConcatDataset:
    """CC15M = CC3M + CC12M."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        di = bisect.bisect_right(self.cum, idx)
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


@dataclass
class LoaderConfig:
    batch_size: int
    resolution: int = 256
    dataset_name: str = 'imagenet'
    train: bool = True
    seed: int = 0
    num_workers: int = 8
    drop_remainder: bool = True
    shard_index: int = 0
    shard_count: int = 1


class DataLoader:
    """Deterministic, shardable loader of NHWC float32 [-1, 1] batches and
    their labels (int64 [B], or stacked token ids). Items are decoded and
    transformed on a pool of `cfg.num_workers` threads; each item's random
    state is keyed by (seed, dataset index), not by worker order."""

    def __init__(self, dataset, cfg: LoaderConfig):
        self.dataset = dataset
        self.cfg = cfg
        self.decoder = image_decoder()
        _log.info('%r', self)

    def __repr__(self):
        kind = 'train' if self.cfg.train else 'valid'
        return (f'DataLoader({len(self.dataset)} items, batch '
                f'{self.cfg.batch_size}, {kind} transform, '
                f'{self.cfg.num_workers} workers, decoder: {self.decoder})')

    def _load_item(self, i: int):
        cfg = self.cfg
        img, label = self.dataset[int(i)]
        item_rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + int(i)) % (2 ** 31))
        if cfg.train:
            arr = T.train_transform(img, cfg.resolution, item_rng,
                                    cfg.dataset_name)
        else:
            arr = T.valid_transform(img, cfg.resolution)
        return arr, label

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        n = len(self.dataset)
        rng = np.random.RandomState(cfg.seed)
        order = rng.permutation(n) if cfg.train else np.arange(n)
        order = order[cfg.shard_index::cfg.shard_count]
        bs = cfg.batch_size
        steps = len(order) // bs if cfg.drop_remainder else \
            (len(order) + bs - 1) // bs
        pool = ThreadPoolExecutor(max(1, cfg.num_workers)) \
            if cfg.num_workers > 1 else None
        try:
            for s in range(steps):
                idxs = order[s * bs:(s + 1) * bs]
                if pool is not None:
                    items = list(pool.map(self._load_item, idxs))
                else:
                    items = [self._load_item(i) for i in idxs]
                imgs = [it[0] for it in items]
                labels = [it[1] for it in items]
                yield (np.stack(imgs),
                       np.stack(labels) if np.ndim(labels[0]) else
                       np.asarray(labels, np.int64))
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def __len__(self):
        n = len(self.dataset) // self.cfg.shard_count
        return n // self.cfg.batch_size


def build_dataset(name: str, root: str, split: str = 'train',
                  tokenizer=None, context_length: int = 64):
    """The dataset of `name` ('imagenet', 'ffhq', 'imagefolder', 'cc3m',
    'cc15m') under `root`."""
    if name == 'imagenet':
        sub = 'train' if split == 'train' else 'val'
        return ImageFolderDataset(root, sub)
    if name in ('ffhq', 'imagefolder'):
        sub = os.path.join(root, split)
        return FileListDataset(sub if os.path.isdir(sub) else root)
    if name == 'cc3m':
        tsv = 'train_list.txt' if split == 'train' else 'val_list.txt'
        return CC3MDataset(root, tsv, tokenizer, context_length)
    if name == 'cc15m':
        tsv = 'train_list.txt' if split == 'train' else 'val_list.txt'
        cc3m = CC3MDataset(os.path.join(root, 'cc3m'), tsv, tokenizer,
                           context_length)
        if split != 'train':
            return cc3m
        cc12m = CC3MDataset(os.path.join(root, 'cc12m'), 'train_list.txt',
                            tokenizer, context_length)
        return ConcatDataset([cc3m, cc12m])
    raise ValueError(f'{name} is not a supported dataset')


class CC3MTextOnly:
    """The captions of a CC3M tsv: items are (index, int32 token ids)."""

    def __init__(self, root: str, tsv_name: str, tokenizer,
                 context_length: int = 64):
        self.captions = [c for _, c in _read_tsv(os.path.join(root,
                                                              tsv_name))]
        self.tokenizer = tokenizer
        self.context_length = context_length

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        tokens = self.tokenizer.encode_padded(self.captions[idx],
                                              self.context_length)
        return idx, np.asarray(tokens, np.int32)


class PrefetchLoader:
    """A loader behind a producer thread holding up to `prefetch` whole
    batches, so that batch assembly overlaps the device's work. An error
    in the loader is raised to the consumer (the JAX loader's ends the
    iteration quietly)."""

    def __init__(self, loader, prefetch: int = 4):
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = object()
        failure: List[BaseException] = []

        def producer():
            try:
                for item in self.loader:
                    q.put(item)
            except Exception as e:  # handed to the consumer below
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]
