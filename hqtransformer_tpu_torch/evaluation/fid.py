"""FID utilities: Inception features of sample files and datasets, their
mean and covariance, the Frechet distance, the Inception score.

Counterpart of `hqtransformer_tpu/evaluation/fid.py`. The sample files
are the pickled [B, 3, H, W] float arrays in [0, 1] that the sampling
CLIs write; statistics are npz files with `mu` and `sigma` (and `acts`).
The Inception forward runs batched in f32 on the device (CUDA unless
asked); `sqrtm` stays on the host's scipy, as in JAX.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch
from scipy import linalg

from ..device import resolve_device
from .inception import (FIDInceptionV3, he_scaled_state,
                        pt_inception_state)

_log = logging.getLogger(__name__)


def mean_covar_numpy(xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(xs, axis=0), np.cov(xs, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Frechet distance of two Gaussians, with `eps` added to the
    covariances' diagonals where their product is singular."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(
            f'feature-dimension mismatch {mu1.shape} vs {mu2.shape}: '
            f'candidate and reference statistics must come from the same '
            f'feature extractor')

    diff = mu1 - mu2
    # (no `disp`: SciPy 1.18 removed it; the array is the same)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        _log.warning('fid calculation produces singular product; '
                     'adding %s to diagonal of cov estimates', eps)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError('Imaginary component '
                             f'{np.max(np.abs(covmean.imag))}')
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) -
                 2 * np.trace(covmean))


class InceptionExtractor:
    """Batched 2048-d features (and 1008 logits) of the FID Inception, f32
    on `device` (CUDA unless asked). Its weights are a pt_inception-
    2015-12-05 state dict from `weights_path`; without one, seeded random
    weights (`he_scaled_state(seed)`), whose features mean nothing next
    to published numbers."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 100,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        state = (torch.load(weights_path, map_location='cpu',
                            weights_only=True) if weights_path
                 else he_scaled_state(seed))
        with torch.device('meta'):
            model = FIDInceptionV3()
        model.load_state_dict(pt_inception_state(state), strict=True,
                              assign=True)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def _run(self, images01_nhwc, logits: bool) -> np.ndarray:
        outs = []
        for i in range(0, images01_nhwc.shape[0], self.batch_size):
            chunk = torch.as_tensor(images01_nhwc[i:i + self.batch_size])
            out = self.model(chunk.to(self.device, torch.float32),
                             return_logits=logits)
            outs.append((out[1] if logits else out).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def features(self, images01_nhwc) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] (numpy, or a tensor on any
        device) -> [N, 2048] f32."""
        return self._run(images01_nhwc, logits=False)

    def logits(self, images01_nhwc) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> [N, 1008] f32."""
        return self._run(images01_nhwc, logits=True)


class PixelExtractor:
    """Weightless features: average-pooled pixels ([grid, grid, 3] ->
    flat), a pixel-space Frechet distance where the Inception weights
    are missing. Not comparable to published FID numbers."""

    def __init__(self, grid: int = 8, batch_size: int = 100):
        self.grid = grid
        self.batch_size = batch_size

    def features(self, images01_nhwc: np.ndarray) -> np.ndarray:
        x = np.asarray(images01_nhwc, np.float32)
        n, h, w, c = x.shape
        g = min(self.grid, h, w)
        hb, wb = h // g, w // g
        x = x[:, :hb * g, :wb * g]
        x = x.reshape(n, g, hb, g, wb, c).mean(axis=(2, 4))
        return x.reshape(n, -1)


def make_extractor(kind: str = 'inception', weights_path=None,
                   batch_size: int = 100, device=None):
    """'inception' (weights_path for real FID) or 'pixels' (weightless)."""
    if kind == 'pixels':
        return PixelExtractor(batch_size=batch_size)
    if kind != 'inception':
        raise ValueError(f'unknown feature extractor {kind!r}')
    return InceptionExtractor(weights_path=weights_path,
                              batch_size=batch_size, device=device)


def iter_sample_files(result_path: str) -> Iterable[np.ndarray]:
    """[B, H, W, 3] float batches in [0, 1] from the pickled sample files
    (samples_*.pkl, sorted by name) of a result directory."""
    files = sorted(glob.glob(os.path.join(result_path, 'samples_*.pkl')))
    if not files:
        raise FileNotFoundError(f'no samples_*.pkl under {result_path}')
    for f in files:
        with open(f, 'rb') as fp:
            arr = pickle.load(fp)
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 4 and arr.shape[1] == 3:  # NCHW -> NHWC
            arr = arr.transpose(0, 2, 3, 1)
        yield arr


def compute_activations_from_files(result_path: str, extractor,
                                   max_samples: Optional[int] = None
                                   ) -> np.ndarray:
    """The features of every sample batch in a result directory."""
    acts = []
    n = 0
    for batch in iter_sample_files(result_path):
        acts.append(extractor.features(batch))
        n += batch.shape[0]
        if max_samples and n >= max_samples:
            break
    acts = np.concatenate(acts, axis=0)
    return acts[:max_samples] if max_samples else acts


def compute_activations_from_dataset(dataset, extractor,
                                     resolution: int = 256,
                                     max_samples: Optional[int] = None,
                                     dataset_name: str = 'imagenet'
                                     ) -> np.ndarray:
    """The features of a dataset's images (any indexable of (image,
    label), e.g. `data.datasets.build_dataset(...)`) through the
    center-crop evaluation transform."""
    from ..data import transforms as T

    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    acts = []
    bs = extractor.batch_size
    for start in range(0, n, bs):
        imgs = []
        for i in range(start, min(start + bs, n)):
            img, _ = dataset[i]
            arr = T.valid_transform(img, resolution)   # [-1, 1] NHWC
            imgs.append(arr * 0.5 + 0.5)               # -> [0, 1]
        acts.append(extractor.features(np.stack(imgs).astype(np.float32)))
    return np.concatenate(acts, axis=0)


def compute_statistics_from_dataset(dataset, extractor, out_path: str,
                                    resolution: int = 256,
                                    max_samples: Optional[int] = None,
                                    save_acts: bool = False) -> dict:
    """Write a reference-statistics npz (mu, sigma[, acts]) of a dataset
    and return its entries."""
    acts = compute_activations_from_dataset(dataset, extractor, resolution,
                                            max_samples)
    mu, sigma = mean_covar_numpy(acts)
    payload = {'mu': mu, 'sigma': sigma}
    if save_acts:
        payload['acts'] = acts
    np.savez(out_path, **payload)
    _log.info('inception statistics (%d samples) saved to %s',
              acts.shape[0], out_path)
    return payload


def inception_score(logits: np.ndarray, splits: int = 10) -> float:
    """IS from Inception logits (softmax over the 1008 classes)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores))
