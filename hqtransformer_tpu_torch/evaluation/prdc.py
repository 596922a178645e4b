"""Precision, recall, density and coverage over feature manifolds.

Counterpart of `hqtransformer_tpu/evaluation/prdc.py`: squared L2
distances |u|^2 + |v|^2 - 2 u.v in f32 tiles on the device (one
`torch.matmul` a tile; TF32 is left as the caller set it, off by
PyTorch's default), k-NN radii by `argpartition` on the host, and the
four metrics in numpy, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device


def _tile_distances(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    nu = (u * u).sum(1, keepdim=True)
    nv = (v * v).sum(1, keepdim=True).T
    return nu + nv - 2.0 * torch.matmul(u, v.T)


def compute_pairwise_distance(data_x: np.ndarray,
                              data_y: Optional[np.ndarray] = None,
                              row_batch_size: int = 10000,
                              col_batch_size: int = 10000,
                              device: Optional[Union[str, torch.device]]
                              = None) -> np.ndarray:
    """Squared distances [n_x, n_y] f32, tile by tile on `device` (CUDA
    unless asked)."""
    device = resolve_device(device)
    if data_y is None:
        data_y = data_x
    n_x, n_y = len(data_x), len(data_y)
    dists = np.zeros([n_x, n_y], dtype=np.float32)
    for b1 in range(0, n_x, row_batch_size):
        e1 = min(b1 + row_batch_size, n_x)
        u = torch.as_tensor(np.asarray(data_x[b1:e1], np.float32),
                            device=device)
        for b2 in range(0, n_y, col_batch_size):
            e2 = min(b2 + col_batch_size, n_y)
            v = torch.as_tensor(np.asarray(data_y[b2:e2], np.float32),
                                device=device)
            dists[b1:e1, b2:e2] = _tile_distances(u, v).cpu().numpy()
    return dists


def get_kth_value(unsorted: np.ndarray, k: int, axis: int = -1) -> np.ndarray:
    indices = np.argpartition(unsorted, k, axis=axis)[..., :k]
    k_smallests = np.take_along_axis(unsorted, indices, axis=axis)
    return k_smallests.max(axis=axis)


def compute_nearest_neighbour_distances(features: np.ndarray, nearest_k: int,
                                        device=None) -> np.ndarray:
    """Each row's squared distance to its `nearest_k`-th neighbour (itself
    counted as the first)."""
    distances = compute_pairwise_distance(features, device=device)
    return get_kth_value(distances, k=nearest_k + 1, axis=-1)


def compute_prdc(real_features: np.ndarray, fake_features: np.ndarray,
                 nearest_k: int, device=None) -> Dict[str, float]:
    """{'precision', 'recall', 'density', 'coverage'} of the fake features
    against the real ones."""
    real_nnd = compute_nearest_neighbour_distances(real_features, nearest_k,
                                                   device)
    fake_nnd = compute_nearest_neighbour_distances(fake_features, nearest_k,
                                                   device)
    d_rf = compute_pairwise_distance(real_features, fake_features,
                                     device=device)

    precision = (d_rf < np.expand_dims(real_nnd, 1)).any(axis=0).mean()
    recall = (d_rf < np.expand_dims(fake_nnd, 0)).any(axis=1).mean()
    density = (1.0 / float(nearest_k)) * \
        (d_rf < np.expand_dims(real_nnd, 1)).sum(axis=0).mean()
    coverage = (d_rf.min(axis=1) < real_nnd).mean()
    return dict(precision=float(precision), recall=float(recall),
                density=float(density), coverage=float(coverage))
