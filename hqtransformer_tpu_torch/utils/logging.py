"""Run logging: the rank-zero file log, the saved config, TensorBoard
scalars and image grids.

Counterpart of `hqtransformer_tpu/utils/logging.py::RunLogger`. Only rank
0 (`enabled`) writes: `train.log`, `config.yaml` (`config.save_config`,
read back to an equal config by `build_twostage_config` or
`build_stage1_config`) and, where `tensorboardX` imports, TensorBoard
events under `tb/`. Each logger has handlers of its own, which `close`
removes, so several runs in one process do not repeat each other's lines.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np

from ..config import save_config


class RunLogger:
    def __init__(self, result_path: str, config=None, enabled: bool = True,
                 img_logging_freq: int = 5000):
        self.enabled = enabled
        self.result_path = result_path
        self.img_logging_freq = img_logging_freq
        self.tb = None
        self.log = None
        if not enabled:
            return
        os.makedirs(result_path, exist_ok=True)
        self.log = logging.getLogger(f'train.{id(self)}')
        self.log.setLevel(logging.INFO)
        self.log.propagate = False
        fh = logging.FileHandler(os.path.join(result_path, 'train.log'))
        fh.setFormatter(logging.Formatter('%(asctime)s %(message)s'))
        self.log.addHandler(fh)
        self.log.addHandler(logging.StreamHandler())
        if config is not None:
            save_config(config, os.path.join(result_path, 'config.yaml'))
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(os.path.join(result_path, 'tb'))
        except ImportError:
            self.tb = None

    def scalars(self, metrics: Dict[str, float], step: int,
                prefix: str = 'train'):
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f'{prefix}/{k}', float(v), step)

    def line(self, msg: str):
        if self.enabled:
            self.log.info(msg)

    def images(self, tag: str, images: np.ndarray, step: int,
               max_images: int = 8):
        """images: [B, H, W, C] in [0, 1], logged as one horizontal grid."""
        if self.tb is None:
            return
        arr = np.clip(np.asarray(images[:max_images]), 0, 1)
        B, H, W, C = arr.shape
        grid = arr.transpose(1, 0, 2, 3).reshape(H, B * W, C)
        self.tb.add_image(tag, grid, step, dataformats='HWC')

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.log is not None:
            for h in list(self.log.handlers):
                h.close()
                self.log.removeHandler(h)
