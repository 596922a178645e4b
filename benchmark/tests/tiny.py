"""Tiny cells for the harness's CPU tests: the configurations under
`tests/data/` with small traffic, driven on the CPU."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from hqbench import check, manifest
from hqbench.run_context import Run

DATA = Path(__file__).resolve().parent / 'data'

TRAFFIC = {
    'sample': {'kind': 'sample', 'batch': 4, 'top_k': 8, 'temperature': 0.95,
               'decode_chunk': 2, 'label_batches': 3},
    'train': {'kind': 'train', 'batch': 2, 'data_parallel': 8,
              'train_images': 1281167, 'image_batches': 4,
              'checked_steps': 3, 'sync_every': 2, 'tf32_matmul': False,
              'tf32_cudnn': True},
}
LIMITS = {
    'sample': {'check_rows': 4, 'limits': {'topk_gap': 1e-4,
                                           'topp_excess': 1e-4,
                                           'pixel_rel_rms': 1e-4,
                                           'codes_out_of_range': 0}},
    'train': {'limits': {'codes_rows_missing': 0, 'code_gap': 1e-5,
                         'code_mismatch': 0, 'grad_gap': 1e-3,
                         'change_gap': 1e-3}},
}


def cell(config: str, kind: str, precision: str = 'float32',
         **traffic) -> manifest.Cell:
    """A tiny cell of the configuration `tests/data/<config>.json` run in
    `precision` (float32 on the CPU, where bf16 is slow)."""
    cfg = json.loads((DATA / f'{config}.json').read_text())
    cfg['precision'] = precision
    man = manifest.load_json(manifest.MANIFEST)
    rate = {'sample': 'samples_per_s', 'train': 'train_images_per_s'}[kind]
    e2e = [m for m in man['end_to_end'] if m['name'] in (
        rate, 'peak_mem_gib', 'setup_s')]
    per_layer = [m for m in man['per_layer'] if m['moves'] == rate]
    return manifest.Cell(f'tiny.{kind}', 1, cfg,
                         {**TRAFFIC[kind], **traffic}, LIMITS[kind], e2e,
                         per_layer)


def run(cell_: manifest.Cell, seed: int = 7, seconds: float = 0.0,
        trace: bool = False, fault=None, control=None):
    r = Run(cell_, seed, seconds, trace, time.perf_counter(),
            torch.device('cpu'), fault=fault, control=control)
    out = manifest.driver(cell_.kind).run(r)
    check.judge(out, bool(control))
    return r, out
