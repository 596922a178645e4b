"""The program under test as the drivers build it: the configuration file's
`model` section through the program's own YAML parser, and its model."""

from __future__ import annotations

import torch
import yaml

from .manifest import ROOT

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
CONFIG_DIR = ROOT / 'build' / 'benchmark'


def twostage_config(config: dict):
    """The program's `TwoStageConfig` of a configuration file, through the
    YAML file the CLIs read (written under `build/benchmark/`)."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    CONFIG_DIR.mkdir(parents=True, exist_ok=True)
    path = CONFIG_DIR / f'{config["name"]}.yaml'
    text = yaml.safe_dump(config['model'], sort_keys=False)
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix('.tmp')
        tmp.write_text(text)
        tmp.replace(path)
    return build_twostage_config(str(path))


def model(config: dict, device: torch.device):
    """The program's `TwoStageModel` of a configuration file, in its
    precision, on `device`."""
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel
    return TwoStageModel(twostage_config(config), DTYPES[config['precision']],
                         device=str(device))


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
