"""What a driver gets and gives back: the run's arguments and cell, and
the result line's parts."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .manifest import Cell
from .trace import Trace

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hqtransformer_tpu')


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float                  # the process's start, host clock
    device: torch.device
    fault: Optional[str] = None     # a planted fault (the harness tests)
    control: Optional[str] = None   # run the control in the program's place


@dataclass
class Outcome:
    """What one run measured and compared."""
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                  # samples or images completed
    memory_peak_bytes: int = 0
    rates: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[Trace] = None
    info: Dict[str, object] = field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    correct: bool = False


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})
