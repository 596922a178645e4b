"""Build and load the port's hand-written CUDA kernels.

Each source in `hqtransformer_tpu_torch/csrc/` exports a plain C function and
is compiled by `nvcc` for Hopper (`sm_90a`) into its own shared library,
which `ctypes` loads. The build happens at first use, into `build/kernels/`
at the root of the checkout, under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one `nvcc` per missing library, all at once.

Nothing here runs at import time: this module imports on machines without
a card or a CUDA toolkit, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
KERNEL_SOURCES = ('decode_attention', 'sample_topk', 'vq_argmin')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))
    candidate = cuda_home / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin and on PATH): the '
            'CUDA kernels of hqtransformer_tpu_torch cannot be built')
    return found


def library_path(name: str) -> Path:
    """The shared library built from `csrc/<name>.cu` with NVCC_FLAGS."""
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / f'{name}.cu').read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process each, all started together. Returns each compiled source's
    compiler messages (the `ptxas` register and shared-memory report).
    Raises with nvcc's output if any build fails."""
    nvcc = None
    jobs = []
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            nvcc = nvcc or _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
            cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
                   str(CSRC_DIR / f'{name}.cu')]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, so, tmp, proc))
        messages, errors = {}, []
        for name, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            messages[name] = out
            if proc.returncode != 0:
                errors.append(f'{name}.cu: nvcc exited with '
                              f'{proc.returncode}\n{out}')
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError('CUDA kernel build failed:\n' +
                               '\n'.join(errors))
        return messages
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
