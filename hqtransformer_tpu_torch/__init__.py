"""hqtransformer_tpu_torch: the PyTorch and CUDA port of hqtransformer_tpu
for NVIDIA Hopper (H100).

The JAX package `hqtransformer_tpu` is the reference this package is held
against; the port imports nothing of it, and nothing of JAX. Plain tensor
code is PyTorch. The TPU's Pallas kernels on the ported path are
hand-written CUDA kernels (`csrc/`), built with nvcc at first use, each
beside a plain PyTorch version that CPU tensors take.
"""

__version__ = "0.1.0"
