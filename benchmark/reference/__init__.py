"""The benchmark's plain reference of HQ-Transformer: plain PyTorch in
float32, written from the model's description and the reference key
layout of its state dicts. It imports nothing of the program under test
and takes only the weights, labels, images and codes that the benchmark
makes or judges.

- `stage2`: the 2-level (`hq-transformer/parallel`) and 3-level
  (`multilevel-hq`, `parallel-add`) teacher-forced forwards, with class
  conditioning and the `transformer1` cell embedding.
- `stage1`: the 2-level HQ-VAE (`simrqgan2`) and the 3-level one
  (`hqvae`) with the pixel-shuffle resampler: encoder, nearest-code
  search, decoder.
- `train`: the stage-2 loss, its gradients and one AdamW update.
- `lowp`: the rounding of matrix-product operands that turns the
  reference into the lower-precision control (float8 e4m3).
"""
