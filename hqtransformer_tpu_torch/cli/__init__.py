"""Command-line entry points of the port, the counterparts of the JAX
package's root scripts:

- `python -m hqtransformer_tpu_torch.cli.sampling_hqmodel`: class-
  conditional (or unconditional) sampling to pickled pixel batches
  (`sampling_hqmodel.py`);
- `python -m hqtransformer_tpu_torch.cli.sampling_hqmodel_txt2img`:
  text-to-image sampling over captions, with CLIP re-ranking
  (`sampling_hqmodel_txt2img.py`);
- `python -m hqtransformer_tpu_torch.cli.measure_throughput`: sampling
  throughput, bf16 and int8 serving, with the calibration artifact split
  (`measure_throughput.py`).

They take the JAX scripts' arguments and write their files, so the
repo's `eval_hqmodel.py` reads either's results. Differences: they run on
the card unless asked for the CPU (`--device cpu`, `device=cpu`), with no
quiet fall back; the random numbers are a `torch.Generator` seeded by the
seed argument, so the draws are not JAX's; models load from the
reference's PyTorch checkpoints, not from Orbax directories.
"""
