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
  (`measure_throughput.py`);
- `python -m hqtransformer_tpu_torch.cli.eval_stage1`: stage-1
  reconstruction MSE, per-level code usage and rFID over an ImageFolder
  validation split (`eval_stage1.py`);
- `python -m hqtransformer_tpu_torch.cli.eval_hqmodel`: FID and PRDC of
  the sampling CLIs' pickles, features cached in `acts.npz`
  (`eval_hqmodel.py`);
- `python -m hqtransformer_tpu_torch.cli.compute_fid_stats`: reference
  statistics (and features) of a dataset folder
  (`scripts/compute_fid_stats.py`);
- `python -m hqtransformer_tpu_torch.cli.main_stage2` and
  `cli.main_stage1`: stage-2 and stage-1 training with `--resume`,
  data-parallel under torchrun (`main_stage2.py`, `main_stage1.py`).

They take the JAX scripts' arguments and read and write their files, so
either package's evaluation reads the other's results. Real FID needs the
public FID-Inception weights `pt_inception-2015-12-05` (`--inception-
weights`), which are not in the repository. Differences: they run on
the card unless asked for the CPU (`--device cpu`, `device=cpu`), with no
quiet fall back; the random numbers are a `torch.Generator` seeded by the
seed argument, so the draws are not JAX's; models load from the
reference's PyTorch checkpoints, not from Orbax directories, and the
trainers write training checkpoints of the port's own (`checkpoint.py`).
"""
