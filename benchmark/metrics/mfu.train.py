"""The whole step's share of the card's bf16 peak: the training FLOPs of
an image (3 x the reference's teacher-forced stage-2 forward plus the
frozen stage-1 encoder's forward, counted on shapes) times the images of
the traced run's unprofiled window steps, over their host-clock time and
over 989 TFLOP/s."""

from pathlib import Path

from hqbench.manifest import load_module

read = load_module(Path(__file__).with_name('mfu.sample.py'),
                   'hqbench_metric_mfu_sample').read
