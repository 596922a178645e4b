"""The port's `cli/compute_fid_stats.py` and `cli/eval_hqmodel.py` against
the JAX package's `scripts/compute_fid_stats.py` and `eval_hqmodel.py` on
the CPU, on the files of `test_torch_eval.py` (an ImageFolder tree of 12
PNGs, two sample pickles [4, 3, 32, 32], He-scaled random FID-Inception
weights in the pt_inception layout): the same npz (features within
1e-4), PRDC equal, the pixel-feature FID equal, the `acts.npz` cache
read across packages without a feature computed. (A Frechet distance of
2048 Inception features takes two `sqrtm` calls of 10-20 s on a CPU, so the
Inception FID of the CLIs is held to JAX's in `test_torch_eval.py`'s
rFID only.)
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from hqtransformer_tpu_torch.cli import (compute_fid_stats,  # noqa: E402
                                         eval_hqmodel)

import eval_hqmodel as jax_eval_hqmodel  # noqa: E402

from test_torch_eval import _jax_script, _run, _run_jax  # noqa: E402
from test_torch_eval import _one_thread, files, zero_inits  # noqa: E402,F401


def test_compute_fid_stats_matches_jax(files, capsys,  # noqa: F811
                                       monkeypatch):
    jax_script = _jax_script('scripts/compute_fid_stats.py')
    root = files['root']
    argv = ['-d', 'imagenet', '--data-root', files['data'], '--split', 'val',
            '--batch-size', '5', '--save-acts', '--inception-weights',
            files['inception']]
    _run(compute_fid_stats.main, argv + ['-o', str(root / 'port.npz'),
                                         '--device', 'cpu'], capsys)
    _run_jax(jax_script.main, argv + ['-o', str(root / 'jax.npz')], capsys,
             monkeypatch)
    ours, theirs = np.load(root / 'port.npz'), np.load(root / 'jax.npz')
    assert sorted(ours.files) == sorted(theirs.files) == ['acts', 'mu',
                                                          'sigma']
    assert ours['acts'].shape == (12, 2048)
    for k in ours.files:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, atol=1e-4)
    compute_fid_stats.main(['-d', 'imagenet', '--data-root', files['data'],
                            '-o', str(root / 'pixels.npz'),
                            '--feature-extractor', 'pixels',
                            '--device', 'cpu'])
    assert 'WARNING' not in capsys.readouterr().err
    compute_fid_stats.main(['-d', 'imagenet', '--data-root', files['data'],
                            '-o', str(root / 'random.npz'), '--max-samples',
                            '3', '--device', 'cpu'])
    assert 'no --inception-weights' in capsys.readouterr().err
    assert np.load(root / 'random.npz')['mu'].shape == (2048,)


def test_eval_hqmodel_matches_jax(files, tmp_path, capsys,  # noqa: F811
                                  monkeypatch):
    """PRDC of the Inception features against the tree's, FID of the pixel
    features against the tree's (the Inception FID is a Frechet distance
    of the same cached statistics, held to JAX's in
    `test_torch_inception.py`): the port's numbers equal JAX's; the
    acts.npz cache has JAX's keys and features within 1e-4, is read by
    the other package, and a second call computes no feature."""
    for name, kind in (('port.npz', 'inception'), ('pixels.npz', 'pixels')):
        compute_fid_stats.main([
            '-d', 'imagenet', '--data-root', files['data'], '--save-acts',
            '--inception-weights', files['inception'], '-o',
            str(tmp_path / name), '--feature-extractor', kind, '--device',
            'cpu'])
    ref, pixels = str(tmp_path / 'port.npz'), str(tmp_path / 'pixels.npz')
    ours_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    samples = files['root'] / 'samples'
    for d in (ours_dir, jax_dir):
        d.mkdir()
        for f in os.listdir(samples):
            (d / f).write_bytes((samples / f).read_bytes())
    ours = eval_hqmodel.compute_fid_prdc(str(ours_dir), None, ref,
                                         files['inception'], device='cpu')
    with zero_inits():
        theirs = jax_eval_hqmodel.compute_fid_prdc(str(jax_dir), None, ref,
                                                   files['inception'])
    assert sorted(ours) == sorted(theirs) == ['coverage', 'density',
                                              'precision', 'recall']
    assert ours == theirs
    for k, v in ours.items():
        assert 0 <= v <= (3 if k == 'density' else 1), k
    a, b = np.load(ours_dir / 'acts.npz'), np.load(jax_dir / 'acts.npz')
    assert sorted(a.files) == sorted(b.files) == ['acts', 'mu', 'sigma']
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4)

    def no_features(*args, **kwargs):
        raise AssertionError('the cache was not read')
    monkeypatch.setattr(eval_hqmodel, 'make_extractor', no_features)
    monkeypatch.setattr(jax_eval_hqmodel, 'make_extractor', no_features)
    # each package reads the other's cache
    port_cache = (ours_dir / 'acts.npz').read_bytes()
    (ours_dir / 'acts.npz').write_bytes((jax_dir / 'acts.npz').read_bytes())
    (jax_dir / 'acts.npz').write_bytes(port_cache)
    assert eval_hqmodel.compute_fid_prdc(str(ours_dir), None, ref,
                                         device='cpu') == ours
    assert jax_eval_hqmodel.compute_fid_prdc(str(jax_dir), None, ref) == ours
    monkeypatch.undo()
    out = _run(eval_hqmodel.main, ['-r', str(ours_dir),
                                   '--feature-extractor', 'pixels',
                                   '--ref-stat-path', pixels, '-m', 'fid',
                                   '--device', 'cpu'], capsys)
    fid = eval(out.strip().splitlines()[-1])['fid']
    assert (ours_dir / 'acts_pixels.npz').exists()
    assert (ours_dir / 'fid_prdc.log').exists()
    theirs = jax_eval_hqmodel.compute_fid_prdc(
        str(jax_dir), pixels, feature_extractor='pixels')['fid']
    assert np.isfinite(fid) and abs(fid - round(theirs, 4)) < 1e-9
