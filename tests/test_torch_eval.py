"""The port's evaluation CLIs (`cli/eval_stage1.py`, `cli/eval_hqmodel.py`,
`cli/compute_fid_stats.py`) against the JAX package's root scripts on the
CPU: the tiny stage-1 config with seeded random weights read from one
`generator.`-prefixed `.ckpt`, an ImageFolder tree of 12 PNGs and sample
pickles written to a temporary directory, and He-scaled random
FID-Inception weights in the pt_inception layout read by both.

- `eval_stage1`: MSE and top-only MSE within 1e-5, code usage equal,
  rFID within 1e-3 relative (both take sqrtm's singular path: 10 images
  of 2048 features); every checkpoint layout; VQGAN's one level, where
  the JAX script counts a "level" an image;
- without a card and without `--device cpu`, every entry point raises.

`compute_fid_stats` and `eval_hqmodel` are in
`test_torch_eval_hqmodel.py`, on these files. The JAX scripts run flax's
plain `init` (20-30 s on a CPU for the generator and for the
Inception) and then load their files over every leaf; `zero_inits` gives them
`jax.eval_shape`'s template filled with zeros instead.
"""

import contextlib
import functools
import importlib.util
import pickle
import re
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip('torch')

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import \
    build_stage1_config as jax_stage1_config  # noqa: E402
from hqtransformer_tpu.evaluation import fid as jax_fid  # noqa: E402
from hqtransformer_tpu.models.stage1.generator import \
    build_generator as jax_generator  # noqa: E402

from hqtransformer_tpu_torch.cli import (compute_fid_stats,  # noqa: E402
                                         eval_hqmodel, eval_stage1)
from hqtransformer_tpu_torch.config import build_stage1_config  # noqa: E402
from hqtransformer_tpu_torch.evaluation.inception import \
    he_scaled_state  # noqa: E402
from hqtransformer_tpu_torch.evaluation.stage1 import \
    make_reconstructor  # noqa: E402

import eval_hqmodel as jax_eval_hqmodel  # noqa: E402
import eval_stage1 as jax_eval_stage1  # noqa: E402

from test_torch_data import pil_image  # noqa: E402

CFG = 'configs/tiny/stage1-tiny.yaml'


def _jax_script(path):
    spec = importlib.util.spec_from_file_location('jax_script', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread for torch and for the BLAS under numpy and
    scipy (`sqrtm` of 2048-d products): the suite's parallel workers
    would oversubscribe the cores."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = contextlib.nullcontext
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def zero_inits():
    """flax's `Module.init` as its shapes in zeros while a JAX script runs:
    the scripts overwrite every leaf from the files they load, and a plain
    `init` takes 20-30 s on a CPU (the generator's, the Inception's)."""
    original = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(original, self, **kwargs),
                                rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, 'init', init)
        # the JAX extractor pads every chunk to its batch size
        mp.setattr(jax_eval_hqmodel, 'make_extractor', functools.partial(
            jax_fid.make_extractor, batch_size=4))
        yield


def _write_ckpt(path, variables, prefix, extra=None):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_torch_state_dict(variables, prefix=prefix).items()}
    sd.update(extra or {})
    torch.save({'state_dict': sd, 'epoch': 0}, path)
    return str(path)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('eval')
    modes = ('RGB', 'L', 'RGBA', 'P', 'LA', 'RGB')
    sizes = ((40, 32), (32, 48), (50, 50), (33, 35))
    for k in range(12):
        d = root / 'data' / 'val' / f'class{k % 2}'
        d.mkdir(parents=True, exist_ok=True)
        pil_image(modes[k % 6], sizes[k % 4], seed=k).save(d / f'{k}.png')
    cfg = jax_stage1_config(CFG)
    gen = jax_generator(cfg.stage1)
    variables = jax.jit(gen.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 32, 32, 3), jnp.float32))
    out = {'root': root, 'data': str(root / 'data')}
    out['gen_ckpt'] = _write_ckpt(
        root / 'stage1.ckpt', variables, 'generator.',
        {'discriminator.main.0.weight': torch.zeros(4, 3, 4, 4),
         'generator.encoder.norm_out.num_batches_tracked': torch.tensor(7)})
    out['twostage_ckpt'] = _write_ckpt(root / 'twostage.ckpt', variables,
                                       'stage1.')
    out['bare_ckpt'] = _write_ckpt(root / 'bare.pth', variables, '')
    torch.save(he_scaled_state(1), root / 'inception.pth')
    out['inception'] = str(root / 'inception.pth')
    rng = np.random.RandomState(0)
    (root / 'samples').mkdir()
    for c in (1, 2):
        with open(root / 'samples' / f'samples_({c}_0).pkl', 'wb') as f:
            pickle.dump(rng.rand(4, 3, 32, 32).astype(np.float32), f)
    return out


def _run(main, argv, capsys):
    assert main(argv) in (None, 0)
    return capsys.readouterr().out


def _run_jax(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['script'] + argv)
    with zero_inits():
        main()
    return capsys.readouterr().out


def _numbers(out):
    """{line label: float} of eval_stage1's result lines."""
    found = {}
    for ln in out.splitlines():
        m = re.match(r'(MSE|MSE \(top-only recon\)|rFID): ([-\d.e+]+)', ln)
        if m:
            found[m.group(1)] = float(m.group(2))
        m = re.match(r'(level \d+): ([\d.]+)% of', ln)
        if m:
            found[m.group(1)] = float(m.group(2))
        m = re.match(r'MSE: .* over (\d+) images', ln)
        if m:
            found['images'] = int(m.group(1))
    return found


def test_eval_stage1_matches_jax(files, capsys, monkeypatch):
    """Batch 5 over 12 images: 10 evaluated (the last partial batch is
    dropped), MSE and top-only MSE within 1e-5, code usage equal, rFID
    within 1e-3 relative."""
    argv = ['-c', CFG, '-m', files['gen_ckpt'], '--data-root',
            files['data'], '--batch-size', '5', '--fid', '--code-usage',
            '--top-only', '--inception-weights', files['inception']]
    ours = _numbers(_run(eval_stage1.main, argv + ['--device', 'cpu'],
                         capsys))
    theirs = _numbers(_run_jax(jax_eval_stage1.main, argv, capsys,
                               monkeypatch))
    assert ours.keys() == theirs.keys() == {
        'MSE', 'MSE (top-only recon)', 'level 0', 'level 1', 'rFID',
        'images'}
    assert ours['images'] == theirs['images'] == 10
    for key in ('MSE', 'MSE (top-only recon)'):
        assert abs(ours[key] - theirs[key]) <= 1e-5, key
    assert ours['level 0'] == theirs['level 0']
    assert ours['level 1'] == theirs['level 1']
    assert np.isfinite(ours['rFID']) and ours['rFID'] >= 0
    assert abs(ours['rFID'] - theirs['rFID']) <= 1e-3 * theirs['rFID']


def test_eval_stage1_reads_every_checkpoint_layout(files, capsys):
    """`stage1.`-prefixed, `generator.`-prefixed (discriminator and
    BatchNorm counters left out) and bare keys give the same numbers; an
    Orbax directory is refused; without -m the weights are random."""
    base = ['-c', CFG, '--data-root', files['data'], '--batch-size', '4',
            '--code-usage', '--device', 'cpu']
    outs = [_numbers(_run(eval_stage1.main, base + ['-m', files[k]],
                          capsys))
            for k in ('gen_ckpt', 'twostage_ckpt', 'bare_ckpt')]
    assert outs[0] == outs[1] == outs[2] and outs[0]['images'] == 12
    with pytest.raises(ValueError, match='Orbax'):
        eval_stage1.main(base + ['-m', str(files['root'])])
    assert 'MSE' in _numbers(_run(eval_stage1.main, base, capsys))


def test_vqgan_code_usage_reading(files, tmp_path, capsys, monkeypatch):
    """A deliberate difference: on a VQGAN the JAX script's `codes[:-1]`
    slices the one code map by image, so it prints a "level" for each
    image of a batch but the last; the port prints one level, the usage
    over every image's codes."""
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    cfg['stage1']['type'] = 'vqgan'
    cfg['stage1'].pop('hparams_aux')
    path = str(tmp_path / 'vqgan.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    gen = jax_generator(jax_stage1_config(path).stage1)
    variables = jax.jit(gen.init)(jax.random.PRNGKey(5),
                                  jnp.zeros((1, 32, 32, 3), jnp.float32))
    ckpt = _write_ckpt(tmp_path / 'vqgan.ckpt', variables, 'generator.')
    argv = ['-c', path, '-m', ckpt, '--data-root', files['data'],
            '--batch-size', '4', '--code-usage']
    ours = _numbers(_run(eval_stage1.main, argv + ['--device', 'cpu'],
                         capsys))
    theirs = _numbers(_run_jax(jax_eval_stage1.main, argv, capsys,
                               monkeypatch))
    assert [k for k in theirs if k.startswith('level')] == \
        ['level 0', 'level 1', 'level 2']
    assert [k for k in ours if k.startswith('level')] == ['level 0']
    assert abs(ours['MSE'] - theirs['MSE']) <= 1e-5
    # the port's level 0: the share of codes any of the 12 images used
    from hqtransformer_tpu_torch.data.datasets import (DataLoader,
                                                       LoaderConfig,
                                                       build_dataset)
    stage1 = build_stage1_config(path).stage1
    weights = eval_stage1.stage1_state(ckpt)
    recon = make_reconstructor(stage1, torch.float32, 'cpu')
    used = set()
    for x, _ in DataLoader(build_dataset('imagenet', files['data'], 'val'),
                           LoaderConfig(4, 32, train=False)):
        used |= set(recon(weights, torch.from_numpy(x))[1][0]
                    .reshape(-1).tolist())
    assert ours['level 0'] == round(100 * len(used) / stage1.n_embed, 2)


def test_entry_points_raise_without_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main, argv in (
            (eval_stage1.main, ['-c', CFG, '--data-root', files['data']]),
            (eval_hqmodel.main, ['-r', str(files['root'] / 'samples')]),
            (compute_fid_stats.main, ['--data-root', files['data'], '-o',
                                      str(files['root'] / 'x.npz'),
                                      '--feature-extractor', 'pixels'])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main(argv)
