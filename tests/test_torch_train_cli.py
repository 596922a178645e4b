"""The port's training entry points on the CPU: `cli.main_stage2` and
`cli.main_stage1` on a PNG tree the test writes (a resumed run, 2 + 2
steps with a mid-epoch skip, bit-equal to 4 uninterrupted ones; the
sampler-ready bundle loading strictly; stage 2 reading a stage-1 run's
checkpoint directory), two gloo processes on half batches equal to one on
the whole batch, `RunLogger`'s config.yaml read back equal, and the
refusal of tensor-parallel sizes that do not divide the world, the heads
or a vocabulary (tensor parallelism itself: `test_torch_tp.py`).

These hold the port to itself (bit for bit) where a JAX run cannot be
reproduced: the JAX scripts train through Orbax and their own key
streams. Each test states its bound and prints what it measured.
"""

import dataclasses
import glob
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from hqtransformer_tpu_torch.checkpoint import restore_checkpoint  # noqa
from hqtransformer_tpu_torch.cli import main_stage1, main_stage2  # noqa
from hqtransformer_tpu_torch.config import (build_stage1_config,  # noqa
                                            build_twostage_config)
from hqtransformer_tpu_torch.data.png import decode_png  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import TwoStageModel  # noqa
from hqtransformer_tpu_torch.utils.logging import RunLogger  # noqa: E402

import torch_ddp_worker  # noqa: E402

STAGE2 = 'configs/tiny/stage2-tiny.yaml'
STAGE1 = 'configs/tiny/stage1-tiny.yaml'
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more, and
    the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path, pixels):
    """Write RGB uint8 pixels [H, W, 3] as a PNG (zlib, filter 0)."""
    import struct
    import zlib

    h, w, _ = pixels.shape
    raw = b''.join(b'\x00' + pixels[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
            '>IIBBBBB', w, h, 8, 2, 0, 0, 0)) + chunk(
            b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """12 train and 4 val PNGs (36x40, two classes) under train/ and val/."""
    root = tmp_path_factory.mktemp('tree')
    rng = np.random.RandomState(0)
    for split, n in (('train', 12), ('val', 4)):
        for i in range(n):
            d = root / split / f'class{i % 2}'
            d.mkdir(parents=True, exist_ok=True)
            pixels = rng.randint(0, 256, (36, 40, 3)).astype(np.uint8)
            _png(d / f'{i}.png', pixels)
            blob = (d / f'{i}.png').read_bytes()
            assert (decode_png(blob).array == pixels).all()
    return str(root)


def _run(main, config, tree, out, *extra):
    rc = main.main(['-c', config, '-r', str(out), '--data-root', tree,
                    '--device', 'cpu', *extra])
    assert rc == 0
    (run,) = glob.glob(os.path.join(str(out), '*', '*'))
    return run


def _equal_trees(a, b, path=''):
    """Whether two checkpoint trees are equal, tensors bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope='module')
def stage1_ckpt(tmp_path_factory):
    """A stage-1 trainer's .ckpt (generator. keys, a discriminator entry)
    of the tiny stage 2's stage 1, seeded random weights."""
    path = tmp_path_factory.mktemp('s1') / 'stage1.ckpt'
    tm = TwoStageModel(build_twostage_config(STAGE2), device='cpu')
    sd = {f'generator.{k}': v for k, v in tm.init_weights(5)['stage1'].items()}
    sd['discriminator.main.0.weight'] = torch.zeros(64, 3, 4, 4)
    torch.save({'state_dict': sd}, path)
    return str(path)


@pytest.mark.parametrize('stage', ['stage2', 'stage1'])
def test_resume_is_bit_equal_to_an_uninterrupted_run(stage, tree, tmp_path,
                                                     stage1_ckpt):
    """2 steps, then --resume to 4 (the epoch is 3 steps at batch 4, or 6
    at stage 1's batch 2 with 2-step accumulation: the resumed run skips
    the 2 batches it consumed) against 4 uninterrupted steps: the saved
    states (step, parameters, optimizer state, EMA buffers, the restart
    generator) are equal bit for bit. Stage 2 also reads a trainer-layout
    stage-1 .ckpt, and its sampler-ready bundle loads strictly."""
    main, config = ((main_stage2, STAGE2) if stage == 'stage2'
                    else (main_stage1, STAGE1))
    extra = ['--stage1-ckpt', stage1_ckpt] if stage == 'stage2' else []
    first = _run(main, config, tree, tmp_path / 'a', '--max-steps', '2',
                 *extra)
    resumed = _run(main, config, tree, tmp_path / 'b', '--max-steps', '4',
                   '--resume', os.path.join(first, 'ckpt'), *extra)
    whole = _run(main, config, tree, tmp_path / 'c', '--max-steps', '4',
                 *extra)
    log = open(os.path.join(resumed, 'train.log')).read()
    assert 'resumed from' in log and 'skipping 2 consumed batches' in log
    a = restore_checkpoint(os.path.join(resumed, 'ckpt'), 4)
    b = restore_checkpoint(os.path.join(whole, 'ckpt'), 4)
    assert a['step'] == 4
    _equal_trees(a, b)
    before = restore_checkpoint(os.path.join(first, 'ckpt'), 2)
    key = 'params' if stage == 'stage2' else 'gen_params'
    assert any(not torch.equal(before[key][k], a[key][k])
               for k in a[key])
    print(f'{stage}: 2 + 2 steps equal 4 bit for bit '
          f'({len(a[key])} parameter tensors)')
    if stage == 'stage2':
        (bundle,) = glob.glob(os.path.join(whole, 'ckpt_full', '*.ckpt'))
        assert os.path.basename(bundle) == '4.ckpt'
        tm = TwoStageModel(build_twostage_config(
            os.path.join(whole, 'config.yaml')), device='cpu')
        weights = tm.load_reference_checkpoint(bundle)
        for k, v in a['params'].items():
            assert torch.equal(weights['stage2'][k], v)
        s1 = torch.load(stage1_ckpt)['state_dict']
        for k, v in weights['stage1'].items():
            assert torch.equal(v, s1[f'generator.{k}'])
    else:
        assert 'valid/rec_loss' in log
        rc = main_stage1.main(['-c', config, '-r', str(tmp_path / 'e'),
                               '--data-root', tree, '--device', 'cpu',
                               '--eval', '--resume',
                               os.path.join(whole, 'ckpt')])
        assert rc == 0


def test_stage2_reads_a_stage1_training_directory(tree, tmp_path):
    """cli.main_stage1 trains the tiny stage 2's stage 1 for 1 step;
    cli.main_stage2 --stage1-ckpt <its ckpt dir> then holds exactly its
    generator parameters and EMA buffers (as the bundle shows)."""
    s1 = build_stage1_config(STAGE1)
    s1.stage1 = build_twostage_config(STAGE2).stage1
    s1.stage1.hparams_disc = build_stage1_config(STAGE1).stage1.hparams_disc
    yaml_path = tmp_path / 'stage1.yaml'
    RunLogger(str(tmp_path / 'cfg'), s1).close()
    os.replace(tmp_path / 'cfg' / 'config.yaml', yaml_path)
    run1 = _run(main_stage1, str(yaml_path), tree, tmp_path / 's1',
                '--max-steps', '1')
    run2 = _run(main_stage2, STAGE2, tree, tmp_path / 's2', '--max-steps',
                '1', '--stage1-ckpt', os.path.join(run1, 'ckpt'))
    trained = restore_checkpoint(os.path.join(run1, 'ckpt'), 1)
    (bundle,) = glob.glob(os.path.join(run2, 'ckpt_full', '*.ckpt'))
    sd = torch.load(bundle)['state_dict']
    held = {**trained['gen_params'], **trained['ema']}
    assert set(held) == {k[len('stage1.'):] for k in sd
                         if k.startswith('stage1.')}
    for k, v in held.items():
        assert torch.equal(sd[f'stage1.{k}'], v)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.mark.parametrize('kind', ['stage2', 'stage1'])
def test_two_gloo_processes_equal_one_on_the_whole_batch(kind, tmp_path):
    """2 steps in two gloo processes, each on half of every batch of 4
    (gradients averaged, EMA statistics summed, d_weight's gradients
    averaged), against one process on the whole batches, rank 0's state:
    the parameters' median difference under 1e-7 and 99% of them within
    1e-5 (the same sums in another order; Adam makes the rounding of a
    gradient that is zero but for rounding a whole +-lr update, see
    test_torch_train_stage1.py); the EMA counts within 1e-6, the codebooks
    and sums rtol 1e-2, atol 1e-3."""
    port = _free_port()
    out = str(tmp_path / 'rank0.pt')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.getcwd(), HERE, os.environ.get('PYTHONPATH', '')]),
        OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, os.path.join(
        HERE, 'torch_ddp_worker.py'), kind, str(r), '2', str(port), out],
        env=env) for r in range(2)]
    try:
        assert [p.wait(timeout=240) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    single = str(tmp_path / 'single.pt')
    torch_ddp_worker.train(kind, 0, 1, single)
    a, b = torch.load(out), torch.load(single)
    assert set(a) == set(b)
    ema = ('embedding', 'cluster_size', 'embedding_avg')
    diffs = []
    for k in a:
        if k.rsplit('.', 1)[-1] in ema:
            tol = dict(rtol=0, atol=1e-6) if k.endswith('cluster_size') \
                else dict(rtol=1e-2, atol=1e-3)
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       err_msg=k, **tol)
        elif a[k].is_floating_point():
            diffs.append((a[k] - b[k]).abs().reshape(-1).numpy())
    diffs = np.concatenate(diffs)
    median, p99 = np.quantile(diffs, 0.5), np.quantile(diffs, 0.99)
    print(f'{kind}: 2 processes on half batches against one on the whole '
          f'batch: parameters differ by median {median:.2e}, 99% within '
          f'{p99:.2e}, at most {diffs.max():.2e}')
    assert median < 1e-7 and p99 <= 1e-5
    if kind == 'stage1':
        assert any(k.endswith('cluster_size') and float(a[k].sum()) > 0
                   for k in a)


@pytest.mark.parametrize('path', [
    STAGE2, STAGE1, 'configs/imagenet/stage2/hqtransformer-l12-top8x8.yaml',
    'configs/imagenet/stage1/hqvae-pixelshuffle-top8x8.yaml',
    'configs/cc15m/stage2/hqtransformer-l12-cc15m.yaml'])
def test_run_logger_config_reads_back_equal(path, tmp_path):
    stage1 = 'stage1/' in path or path == STAGE1
    build = build_stage1_config if stage1 else build_twostage_config
    cfg = build(path)
    logger = RunLogger(str(tmp_path), cfg)
    logger.line('hello')
    logger.close()
    again = build(str(tmp_path / 'config.yaml'))
    assert again == cfg
    assert dataclasses.asdict(again) == dataclasses.asdict(cfg)
    assert 'hello' in open(tmp_path / 'train.log').read()


def test_tensor_parallel_sizes_are_refused(tree, tmp_path):
    """--tp that does not divide the world (one process without
    --multihost), the 4 heads (3) or the vocabulary (255, at tp 2) raises
    ValueError naming the size, before any run directory is made."""
    args = ['-c', STAGE2, '-r', str(tmp_path / 'runs'), '--data-root', tree,
            '--device', 'cpu']
    with pytest.raises(ValueError, match='world of 1 process'):
        main_stage2.main(args + ['--tp', '2'])
    with pytest.raises(ValueError, match='4 heads'):
        main_stage2.main(args + ['--tp', '3'])
    text = open(STAGE2).read().replace('vocab_size_img: 256',
                                       'vocab_size_img: 255')
    odd = tmp_path / 'odd-vocab.yaml'
    odd.write_text(text)
    with pytest.raises(ValueError, match='vocabulary 255'):
        main_stage2.main(['-c', str(odd)] + args[2:] + ['--tp', '2'])
    assert not (tmp_path / 'runs').exists()
