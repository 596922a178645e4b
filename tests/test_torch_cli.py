"""The port's command-line entry points on the CPU (`--device cpu`,
`device=cpu`), on tiny configs written to a temporary directory: each runs
end to end from a reference `.ckpt` that the test writes (fp16, the
Lightning layout) and with `--random-init`, and writes the files the JAX
package's script of the same name writes, with the same names, shapes and
dtypes. With top-k 1 every draw is the argmax, so the port's
`sampling_hqmodel` and the JAX script give the same samples from the same
checkpoint: pixels within 1e-4 (f32; the two frameworks' convolutions sum
in another order). `measure_throughput`'s `scales_out` artifact loads in
the JAX package's `load_serving_scales`.
"""

import os
import pickle

import numpy as np
import pytest
import yaml

torch = pytest.importorskip('torch')

import jax  # noqa: E402,F401

from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402

from hqtransformer_tpu_torch.cli import measure_throughput  # noqa: E402
from hqtransformer_tpu_torch.cli import sampling_hqmodel  # noqa: E402
from hqtransformer_tpu_torch.cli import \
    sampling_hqmodel_txt2img as txt2img  # noqa: E402
from hqtransformer_tpu_torch.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu_torch.evaluation import clip_rerank  # noqa: E402
from hqtransformer_tpu_torch.models.twostage import \
    TwoStageModel  # noqa: E402

from test_torch_clip import TINY, stub_state  # noqa: E402
from test_torch_multilevel import _one_thread  # noqa: E402,F401

CFG = 'configs/tiny/stage2-tiny.yaml'
RES = 32


def _write_config(path, text):
    """The tiny config, or with `text` its caption-conditioned cut (an
    8-token caption of the BPE-16k vocabulary)."""
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    if text:
        cfg['dataset']['tokenizer_type'] = 'bpe16k_huggingface'
        s2 = cfg['stage2']
        s2['use_cls_cond'], s2['use_txt_cond'] = False, True
        s2['vocab_size_txt'] = 16384
        s2['hparams']['ctx_len_txt'] = 8
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _write_ckpt(path, config, seed):
    """Seeded random weights of `config` as a reference Lightning .ckpt:
    fp16 tensors under 'stage1.' / 'stage2.' in its 'state_dict'."""
    model = TwoStageModel(build_twostage_config(config), device='cpu')
    sd = {f'{stage}.{k}': t.half()
          for stage, w in model.init_weights(seed).items()
          for k, t in w.items()}
    torch.save({'state_dict': sd, 'epoch': 0}, path)
    return str(path)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    cls_cfg = _write_config(root / 'config.yaml', text=False)
    txt_cfg = _write_config(root / 'txt.yaml', text=True)
    return dict(root=root, cls_cfg=cls_cfg, txt_cfg=txt_cfg,
                cls_ckpt=_write_ckpt(root / 'model.ckpt', cls_cfg, 1),
                txt_ckpt=_write_ckpt(root / 'txt.ckpt', txt_cfg, 2))


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def _sampling_args(out, files, *extra):
    return ['-r', str(out), '--num-classes', '2', '--total-samples', '4',
            '--batch-size', '2', '--top-k', '1', '--dtype', 'float32',
            *extra]


@pytest.mark.parametrize('source', ['ckpt', 'random-init'])
def test_sampling_cli_writes_the_jax_files(files, tmp_path, source):
    """From the checkpoint (its config found beside it, as the JAX script
    finds it) and with --random-init: per class one batch, samples_(c_0)
    .pkl f32 [2, 3, 32, 32] in [0, 1] and targets_(c_0).npz int64 [2]."""
    out = tmp_path / 'out'
    extra = (['-m', files['cls_ckpt']] if source == 'ckpt' else
             ['--random-init', '-c', files['cls_cfg']])
    assert sampling_hqmodel.main(_sampling_args(
        out, files, '--device', 'cpu', '--attention', 'packed',
        '--temperature-decay', '0.9', *extra)) == 0
    assert sorted(os.listdir(out)) == [
        'samples_(1_0).pkl', 'samples_(2_0).pkl', 'targets_(1_0).npz',
        'targets_(2_0).npz']
    for c in (1, 2):
        px = _load(out / f'samples_({c}_0).pkl')
        assert px.dtype == np.float32 and px.shape == (2, 3, RES, RES)
        assert 0 <= px.min() and px.max() <= 1
        t = np.load(out / f'targets_({c}_0).npz')['targets']
        assert t.dtype == np.int64 and list(t) == [c - 1] * 2


def test_sampling_cli_matches_the_jax_cli(files, tmp_path, monkeypatch):
    """Greedy (--top-k 1), f32, from the same .ckpt: the port's pixels
    within 1e-4 of the JAX script's, file for file."""
    import sampling_hqmodel as jax_cli
    ours, theirs = tmp_path / 'port', tmp_path / 'jax'
    args = _sampling_args(ours, files, '-m', files['cls_ckpt'])
    assert sampling_hqmodel.main(args + ['--device', 'cpu']) == 0
    monkeypatch.setattr('sys.argv', ['sampling_hqmodel.py'] +
                        _sampling_args(theirs, files, '-m',
                                       files['cls_ckpt']))
    jax_cli.main()
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in os.listdir(ours):
        if name.endswith('.pkl'):
            a, b = _load(ours / name), _load(theirs / name)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(np.load(ours / name)['targets'],
                                          np.load(theirs / name)['targets'])


@pytest.mark.parametrize('rerank', [0, 3])
def test_txt2img_cli_writes_the_jax_files(files, tmp_path, monkeypatch,
                                          rerank):
    """Two batches of two captions: samples_(b_2).pkl f32 [2, 3, 32, 32]
    and captions_(b_2).txt; with --clip-rerank 3 (the stub's tiny CLIP
    state dict, saved with torch.save) [2, 3, 3, 32, 32], ranked best
    first, and clip_scores_(b_2).npz [2, 3], finite and sorted."""
    captions = tmp_path / 'captions.txt'
    caps = ['a red fox in the snow', 'two boats at dusk', 'Café au lait!',
            'a bowl of ramen', 'left over']
    captions.write_text('\n'.join(caps) + '\n')
    out = tmp_path / 'out'
    args = ['-r', str(out), '-c', files['txt_cfg'], '-m', files['txt_ckpt'],
            '--captions', str(captions), '--batch-size', '2', '--top-k',
            '4', '--device', 'cpu']
    if rerank:
        weights = tmp_path / 'clip.pt'
        torch.save(stub_state(), weights)
        monkeypatch.setattr(txt2img, 'CLIP_CONFIG',
                            clip_rerank.CLIPConfig(**TINY))
        args += ['--clip-rerank', str(rerank), '--clip-weights',
                 str(weights)]
    assert txt2img.main(args) == 0
    want = ['captions_(1_2).txt', 'captions_(2_2).txt', 'samples_(1_2).pkl',
            'samples_(2_2).pkl']
    if rerank:
        want += ['clip_scores_(1_2).npz', 'clip_scores_(2_2).npz']
    assert sorted(os.listdir(out)) == sorted(want)
    for b in (1, 2):
        px = _load(out / f'samples_({b}_2).pkl')
        shape = (2, rerank, 3, RES, RES) if rerank else (2, 3, RES, RES)
        assert px.dtype == np.float32 and px.shape == shape
        assert 0 <= px.min() and px.max() <= 1
        assert (out / f'captions_({b}_2).txt').read_text() == '\n'.join(
            caps[2 * b - 2:2 * b])
        if rerank:
            s = np.load(out / f'clip_scores_({b}_2).npz')['scores']
            assert s.shape == (2, rerank) and np.isfinite(s).all()
            assert (np.diff(s, axis=1) <= 0).all()


def test_measure_throughput_scales_split(files, tmp_path, capsys):
    """int8max: `scales_out=` calibrates, writes the artifact (which the
    JAX package's load_serving_scales reads: KV, stage-2 and decode
    scales) and exits; `scales_in=` reads it and prints each loop's ms a
    sample and the summary line."""
    path = str(tmp_path / 'scales.pkl')
    common = [f'model_path={files["cls_cfg"]}', 'serving=int8max',
              'batch_size=2', 'top_resolution=4', 'device=cpu']
    assert measure_throughput.main(common + [f'scales_out={path}']) == 0
    back = jax_twostage.load_serving_scales({'stage1': {}, 'stage2': {}},
                                            path)
    assert sorted(back['stage2']) == ['act_scales', 'kv_scales']
    assert 'act_scales' in back['stage1']
    capsys.readouterr()
    assert measure_throughput.main(common + [
        f'scales_in={path}', 'samples_per_loop=2', 'n_loop=2']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(' | ar: ' in ln for ln in lines) == 2
    assert sum(' | e2e: ' in ln for ln in lines) == 2
    assert any(ln.startswith('bs2 | ') and 'decode:' in ln for ln in lines)
    with pytest.raises(SystemExit):
        measure_throughput.main(common + ['serving=fp8'])


def test_bf16_cli_weights_sample_as_the_f32_ones(files):
    """In bf16 the CLIs store stage 2's matrices in bf16 once; the layers
    cast f32 matrices to bf16 where they use them, so the greedy samples
    are equal, bit for bit."""
    from types import SimpleNamespace

    from hqtransformer_tpu_torch.cli.common import load_model
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams
    args = SimpleNamespace(dtype='bfloat16', device='cpu',
                           model_path=files['cls_ckpt'], random_init=False,
                           seed=0)
    model, weights = load_model(args, files['cls_cfg'])
    assert all(t.dtype == torch.bfloat16 for t in weights['stage2'].values()
               if t.dim() >= 2)
    f32 = model.load_reference_checkpoint(files['cls_ckpt'])
    sampler = model.make_pixel_sampler(params=SamplingParams(
        top_k_top=1, top_k_bot=1))
    labels = torch.arange(3)
    a = sampler(weights, torch.Generator(), labels)
    b = sampler(f32, torch.Generator(), labels)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
