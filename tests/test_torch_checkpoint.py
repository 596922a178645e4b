"""Loading the reference's PyTorch checkpoints in the port against the JAX
package: a Lightning `.ckpt` that the test writes from JAX's
`export_torch_state_dict` of random variables of the tiny two-stage model
(every 'stage1.' and 'stage2.' key of the reference's layout), wrapped in
'state_dict' beside pickled hyper-parameters or bare, in fp16 (as released
checkpoints ship) and f32, with a BatchNorm `num_batches_tracked` counter
that neither package holds. The port's `load_reference_checkpoint` must
give, tensor for tensor, `convert_variables` of what JAX's
`load_reference_checkpoint` reads from the same file (equal: both widen
the same fp16 values to f32), and refuse a key or shape that does not
match, as JAX's strict conversion does.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

from hqtransformer_tpu.checkpoint import \
    export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa: E402

from hqtransformer_tpu_torch.checkpoint import (  # noqa: E402
    load_torch_checkpoint, split_reference_state)
from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.sampling.engine import \
    SamplingParams  # noqa: E402

from test_torch_int8 import _jax_variables  # noqa: E402
from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401

CFG = 'configs/tiny/stage2-tiny.yaml'
COUNTER = 'stage1.encoder.down.0.block.0.norm1.num_batches_tracked'


@pytest.fixture(scope='module')
def jax_model():
    jm = jax_twostage.TwoStageModel(build_twostage_config(CFG))
    return jm, _jax_variables(jm, jax.random.PRNGKey(5))


def _reference_state(variables, dtype):
    """The reference's Lightning state dict of `variables`: JAX's export
    under the stage prefixes, in `dtype`, with a BatchNorm counter."""
    sd = {f'{stage}.{k}': torch.from_numpy(np.array(v)).to(dtype)
          for stage in ('stage1', 'stage2')
          for k, v in export_torch_state_dict(variables[stage]).items()}
    sd[COUNTER] = torch.tensor(7)
    return sd


def _write(path, sd, wrapped):
    torch.save({'state_dict': sd, 'epoch': 3,
                'hyper_parameters': {'config': {'lr': 1e-4}}}
               if wrapped else sd, path)
    return str(path)


@pytest.mark.parametrize('dtype', ['float16', 'float32'])
@pytest.mark.parametrize('wrapped', [True, False])
def test_checkpoint_loads_as_jax_reads_it(jax_model, tmp_path, dtype,
                                          wrapped):
    """The port's weights of the file equal convert_variables of JAX's, key
    for key and bit for bit; they load strictly and sample."""
    jm, variables = jax_model
    path = _write(tmp_path / 'model.ckpt',
                  _reference_state(variables, getattr(torch, dtype)),
                  wrapped)
    ref = jm.load_reference_checkpoint(path, variables)
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    ours = tm.load_reference_checkpoint(path)
    assert sorted(ours) == ['stage1', 'stage2']
    for stage in ours:
        want = convert_variables(ref[stage])
        assert sorted(ours[stage]) == sorted(want), stage
        for k, t in want.items():
            assert ours[stage][k].dtype == torch.float32, k
            assert torch.equal(ours[stage][k], t), k
    codes = tm.make_pixel_sampler(params=SamplingParams(
        top_k_top=1, top_k_bot=1))(ours, torch.Generator(), torch.arange(2))
    assert codes[0].shape == (2, 32, 32, 3)


def test_state_dict_given_directly_and_split(jax_model):
    """A state dict in memory loads as its file does; the split keeps each
    stage's keys without their prefix and drops the counters and the keys
    of neither stage (a trainer's discriminator, say)."""
    _, variables = jax_model
    sd = _reference_state(variables, torch.float16)
    sd['discriminator.main.0.weight'] = torch.zeros(3)
    split = split_reference_state(sd)
    assert sorted(split) == ['stage1', 'stage2']
    assert not any('num_batches_tracked' in k for k in split['stage1'])
    assert len(split['stage1']) + len(split['stage2']) == len(sd) - 2
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    del sd['discriminator.main.0.weight']
    ours = tm.load_reference_checkpoint(sd)
    for stage, state in split.items():
        for k, t in state.items():
            assert torch.equal(ours[stage][k], t.float())


@pytest.mark.parametrize('fault', ['unexpected', 'missing', 'shape'])
def test_key_mismatch_raises(jax_model, tmp_path, fault):
    """A key the modules lack, a key they need and a tensor of another
    shape each raise a KeyError naming the key, as JAX's strict
    conversion raises for the first two."""
    _, variables = jax_model
    sd = _reference_state(variables, torch.float16)
    key = 'stage2.head_bot.weight'
    if fault == 'unexpected':
        sd['stage2.head_extra.weight'] = torch.zeros(4, 4)
        key = 'stage2.head_extra.weight'
    elif fault == 'missing':
        del sd[key]
    else:
        sd[key] = sd[key][:-1]
    path = _write(tmp_path / 'bad.ckpt', sd, True)
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    with pytest.raises(KeyError, match=key.replace('.', r'\.')):
        tm.load_reference_checkpoint(path)


def test_loader_reads_files_and_refuses_other_paths(tmp_path):
    """load_torch_checkpoint widens fp16 and bf16 to f32 and leaves other
    dtypes; a path that is no reference checkpoint (an Orbax directory)
    is refused with a ValueError that names the formats read."""
    sd = {'stage1.a': torch.ones(2, dtype=torch.float16),
          'stage1.b': torch.ones(2, dtype=torch.bfloat16),
          'stage1.n': torch.tensor(3)}
    path = _write(tmp_path / 'x.pt', sd, False)
    got = load_torch_checkpoint(path)
    assert [got[k].dtype for k in ('stage1.a', 'stage1.b', 'stage1.n')] == \
        [torch.float32, torch.float32, torch.int64]
    tm = twostage.TwoStageModel(torch_config(CFG), device='cpu')
    with pytest.raises(ValueError, match=r'\.ckpt'):
        tm.load_reference_checkpoint(str(tmp_path / 'ckpt'))
