"""Tensor parallelism of the port's stage 2 (`parallel/tp.py`) against the
JAX package's ('dp', 'tp') mesh and against the port at tp 1, f32 on the
CPU.

- The sharding rule: `shard_dim` equals `mesh.py::_spec_for_path` on every
  stage-2 parameter of the tiny 2-level, 3-level and flat models, through
  the JAX export names (no processes).
- One spawn of four gloo processes, tp 2 x dp 2 (`torch_tp_worker.py`),
  holds the rest, each test reading what the ranks saved (the int8
  serving inputs are written after the spawn, and the ranks wait for
  them):
  - training `tests/test_parallel.py`'s tiny HierarchicalGPT with a clip
    that binds: the loss and the gathered parameters after 2 steps against
    JAX's `make_mesh(dp=2, tp=2)` sharded step, and after 2 and 3 steps
    against the port's tp 1 on the whole batch; one step with `remat` and
    one with soft labels (the tiny two-stage config) against tp 1;
  - one step of the caption-conditioned tiny config against tp 1;
  - the 2-level and 3-level samplers' codes, and those of the
    bidirectional and top2bot depth modes and the flat baselines, against
    tp 1's, bit for bit, for one generator seed; the scorer's logits
    against JAX's;
  - the tp-2 checkpoint of step 2 resumed at tp 1 against the
    uninterrupted tp-1 run;
  - `cli.main_stage2 --tp 2`: 2 steps, then `--resume` to 3, and its
    sampler-ready bundle loading strictly;
  - int8 serving: every sampler's codes with f32 activations and the
    int8 KV cache (scales from tp-1 artifacts) against tp 1's, bit for
    bit; a row-parallel and a vocabulary-sharded bf16 A8W8 product
    against tp 1's, bit for bit; the calibrations at tp 2 against tp 1's;
    the bf16 int8max scorer against JAX's on `make_mesh(dp=2, tp=2)`
    (tp-1 scales, bounds of `test_torch_int8.py::_assert_near_jax`).
Bounds are `tests/test_parallel.py`'s: loss rtol 1e-5, parameters atol
1e-5, rtol 1e-4; logits atol 2e-4. Each test prints what it measured.
Without processes, bad int8 scales under tp raise before any collective.
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa
from hqtransformer_tpu.config import OptConfig as JaxOptConfig  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models import twostage as jax_twostage  # noqa
from hqtransformer_tpu.models.twostage import \
    TwoStageModel as JaxTwoStage  # noqa: E402
from hqtransformer_tpu.parallel.mesh import (_spec_for_path,  # noqa: E402
                                             batch_sharding, make_mesh,
                                             replicated,
                                             stage2_param_sharding)
from hqtransformer_tpu.sampling.engine import \
    make_hierarchical_scorer as jax_scorer  # noqa: E402
from hqtransformer_tpu.train import scheduler as jsched  # noqa: E402
from hqtransformer_tpu.train import stage2 as jtrain  # noqa: E402

from hqtransformer_tpu_torch.checkpoint import restore_checkpoint  # noqa
from hqtransformer_tpu_torch.convert import convert_variables  # noqa: E402
from hqtransformer_tpu_torch.models import twostage  # noqa: E402
from hqtransformer_tpu_torch.parallel.tp import (  # noqa: E402
    check_tp_within_host, order_host_major, shard_dim)
from hqtransformer_tpu_torch.sampling.engine import (  # noqa: E402
    LevelSampling, SamplingParams, make_hierarchical_sampler,
    make_multilevel_sampler)
from hqtransformer_tpu_torch.train import stage2 as ts  # noqa: E402

import test_parallel  # noqa: E402
import torch_tp_worker as worker  # noqa: E402
from test_torch_int8 import _assert_near_jax  # noqa: E402
from test_torch_flat import config as flat_config  # noqa: E402
from test_torch_flat import inputs as flat_inputs  # noqa: E402
from test_torch_multilevel import tiny_config  # noqa: E402
from test_torch_train_cli import _png  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
B = 8
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the sharding rule

def twostage_config(path):
    from hqtransformer_tpu_torch.config import build_twostage_config as b
    return b(path)


MODELS = {
    '2-level': lambda build: build('configs/tiny/stage2-tiny.yaml'),
    '3-level': tiny_config,
    'igpt': lambda build: flat_config(build, 'igpt-class'),
    'transformer1d': lambda build: flat_config(build, 'transformer1d'),
}


def _jax_params(kind):
    """The shapes of the JAX stage-2 model's params of `kind`."""
    cfg = MODELS[kind](build_twostage_config)
    key = jax.random.PRNGKey(0)
    if kind in ('igpt', 'transformer1d'):
        case = 'igpt-class' if kind == 'igpt' else kind
        jm = jax_twostage.build_stage2(cfg)
        return jax.eval_shape(jm.init, key, *map(
            jnp.asarray, flat_inputs(case, 0)))['params']
    return jax.eval_shape(JaxTwoStage(cfg).init_variables,
                          key)['stage2']['params']


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _nest(path, leaf):
    out = leaf
    for k in reversed(path):
        out = {k: out}
    return out


@pytest.mark.parametrize('kind', list(MODELS))
def test_shard_dim_matches_jax_spec_for_every_parameter(kind):
    """For every stage-2 parameter, the torch dim `shard_dim` splits is
    the one JAX's `_spec_for_path` shards, through the export name (flax
    kernels [in, out] are torch weights [out, in]); the names cover the
    port module's parameters exactly."""
    with torch.device('meta'):
        tm = twostage.build_stage2(MODELS[kind](twostage_config))
    ours = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    seen, sharded = set(), 0
    for path, leaf in _paths(_jax_params(kind)):
        (name,) = export_torch_state_dict(
            {'params': _nest(path, np.zeros((1,) * len(leaf.shape)))})
        spec = tuple(_spec_for_path(path, leaf.shape))
        spec = spec + (None,) * (len(leaf.shape) - len(spec))
        want = spec.index('tp') if 'tp' in spec else None
        if want is not None and path[-1] == 'kernel':
            want = len(leaf.shape) - 1 - want       # [in, out] -> [out, in]
        assert name in ours, name
        got = shard_dim(name, ours[name])
        assert got == want, (name, path, spec, got)
        seen.add(name)
        sharded += got is not None
    assert seen == set(ours), sorted(seen ^ set(ours))
    print(f'{kind}: {len(seen)} parameters, {sharded} sharded, every one '
          f'as JAX shards it')


def test_layout_orders_ranks_host_major_and_keeps_tp_within_a_host():
    """`order_host_major` and `check_tp_within_host`, as `mesh.py`'s
    `_order_host_major` and `_check_tp_within_host` order and refuse."""
    hosts = [1, 0, 1, 0]
    order = order_host_major(hosts)
    assert order == [1, 3, 0, 2]
    check_tp_within_host(hosts, order, 2)
    with pytest.raises(ValueError, match='spans hosts'):
        check_tp_within_host(hosts, order, 4)


# -------------------------------------------------------------- one spawn

def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(('127.0.0.1', 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _tree(root):
    """12 train and 4 val PNGs (36x40, two classes)."""
    rng = np.random.RandomState(0)
    for split, n in (('train', 12), ('val', 4)):
        for i in range(n):
            d = root / split / f'class{i % 2}'
            d.mkdir(parents=True, exist_ok=True)
            _png(d / f'{i}.png', rng.randint(0, 256, (36, 40, 3)).astype(
                np.uint8))
    return str(root)


def _images(seed):
    return np.random.RandomState(seed).randn(B, 8, 8, 3).astype(np.float32)


def _jax_train(variables, batches, labels):
    """JAX's sharded step on make_mesh(dp=2, tp=2) (4 of the virtual
    devices): (losses, params after each step)."""
    model = test_parallel.tiny_model()
    opt = jtrain.make_optimizer(JaxOptConfig(**worker.OPT),
                                jsched.build_schedule(1e-3, 2, 10,
                                                      warmup_epoch=1.0))
    step = jax.jit(jtrain.make_train_step(model, test_parallel._FakeStage1(),
                                          opt, weight_bottom=4.0))
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    losses, params = [], []
    with mesh:
        p = jax.device_put(variables['params'], stage2_param_sharding(
            mesh, variables['params']))
        state = jtrain.TrainState(jnp.zeros((), jnp.int32), p, opt.init(p))
        lb = jax.device_put(jnp.asarray(labels), batch_sharding(mesh))
        for images in batches:
            im = jax.device_put(jnp.asarray(images), batch_sharding(mesh))
            state, m = step(state, {}, im, lb)
            losses.append(float(m['loss']))
            params.append(convert_variables(
                {'params': jax.tree.map(np.asarray, state.params)}))
    return losses, params


def _port_tp1(sd, batches, labels):
    """The port at tp 1 on the whole batches: (losses, params after each
    step, the first step's gradient norm, the state after 2 steps)."""
    model = worker.parallel_model()
    model.load_state_dict(sd, strict=True)
    opt = worker.optimizer(model)
    step = ts.make_train_step(model, worker.FakeStage1(), opt,
                              weight_bottom=4.0)
    state = ts.init_train_state(model, opt)
    images0 = torch.from_numpy(batches[0])
    loss, _ = step.loss_fn(images0, labels)
    grads = ts.grads_of(loss, state.params)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    losses, params, tree2 = [], [], None
    for images in batches:
        state, m = step(state, torch.from_numpy(images), labels)
        losses.append(float(m['loss']))
        params.append({k: p.detach().clone() for k, p in
                       state.params.items()})
        if state.step == 2:
            tree2 = copy.deepcopy(ts.train_state_dict(state))
    return losses, params, norm, tree2


def _int8_scorer_inputs(out, score_labels):
    """The tiny two-stage config in bf16: JAX's stage-2 variables (seeded
    init, bf16 serving weights) and the port's weights converted from
    them; the port's tp-1 int8 scales (the KV scales of a bf16 sampling
    run, the activation scales on seeded codes) written to
    `out/scores8.pkl`; the scorer's codes. Returns (JAX's stage 2, its
    variables with the artifact's scales, the port's weights, the codes
    [B, 16] and cells [B, 16, 4])."""
    jm = jax_twostage.TwoStageModel(build_twostage_config(worker.TINY2),
                                    dtype=jnp.bfloat16)
    v2 = jax_twostage.serving_bf16_params({'stage2': jax.jit(
        jm.stage2.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16), jnp.int32),
                        jnp.zeros((1, 64), jnp.int32),
                        jnp.zeros((1,), jnp.int32))})['stage2']
    tm = twostage.TwoStageModel(twostage_config(worker.TINY2),
                                dtype=torch.bfloat16, device='cpu')
    weights = {'stage1': tm.init_weights(0)['stage1'],
               'stage2': twostage.serving_bf16_params(convert_variables(v2))}
    rng = np.random.RandomState(5)
    top = torch.from_numpy(rng.randint(0, 256, (B, 16))).long()
    cells = torch.from_numpy(rng.randint(0, 256, (B, 16, 4))).long()
    labels = torch.from_numpy(np.asarray(score_labels)).long()
    scales = tm.calibrate_kv_scales(
        weights, torch.Generator().manual_seed(2), labels,
        SamplingParams(top_k_top=16, top_k_bot=16, temperature_top=0.95,
                       temperature_bot=0.95))
    raster = twostage.cells_to_raster(cells, 4, 2).reshape(B, -1)
    scales.update(tm.calibrate_stage2_int8(weights, top, raster, labels))
    path = str(out / 'scores8.pkl')
    twostage.save_serving_scales(scales, path)
    variables = jax_twostage.load_serving_scales(
        {'stage1': {}, 'stage2': v2}, path)['stage2']
    return jm.stage2, variables, weights, top, cells


def _jax_scores_sharded(jmodel, variables, labels, top, cells):
    """JAX's scorer on make_mesh(dp=2, tp=2) (4 of the virtual devices),
    params sharded by `stage2_param_sharding`, the scale collections
    replicated, the batch over 'dp': the bf16 logits, then int8max's
    (HQT_INT8_STAGE2 and HQT_INT8_SPATIAL set, the int8 KV cache) as f32
    numpy (top, bottom)."""
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    out = []
    with mesh, pytest.MonkeyPatch.context() as mp:
        v = {k: jax.device_put(t, stage2_param_sharding(mesh, t)
                               if k == 'params' else replicated(mesh))
             for k, t in variables.items()}
        args = [jax.device_put(jnp.asarray(np.asarray(a), jnp.int32),
                               batch_sharding(mesh))
                for a in (labels, top, cells)]
        for int8 in (False, True):
            if int8:
                mp.setenv('HQT_INT8_STAGE2', '1')
                mp.setenv('HQT_INT8_SPATIAL', '1')
            fn = jax_scorer(jmodel, 16, attention='packed',
                            cache_dtype=jnp.int8 if int8 else None)
            out.append([np.asarray(jnp.asarray(x).astype(jnp.float32))
                        for x in fn(v, *args)])
    return out


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Spawn the four ranks; meanwhile compute JAX's and the port's tp-1
    references. Returns a dict of everything the tests compare."""
    out = tmp_path_factory.mktemp('tp')
    jmodel = test_parallel.tiny_model()
    labels = np.arange(B, dtype=np.int32) % 10
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((B, 16), jnp.int32),
                            jnp.zeros((B, 64), jnp.int32),
                            jnp.asarray(labels))
    sd = convert_variables(variables)
    batches = [_images(10 + i) for i in range(3)]
    rng = np.random.RandomState(4)
    score = (np.arange(B) % 10, rng.randint(0, 32, (B, 16)),
             rng.randint(0, 32, (B, 16, 4)))
    torch.save({'parallel_sd': sd,
                'train_images': [torch.from_numpy(x) for x in batches],
                'train_labels': torch.from_numpy(labels).long(),
                'score_labels': torch.from_numpy(score[0]).long(),
                'score_top': torch.from_numpy(score[1]).long(),
                'score_cells': torch.from_numpy(score[2]).long(),
                'tree': _tree(out / 'tree')}, out / 'inputs.pt')
    ports = _free_ports(3)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.getcwd(), HERE, os.environ.get('PYTHONPATH', '')]),
        OMP_NUM_THREADS='1')
    logs = [open(out / f'log{r}.txt', 'w') for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_tp_worker.py'), str(r),
         '4', *map(str, ports), str(out)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(4)]
    try:
        # int8 serving's tp-1 artifacts, which the ranks wait for
        kv = worker.kv_scales_tp1(sd)
        for kind, scales in kv.items():
            twostage.save_serving_scales(scales, str(out / f'kv_{kind}.pkl'))
        jm8, v8, weights8, top8, cells8 = _int8_scorer_inputs(out, score[0])
        torch.save({'bf16_weights': weights8, 'score8_top': top8,
                    'score8_cells': cells8}, out / 'int8_inputs.tmp')
        os.replace(out / 'int8_inputs.tmp', out / worker.INT8_INPUTS)
        ref = {'jax_train': _jax_train(variables, batches[:2], labels),
               'tp1': _port_tp1(sd, batches,
                                torch.from_numpy(labels).long()),
               'variants': worker.variant_codes(None),
               'text': worker.text_step(None),
               'jax_scores': jax_scorer(jmodel, 16, attention='packed')(
                   variables, jnp.asarray(score[0]), jnp.asarray(score[1]),
                   jnp.asarray(score[2])),
               'int8_codes': worker.int8_cache_codes(None, sd, kv),
               'a8w8': worker.a8w8_products(None),
               'calib': worker.calibrations(None),
               'jax_scores8': _jax_scores_sharded(jm8, v8, score[0], top8,
                                                  cells8)}
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    if rcs != [0] * 4:
        tail = open(out / f'log{rcs.index(next(r for r in rcs if r))}.txt'
                    ).read()[-3000:]
        pytest.fail(f'tp ranks exited {rcs}:\n{tail}')
    ranks = [torch.load(out / f'rank{r}.pt', weights_only=False)
             for r in range(4)]
    return dict(ref, ranks=ranks, out=out, sd=sd, labels=labels,
                batches=batches)


def _close_params(got, want, what):
    assert set(got) == set(want)
    err = 0.0
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        np.testing.assert_allclose(g, w, err_msg=f'{what} {k}', **PARAM_TOL)
        err = max(err, float(np.abs(g - w).max()))
    return err


def test_layout_of_the_ranks(run):
    """Ranks 0..3 are (dp, tp) = (0, 0), (0, 1), (1, 0), (1, 1)."""
    assert [r['layout'] for r in run['ranks']] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_tp2_dp2_training_matches_jax_sharded_step(run):
    """tp 2 x dp 2, 2 steps, the clip binding: the loss of each step
    within rtol 1e-5 of JAX's dp=2, tp=2 sharded step, the gathered
    parameters after 2 steps within atol 1e-5, rtol 1e-4 of its."""
    jlosses, jparams = run['jax_train']
    norm = run['tp1'][2]
    assert norm > worker.OPT['grad_clip_norm'], norm
    for r in run['ranks']:
        got = r['train']
        np.testing.assert_allclose(got['losses'][:2], jlosses, rtol=1e-5)
        err = _close_params(got['params2'], jparams[1], 'tp2 vs JAX')
    moved = max(float((jparams[1][k] - run['sd'][k]).abs().max())
                for k in run['sd'])
    print(f'losses {got["losses"][:2]} (JAX {jlosses}); clip 0.05 under a '
          f'gradient norm {norm:.3f}; parameters moved up to {moved:.2e}, '
          f'within {err:.2e} of JAX')


def test_tp2_dp2_training_matches_port_tp1(run):
    """The same run against the port's tp 1 on the whole batches, after 2
    and 3 steps, within the same bounds."""
    losses, params, _, _ = run['tp1']
    got = run['ranks'][0]['train']
    np.testing.assert_allclose(got['losses'], losses, rtol=1e-5)
    e2 = _close_params(got['params2'], params[1], 'step 2')
    e3 = _close_params(got['params3'], params[2], 'step 3')
    print(f'tp2 x dp2 against tp 1: parameters within {e2:.2e} (step 2), '
          f'{e3:.2e} (step 3)')


@pytest.mark.parametrize('mode', ['remat', 'soft'])
def test_remat_and_soft_label_steps_match_tp1(run, mode):
    """One step of the tiny two-stage config at tp 2 x dp 2 with `remat`
    (hard codes) or soft labels (temperature 1) against the port's tp 1
    on the whole batch: the gathered parameters within atol 1e-5, rtol
    1e-4."""
    want = worker.one_step(None, remat=mode == 'remat',
                           soft=1.0 if mode == 'soft' else None)
    err = max(_close_params(r[mode], want, mode) for r in run['ranks'])
    print(f'{mode}: tp2 x dp2 within {err:.2e} of tp 1')


def _stitch(ranks, key):
    """The whole batch's codes from the dp ranks' shards, after checking
    that the tp ranks of each dp group agree."""
    for a, b in ((0, 1), (2, 3)):
        for x, y in zip(ranks[a][key], ranks[b][key]):
            assert torch.equal(x, y)
    return [torch.cat([x, y]) for x, y in zip(ranks[0][key],
                                              ranks[2][key])]


def test_samplers_give_tp1_codes(run):
    """The 2-level `parallel` sampler (top-k 16) and the 3-level sampler
    (top-k 8 a level) at tp 2 x dp 2 give tp 1's codes bit for bit for
    the same generator seed; the tp ranks of a dp group draw the same."""
    model = worker.parallel_model()
    model.load_state_dict(run['sd'])
    labels = torch.arange(B) % 10
    want2 = make_hierarchical_sampler(
        model.eval(), 16, SamplingParams(top_k_top=16, top_k_bot=16))(
        torch.Generator().manual_seed(7), labels)
    tm = twostage.TwoStageModel(worker.level3_config(), device='cpu')
    tm.load_weights(tm.init_weights(1))
    want3 = make_multilevel_sampler(tm.stage2, 16,
                                    (LevelSampling(top_k=8),) * 3)(
        torch.Generator().manual_seed(8), labels)
    for key, want in (('codes2', want2), ('codes3', want3)):
        got = _stitch(run['ranks'], key)
        for g, w in zip(got, want):
            assert torch.equal(g, w), key
    print('2-level and 3-level codes at tp 2 x dp 2 equal tp 1\'s')


@pytest.mark.parametrize('kind', worker.VARIANTS)
def test_other_samplers_give_tp1_codes(run, kind):
    """The bidirectional and top2bot depth modes' samplers and the flat
    baselines' (IGPT, Transformer1d), top-k 16, at tp 2 x dp 2 give tp 1's
    codes bit for bit for the same generator seed; the tp ranks of a dp
    group draw the same."""
    ranks = [{kind: r['variants'][kind]} for r in run['ranks']]
    got = _stitch(ranks, kind)
    want = run['variants'][kind]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), kind
    print(f'{kind}: codes {[tuple(w.shape) for w in want]} at tp 2 x dp 2 '
          f'equal tp 1\'s')


def test_text_conditioned_step_matches_tp1(run):
    """One step of the caption-conditioned tiny config (the
    feature-sharded `tok_emb_txt`, the vocabulary-sharded `head_txt` and
    the text loss) at tp 2 x dp 2 against the port's tp 1 on the whole
    batch: the gathered parameters within atol 1e-5, rtol 1e-4."""
    err = max(_close_params(r['text'], run['text'], 'text')
              for r in run['ranks'])
    print(f'text: tp2 x dp2 within {err:.2e} of tp 1')


def test_scorer_logits_match_jax(run):
    """The scorer's f32 logits at tp 2 x dp 2 (stitched over dp) within
    atol 2e-4 of JAX's."""
    got = _stitch(run['ranks'], 'scores')
    err = 0.0
    for g, w in zip(got, run['jax_scores']):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4)
        err = max(err, float(np.abs(g.numpy() - w).max()))
    print(f'scorer logits within {err:.2e} of JAX')


def test_tp2_checkpoint_resumes_at_tp1(run):
    """The tp-2 checkpoint of step 2 holds whole tensors equal to tp 1's
    state at step 2 (parameters and Adam moments, (b)'s bounds), and
    resumed at tp 1 for step 3 gives the uninterrupted run's
    parameters."""
    tree = restore_checkpoint(str(run['out'] / 'ckpt'), 2)
    _, params, _, tree1 = run['tp1']
    assert tree['step'] == 2
    for part in ('mu', 'nu'):
        _close_params(tree['opt_state'][part], tree1['opt_state'][part],
                      part)
    model = worker.parallel_model()
    model.load_state_dict(run['sd'])
    opt = worker.optimizer(model)
    step = ts.make_train_step(model, worker.FakeStage1(), opt,
                              weight_bottom=4.0)
    state = ts.load_train_state(ts.init_train_state(model, opt), tree)
    assert state.opt_state.count == 2
    state, _ = step(state, torch.from_numpy(run['batches'][2]),
                    torch.from_numpy(run['labels']).long())
    err = _close_params({k: p.detach() for k, p in state.params.items()},
                        params[2], 'resumed')
    print(f'tp-2 checkpoint resumed at tp 1: step 3 within {err:.2e} of '
          f'the uninterrupted run')


def test_cli_tp2_trains_resumes_and_writes_a_strict_bundle(run):
    """`cli.main_stage2 --tp 2` in 4 gloo processes (tp 2 x dp 2): 2
    steps, then `--resume` to 3; its log names the layout and the global
    batch 8 (local 4 x dp 2), the resumed state is at step 3 with finite
    parameters of the full shapes, and its ckpt_full bundle loads
    strictly."""
    cli = run['out'] / 'cli' / 'stage2-tiny'
    logs = sorted(cli.glob('*/train.log'))
    text = ''.join(p.read_text() for p in logs)
    assert 'dp 2 tp 2' in text and 'global batch 8' in text, text
    assert 'resumed from' in text and '@ step 2' in text
    (state,) = list(cli.glob('*/ckpt/3/state.pt'))
    tree = torch.load(state, weights_only=False)
    assert tree['step'] == 3
    tm = twostage.TwoStageModel(twostage_config(worker.TINY2), device='cpu')
    shapes = {k: p.shape for k, p in tm.full_stage2.named_parameters()}
    for k, v in tree['params'].items():
        assert v.shape == shapes[k] and bool(torch.isfinite(v).all()), k
    (bundle,) = list(cli.glob('*/ckpt_full/3.ckpt'))
    weights = tm.load_reference_checkpoint(str(bundle))
    for k, v in tree['params'].items():
        assert torch.equal(weights['stage2'][k], v.float()), k
    print(f'cli: {len(logs)} run(s), step 3 state and a strict bundle')


# ------------------------------------------------------------ int8 serving

@pytest.mark.parametrize('kind', worker.KV_KINDS)
def test_int8_cache_samplers_give_tp1_codes(run, kind):
    """Every sampler with f32 activations and the int8 KV cache at tp 2 x
    dp 2, its whole scales read from the tp-1 artifact and cut to each
    rank's heads, gives tp 1's int8-cache codes bit for bit for the same
    generator seed; the tp ranks of a dp group draw the same."""
    ranks = [{kind: r['int8_codes'][kind]} for r in run['ranks']]
    got = _stitch(ranks, kind)
    want = run['int8_codes'][kind]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w), kind
    print(f'{kind}: int8-cache codes {[tuple(w.shape) for w in want]} at '
          f'tp 2 x dp 2 equal tp 1\'s')


@pytest.mark.parametrize('part', ['row', 'vocab', 'int32'])
def test_a8w8_products_give_tp1_outputs(run, part):
    """A row-parallel bf16 A8W8 `proj` (the rank's input columns, weight
    scales maxed over the group, the int32 partial products summed
    exactly before the dequantization and the bias) and a
    vocabulary-sharded `head_bot` (its logits gathered) give tp 1's
    outputs bit for bit on every rank; the tp group's int32 sum of values
    past f32's mantissa is exact."""
    want = run['a8w8'][part]
    for r in run['ranks']:
        got = r['a8w8'][part]
        assert got.dtype == want.dtype and torch.equal(got, want), part
    print(f'{part}: {tuple(want.shape)} {want.dtype} on every rank equal '
          f'to tp 1\'s')


def _scale_diffs(got, want):
    """(the count of scales, those bit-equal, the largest relative
    difference) of two calibrations, after checking they name the same
    scales of the same shapes."""
    n = same = 0
    worst = 0.0
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for name, w in want[key].items():
            g = got[key][name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            n += w.numel()
            same += int((g == w).sum())
            worst = max(worst, float(((g - w).abs() / w.abs()).max()))
    return n, same, worst


@pytest.mark.parametrize('model', ['2-level', '3-level'])
def test_calibration_at_tp2_gives_tp1_scales(run, model):
    """`calibrate_kv_scales` and `calibrate_stage2_int8` at tp 2 x dp 2
    (f32) return the whole, tp-1-layout scales on every rank, equal to
    tp 1's: bit for bit where tp 2 computes the calibrated activation as
    tp 1 does, and within f32 rounding (rtol 1e-5) where a row-parallel
    sum in another order came before it."""
    want = run['calib'][model]
    first = run['ranks'][0]['calib'][model]
    for r in run['ranks'][1:]:
        assert _scale_diffs(r['calib'][model], first)[2] == 0.0
    n, same, worst = _scale_diffs(first, want)
    assert worst <= 1e-5, worst
    print(f'{model}: {n} scale values at tp 2 x dp 2, {same} bit-equal to '
          f'tp 1\'s, the rest within {worst:.2e} relative')


def test_int8max_scorer_under_tp_matches_jax_sharded(run):
    """The bf16 scorer in int8max at tp 2 x dp 2 (the tp-1 artifact's
    scales, every gemm A8W8, the int8 KV cache) against JAX's scorer on
    make_mesh(dp=2, tp=2) with the same scales, per logits (top, bottom):
    `_assert_near_jax`'s bounds (int8max changes the port's logits by
    0.9x-1.1x as much as JAX's; mean and max |d| at most 3.5x the bf16
    scorer's own port-to-JAX deviation, both sharded; top-1 agreement >=
    90%)."""
    ours8 = _stitch(run['ranks'], 'int8_scores')
    ours16 = _stitch(run['ranks'], 'bf16_scores')
    ref16, ref8 = run['jax_scores8']
    for level, o, r, ob, rb in zip(('top', 'bottom'), ours8, ref8, ours16,
                                   ref16):
        o, ob = o.float().numpy(), ob.float().numpy()
        d, db, gap = np.abs(o - r), np.abs(ob - rb), np.abs(r - rb)
        reading = dict(mean=d.mean() / db.mean(), max=d.max() / db.max(),
                       size=np.abs(o - ob).mean() / gap.mean(),
                       top1=float(np.mean(o.argmax(-1) == r.argmax(-1))))
        print(f'int8max scorer at tp 2 x dp 2 against JAX\'s on the mesh, '
              f'{level}: {reading}')
        _assert_near_jax(reading)


@pytest.mark.parametrize('case', ['indivisible', 'rank_width', 'missing_kv',
                                  'missing_act', 'complete'])
def test_int8_serving_under_tp_is_refused(monkeypatch, case):
    """Under tp 2 (one process, a stand-in tp group), int8 scales that
    cannot serve are refused with ValueError before any collective and
    before any module changes: a KV-cache scale vector that tp does not
    divide, one already cut to a rank's width (scales are whole, in the
    tp-1 layout), a missing K/V scale, a missing activation scale of a
    row-parallel layer. With complete scales the serving call gets as far
    as its first collective (the row-parallel weights' scale max)."""
    from hqtransformer_tpu_torch.ops.int8 import INT8MAX
    from hqtransformer_tpu_torch.parallel.tp import ParallelLayout, TPGroup

    def no_collective(*args, **kwargs):
        raise AssertionError('a collective ran')
    monkeypatch.setattr(torch.distributed, 'all_reduce', no_collective)
    layout = ParallelLayout(tp=2, tp_group=TPGroup(None, 0, 2))
    tm = twostage.TwoStageModel(twostage_config(worker.TINY2),
                                dtype=torch.bfloat16, device='cpu',
                                layout=layout)
    tm.load_weights(tm.init_weights(0))
    full = tm.full_stage2
    kv = {f'blocks.{i}.attn.{c}': torch.full((128,), 0.01)
          for i in range(len(full.blocks)) for c in 'kv'}
    act = {n: torch.tensor(0.01) for n, m in full.named_modules()
           if isinstance(m, twostage.QuantizableLinear)}
    if case == 'indivisible':
        kv['blocks.1.attn.k'] = torch.full((127,), 0.01)
    elif case == 'rank_width':
        kv['blocks.0.attn.v'] = torch.full((64,), 0.01)
    elif case == 'missing_kv':
        del kv['blocks.1.attn.v']
    elif case == 'missing_act':
        del act['depths.1.mlp.2']
    scales = {'stage2/kv_scales': kv, 'stage2/act_scales': act}
    sampler = make_hierarchical_sampler(tm.stage2, 16, SamplingParams(),
                                        int8=INT8MAX, scales=scales)
    want = {'indivisible': 'tp 2 does not divide', 'rank_width':
            'the layer has 128', 'missing_kv': "'blocks.1.attn.v' has none",
            'missing_act': "'depths.1.mlp.2' has none"}
    if case == 'complete':
        with pytest.raises(AssertionError, match='a collective ran'):
            sampler(torch.Generator(), torch.arange(2))
    else:
        with pytest.raises(ValueError, match=want[case]):
            sampler(torch.Generator(), torch.arange(2))
    s2 = tm.stage2
    assert all(b.attn.serving is None for b in (*s2.blocks, *s2.depths))
    assert all(getattr(m, 'q8', None) is None for m in s2.modules())
    print(f'{case}: ' + ('stopped at the first collective' if case ==
                         'complete' else 'refused before any collective') +
          ', no module changed')
