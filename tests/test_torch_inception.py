"""The port's FID-Inception (`evaluation/inception.py`) and metrics
(`evaluation/fid.py`, `evaluation/prdc.py`) against the JAX package's on
the CPU, on inputs made from numpy seeds:

- features and logits of the same He-scaled random weights (the public
  pt_inception file is not in the repository; flax's default init makes
  the features collapse to a std of ~4e-4) within rtol 1e-4 / atol 1e-4,
  at 256^2 (enlarged to 299, no antialiasing) and 320^2 (shrunk,
  antialiased) inputs, batch 2, with the features' std above 1e-2;
- the weight mapping both ways: `fid_inception_state_from_jax` undoes
  `load_torch_fid_inception`, and a pt_inception-layout file with its
  `AuxLogits.*` entries and BatchNorm counters loads strictly;
- `frechet_distance` within 1e-6 relative, `inception_score` equal,
  PRDC's four metrics equal (distances within 1e-5 relative, and none
  within 1e-5 of the radius it is compared with), `PixelExtractor`
  bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.evaluation import fid as jax_fid  # noqa: E402
from hqtransformer_tpu.evaluation import prdc as jax_prdc  # noqa: E402
from hqtransformer_tpu.evaluation.inception import (  # noqa: E402
    FIDInceptionV3 as JaxInception, load_torch_fid_inception)

from hqtransformer_tpu_torch.convert import \
    fid_inception_state_from_jax  # noqa: E402
from hqtransformer_tpu_torch.evaluation import fid, prdc  # noqa: E402
from hqtransformer_tpu_torch.evaluation.inception import (  # noqa: E402
    FIDInceptionV3, he_scaled_state, load_pt_inception)

from test_torch_eval import _one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_variables(state):
    """JAX's Inception variables holding a port state dict: the template
    from `jax.eval_shape` of `init` (no weights made), every leaf then
    put by the JAX package's own loader."""
    model = JaxInception()
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        return_logits=True))
    return model, load_torch_fid_inception(
        template, {k: v.numpy() for k, v in state.items()})


@pytest.fixture(scope='module')
def nets():
    state = he_scaled_state(0)
    model = FIDInceptionV3().eval()
    load_pt_inception(model, state)
    jax_model, variables = jax_variables(state)
    return state, model, jax_model, variables


@pytest.mark.parametrize('res', [256, 320], ids=['enlarged', 'shrunk'])
def test_features_and_logits_match_jax(nets, res):
    _, model, jax_model, variables = nets
    x = np.random.RandomState(res).rand(2, res, res, 3).astype(np.float32)
    jf, jl = jax.jit(lambda v, x: jax_model.apply(v, x, return_logits=True))(
        variables, x)
    with torch.no_grad():
        f, lg = model(torch.from_numpy(x), return_logits=True)
    assert f.shape == (2, 2048) and lg.shape == (2, 1008)
    assert float(np.std(np.asarray(jf))) > 1e-2
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    # the extractor's default weights are he_scaled_state(0), these ones
    extractor = fid.InceptionExtractor(device='cpu')
    np.testing.assert_array_equal(extractor.features(x), f.numpy())
    np.testing.assert_array_equal(extractor.logits(x), lg.numpy())


def test_weight_mapping_both_ways(nets, tmp_path):
    """`fid_inception_state_from_jax` of JAX's variables gives back the
    state they were loaded from; a pt_inception-layout file (with
    `AuxLogits.*` entries and `num_batches_tracked` counters) loads into
    the extractor strictly, and a missing key raises."""
    state, _, _, variables = nets
    back = fid_inception_state_from_jax(jax.device_get(variables))
    assert back.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    public = dict(state)
    public['AuxLogits.conv0.conv.weight'] = torch.zeros(128, 768, 1, 1)
    public['AuxLogits.fc.weight'] = torch.zeros(1000, 768)
    public['Mixed_5b.branch1x1.bn.num_batches_tracked'] = torch.tensor(0)
    torch.save(public, tmp_path / 'pt_inception.pth')
    extractor = fid.InceptionExtractor(str(tmp_path / 'pt_inception.pth'),
                                       device='cpu')
    loaded = extractor.model.state_dict()
    assert loaded.keys() == state.keys()
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    del public['fc.bias']
    with pytest.raises(RuntimeError, match='fc.bias'):
        load_pt_inception(FIDInceptionV3(), public)


def test_frechet_distance_and_inception_score_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(300, 64)
    b = rng.randn(250, 64) * 1.2 + 0.3
    mu1, s1 = fid.mean_covar_numpy(a)
    mu2, s2 = fid.mean_covar_numpy(b)
    for ours, theirs in zip((mu1, s1), jax_fid.mean_covar_numpy(a)):
        np.testing.assert_array_equal(ours, theirs)
    ours = fid.frechet_distance(mu1, s1, mu2, s2)
    theirs = jax_fid.frechet_distance(mu1, s1, mu2, s2)
    assert ours > 1 and abs(ours - theirs) <= 1e-6 * abs(theirs)
    # a singular product takes the eps path in both
    few = rng.randn(10, 64)
    mu3, s3 = fid.mean_covar_numpy(few)
    assert np.isclose(fid.frechet_distance(mu3, s3, mu2, s2),
                      jax_fid.frechet_distance(mu3, s3, mu2, s2),
                      rtol=1e-6)
    with pytest.raises(ValueError, match='mismatch'):
        fid.frechet_distance(mu1, s1, mu1[:8], s1[:8, :8])
    logits = rng.randn(100, 1008).astype(np.float32) * 3
    assert fid.inception_score(logits) == jax_fid.inception_score(logits)
    assert fid.inception_score(logits, splits=3) == \
        jax_fid.inception_score(logits, splits=3)


def test_prdc_matches_jax():
    rng = np.random.RandomState(1)
    real = rng.randn(200, 16).astype(np.float32)
    fake = (rng.randn(180, 16) * 1.1 + 0.1).astype(np.float32)
    ours = prdc.compute_pairwise_distance(real, fake, row_batch_size=64,
                                          col_batch_size=50, device='cpu')
    theirs = jax_prdc.compute_pairwise_distance(real, fake)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    # no decision hangs on rounding: every distance lies more than 1e-5
    # (relative) from the radius it is compared with
    for radii, d in ((jax_prdc.compute_nearest_neighbour_distances(real, 3),
                      theirs),
                     (jax_prdc.compute_nearest_neighbour_distances(fake, 3),
                      theirs.T)):
        gap = np.abs(d - radii[:, None]) / radii[:, None]
        assert gap.min() > 1e-5
    assert prdc.compute_prdc(real, fake, 3, device='cpu') == \
        jax_prdc.compute_prdc(real, fake, nearest_k=3)


def test_pixel_extractor_matches_jax():
    x = np.random.RandomState(2).rand(5, 37, 29, 3).astype(np.float32)
    for grid in (8, 4, 50):
        np.testing.assert_array_equal(
            fid.PixelExtractor(grid).features(x),
            jax_fid.PixelExtractor(grid).features(x))
    assert isinstance(fid.make_extractor('pixels'), fid.PixelExtractor)
    with pytest.raises(ValueError, match='unknown'):
        fid.make_extractor('vgg', device='cpu')
