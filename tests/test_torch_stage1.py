"""Stage-1 decode parity of the PyTorch port against the JAX package:
`SimRQGAN2Generator.decode_code` pixels for the same codes and weights, on
the tiny config in f32 (atol 2e-4 / rtol 1e-3)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.checkpoint import export_torch_state_dict  # noqa: E402
from hqtransformer_tpu.config import build_twostage_config  # noqa: E402
from hqtransformer_tpu.models.stage1.generator import \
    build_generator as jax_generator  # noqa: E402

from hqtransformer_tpu_torch.config import \
    build_twostage_config as torch_config  # noqa: E402
from hqtransformer_tpu_torch.convert import (convert_variables,  # noqa: E402
                                             drop_prefixes)
from hqtransformer_tpu_torch.models.stage1.generator import \
    build_generator  # noqa: E402

CFG = 'configs/tiny/stage2-tiny.yaml'
ENCODE_SIDE = ('encoder.', 'quant_conv_b.')


@pytest.fixture(scope='module')
def generators():
    cfg = build_twostage_config(CFG).stage1
    jg = jax_generator(cfg)
    res = cfg.hparams.resolution
    variables = jax.jit(jg.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, res, res, 3), jnp.float32))
    tg = build_generator(torch_config(CFG).stage1)
    tg.load_state_dict(drop_prefixes(convert_variables(variables),
                                     *ENCODE_SIDE), strict=True)
    return cfg, jg, variables, tg


def test_convert_matches_export(generators):
    _, _, variables, _ = generators
    mine = convert_variables(variables)
    ref = export_torch_state_dict(variables)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_code_pixels(generators, seed):
    cfg, jg, variables, tg = generators
    bot = cfg.hparams.attn_resolutions[0]
    rng = np.random.RandomState(seed)
    ct = rng.randint(0, cfg.n_embed, (2, bot // 2, bot // 2)).astype(np.int32)
    cb = rng.randint(0, cfg.n_embed, (2, bot, bot)).astype(np.int32)
    ref = jax.jit(lambda v, a, b: jg.apply(
        v, a, b, method=type(jg).decode_code))(variables, jnp.asarray(ct),
                                              jnp.asarray(cb))
    with torch.no_grad():
        ours = tg.decode_code(torch.from_numpy(ct), torch.from_numpy(cb))
    assert ours.shape == ref.shape == (2, cfg.hparams.resolution,
                                       cfg.hparams.resolution, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-3)
