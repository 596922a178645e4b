"""CLIP re-ranking and CLIP's tokenizer in the PyTorch port against the JAX
package: `tests/torch_clip_stub.py`'s tiny `TorchCLIP` (the official
`clip` package's architecture and key names; a 64^2 ViT with 16^2
patches, 2 layers a tower) gives one seeded state dict, loaded strictly
into the port's `CLIP` and through JAX's `load_torch_clip`. f32 features
are held at the repo's parity bound, atol 2e-4 / rtol 1e-3, and so are the
scores; the ranking must be equal. The preprocess (bilinear, antialiased
when it shrinks) is held within 1e-5 of JAX's: the two resizers' filter
weights round differently in f32 (measured: under 1e-6). The tokenizer's
ids must equal JAX's `ClipSimpleTokenizer`'s (which needs the `regex`
package; the port does not).
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hqtransformer_tpu.data.tokenizers import \
    create_tokenizer as jax_tokenizer  # noqa: E402
from hqtransformer_tpu.evaluation import \
    clip_rerank as jclip  # noqa: E402

from hqtransformer_tpu_torch.data.tokenizers import (  # noqa: E402
    clip_pre_tokenize, create_tokenizer)
from hqtransformer_tpu_torch.evaluation import clip_rerank  # noqa: E402

from test_torch_multilevel import _no_grad, _one_thread  # noqa: E402,F401
from torch_clip_stub import TorchCLIP  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-3)
TINY = dict(image_resolution=64, vision_width=64, vision_layers=2,
            vision_heads=4, patch_size=16, embed_dim=32, context_length=77,
            text_width=48, text_layers=2, text_heads=4)
CAPTIONS = [
    'A photo of a cat sitting on a red sofa.',
    'Café au lait, crème brûlée & naïve résumé — “quoted” text!',
    '東京の夜景と富士山, 2½ cups of flour; x² + y² = z² (№ 7)',
    "  it's   DON'T stop... <|endoftext|> 'll &amp; &lt;b&gt; ٣٤ Ⅻ 🙂 ",
]


def stub_state(seed=0):
    """A seeded state dict of the stub in the official layout."""
    torch.manual_seed(seed)
    ref = TorchCLIP(embed_dim=32, image_resolution=64, vision_layers=2,
                    vision_width=64, vision_heads=4, vision_patch_size=16,
                    context_length=77, vocab_size=49408,
                    transformer_width=48, transformer_heads=4,
                    transformer_layers=2)
    return ref.state_dict()


@pytest.fixture(scope='module')
def pair():
    """(JAX CLIP, its variables, the port's CLIP) with the stub's
    weights, and the port's and JAX's CLIP tokenizers."""
    sd = stub_state()
    jm = jclip.CLIP(jclip.CLIPConfig(**TINY))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                jnp.zeros((1, 77), jnp.int32))
    v = jclip.load_torch_clip(v, sd)
    with torch.device('meta'):
        tm = clip_rerank.CLIP(clip_rerank.CLIPConfig(**TINY))
    # the three non-tensor entries of an official JIT archive's dict
    sd = {**sd, 'input_resolution': 224, 'context_length': 77,
          'vocab_size': 49408}
    tm.load_state_dict(clip_rerank.official_state(sd), strict=True,
                       assign=True)
    return jm, v, tm.eval()


def _pixels(seed, n=5, res=256):
    return np.random.RandomState(seed).rand(n, res, res, 3).astype(
        np.float32)


def _tokens():
    tok = create_tokenizer('clip')
    return np.array([tok.encode_padded(c, 77) for c in CAPTIONS], np.int32)


def test_official_names_load_strictly():
    """Every parameter of the port's CLIP is a key of the official layout
    and the other way round (ViT-B/32 built on the meta device against the
    stub at ViT-B/32's shapes' names)."""
    with torch.device('meta'):
        tm = clip_rerank.CLIP()
        ref = TorchCLIP(embed_dim=512, image_resolution=224,
                        vision_layers=12, vision_width=768, vision_heads=12,
                        vision_patch_size=32, context_length=77,
                        vocab_size=49408, transformer_width=512,
                        transformer_heads=8, transformer_layers=12)
    ours = {k: tuple(t.shape) for k, t in tm.state_dict().items()}
    theirs = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    assert ours == theirs
    assert 'visual.transformer.resblocks.11.attn.in_proj_weight' in ours


@pytest.mark.parametrize('res', [64, 224])
def test_preprocess_matches_jax(res):
    """256^2 samples resized down (antialiased, as jax.image.resize does)
    and normalized: within 1e-5 of JAX's preprocess."""
    px = _pixels(res)
    ref = jclip.preprocess(px, res)
    ours = clip_rerank.preprocess(torch.from_numpy(px), res)
    assert ours.shape == ref.shape == (5, res, res, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_features_match_jax(pair):
    """encode_image on JAX's preprocessed images and encode_text on the
    CLIP tokenizer's ids: the features of both packages agree."""
    jm, v, tm = pair
    imgs = jclip.preprocess(_pixels(1), 64)
    toks = _tokens()
    ref_i = jm.apply(v, jnp.asarray(imgs), method=jclip.CLIP.encode_image)
    ref_t = jm.apply(v, jnp.asarray(toks), method=jclip.CLIP.encode_text)
    ours_i = tm.encode_image(torch.from_numpy(np.array(imgs)))
    ours_t = tm.encode_text(torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours_i.numpy(), np.asarray(ref_i), **TOL)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), **TOL)


@pytest.mark.parametrize('caption', range(len(CAPTIONS)))
def test_rerank_matches_jax(pair, caption):
    """clip_scores and clip_rerank of 8 candidates against one caption:
    the scores agree and the ranking, best first, is JAX's."""
    jm, v, tm = pair
    px = _pixels(10 + caption, n=8)
    toks = _tokens()[caption:caption + 1]
    order, scores = jclip.clip_rerank(jm, v, px, toks)
    ours_order, ours_scores = clip_rerank.clip_rerank(
        tm, torch.from_numpy(px), torch.from_numpy(toks))
    np.testing.assert_array_equal(ours_order.numpy(), order)
    np.testing.assert_allclose(ours_scores.numpy(), scores, **TOL)
    assert bool((ours_scores[:-1] >= ours_scores[1:]).all())


@pytest.mark.parametrize('caption', range(len(CAPTIONS)))
def test_clip_tokenizer_matches_jax(caption):
    """The ids of JAX's ClipSimpleTokenizer (its `regex`-based split) on
    captions with accented letters, CJK, digits, other numbers (½, ², №,
    Arabic-Indic digits, Roman numerals), punctuation, entities, an emoji
    and a literal <|endoftext|>; padded to 77 with the end token, and
    truncated to 10."""
    ours, ref = create_tokenizer('clip'), jax_tokenizer('clip')
    text = CAPTIONS[caption]
    assert ours.encode(text) == ref.encode(text)
    assert ours.encode_padded(text, 77) == ref.encode_padded(text, 77)
    assert ours.encode_padded(text, 10) == ref.encode_padded(text, 10)
    assert ours.vocab_size == ref.vocab_size == 49408


def test_clip_split_matches_jax_pattern():
    """clip_pre_tokenize against the JAX class's compiled pattern on a
    string with every class boundary: contractions, letters, one number a
    piece, runs of other characters, the literals, whitespace."""
    ref = jax_tokenizer('clip')
    text = "a'sb'tc're'llx'dy'm'''9½ab!?¿«»<|startoftext|>é!<|endoftext|> ok"
    assert clip_pre_tokenize(text) == ref.pat.findall(text)
