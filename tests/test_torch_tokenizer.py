"""The port's caption tokenizer (`hqtransformer_tpu_torch/data/
tokenizers.py`, plain Python) against the `tokenizers` package's
CharBPETokenizer, which the JAX package's `create_tokenizer` builds, for
'bpe16k_huggingface' and 'bpe30k_huggingface' on the vocabulary files in
`hqtransformer_tpu/assets/tokenizers/`: `encode` ids and
`encode_padded(., 64)` equal on fixed captions and on random text."""

import pytest

pytest.importorskip('tokenizers')

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from hqtransformer_tpu.data.tokenizers import \
    create_tokenizer as jax_tokenizer  # noqa: E402

from hqtransformer_tpu_torch.data import tokenizers  # noqa: E402

NAMES = ('bpe16k_huggingface', 'bpe30k_huggingface')
CONTEXT = 64
CAPTIONS = [
    'A photo of a cat sitting on a red mat.',
    'Two dogs playing in the snow, one of them brown!!!',
    'what?!... (really) -- yes; "quoted" [brackets] {braces} <tags> #1 @home',
    '$100 + 20% = ~120^2 | a_b `code` \\ back/slash',
    'café crème brûlée naïve Ångström façade Øresund',
    'ΣΊΣΥΦΟΣ Straße İstanbul ǅemal',
    '日本の風景 中文字幕 한국어 文字',
    'tab\there\nnewline\r\nreturn\x0bvertical\x0cform\x00nul\x7fdel',
    'zero​width‍joiner﻿bom­soft�repl',
    'emoji 😀🚀 and symbols ☃ ♥ ∑ ≠ ∞ ™ © ®',
    'Ünïcödé mixed with [UNK] and [unk] and [PAD] tokens',
    '',
    '   ',
    ' '.join(['a very long caption'] * 40),
    'supercalifragilisticexpialidocious antidisestablishmentarianism',
    '⹃؝᙭⸻࢐ classified by older tables',
]


# (the JAX package's tokenizer, the port's) for each vocabulary
_PAIRS = {name: (jax_tokenizer(name), tokenizers.create_tokenizer(name))
          for name in NAMES}


@pytest.fixture(params=NAMES)
def pair(request):
    return _PAIRS[request.param]


@pytest.mark.parametrize('caption', CAPTIONS, ids=range(len(CAPTIONS)))
def test_fixed_captions_match(pair, caption):
    ref, ours = pair
    assert ours.encode(caption) == ref.encode(caption)
    padded = ours.encode_padded(caption, CONTEXT)
    assert padded == ref.encode_padded(caption, CONTEXT)
    assert len(padded) == CONTEXT


def test_vocabulary_and_padding(pair):
    """The same vocabulary size, '[PAD]' at 0 and '[UNK]' at 1; a long
    caption truncated to 64 ids, an empty one all padding; an unknown
    character is '[UNK]' on its own."""
    ref, ours = pair
    assert ours.vocab_size == ref.vocab_size
    assert (ours.pad_id, ours.unk_id) == (0, 1)
    assert ours.encode_padded('', CONTEXT) == [0] * CONTEXT
    assert len(ours.encode(CAPTIONS[13])) > CONTEXT
    assert ours.encode('a😀b') == ref.encode('a😀b')
    assert 1 in ours.encode('a😀b')


TEXT = st.text(st.characters(
    categories=['L', 'M', 'N', 'P', 'S', 'Z', 'Cc']), max_size=80)
WORDS = st.lists(st.sampled_from(
    ['the', 'The', 'photograph', 'of', 'a', "don't", 'U.S.', 'x-ray', '',
     '[UNK]', 'naïve', '東京', 'çà', '\t', '...', 'co-op', '1999', '3.14']),
    max_size=20).map(' '.join)


@settings(max_examples=200, deadline=None)
@given(text=st.one_of(TEXT, WORDS))
def test_random_text_matches(text):
    """200 random texts, each through both vocabularies: letters, marks,
    digits, punctuation, symbols, whitespace and control characters (no
    surrogates), or words of captions joined by spaces."""
    for name in NAMES:
        ref, ours = _PAIRS[name]
        assert ours.encode(text) == ref.encode(text), name
        assert ours.encode_padded(text, CONTEXT) == \
            ref.encode_padded(text, CONTEXT), name

