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



# WordPiece (BertWordPieceTokenizer) and byte-level BPE
# (ByteLevelBPETokenizer), the other tokenizers of `create_tokenizer`.
OTHER_NAMES = ('wordpiece16k_huggingface', 'bytebpe16k_huggingface')
OTHER_CAPTIONS = CAPTIONS + [
    'a dog',
    '[CLS] first [SEP] second [MASK] [PAD] [UNK]x[cls]',
    'x' * 100 + ' ' + 'y' * 101,
    "it's they're we've I'm you'll he'd 'S 'LL",
    'İstanbul ǅemal ΣΊΣΥΦΟΣ àéîõü ñ Ω ﬁ',
    'a࢘b᜴ćd ்̀̂ eᇰ0f',
    'two  spaces,   three, \t tab\n\nnewlines  ',
    '\x1c\x1d\x1e\x1f file separators \x85 nel \xa0 nbsp 　 ideo',
    'числа 123 45.6 ٣٤ ½ Ⅻ 𝟙',
]
_OTHER_PAIRS = {name: (jax_tokenizer(name), tokenizers.create_tokenizer(name))
                for name in OTHER_NAMES}


@pytest.mark.parametrize('name', OTHER_NAMES)
@pytest.mark.parametrize('caption', OTHER_CAPTIONS,
                         ids=range(len(OTHER_CAPTIONS)))
def test_other_tokenizers_fixed_captions_match(name, caption):
    ref, ours = _OTHER_PAIRS[name]
    assert ours.encode(caption) == ref.encode(caption)
    assert ours.encode_padded(caption, CONTEXT) == \
        ref.encode_padded(caption, CONTEXT)


def test_other_tokenizers_vocabulary_and_padding():
    """WordPiece wraps the ids in [CLS] .. [SEP] (JAX's encode('a dog') is
    [101, 1037, 3899, 102]) and pads with [PAD] = 0; byte-level BPE has no
    [PAD] and pads with 0, which is also the id of '!' (JAX's quirk);
    every alias of the vocabularies builds, and a name JAX does not know
    raises as JAX's does."""
    for name in OTHER_NAMES:
        ref, ours = _OTHER_PAIRS[name]
        assert ours.vocab_size == ref.vocab_size
        assert ours.pad_id == ref.pad_id == 0
    wp = _OTHER_PAIRS['wordpiece16k_huggingface'][1]
    assert wp.encode('a dog') == [101, 1037, 3899, 102]
    assert wp.encode_padded('a dog', 6) == [101, 1037, 3899, 102, 0, 0]
    byte_bpe = _OTHER_PAIRS['bytebpe16k_huggingface'][1]
    assert byte_bpe.encode('!') == [0]
    for alias in ('bert_huggingface', 'wordpiece30k_huggingface'):
        assert tokenizers.create_tokenizer(alias).encode('a dog') == \
            wp.encode('a dog')
    with pytest.raises(ValueError, match='unknown tokenizer'):
        tokenizers.create_tokenizer('wordpiece')


def test_bpe_dropout_waits_for_training():
    """A nonzero dropout (training's BPE dropout) raises; None and 0 are
    JAX's inference settings and build the tokenizer."""
    for name in OTHER_NAMES + NAMES:
        with pytest.raises(NotImplementedError, match='A11'):
            tokenizers.create_tokenizer(name, dropout=0.1)
        for off in (None, 0, 0.0):
            tokenizers.create_tokenizer(name, dropout=off)


OTHER_WORDS = st.lists(st.sampled_from(
    ['the', 'The', 'photograph', "don't", "it's", 'U.S.', '', '[CLS]',
     '[SEP]', '[MASK]', '[PAD]', 'naïve', '東京', 'Ünïcödé', '  ', '\t',
     '...', '1999', '3.14', 'x' * 101, 'straße']), max_size=20).map(''.join)


@settings(max_examples=150, deadline=None)
@given(text=st.one_of(TEXT, OTHER_WORDS))
def test_other_tokenizers_random_text_matches(text):
    """150 random texts through WordPiece and byte-level BPE: the
    characters of `test_random_text_matches`, or caption words joined
    without separators (special tokens and long words included)."""
    for name in OTHER_NAMES:
        ref, ours = _OTHER_PAIRS[name]
        assert ours.encode(text) == ref.encode(text), name
        assert ours.encode_padded(text, CONTEXT) == \
            ref.encode_padded(text, CONTEXT), name
