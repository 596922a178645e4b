"""The caption tokenizers of the text-to-image path, in plain Python.

Counterpart of `hqtransformer_tpu/data/tokenizers.py::create_tokenizer` for
'bpe16k_huggingface' and 'bpe30k_huggingface': the HuggingFace
`CharBPETokenizer` those build (lowercase, unknown token '[UNK]', no BPE
dropout at inference), re-implemented here so that the port needs no
`tokenizers` package. The steps, as that tokenizer runs them:

1. '[UNK]', its one special token, is split off the raw text wherever it
   occurs and becomes its id;
2. the rest is normalized as `BertNormalizer(clean_text=True,
   handle_chinese_chars=True, strip_accents=None, lowercase=False)` and
   then `Lowercase()` do it: NUL, U+FFFD and characters of the Unicode
   categories Cc, Cf and Co are dropped (tab, newline and carriage return
   count as whitespace), whitespace becomes a space, every CJK ideograph
   gets a space on either side, and each character is lowercased on its
   own (no final-sigma rule). Accents are kept: 'café' stays 'café';
3. `BertPreTokenizer`: split on whitespace, and every punctuation
   character (ASCII punctuation, or a Unicode P* category) is a piece of
   its own;
4. BPE with the end-of-word suffix '</w>': each character of a piece is
   looked up (the last with '</w>'); one not in the vocabulary is '[UNK]'
   on its own; then the ranked merges apply, lowest rank first and, within
   a rank, leftmost first.

`encode_padded(text, n)` truncates to n ids and pads with '[PAD]' (id 0).

The reference classifies characters as control, format or punctuation by
the Unicode 8.0 tables of a library it is built with; its whitespace and
casing follow its language's standard library, as Python's do. Where
Python 3.12's tables (`unicodedata`, Unicode 15.0) differ from Unicode
8.0, the differences are listed here: format characters assigned later
(kept, being unassigned in 8.0), punctuation assigned later (not
punctuation there), and two characters that were punctuation in 8.0.
Characters that Python's tables leave unassigned are kept as they are,
where a reference built on a newer standard library may lowercase one of
them.

`create_tokenizer('clip')` is the counterpart of the JAX package's
`ClipSimpleTokenizer`, the byte-level BPE of OpenAI CLIP's text tower
(`bpe_simple_vocab_16e6.txt.gz`, read with `gzip`), which CLIP re-ranking
reads: the text cleaned as JAX cleans it (HTML entities unescaped twice,
NFC, runs of whitespace made one space, stripped, lowercased), split into
pieces (`clip_pre_tokenize`), each piece's UTF-8 bytes mapped to
characters and merged by rank; `encode_padded(text, n)` wraps the ids in
<|startoftext|> and <|endoftext|> and pads with <|endoftext|>. JAX splits
with the `regex` package's Unicode letter and number classes;
here they are the Unicode categories L* and N* of Python's `unicodedata`
(Unicode 15.0), which may differ from that package's newer tables only on
characters assigned since.

`create_tokenizer('wordpiece16k_huggingface')` (also 'bert_huggingface'
and 'wordpiece30k_huggingface', the same file) is the `tokenizers`
package's `BertWordPieceTokenizer` over `bert-base-uncased-vocab.txt`:
its five special tokens ('[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]')
split off the raw text; `BertNormalizer` with accents stripped (NFD,
then the non-spacing marks dropped) before lowercasing; the same
pre-tokenizer; greedy longest-match WordPiece with '##' continuations, a
word of more than 100 characters or with no match being '[UNK]'; and
[CLS] ... [SEP] around the ids. Marks assigned after Unicode 8.0 are
kept whole, as that tokenizer's tables do not know them
(`_MARKS_AFTER_8`, found by holding every code point against it).

`create_tokenizer('bytebpe16k_huggingface')` is its
`ByteLevelBPETokenizer` over `vocab.json` and `merges.txt`: lowercase,
GPT-2's split (`byte_level_pre_tokenize`, by Unicode categories: no
`regex` package), each piece's UTF-8 bytes mapped to characters and
merged by rank; no special tokens, and padding with id 0 (the id of '!':
the JAX wrapper pads with '[PAD]''s id, else 0).

BPE dropout (`create_tokenizer(..., dropout=p, generator=g)`, which
training reads) is that package's rule: the merges pop from the queue as
above, each skipped with probability p (one uniform draw a pop, from `g`:
a `random.Random` or a `torch.Generator`; a fresh `random.Random` when
none is given), the skipped ones pushed back after the next merge that
is not skipped, and the encoding ends when the queue is empty. Its draws
are not the package's (it draws from a generator of its own), so the two
agree in distribution only. The WordPiece and CLIP tokenizers take no
dropout, as in JAX.

The vocabulary and merges are read as data files from
`hqtransformer_tpu/assets/tokenizers/` beside this package in the
repository, or from `vocab_dir`.
"""

from __future__ import annotations

import gzip
import heapq
import html
import json
import random
import re
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

ASSETS = Path(__file__).resolve().parents[2] / 'hqtransformer_tpu' / \
    'assets' / 'tokenizers'
FILES = {'bpe16k_huggingface': ('bpe-16k-vocab.json', 'bpe-16k-merges.txt'),
         'bpe30k_huggingface': ('bpe-30k-vocab.json', 'bpe-30k-merges.txt'),
         'clip': ('bpe_simple_vocab_16e6.txt.gz',),
         'wordpiece16k_huggingface': ('bert-base-uncased-vocab.txt',),
         'bytebpe16k_huggingface': ('vocab.json', 'merges.txt')}
ALIASES = {'bpe16k': 'bpe16k_huggingface', 'bpe30k': 'bpe30k_huggingface',
           'bert_huggingface': 'wordpiece16k_huggingface',
           'wordpiece30k_huggingface': 'wordpiece16k_huggingface'}
UNK, PAD, SUFFIX = '[UNK]', '[PAD]', '</w>'

# CJK ideograph blocks that BertNormalizer pads with spaces.
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_OTHER = ('Cc', 'Cf', 'Co')
# Where Unicode 8.0, whose tables the reference reads, differs from
# Python's: format characters assigned later, punctuation assigned later,
# and the characters that were punctuation then.
_FORMAT_AFTER_8 = ((0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD),
                   (0x13430, 0x1343F))
_PUNCT_AFTER_8 = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F))
_PUNCT_IN_8 = (0x166D, 0x111C9)


def _within(c: int, ranges) -> bool:
    return any(lo <= c <= hi for lo, hi in ranges)


def _is_other(ch: str) -> bool:
    return unicodedata.category(ch) in _OTHER and \
        not _within(ord(ch), _FORMAT_AFTER_8)


def _is_punctuation(ch: str) -> bool:
    c = ord(ch)
    if ch.isascii():
        return ch.isprintable() and not (ch.isalnum() or ch.isspace())
    return c in _PUNCT_IN_8 or (unicodedata.category(ch).startswith('P')
                                and not _within(c, _PUNCT_AFTER_8))


def _clean(text: str) -> str:
    """BertNormalizer's clean text and CJK padding."""
    out = []
    for ch in text:
        c = ord(ch)
        if ch in '\t\n\r':
            out.append(' ')
            continue
        if c == 0 or c == 0xFFFD or _is_other(ch):
            continue
        if ch.isspace():
            out.append(' ')
        elif _within(c, _CJK):
            out.append(f' {ch} ')
        else:
            out.append(ch)
    return ''.join(out)


def _lower(text: str) -> str:
    """Each character lowercased on its own."""
    return ''.join(ch.lower() for ch in text)


def normalize(text: str) -> str:
    """BertNormalizer (clean text, pad CJK, keep accents, no lowercase)
    and then Lowercase, character by character."""
    return _lower(_clean(text))


# Marks (Mn, Mc) assigned after Unicode 8.0 that BertNormalizer keeps
# whole when it strips accents, and the one mark it drops that Python's
# tables no longer call non-spacing.
_MARKS_AFTER_8 = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA),
    (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE),
    (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF),
    (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x11938, 0x11938),
    (0x1193B, 0x1193C), (0x1193E, 0x1193E), (0x11943, 0x11943),
    (0x119D4, 0x119D7), (0x119DA, 0x119DB), (0x119E0, 0x119E0),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A56), (0x11A59, 0x11A5B),
    (0x11A8A, 0x11A96), (0x11A98, 0x11A99), (0x11C30, 0x11C36),
    (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7),
    (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D),
    (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D90, 0x11D91),
    (0x11D95, 0x11D95), (0x11D97, 0x11D97), (0x11EF3, 0x11EF4),
    (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40),
    (0x11F42, 0x11F42), (0x13440, 0x13440), (0x13447, 0x13455),
    (0x16F4F, 0x16F4F), (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018),
    (0x1E01B, 0x1E021), (0x1E023, 0x1E024), (0x1E026, 0x1E02A),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A))
_NONSPACING_IN_8 = '\u1734'


_KEPT_MARKS = frozenset(cp for lo, hi in _MARKS_AFTER_8
                        for cp in range(lo, hi + 1))


def strip_accents(text: str) -> str:
    """NFD, then the non-spacing marks (Mn) dropped, by the tables of
    Unicode 8.0: a mark assigned later is kept as it is."""
    out, start = [], 0

    def flush(seg: str) -> None:
        out.extend(c for c in unicodedata.normalize('NFD', seg)
                   if unicodedata.category(c) != 'Mn')

    for i, ch in enumerate(text):
        if ord(ch) in _KEPT_MARKS or ch == _NONSPACING_IN_8:
            flush(text[start:i])
            start = i + 1
            if ch != _NONSPACING_IN_8:
                out.append(ch)
    flush(text[start:])
    return ''.join(out)


def split_special(text: str, specials) -> List[Tuple[str, bool]]:
    """`text` cut at each occurrence of a special token: [(piece,
    is_special)], in order."""
    pattern = re.compile('|'.join(re.escape(t) for t in specials))
    out, pos = [], 0
    for m in pattern.finditer(text):
        out.append((text[pos:m.start()], False))
        out.append((m.group(), True))
        pos = m.end()
    out.append((text[pos:], False))
    return [(p, sp) for p, sp in out if p]


def pre_tokenize(text: str) -> List[str]:
    """BertPreTokenizer: whitespace separates pieces and is dropped; each
    punctuation character is a piece of its own."""
    pieces, word = [], []
    for ch in text:
        if ch.isspace() or _is_punctuation(ch):
            if word:
                pieces.append(''.join(word))
                word = []
            if not ch.isspace():
                pieces.append(ch)
        else:
            word.append(ch)
    if word:
        pieces.append(''.join(word))
    return pieces


class CharBPETokenizer:
    """The BPE caption tokenizer over one vocabulary and merges file."""

    def __init__(self, vocab_path: Path, merges_path: Path):
        with open(vocab_path, encoding='utf-8') as f:
            self.vocab: Dict[str, int] = json.load(f)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        with open(merges_path, encoding='utf-8') as f:
            lines = [ln.rstrip('\n') for ln in f]
        if lines and lines[0].startswith('#version'):
            lines = lines[1:]
        for rank, line in enumerate(ln for ln in lines if ln):
            a, b = line.split(' ')
            pair = (self.vocab[a], self.vocab[b])
            self.merges[pair] = (rank, self.vocab[a + b])
        self.unk_id = self.vocab.get(UNK)
        self.pad_id = self.vocab.get(PAD, 0)
        self.dropout: Optional[float] = None
        self.uniform: Optional[Callable[[], float]] = None

    def set_dropout(self, p: Optional[float],
                    generator: Union[random.Random, torch.Generator,
                                     None] = None) -> None:
        """BPE dropout with probability `p` (None or 0: none), its draws
        from `generator`."""
        if not p:
            self.dropout, self.uniform = None, None
            return
        if isinstance(generator, torch.Generator):
            self.uniform = lambda: float(torch.rand(
                (), generator=generator, device=generator.device))
        else:
            self.uniform = (generator or random.Random()).random
        self.dropout = float(p)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _word(self, piece: str) -> List[int]:
        """The ids of one pre-tokenized piece: its characters looked up
        (the last with the end-of-word suffix), then merged."""
        return self._merge([
            self.vocab.get(ch + SUFFIX if i == len(piece) - 1 else ch,
                           self.unk_id) for i, ch in enumerate(piece)])

    def _merge(self, ids: List[int]) -> List[int]:
        """Apply the merges: lowest rank first, leftmost first within a
        rank, each merge offering the pairs it forms with its
        neighbours."""
        n = len(ids)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        skipped = []
        while heap:
            top = heapq.heappop(heap)
            if self.dropout is not None:
                if self.uniform() < self.dropout:
                    skipped.append(top)
                    continue
                for item in skipped:
                    heapq.heappush(heap, item)
                skipped.clear()
            _, pos, new_id = top
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = pos
            if prv[pos] != -1:
                m = self.merges.get((ids[prv[pos]], ids[pos]))
                if m:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((ids[pos], ids[nxt[pos]]))
                if m:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [i for i, a in zip(ids, alive) if a]

    def encode(self, text: str) -> List[int]:
        """The ids of `text`."""
        out: List[int] = []
        for k, part in enumerate(text.split(UNK)):
            if k:
                out.append(self.unk_id)
            for piece in pre_tokenize(normalize(part)):
                out.extend(self._word(piece))
        return out

    def encode_padded(self, text: str, context_length: int) -> List[int]:
        """The ids of `text` truncated to `context_length` and padded with
        '[PAD]'."""
        ids = self.encode(text)[:context_length]
        return ids + [self.pad_id] * (context_length - len(ids))


class ByteLevelBPETokenizer(CharBPETokenizer):
    """The byte-level BPE tokenizer over `vocab.json` and `merges.txt`:
    each piece's UTF-8 bytes as characters, merged by rank, no
    end-of-word suffix, no special tokens."""

    def __init__(self, vocab_path: Path, merges_path: Path):
        super().__init__(vocab_path, merges_path)
        self.byte_encoder = _bytes_to_unicode()

    def encode(self, text: str) -> List[int]:
        """The ids of `text`."""
        out: List[int] = []
        for piece in byte_level_pre_tokenize(_lower(text)):
            out.extend(self._merge([self.vocab[self.byte_encoder[b]]
                                    for b in piece.encode()]))
        return out


_GPT2_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode's White_Space, the regex's \s (Python's isspace also takes
# U+001C..U+001F)
_WHITE_SPACE = frozenset('\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f'
                         '\u205f\u3000' + ''.join(map(chr, range(0x2000,
                                                                 0x200B))))


def _gpt2_class(ch: str) -> str:
    """'L' (a letter), 'N' (a number), ' ' (white space) or 'O'."""
    major = unicodedata.category(ch)[0]
    if major in 'LN':
        return major
    return ' ' if ch in _WHITE_SPACE else 'O'


def byte_level_pre_tokenize(text: str) -> List[str]:
    """GPT-2's split, as the pattern `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+` finds it: a contraction,
    else a run of letters, of numbers or of other characters, each with
    at most one space before it, else a run of white space that leaves
    its last space to the word after it."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        literal = next((t for t in _GPT2_CONTRACTIONS
                        if text.startswith(t, i)), None)
        if literal is not None:
            pieces.append(literal)
            i += len(literal)
            continue
        start = i
        if text[i] == ' ' and i + 1 < n and _gpt2_class(text[i + 1]) != ' ':
            i += 1
        kind = _gpt2_class(text[i])
        j = i + 1
        while j < n and _gpt2_class(text[j]) == kind:
            j += 1
        if kind == ' ' and j < n and j - start >= 2:
            j -= 1
        pieces.append(text[start:j])
        i = j
    return pieces


class WordPieceTokenizer:
    """BERT's WordPiece tokenizer over `bert-base-uncased-vocab.txt`."""

    SPECIALS = ('[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]')
    MAX_WORD = 100

    def __init__(self, vocab_path: Path):
        with open(vocab_path, encoding='utf-8') as f:
            self.vocab: Dict[str, int] = {
                ln.rstrip(): i for i, ln in enumerate(f)}
        self.unk_id = self.vocab[UNK]
        self.pad_id = self.vocab.get(PAD, 0)
        self.cls_id, self.sep_id = self.vocab['[CLS]'], self.vocab['[SEP]']

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _word(self, word: str) -> List[int]:
        """Greedy longest match, '##' before every piece but the first;
        '[UNK]' for a word too long or with a part that matches nothing."""
        if len(word) > self.MAX_WORD:
            return [self.unk_id]
        out, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else \
                    '##' + word[start:end]
                if sub in self.vocab:
                    break
            else:
                return [self.unk_id]
            out.append(self.vocab[sub])
            start = end
        return out

    def encode(self, text: str) -> List[int]:
        """[CLS], the ids of `text`, [SEP]."""
        out = [self.cls_id]
        for part, special in split_special(text, self.SPECIALS):
            if special:
                out.append(self.vocab[part])
                continue
            for word in pre_tokenize(_lower(strip_accents(_clean(part)))):
                out.extend(self._word(word))
        return out + [self.sep_id]

    encode_padded = CharBPETokenizer.encode_padded


# --------------------------------------------------- CLIP's byte-level BPE

SOT, EOT = '<|startoftext|>', '<|endoftext|>'
# The pieces the split takes whole before any class, in its order.
_CLIP_LITERALS = (SOT, EOT, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# merges in the vocabulary file that the encoder uses (CLIP's count)
_CLIP_MERGES = 49152 - 256 - 2


def _bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible map of the 256 byte values to printable
    characters."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('\xa1'), ord('\xac') + 1)) +
          list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def clean_clip_text(text: str) -> str:
    """HTML entities unescaped twice, NFC, whitespace runs made one space,
    stripped and lowercased."""
    text = unicodedata.normalize('NFC', html.unescape(html.unescape(text)))
    return re.sub(r'\s+', ' ', text).strip().lower()


def _clip_class(ch: str) -> str:
    """'L' (a letter), 'N' (a number), ' ' (whitespace) or 'O'."""
    major = unicodedata.category(ch)[0]
    if major in 'LN':
        return major
    return ' ' if ch.isspace() else 'O'


def clip_pre_tokenize(text: str) -> List[str]:
    """CLIP's split of cleaned text, as JAX's pattern
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|
    [\\p{N}]|[^\\s\\p{L}\\p{N}]+` finds it: at each position the first
    literal that starts there, else a run of letters, one number, or a
    run of other characters; whitespace separates."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        literal = next((t for t in _CLIP_LITERALS if text.startswith(t, i)),
                       None)
        if literal is not None:
            pieces.append(literal)
            i += len(literal)
            continue
        kind = _clip_class(text[i])
        j = i + 1
        if kind in 'LO':
            while j < n and _clip_class(text[j]) == kind:
                j += 1
        if kind != ' ':
            pieces.append(text[i:j])
        i = j
    return pieces


class ClipSimpleTokenizer:
    """CLIP's text tokenizer over `bpe_simple_vocab_16e6.txt.gz`."""

    def __init__(self, bpe_path: Path):
        with gzip.open(bpe_path) as f:
            lines = f.read().decode('utf-8').split('\n')
        merges = [tuple(m.split()) for m in lines[1:_CLIP_MERGES + 1]]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [v + SUFFIX for v in vocab]
        vocab += [''.join(m) for m in merges] + [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.sot, self.eot = self.encoder[SOT], self.encoder[EOT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        """The merged symbols of one piece's byte characters, joined by
        spaces: the pair of lowest rank merged everywhere, until none of
        its pairs has a rank."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + SUFFIX,)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float('inf')))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and \
                        word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = out = ' '.join(word)
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of `text`, without the start and end tokens."""
        ids: List[int] = []
        for piece in clip_pre_tokenize(clean_clip_text(text)):
            chars = ''.join(self.byte_encoder[b] for b in piece.encode())
            ids.extend(self.encoder[t] for t in self._bpe(chars).split(' '))
        return ids

    def encode_padded(self, text: str, context_length: int) -> List[int]:
        """<|startoftext|>, the ids of `text` cut to context_length - 2,
        <|endoftext|>, then <|endoftext|> up to `context_length`."""
        ids = [self.sot] + self.encode(text)[:context_length - 2] + \
            [self.eot]
        return ids + [self.eot] * (context_length - len(ids))


Tokenizer = Union[CharBPETokenizer, ByteLevelBPETokenizer,
                  WordPieceTokenizer, ClipSimpleTokenizer]
_CLASSES = {'clip': ClipSimpleTokenizer,
            'wordpiece16k_huggingface': WordPieceTokenizer,
            'bytebpe16k_huggingface': ByteLevelBPETokenizer}


def create_tokenizer(name: str = 'bpe16k_huggingface',
                     vocab_dir: Optional[str] = None,
                     dropout: Optional[float] = None,
                     generator: Union[random.Random, torch.Generator,
                                      None] = None) -> Tokenizer:
    """The tokenizer `name`, as the JAX package's `create_tokenizer` names
    it ('bpe16k_huggingface', 'bpe30k_huggingface', 'bpe16k', 'bpe30k',
    'wordpiece16k_huggingface', 'bert_huggingface',
    'wordpiece30k_huggingface', 'bytebpe16k_huggingface', 'clip'), its
    files read from `vocab_dir` or from the repository's assets. The BPE
    tokenizers take BPE dropout (training): `dropout` p, drawn from
    `generator` (see the module docstring); the others ignore it, as in
    JAX."""
    key = ALIASES.get(name, name)
    if key not in FILES:
        raise ValueError(f'unknown tokenizer {name}')
    root = Path(vocab_dir) if vocab_dir is not None else ASSETS
    paths = [root / f for f in FILES[key]]
    tok = _CLASSES.get(key, CharBPETokenizer)(*paths)
    if isinstance(tok, CharBPETokenizer):
        tok.set_dropout(dropout, generator)
    return tok


def tokenize(texts: List[str], context_length: int = 64,
             name: str = 'bpe16k_huggingface',
             vocab_dir: Optional[str] = None) -> List[List[int]]:
    """`encode_padded` of every text: [len(texts)][context_length] ids."""
    tok = create_tokenizer(name, vocab_dir)
    return [tok.encode_padded(t, context_length) for t in texts]
