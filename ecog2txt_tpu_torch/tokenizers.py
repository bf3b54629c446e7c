"""Tokenization, vocabularies, and detokenization.

Rebuilds the reference's text handling:

* ``sentence_tokenize`` — word / trial / word-piece / phoneme modes
  (reference data_generators.py:446-475).  Word tokens carry a trailing
  ``_`` (``"word_"``), the ``trial`` mode joins the whole sentence into a
  single token, and word-piece mode encodes against a subword vocab (the
  reference shells out to tensor2tensor's SubwordTextEncoder at
  data_generators.py:451-461; here a native greedy-longest-match subword
  encoder with a BPE-style builder replaces it).
* vocab files — one token per line, beginning ``<pad>``, ``<EOS>``,
  ``<OOV>`` (reference auxiliary/vocab.mocha-timit.1806).
* ``target_inds_to_sequences`` — index → text detokenization: join,
  ``_`` → space, strip pad/EOS (reference trainers.py:952-963).
* ``string_seq_to_index_seq`` — token → id with OOV fallback and optional
  ``<EOS>`` append (the per-tensor transform of the reference's
  SequenceDataManifest, subjects.py:338-367).

The port's own copy of ``ecog2txt_tpu/tokenizers.py`` (plain Python, no
JAX), with the same names and behaviour.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Iterable, Sequence

from . import EOS_token, OOV_token, SPECIAL_TOKENS, pad_token

WORD_SUFFIX = "_"


# --------------------------------------------------------------------------
# vocab files
# --------------------------------------------------------------------------


def _is_t2t_vocab(lines: Sequence[str]) -> bool:
    """tensor2tensor ``SubwordTextEncoder.store_to_file`` wraps every
    subtoken in single quotes (``'tok_'`` per line).  Detect that format
    so externally-built t2t vocab files load with the quotes stripped
    (reference data_generators.py:451-461 hands such files straight to
    t2t; here :class:`SubwordEncoder` consumes them natively)."""
    return bool(lines) and all(
        len(ln) >= 2 and ln[0] == "'" and ln[-1] == "'" for ln in lines
    )


def read_vocab_file(path: str) -> list[str]:
    """One token per line; lines are taken verbatim (tokens include their
    ``_`` suffix) — except tensor2tensor-style files (every line quoted),
    whose quotes are stripped so class lists match the encoder output."""
    with open(path, encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    if _is_t2t_vocab(lines):
        return [ln[1:-1] for ln in lines]
    return lines


def write_vocab_file(path: str, tokens: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for token in tokens:
            f.write(token + "\n")


def with_special_tokens(
    tokens: Iterable[str], TARGETS_ARE_SEQUENCES: bool = True
) -> list[str]:
    """Prepend the special tokens to a token list, deduplicating.

    Sequence targets get ``[<pad>, <EOS>, <OOV>]``; non-sequence token
    types ('word'/'trial') get ``[<pad>, <OOV>]`` — the reference adds
    EOS to the class list only when targets are sequences (reference
    trainers.py:191-199).  A token list that already contains an
    uninserted special keeps it in place (vocab files are verbatim)."""
    specials = (
        [pad_token, EOS_token, OOV_token]
        if TARGETS_ARE_SEQUENCES
        else [pad_token, OOV_token]
    )
    rest = [t for t in tokens if t not in specials]
    return specials + rest


def oov_index(class_list: Sequence[str]) -> int:
    """Index of ``<OOV>`` if present, else the literal 2 (reference
    subjects.py:349-352)."""
    try:
        return class_list.index(OOV_token)
    except ValueError:
        return 2


# --------------------------------------------------------------------------
# tokenization
# --------------------------------------------------------------------------


def sentence_tokenize(
    sentence: str | Sequence[str],
    token_type: str = "word_sequence",
    subword_encoder: "SubwordEncoder | None" = None,
) -> list[str]:
    """Sentence → token list under the reference's modes
    (data_generators.py:446-475).

    * ``word`` / ``word_sequence`` / ``phoneme`` / ``phoneme_sequence``:
      one token per word/phoneme, words get the ``_`` suffix;
    * ``trial``: the entire sentence as ONE token of ``_``-postfixed
      words;
    * ``word_piece_sequence``: greedy subword encode (requires
      ``subword_encoder``).
    """
    words = sentence.split() if isinstance(sentence, str) else list(sentence)
    if token_type == "word_piece_sequence":
        if subword_encoder is None:
            raise ValueError("word_piece_sequence requires a subword_encoder")
        text = " ".join(words)
        return subword_encoder.encode(text)
    if token_type == "trial":
        return ["".join(w + WORD_SUFFIX for w in words)]
    if token_type in ("phoneme", "phoneme_sequence"):
        return [str(w) for w in words]
    # word / word_sequence default
    return [w + WORD_SUFFIX for w in words]


def target_inds_to_sequences(
    hypotheses,
    class_list: Sequence[str],
    indices: Sequence[int] | None = None,
) -> list[str]:
    """Token-index sequences → sentences (reference trainers.py:952-963):
    look up tokens, join, ``_`` → space, strip pad/EOS, collapse space."""
    if indices is None:
        indices = range(len(hypotheses))
    sentences = []
    for i in indices:
        tokens = []
        for idx in hypotheses[i]:
            token = class_list[int(idx)]
            if token == EOS_token:
                break
            if token == pad_token:
                continue
            tokens.append(token)
        text = "".join(tokens).replace(WORD_SUFFIX, " ").strip()
        sentences.append(" ".join(text.split()))
    return sentences


def string_seq_to_index_seq(
    tokens: Sequence[str],
    class_list: Sequence[str],
    APPEND_EOS: bool = False,
) -> list[int]:
    """Token strings → class indices with OOV fallback; optionally append
    ``<EOS>`` (reference subjects.py:338-367, tf_helpers contract)."""
    index = {token: i for i, token in enumerate(class_list)}
    oov = oov_index(class_list)
    out = [index.get(t, oov) for t in tokens]
    if APPEND_EOS:
        out.append(index[EOS_token])
    return out


# --------------------------------------------------------------------------
# subword (word-piece) encoder
# --------------------------------------------------------------------------

# tensor2tensor's tokenizer splits text into maximal runs of
# alphanumeric vs non-alphanumeric characters (unicode categories),
# dropping the single space between two runs; its escaping maps
# ``\`` → ``\\``, ``_`` → ``\u``, and any character outside the
# vocab's alphabet to ``\<codepoint>;``, then appends the ``_``
# terminator to EVERY token.  Segmentation is greedy longest-match
# from the left, bounded by the longest vocab entry.  (Algorithm:
# tensor2tensor/data_generators/text_encoder.py + tokenizer.py —
# reimplemented from the published spec; the reference shells out to
# it at data_generators.py:451-461.)


def _t2t_is_alnum(ch: str) -> bool:
    import unicodedata

    return unicodedata.category(ch)[0] in ("L", "N")


def _t2t_tokenize(text: str) -> list[str]:
    """tensor2tensor ``tokenizer.encode``: maximal alnum/non-alnum runs,
    the single inter-run space dropped (re-inserted on decode)."""
    if not text:
        return []
    ret = []
    is_alnum = [_t2t_is_alnum(c) for c in text]
    start = 0
    for pos in range(1, len(text)):
        if is_alnum[pos] != is_alnum[pos - 1]:
            token = text[start:pos]
            if token != " " or start == 0:
                ret.append(token)
            start = pos
    ret.append(text[start:])
    return ret


def _t2t_detokenize(tokens: Sequence[str]) -> str:
    """tensor2tensor ``tokenizer.decode``: join, inserting a space
    between two adjacent alphanumeric tokens."""
    out = []
    prev_alnum = False
    for token in tokens:
        alnum = bool(token) and _t2t_is_alnum(token[0])
        if out and prev_alnum and alnum:
            out.append(" ")
        out.append(token)
        prev_alnum = alnum
    return "".join(out)


def _t2t_escape_token(token: str, alphabet: set[str]) -> str:
    token = token.replace("\\", "\\\\").replace("_", "\\u")
    chars = [
        c if c in alphabet and c != "\n" else rf"\{ord(c)};" for c in token
    ]
    return "".join(chars) + "_"


def _t2t_unescape_token(escaped: str) -> str:
    """Inverse of :func:`_t2t_escape_token` minus the ``_`` terminator
    (the caller strips it when splitting the subtoken stream)."""
    out = []
    i = 0
    while i < len(escaped):
        c = escaped[i]
        if c == "\\" and i + 1 < len(escaped):
            nxt = escaped[i + 1]
            if nxt == "u":
                out.append("_")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            semi = escaped.find(";", i + 1)
            if semi != -1 and escaped[i + 1 : semi].isdigit():
                out.append(chr(int(escaped[i + 1 : semi])))
                i = semi + 1
                continue
        out.append(c)
        i += 1
    return "".join(out)


class SubwordEncoder:
    """Greedy longest-match subword tokenizer with a BPE-style vocabulary
    builder — native stand-in for tensor2tensor's SubwordTextEncoder
    (reference data_generators.py:451-461).

    Two vocab styles (auto-detected at load):

    * ``native``: subword units terminate words with the ``_`` marker
      (so decode is concatenate + ``_``→space, the same rule as word
      tokens).  Unknown characters fall back to ``<OOV>``.
    * ``t2t``: a tensor2tensor-built vocab file (every line quoted) —
      segmentation follows t2t's exact pipeline (run tokenizer →
      escape → greedy longest-match bounded by the longest entry), so
      token ids equal what SubwordTextEncoder would produce on the
      same file.
    """

    def __init__(self, subwords: Sequence[str], style: str = "native"):
        if style not in ("native", "t2t"):
            raise ValueError(f"unknown subword style {style!r}")
        self.style = style
        # longest-first for greedy matching
        self.subwords = list(subwords)
        self._by_length = sorted(
            (s for s in self.subwords if s not in SPECIAL_TOKENS),
            key=len,
            reverse=True,
        )
        if style == "t2t":
            self._vocab_set = {
                s for s in self.subwords if s not in SPECIAL_TOKENS
            }
            self._max_len = max((len(s) for s in self._vocab_set), default=1)
            # t2t derives the escape alphabet from the subtokens
            self._alphabet = {c for s in self._vocab_set for c in s}

    @classmethod
    def build_from_corpus(
        cls,
        sentences: Iterable[str],
        target_vocab_size: int = 256,
        max_subword_len: int = 12,
    ) -> "SubwordEncoder":
        """Count all substrings of ``word_`` forms up to
        ``max_subword_len``; keep the most frequent until
        ``target_vocab_size`` (always keeping single characters so any
        string is encodable)."""
        counts: Counter[str] = Counter()
        chars: set[str] = set()
        for sentence in sentences:
            for word in sentence.split():
                marked = word + WORD_SUFFIX
                chars.update(marked)
                for i in range(len(marked)):
                    for j in range(i + 1, min(i + 1 + max_subword_len, len(marked) + 1)):
                        counts[marked[i:j]] += 1
        keep = sorted(chars)
        budget = max(target_vocab_size - len(keep), 0)
        multi = [
            s
            for s, _ in counts.most_common()
            if len(s) > 1 and s not in chars
        ][:budget]
        return cls(with_special_tokens(keep + multi))

    @classmethod
    def from_vocab_file(cls, path: str) -> "SubwordEncoder":
        with open(path, encoding="utf-8") as f:
            raw = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        if _is_t2t_vocab(raw):
            return cls([ln[1:-1] for ln in raw], style="t2t")
        return cls(raw)

    def encode(self, text: str) -> list[str]:
        """Greedy longest-match over each ``word_`` form (native), or
        tensor2tensor's exact tokenize→escape→greedy pipeline (t2t)."""
        if self.style == "t2t":
            return self._encode_t2t(text)
        out: list[str] = []
        for word in text.split():
            marked = word + WORD_SUFFIX
            i = 0
            while i < len(marked):
                match = None
                for s in self._by_length:
                    if marked.startswith(s, i):
                        match = s
                        break
                if match is None:
                    match = marked[i]
                    if match not in self.subwords:
                        out.append(OOV_token)
                        i += 1
                        continue
                out.append(match)
                i += len(match)
        return out

    def _encode_t2t(self, text: str) -> list[str]:
        out: list[str] = []
        for token in _t2t_tokenize(text):
            escaped = _t2t_escape_token(token, self._alphabet)
            start, n = 0, len(escaped)
            while start < n:
                for end in range(min(n, start + self._max_len), start, -1):
                    piece = escaped[start:end]
                    if piece in self._vocab_set:
                        out.append(piece)
                        start = end
                        break
                else:
                    # a well-formed t2t vocab contains every alphabet
                    # character; an out-of-vocab character (possible on
                    # truncated files) degrades to <OOV>, not a crash
                    out.append(OOV_token)
                    start += 1
        return out

    def decode(self, tokens: Sequence[str]) -> str:
        if self.style == "t2t":
            stream = "".join(t for t in tokens if t not in SPECIAL_TOKENS)
            # '_' terminates each escaped token; '\u' (the escape for a
            # literal '_') contains no '_', so the split is unambiguous
            pieces = [
                _t2t_unescape_token(p) for p in stream.split("_") if p
            ]
            return _t2t_detokenize(pieces)
        text = "".join(t for t in tokens if t not in SPECIAL_TOKENS)
        return " ".join(text.replace(WORD_SUFFIX, " ").split())
