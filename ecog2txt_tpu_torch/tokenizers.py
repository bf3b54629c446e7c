"""Detokenization: index sequences → sentences.

Word tokens carry a trailing ``_`` (``"word_"``); a sentence is the
joined tokens with ``_`` turned into spaces, cut at ``<EOS>`` and with
``<pad>`` dropped (the same rule as the JAX package's tokenizers).
"""

from __future__ import annotations

from typing import Sequence

from . import EOS_token, pad_token

WORD_SUFFIX = "_"


def target_inds_to_sequences(
    hypotheses,
    class_list: Sequence[str],
    indices: Sequence[int] | None = None,
) -> list[str]:
    """Token-index sequences → sentences: look up tokens, join, ``_`` →
    space, strip pad/EOS, collapse space."""
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
