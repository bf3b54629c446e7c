"""Assessment: word error rate, accuracies, confusions.

The port's own copy of the scoring half of ``ecog2txt_tpu/assess.py``
(the ``wer_vector`` edit-distance utility and its companions).  WER is
token-level Levenshtein distance / reference length, computed on the
host over decoded hypotheses.  The statistical comparisons of the JAX
package's module are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


# --------------------------------------------------------------------------
# edit distance / WER
# --------------------------------------------------------------------------


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance between token sequences (numpy DP rows)."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (np.asarray([ref[i - 1] != h for h in hyp]))
        # cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1]) — the cur[j-1]
        # dependency is serial; fold it with a running minimum scan
        np.minimum(prev[1:] + 1, sub, out=cur[1:])
        for j in range(1, n + 1):  # cheap: n is sentence length
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[n])


def word_error_rate(ref: Sequence, hyp: Sequence) -> float:
    """Edit distance normalized by reference length.  Both-empty → 0;
    empty reference with nonempty hypothesis → hyp length (unnormalized
    insertions)."""
    if len(ref) == 0:
        return float(len(hyp))
    return edit_distance(ref, hyp) / len(ref)


def _as_tokens(s) -> list:
    return s.split() if isinstance(s, str) else list(s)


def wer_vector(
    references: Sequence, hypotheses: Sequence
) -> np.ndarray:
    """Per-pair WER over sentence lists (strings are split on
    whitespace) — the reference's ``utils_jgm.wer_vector``."""
    return np.asarray(
        [
            word_error_rate(_as_tokens(r), _as_tokens(h))
            for r, h in zip(references, hypotheses)
        ]
    )


def sequence_accuracy(references: Sequence, hypotheses: Sequence) -> float:
    """Fraction of exactly-matching sequences."""
    if len(references) == 0:
        return 0.0
    hits = sum(
        _as_tokens(r) == _as_tokens(h)
        for r, h in zip(references, hypotheses)
    )
    return hits / len(references)


def confusion_matrix(
    true_ids: np.ndarray, pred_ids: np.ndarray, num_classes: int
) -> np.ndarray:
    """Token-level confusion counts (num_classes, num_classes); rebuilt
    for the reference's validation confusion heatmaps
    (trainers.py:604-620)."""
    true_ids = np.asarray(true_ids).ravel()
    pred_ids = np.asarray(pred_ids).ravel()
    valid = (true_ids >= 0) & (true_ids < num_classes) & (
        pred_ids >= 0
    ) & (pred_ids < num_classes)
    out = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(out, (true_ids[valid], pred_ids[valid]), 1)
    return out
