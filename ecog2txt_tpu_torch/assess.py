"""Assessment: word error rate, accuracies, confusions, statistics.

The port's own copy of ``ecog2txt_tpu/assess.py`` (numpy and scipy only):
(a) the ``wer_vector`` edit-distance utility and its companions, and (b)
the statistical comparisons of WER vectors: the one-sided Wilcoxon test
with its rank-biserial effect size, Welch's t-test, the block-stratified
bootstrap (the same numpy generator and draws as the JAX package's, so
the same numbers), Holm-Bonferroni, and the archive-level plumbing
(``apply_comparisons``, ``results_updater``).  WER is token-level
Levenshtein distance / reference length, computed on the host over
decoded hypotheses.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from scipy import stats as sps


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


# --------------------------------------------------------------------------
# statistical comparisons (reference plotters.py:1943-2120)
# --------------------------------------------------------------------------


def WER_wilcoxon(wers_a: np.ndarray, wers_b: np.ndarray) -> dict:
    """One-sided Wilcoxon signed-rank test that a < b, with rank-biserial
    correlation effect size."""
    wers_a, wers_b = np.asarray(wers_a), np.asarray(wers_b)
    diff = wers_a - wers_b
    nonzero = diff[diff != 0]
    if len(nonzero) == 0:
        return {"p_value": 1.0, "effect_size": 0.0, "statistic": 0.0}
    result = sps.wilcoxon(wers_a, wers_b, alternative="less")
    ranks = sps.rankdata(np.abs(nonzero))
    favorable = ranks[nonzero < 0].sum()
    unfavorable = ranks[nonzero > 0].sum()
    rank_biserial = (favorable - unfavorable) / ranks.sum()
    return {
        "p_value": float(result.pvalue),
        "effect_size": float(rank_biserial),
        "statistic": float(result.statistic),
    }


def WER_paired_t_test(wers_a: np.ndarray, wers_b: np.ndarray) -> dict:
    """Welch unequal-variance t-test (one-sided, a < b) with
    Welch–Satterthwaite dof."""
    a, b = np.asarray(wers_a, float), np.asarray(wers_b, float)
    na, nb = len(a), len(b)
    va, vb = a.var(ddof=1) / na, b.var(ddof=1) / nb
    t = (a.mean() - b.mean()) / np.sqrt(va + vb)
    dof = (va + vb) ** 2 / (va**2 / (na - 1) + vb**2 / (nb - 1))
    return {"p_value": float(sps.t.cdf(t, dof)), "t": float(t), "dof": float(dof)}


def resample_means(
    wers: np.ndarray,
    blocks: np.ndarray | None,
    rng: np.random.Generator,
    num_resamples: int,
) -> np.ndarray:
    """``num_resamples`` bootstrap means of ``wers``, drawn from ``rng``
    (all at once): with ``blocks``, each block resampled within itself
    (block-stratified), the blocks in sorted order."""
    wers = np.asarray(wers, float)
    if blocks is None:
        idx = rng.integers(0, len(wers), size=(num_resamples, len(wers)))
        return wers[idx].mean(axis=1)
    blocks = np.asarray(blocks)
    total = np.zeros(num_resamples)
    count = 0
    for block in np.unique(blocks):
        w = wers[blocks == block]
        idx = rng.integers(0, len(w), size=(num_resamples, len(w)))
        total += w[idx].sum(axis=1)
        count += len(w)
    return total / count


def WER_bootstrap(
    wers_a: np.ndarray,
    wers_b: np.ndarray,
    blocks_a: np.ndarray | None = None,
    blocks_b: np.ndarray | None = None,
    num_resamples: int = 10**6,
    seed: int = 0,
) -> dict:
    """Bootstrap test that mean(a) < mean(b), resampling within blocks;
    a's draws come first from ``default_rng(seed)``, then b's."""
    rng = np.random.default_rng(seed)
    means_a = resample_means(wers_a, blocks_a, rng, num_resamples)
    means_b = resample_means(wers_b, blocks_b, rng, num_resamples)
    return {
        "p_value": float((means_a >= means_b).mean()),
        "mean_diff": float(np.mean(wers_a) - np.mean(wers_b)),
    }


_COMPARATORS: dict[str, Callable] = {
    "wilcoxon": WER_wilcoxon,
    "paired_t_test": WER_paired_t_test,
    "bootstrap": WER_bootstrap,
}


def results_comparator(method: str) -> Callable:
    """Dispatch over comparison methods."""
    try:
        return _COMPARATORS[method]
    except KeyError:
        raise ValueError(
            f"unknown comparison method {method!r}; known: {sorted(_COMPARATORS)}"
        )


def holm_bonferroni(p_values: Sequence[float], alpha: float = 0.05) -> list[bool]:
    """Holm-Bonferroni step-down correction → rejection decisions."""
    p = np.asarray(p_values, float)
    order = np.argsort(p)
    m = len(p)
    reject = np.zeros(m, dtype=bool)
    for rank, idx in enumerate(order):
        if p[idx] <= alpha / (m - rank):
            reject[idx] = True
        else:
            break
    return reject.tolist()


def apply_comparisons(partial_path, comparisons, application_fxn, VERBOSE=True):
    """Run ``application_fxn(baseline_results, comparison_results,
    baseline_suffix, comparison_suffix)`` over every (comparison,
    baseline) pair of saved result archives.  ``partial_path`` is a
    ``%``-template over the experiment suffix; ``comparisons`` maps
    ``comparison_suffix -> {baseline_suffix: stats_dict}``; each archive
    is loaded as a :class:`plotting.results.DecodingResults`."""
    from .plotting.results import DecodingResults

    for comparison_suffix, baseline_dict in comparisons.items():
        comparison_results = DecodingResults("", "", path=partial_path % comparison_suffix)
        for baseline_suffix in baseline_dict:
            if VERBOSE:
                print(f"comparing {comparison_suffix!r} to {baseline_suffix!r}")
            baseline_results = DecodingResults("", "", path=partial_path % baseline_suffix)
            application_fxn(
                baseline_results, comparison_results, baseline_suffix, comparison_suffix,
            )


def results_updater(partial_path, comparisons, ranks, VERBOSE=True):
    """Annotate every comparison's stats in place with its Holm-Bonferroni
    rank and rank-adjusted p value; ``ranks`` are consumed in iteration
    order."""
    ranks = list(ranks)

    def application_fxn(baseline_results, comparison_results, baseline_suffix,
                        comparison_suffix):
        stats = comparisons[comparison_suffix][baseline_suffix]
        p = stats.get("p_value", stats.get("p value"))
        if p is None:
            raise KeyError(
                f"no 'p_value' in stats for comparison ({comparison_suffix!r} vs "
                f"{baseline_suffix!r}): keys={sorted(stats)}"
            )
        rank = ranks.pop(0)
        stats["adjusted_p_value"] = p * rank
        stats["rank"] = rank

    apply_comparisons(partial_path, comparisons, application_fxn, VERBOSE)


def results_summarizer(comparisons: Sequence[dict], alpha: float = 0.05) -> list[dict]:
    """Run a list of comparison specs and Holm-Bonferroni-correct them.
    Each spec: ``{'method': str, 'wers_a': ..., 'wers_b': ..., extra
    kwargs...; 'label': optional}``.  Returns the specs' results annotated
    with 'significant' after the correction (all p values first, then the
    correction)."""
    results = []
    for spec in comparisons:
        spec = dict(spec)
        method = spec.pop("method")
        label = spec.pop("label", method)
        out = results_comparator(method)(**spec)
        results.append({"label": label, "method": method, **out})
    decisions = holm_bonferroni([r["p_value"] for r in results], alpha)
    for r, d in zip(results, decisions):
        r["significant"] = bool(d)
    return results
