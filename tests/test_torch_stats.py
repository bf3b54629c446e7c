"""The port's WER statistics held to the JAX package's.

``ecog2txt_tpu_torch.assess`` against ``ecog2txt_tpu.assess`` on seeded
WER vectors: the one-sided Wilcoxon test with its effect size, Welch's
t-test, the bootstrap (plain and block-stratified: the same numpy
generator, hence the same draws), the resampled means, the comparator
dispatch, Holm-Bonferroni and the summarizer, equal to 1e-12; then
``apply_comparisons`` and ``results_updater`` over archives in a
temporary tree, written by the JAX package's ``save_decoding_results``.
"""

import numpy as np
import pytest

from ecog2txt_tpu import assess as jassess
from ecog2txt_tpu.plotting.results import save_decoding_results
from ecog2txt_tpu_torch import assess as tassess
from ecog2txt_tpu_torch.plotting.results import DecodingResults
from torch_threads import one_torch_thread  # noqa: F401

EXACT = dict(rtol=1e-12, atol=1e-12)


def _wers(seed, n=40, shift=0.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0.3 + shift, 0.15, n), 0, None).round(3)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (str, bool)):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **EXACT)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wilcoxon_and_t_test_match_jax(seed):
    a, b = _wers(seed, shift=-0.05), _wers(seed + 10)
    _close(tassess.WER_wilcoxon(a, b), jassess.WER_wilcoxon(a, b))
    _close(tassess.WER_paired_t_test(a, b), jassess.WER_paired_t_test(a, b))
    _close(tassess.WER_wilcoxon(a, a), jassess.WER_wilcoxon(a, a))  # no nonzero difference


@pytest.mark.parametrize("blocks", [False, True])
def test_bootstrap_and_resampled_means_match_jax(blocks):
    """The same p value and mean difference from ``default_rng(seed)``, a's
    draws first; ``resample_means`` draws what the JAX package's nested
    helper draws."""
    a, b = _wers(3, 30, -0.03), _wers(4, 30)
    ba = np.repeat([1, 2, 3], 10) if blocks else None
    bb = np.tile([4, 5, 6], 10) if blocks else None
    kw = dict(blocks_a=ba, blocks_b=bb, num_resamples=2000, seed=7)
    _close(tassess.WER_bootstrap(a, b, **kw), jassess.WER_bootstrap(a, b, **kw))
    rng_t, rng_ref = np.random.default_rng(7), np.random.default_rng(7)
    means = tassess.resample_means(a, ba, rng_t, 2000)
    # the JAX package's draws, written out: per block in sorted order
    total, count = np.zeros(2000), 0
    groups = [a] if ba is None else [a[ba == k] for k in np.unique(ba)]
    for w in groups:
        idx = rng_ref.integers(0, len(w), size=(2000, len(w)))
        total += w[idx].sum(axis=1)
        count += len(w)
    np.testing.assert_allclose(means, total / count, **EXACT)


def test_comparator_holm_and_summarizer_match_jax():
    specs = [
        {"method": "wilcoxon", "wers_a": _wers(5, shift=-0.1), "wers_b": _wers(6), "label": "w"},
        {"method": "paired_t_test", "wers_a": _wers(7), "wers_b": _wers(8)},
        {"method": "bootstrap", "wers_a": _wers(9, shift=-0.2), "wers_b": _wers(10),
         "num_resamples": 1000, "seed": 3},
    ]
    got, want = tassess.results_summarizer(specs), jassess.results_summarizer(specs)
    for g, w in zip(got, want):
        _close(g, w)
    p = [0.001, 0.04, 0.03, 0.2, 0.0125]
    assert tassess.holm_bonferroni(p) == jassess.holm_bonferroni(p)
    assert tassess.holm_bonferroni(p, 0.2) == jassess.holm_bonferroni(p, 0.2)
    for method in ("wilcoxon", "paired_t_test", "bootstrap"):
        assert tassess.results_comparator(method).__name__ == \
            jassess.results_comparator(method).__name__
    with pytest.raises(ValueError, match="unknown comparison method"):
        tassess.results_comparator("nope")


def test_apply_comparisons_and_results_updater(tmp_path):
    """Archive pairs loaded from a %-template path (npz archives of the JAX
    package's writer); Holm ranks and adjusted p values written into the
    stats in place, as the JAX package writes them."""
    rng = np.random.default_rng(0)
    for suffix in ("", "_untargeted", "_noise"):
        save_decoding_results(
            str(tmp_path / f"perf_vs_training_size_1{suffix}"),
            word_error_rate=rng.uniform(0, 1, (3, 2)),
            accuracy=rng.uniform(0, 1, (3, 2)),
            nums_seconds=rng.uniform(60, 600, (3, 2)),
            training_blocks=[[1], [1, 2]],
            validation_blocks=[9],
        )
    template = str(tmp_path / "perf_vs_training_size_1%s")

    def comparisons():
        return {"_untargeted": {"": {"p_value": 0.01}}, "_noise": {"": {"p_value": 0.002}}}

    seen = []
    tassess.apply_comparisons(
        template, comparisons(),
        lambda b, c, bs, cs: seen.append(
            (bs, cs, b.word_error_rate.shape, c.num_folds, b.training_blocks)),
        VERBOSE=False,
    )
    assert seen == [("", "_untargeted", (3, 2), 3, [[1], [1, 2]]),
                    ("", "_noise", (3, 2), 3, [[1], [1, 2]])]
    got, want = comparisons(), comparisons()
    tassess.results_updater(template, got, ranks=[2, 1], VERBOSE=False)
    jassess.results_updater(template, want, ranks=[2, 1], VERBOSE=False)
    assert got == want
    assert got["_untargeted"][""]["adjusted_p_value"] == pytest.approx(0.02)
    with pytest.raises(FileNotFoundError):
        DecodingResults("", "", path=str(tmp_path / "missing"))
