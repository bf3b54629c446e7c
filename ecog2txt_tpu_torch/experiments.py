"""Experiment sweeps: performance-vs-training-size and hyperparameter
grid search.

The reference's figure layer consumes ``perf_vs_training_size_*`` and
``grid_search_*`` archives (reference plotters.py:51-119, 2159-2257)
but the sweep scripts that produced them live outside the repo; these
runners close that loop natively:

* :func:`perf_vs_training_size` — folds × training-block-subset sweep:
  for each fold and each training-set size, re-train from scratch and
  record validation WER / accuracy / seconds of training data, writing
  the archive :mod:`plotting.results` loads.
* :func:`grid_search` — cartesian hyperparameter sweep writing the
  archive :mod:`plotting.gridsearch` loads.

Both reuse one trainer skeleton and swap datasets/configs.  Every cell
is a fresh trainer on the base trainer's device: it trains through
``fit`` (the Hopper kernels of its encoder: K1f/K1b under
``use_pallas_lstm=True``, K4f/K4b under ``'bi_grid'``, K2f/K2b/K5f/K5b in
a conformer) and assesses through ``assess`` (greedy decode with the EMA
weights).

The port's own copy of ``ecog2txt_tpu/experiments.py``: the same subsets
drawn in the same order from ``np.random.default_rng(seed)``, so the
archives' ``training_blocks`` and ``nums_seconds`` equal the JAX
package's.
"""

from __future__ import annotations

import os
from itertools import product
from typing import Any, Sequence

import numpy as np

from .plotting.gridsearch import save_grid_search
from .plotting.results import save_decoding_results
from .train import MultiSubjectTrainer


def _restricted_trainer(base: MultiSubjectTrainer, **sn_overrides):
    """Fresh trainer sharing the base's manifests/records.  ALL ctor
    kwargs are threaded through (DG/ES/RP overrides, explicit vocab
    lists and the device), so every sweep cell retrains the SAME
    experiment on the same device with only ``sn_overrides`` changed."""
    kwargs = dict(base.SN_kwargs)
    kwargs.update(sn_overrides)
    return MultiSubjectTrainer(
        base._manifest_path,
        base.subject_ids,
        text_dir=base._text_dir,
        SN_kwargs=kwargs,
        DG_kwargs=base.DG_kwargs,
        ES_kwargs=base.ES_kwargs,
        RP_kwargs=base.RP_kwargs,
        VERBOSE=False,
        seed=base.seed,
        device=base.device,
        **base.kwargs,
    )


def perf_vs_training_size(
    trainer: MultiSubjectTrainer,
    num_folds: int = 3,
    fractions: Sequence[float] = (0.25, 0.5, 1.0),
    num_epochs: int | None = None,
    suffix: str = "",
    seed: int = 0,
) -> str:
    """Train at increasing training-set sizes, ``num_folds`` times each
    with different trial subsets; write the perf-vs-training-size
    archive and return its path."""
    rng = np.random.default_rng(seed)
    s_target = len(trainer.ecog_subjects) - 1
    max_host = trainer.SN_kwargs.get("max_host_trials")
    if max_host:
        # host-memory-bounded corpus: learn trial counts/lengths from a
        # streaming probe (O(shard) memory) instead of packing the
        # whole training partition resident
        from .pipeline import LazyShardedDataset

        trainer.write_tf_records_maybe()
        probe = LazyShardedDataset(
            trainer.ecog_subjects, "training", int(max_host),
            pad_channels_to=trainer.net_config.in_channels,
            pad_time_multiple=trainer.net_config.decimation_factor,
        )
        n_trials = int(probe.num_trials[s_target])
        target_lengths = probe.trial_lengths(s_target)
        probe.close()
    else:
        full = trainer.packed_dataset("training")
        n_trials = int(full.num_trials[s_target])
        target_lengths = np.asarray(
            full.encoder_lengths[s_target][full.trial_mask[s_target]],
            np.int64,
        )
    sampling_rate = float(
        trainer.manifest.resolve("sampling_rate", default=200.0)
    )

    wers = np.full((num_folds, len(fractions)), np.nan)
    accs = np.full((num_folds, len(fractions)), np.nan)
    seconds = np.full((num_folds, len(fractions)), np.nan)
    fold_blocks = []
    for fold in range(num_folds):
        chosen_sets = []
        for fi, fraction in enumerate(fractions):
            keep = max(int(round(fraction * n_trials)), 1)
            subset = rng.choice(n_trials, size=keep, replace=False)
            chosen_sets.append(sorted(int(i) for i in subset))
            restricted = trainer.restricted_to_trials(subset)
            history = restricted.fit(
                num_epochs=num_epochs, assess=False
            )
            out = restricted.assess(["validation"])["validation"]
            wers[fold, fi] = out["word_error_rate"]
            accs[fold, fi] = out["accuracy"]
            # seconds of training speech for this cell, from the
            # lengths probed once up front (re-packing the partition
            # here would defeat max_host_trials)
            seconds[fold, fi] = float(
                target_lengths[subset].sum() / sampling_rate
            )
        fold_blocks.append(chosen_sets[-1])

    results_dir = trainer.manifest.resolve("saved_results_dir", default=".")
    subject = trainer.subject_ids[-1]
    stem = f"perf_vs_training_size_{subject}"
    if suffix:
        stem += f"_{suffix}"
    return save_decoding_results(
        os.path.join(results_dir, stem),
        wers,
        accs,
        seconds,
        training_blocks=fold_blocks,
        validation_blocks=sorted(
            trainer.target_subject.block_ids("validation")
        ),
    )


def grid_search(
    trainer: MultiSubjectTrainer,
    param_grid: dict[str, Sequence[Any]],
    num_epochs: int | None = None,
    suffix: str = "",
) -> str:
    """Cartesian sweep over SN_kwargs-style hyperparameters (e.g.
    ``{'learning_rate': [...], 'batch_size': [...]}``); records final
    validation WER per cell and writes the grid-search archive."""
    names = list(param_grid)
    values = [list(param_grid[n]) for n in names]
    shape = tuple(len(v) for v in values)
    wers = np.full(shape, np.nan)
    for idx in product(*(range(len(v)) for v in values)):
        overrides = {n: values[i][j] for i, (n, j) in enumerate(zip(names, idx))}
        sub = _restricted_trainer(trainer, **overrides)
        sub.fit(num_epochs=num_epochs, assess=False)
        out = sub.assess(["validation"])["validation"]
        wers[idx] = out["word_error_rate"]
    results_dir = trainer.manifest.resolve("saved_results_dir", default=".")
    subject = trainer.subject_ids[-1]
    stem = f"grid_search_{subject}"
    if suffix:
        stem += f"_{suffix}"
    return save_grid_search(
        os.path.join(results_dir, stem), names, values, wers
    )
