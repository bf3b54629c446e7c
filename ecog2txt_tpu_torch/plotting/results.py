"""Decoding-results archives.

Rebuilds the reference's results persistence (reference
plotters.py:51-119, 1578-1592): ``DecodingResults`` loads
``perf_vs_training_size_{subject}_{suffix}`` archives with
``training_blocks``, ``validation_blocks`` and fold×datasize matrices of
``word_error_rate`` / ``accuracy`` / ``nums_seconds``; ``ResultsMatrix``
provides nan-aware mean/stderr across folds.

The reference stores these as hickle (HDF5) files; the native container
here is ``.npz`` (numpy archive, same keys), but pre-existing ``.hkl``
archives from the reference toolchain load too (via h5py —
:mod:`plotting.hkl`), with the reference's own normalization applied
(flattened fold×datasize entries reshaped by the number of distinct
training-set sizes, reference plotters.py:77-99).  Loading falls back
to pickle for old archives.

The port's own copy of ``ecog2txt_tpu/plotting/results.py``, with the
same constructor (``DecodingResults(saved_results_dir, subject, suffix,
path=None)``) and loaders.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Sequence

import numpy as np


class ResultsMatrix(np.ndarray):
    """(N_folds, N_datasizes) matrix with nan-aware statistics
    (reference plotters.py:1578-1592)."""

    def __new__(cls, data):
        return np.asarray(data, dtype=float).view(cls)

    @property
    def mean_across_folds(self) -> np.ndarray:
        return np.nanmean(np.asarray(self), axis=0)

    @property
    def stderr_across_folds(self) -> np.ndarray:
        a = np.asarray(self)
        n = np.sum(~np.isnan(a), axis=0).clip(min=1)
        return np.nanstd(a, axis=0, ddof=0) / np.sqrt(n)


_MATRIX_KEYS = ("word_error_rate", "accuracy", "nums_seconds")


def save_decoding_results(
    path: str,
    word_error_rate: np.ndarray,
    accuracy: np.ndarray,
    nums_seconds: np.ndarray,
    training_blocks: Sequence[Sequence[int]],
    validation_blocks: Sequence[int],
) -> str:
    """Write a perf-vs-training-size archive (npz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(
        path,
        word_error_rate=np.asarray(word_error_rate, float),
        accuracy=np.asarray(accuracy, float),
        nums_seconds=np.asarray(nums_seconds, float),
        training_blocks=np.asarray(
            [",".join(map(str, b)) for b in training_blocks], dtype=object
        ),
        validation_blocks=np.asarray(list(validation_blocks)),
        allow_pickle=True,
    )
    return path


class DecodingResults:
    """Load a perf-vs-training-size archive (reference
    plotters.py:51-119): ``perf_vs_training_size_{subject}_{suffix}``
    under ``saved_results_dir``."""

    def __init__(
        self,
        saved_results_dir: str,
        subject: int | str,
        suffix: str = "",
        path: str | None = None,
    ):
        if path is None:
            stem = f"perf_vs_training_size_{subject}"
            if suffix:
                stem += f"_{suffix}"
            path = os.path.join(saved_results_dir, stem)
        data = self._load(path)
        self.training_blocks = data["training_blocks"]
        self.validation_blocks = list(data["validation_blocks"])
        self.word_error_rate = ResultsMatrix(data["word_error_rate"])
        self.accuracy = ResultsMatrix(data["accuracy"])
        self.nums_seconds = ResultsMatrix(data["nums_seconds"])

    @staticmethod
    def _load(path: str) -> dict[str, Any]:
        for candidate in (path, path + ".npz", path + ".hkl", path + ".pkl"):
            if not os.path.exists(candidate):
                continue
            if candidate.endswith(".pkl"):
                with open(candidate, "rb") as f:
                    return pickle.load(f)
            if candidate.endswith(".hkl"):
                return DecodingResults._load_hkl(candidate)
            with np.load(candidate, allow_pickle=True) as z:
                out = {k: z[k] for k in z.files}
            out["training_blocks"] = [
                [int(x) for x in str(s).split(",") if x]
                for s in out["training_blocks"]
            ]
            return out
        raise FileNotFoundError(
            f"no results archive at {path}(.npz|.hkl|.pkl)"
        )

    @staticmethod
    def _load_hkl(path: str) -> dict[str, Any]:
        """Reference-toolchain hickle archive → the dict this class
        consumes, applying the reference's normalization (reference
        plotters.py:73-99): a legacy tuple wrapper is unwrapped,
        flattened fold×datasize entries are reshaped by the number of
        distinct training-block-set sizes, and 2-D result entries keep
        their final column."""
        from .hkl import find_mapping, load_hkl

        raw = load_hkl(path)
        data = find_mapping(raw, _MATRIX_KEYS + ("training_blocks",))
        if data is None:
            raise ValueError(
                f"{path}: no mapping with keys {_MATRIX_KEYS} found"
            )
        blocks = list(data["training_blocks"])
        n_datasizes = max(
            len({len(np.atleast_1d(b)) for b in blocks}), 1
        )
        out: dict[str, Any] = {
            "training_blocks": [
                [int(x) for x in np.atleast_1d(b)]
                for b in np.asarray(blocks, dtype=object).reshape(-1)
            ],
            # flat list OR per-(fold,datasize) lists — either way, the
            # distinct validation block ids
            "validation_blocks": sorted(
                {
                    int(x)
                    for entry in np.asarray(
                        data["validation_blocks"], dtype=object
                    ).ravel()
                    for x in np.atleast_1d(entry)
                }
            ),
        }
        for key in _MATRIX_KEYS:
            matrix = np.asarray(data[key], float)
            if matrix.ndim == 2 and matrix.shape[1] != n_datasizes:
                matrix = matrix[:, -1]  # legacy per-epoch columns
            out[key] = matrix.reshape(-1, n_datasizes)
        return out

    @property
    def num_folds(self) -> int:
        return self.word_error_rate.shape[0]

    @property
    def num_datasizes(self) -> int:
        return self.word_error_rate.shape[1]

    def summary(self) -> dict[str, np.ndarray]:
        return {
            "training_minutes": self.nums_seconds.mean_across_folds / 60.0,
            "wer_mean": self.word_error_rate.mean_across_folds,
            "wer_stderr": self.word_error_rate.stderr_across_folds,
            "accuracy_mean": self.accuracy.mean_across_folds,
        }
