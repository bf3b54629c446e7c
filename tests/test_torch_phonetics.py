"""The port's phonetic feature tables held to the JAX package's.

``consonant_df`` and ``vowel_df`` (pandas, built on first access) equal
the JAX DataFrames column by column, ``ARPABET_PHONEMES`` is equal,
``phoneme_features`` agrees for every phoneme and raises ``KeyError`` for
an unknown one, and importing the port leaves pandas unimported.
"""

import os
import subprocess
import sys

import pandas as pd
import pytest

import ecog2txt_tpu as jax_pkg
import ecog2txt_tpu_torch as port
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["consonant_df", "vowel_df"])
def test_tables_equal_jax(name):
    got, want = getattr(port, name), getattr(jax_pkg, name)
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want)
    assert getattr(port, name) is got  # built once


def test_arpabet_inventory_equals_jax():
    assert port.ARPABET_PHONEMES == jax_pkg.ARPABET_PHONEMES
    assert isinstance(port.ARPABET_PHONEMES, tuple)


@pytest.mark.parametrize("phoneme", jax_pkg.ARPABET_PHONEMES)
def test_phoneme_features_equal_jax(phoneme):
    got, want = port.phoneme_features(phoneme), jax_pkg.phoneme_features(phoneme)
    assert got == want and list(got) == list(want)


def test_unknown_phoneme_raises():
    with pytest.raises(KeyError, match="XX"):
        port.phoneme_features("XX")
    with pytest.raises(AttributeError):
        port.not_a_table  # noqa: B018


def test_import_does_not_import_pandas():
    code = (
        "import sys\n"
        "import ecog2txt_tpu_torch as p\n"
        "assert 'pandas' not in sys.modules, 'pandas imported'\n"
        "assert p.phoneme_features('AA') == {'F1': 768, 'F2': 1333, 'arpabet': 'AA'}\n"
        "assert 'pandas' not in sys.modules, 'pandas imported'\n"
        "assert len(p.consonant_df) == 24 and 'pandas' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
