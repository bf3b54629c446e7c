"""Experiment configuration: YAML manifests + block breakdowns.

Mirrors the reference's two-file config scheme (reference README.md:32-57):

1. A per-experiment YAML *manifest* keyed by subject id, with ~45 keys
   covering paths, grid geometry, net hyperparameters, ``data_mapping``,
   vocab files, and the DataGenerator class (reference loads it with
   ``yaml.full_load`` at trainers.py:60-61, an arbitrary-code-execution
   hazard via ``!!python/name:`` tags).  Here the same files parse under a
   restricted SafeLoader subclass: ``!!python/name:`` resolves through a
   string registry and ``!!python/tuple`` builds a plain tuple — no code
   execution.

2. ``block_breakdowns.json`` — per-subject block → {type, default_dataset,
   audio, bipolar, ...} map with integer-coerced keys (reference
   subjects.py:72-74 uses a str2int JSON hook).

The reference distributes config through the ``auto_attribute(
CHECK_MANIFEST=True)`` decorator, which back-fills ``None`` ctor kwargs
from the manifest (reference README.md:42).  Here that implicit behavior
is an explicit, testable resolution rule: ``Manifest.resolve(key,
explicit, default)`` = explicit kwarg (if not None) > manifest value
(if present and not None) > default.

The port's own copy of ``ecog2txt_tpu/config.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

import json
import os
import warnings
from collections.abc import Mapping
from typing import Any, Callable

import yaml

from . import text_dir as default_text_dir

# --------------------------------------------------------------------------
# DataGenerator registry (replaces !!python/name: code execution)
# --------------------------------------------------------------------------

_GENERATOR_REGISTRY: dict[str, type] = {}
_FALLBACK_GENERATOR_NAME: str | None = None


def register_data_generator(name: str, *aliases: str) -> Callable[[type], type]:
    """Class decorator: make a DataGenerator resolvable by name from YAML."""

    def deco(cls: type) -> type:
        for key in (name, *aliases):
            _GENERATOR_REGISTRY[key] = cls
        return cls

    return deco


def set_fallback_generator(name: str) -> None:
    """Registry name used when a manifest names an unknown generator class
    (e.g. the reference's lab-private ``SpeechDataGenerator`` /
    ``BambooDataGenerator``, which are not public)."""
    global _FALLBACK_GENERATOR_NAME
    _FALLBACK_GENERATOR_NAME = name


def resolve_data_generator(spec: Any) -> type:
    """Resolve a manifest DataGenerator spec (string / _RegistryName /
    class) to a registered class."""
    if isinstance(spec, type):
        return spec
    name = str(spec)
    if name not in _GENERATOR_REGISTRY:
        # make sure the built-in generators have registered themselves
        from . import datagen  # noqa: F401
    if name in _GENERATOR_REGISTRY:
        return _GENERATOR_REGISTRY[name]
    # try the trailing class name: 'pkg.mod.SpeechDataGenerator' → last part
    short = name.rsplit(".", 1)[-1]
    if short in _GENERATOR_REGISTRY:
        return _GENERATOR_REGISTRY[short]
    if _FALLBACK_GENERATOR_NAME is not None:
        warnings.warn(
            f"DataGenerator {name!r} is not registered; substituting "
            f"{_FALLBACK_GENERATOR_NAME!r}"
        )
        return _GENERATOR_REGISTRY[_FALLBACK_GENERATOR_NAME]
    raise KeyError(
        f"DataGenerator {name!r} not registered and no fallback set; "
        f"known: {sorted(_GENERATOR_REGISTRY)}"
    )


class _RegistryName(str):
    """Marker for a ``!!python/name:`` reference parsed from YAML."""


# --------------------------------------------------------------------------
# Restricted YAML loader accepting the reference manifest files
# --------------------------------------------------------------------------


class ManifestLoader(yaml.SafeLoader):
    """SafeLoader + the three non-safe constructs reference manifests use."""


def _construct_python_name(loader: ManifestLoader, suffix: str, node) -> Any:
    # ``!!python/name:pkg.Cls ''`` — do NOT import; defer to the registry.
    return _RegistryName(suffix)


def _construct_python_tuple(loader: ManifestLoader, node) -> tuple:
    return tuple(loader.construct_sequence(node))


ManifestLoader.add_multi_constructor(
    "tag:yaml.org,2002:python/name:", _construct_python_name
)
ManifestLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple", _construct_python_tuple
)
# SafeLoader already handles !!set → set.


# --------------------------------------------------------------------------
# Manifest object
# --------------------------------------------------------------------------


class Manifest(Mapping):
    """One subject's experiment manifest: a read-only mapping with explicit
    kwarg>manifest>default resolution (the reference's ``auto_attribute``
    semantics, README.md:42, made explicit)."""

    def __init__(self, data: dict[str, Any], subject_id: int | str | None = None):
        self._data = dict(data)
        self.subject_id = subject_id

    # Mapping interface
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"Manifest(subject={self.subject_id}, {len(self._data)} keys)"

    def resolve(self, key: str, explicit: Any = None, default: Any = None) -> Any:
        """explicit kwarg (not None) > manifest value (not None) > default."""
        if explicit is not None:
            return explicit
        value = self._data.get(key)
        return default if value is None else value

    def updated(self, overrides: Mapping[str, Any]) -> "Manifest":
        data = dict(self._data)
        data.update(overrides)
        return Manifest(data, self.subject_id)


def load_experiment_manifest(
    manifest_name: str, text_dir: str | None = None
) -> dict[int, Manifest]:
    """Load a full experiment manifest file → {subject_id: Manifest}.

    The reference loads ``text_dir/manifest_name`` with ``yaml.full_load``
    (trainers.py:60-61); file layout = top-level map keyed by subject id.
    """
    text_dir = text_dir or default_text_dir
    if os.path.isabs(manifest_name) or os.path.exists(manifest_name):
        path = manifest_name
    else:
        path = os.path.join(text_dir, manifest_name)
    with open(path) as f:
        raw = yaml.load(f, Loader=ManifestLoader)
    manifest_dir = os.path.dirname(os.path.abspath(path))
    for subject_manifest in raw.values():
        # record where the manifest FILE lives: reference manifests
        # hardcode lab json_dir paths, and their block_breakdowns.json
        # ships next to the YAML (auxiliary/EFC/) — subjects fall back
        # to this directory when json_dir does not exist here
        if isinstance(subject_manifest, dict):
            subject_manifest.setdefault("manifest_dir", manifest_dir)
    return {
        subject_id: Manifest(subject_manifest, subject_id)
        for subject_id, subject_manifest in raw.items()
    }


# --------------------------------------------------------------------------
# Block breakdowns
# --------------------------------------------------------------------------


def _int_keys(pairs) -> dict:
    """JSON object hook coercing integer-like string keys to int
    (the reference's ``str2int_hook``, subjects.py:73)."""
    out = {}
    for key, value in pairs:
        try:
            key = int(key)
        except (TypeError, ValueError):
            pass
        out[key] = value
    return out


def load_block_breakdowns(json_dir: str) -> dict[int, dict[int, dict]]:
    """Load ``block_breakdowns.json``: {subject: {block: descriptor}} with
    int-coerced keys.  Descriptor schema per reference README.md:37-39:
    {type, default_dataset, audio, bipolar, [day, hour]}."""
    path = os.path.join(json_dir, "block_breakdowns.json")
    with open(path) as f:
        return json.load(f, object_pairs_hook=_int_keys)
