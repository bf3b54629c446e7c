"""Hickle (.hkl) archive interop via h5py.

The reference toolchain persists its result archives with hickle —
HDF5 files encoding Python dicts/tuples/arrays (reference
plotters.py:51-119 ``DecodingResults`` loads
``perf_vs_training_size_*.hkl``; :2216-2221 loads ``grid_search_*.hkl``
tuples).  hickle itself is not a dependency here, but its container IS
HDF5, so pre-existing archives are readable with h5py alone.

:func:`load_hkl` reconstructs the stored Python object tolerantly
across hickle layout versions:

* dicts → HDF5 groups whose child names are the keys (hickle v4 may
  repr-quote string keys: ``"'word_error_rate'"``);
* lists/tuples → groups with index-named children (``data_0``,
  ``data_1``, …, or ``item_N``);
* the top-level object may be wrapped in a single ``data``/``data_0``
  child group (v3/v4 both do this).

:func:`save_hkl` writes the same dict/sequence/array structure back —
round-trip fixture for tests and an export path for users moving
between toolchains.

The port's own copy of ``ecog2txt_tpu/plotting/hkl.py``: an archive
either package writes, the other reads.  ``h5py`` is imported inside the
functions, so the package imports where it is absent.
"""

from __future__ import annotations

import os
import re
from typing import Any, Sequence

import numpy as np

_INDEXED = re.compile(r"^(data|item)_(\d+)$")


def _clean_key(name: str) -> str:
    """Strip hickle's repr-quoting of string keys (``"'key'"`` → ``key``)."""
    if len(name) >= 2 and name[0] == name[-1] and name[0] in "'\"":
        return name[1:-1]
    return name


def _decode(value: Any) -> Any:
    """Dataset payload → Python value (bytes → str, 0-d → scalar)."""
    if isinstance(value, bytes):
        return value.decode("utf-8")
    if isinstance(value, np.ndarray):
        if value.dtype.kind == "S":
            return value.astype(str)
        if value.dtype == object:
            return np.asarray(
                [_decode(v) for v in value.ravel()], dtype=object
            ).reshape(value.shape)
        if value.ndim == 0:
            return value[()]
    return value


def _node_to_python(node) -> Any:
    import h5py

    if isinstance(node, h5py.Dataset):
        return _decode(node[()])
    # group: indexed children → list; otherwise dict
    names = list(node.keys())
    matches = [_INDEXED.match(n) for n in names]
    if names and all(matches):
        ordered = sorted(zip(matches, names), key=lambda m: int(m[0].group(2)))
        return [_node_to_python(node[n]) for _, n in ordered]
    return {_clean_key(n): _node_to_python(node[n]) for n in names}


def _unwrap(obj: Any) -> Any:
    """Descend through hickle's single-child wrapper GROUPS (named
    ``data``/``data_0``/``hickle``).  Lists are left alone — a genuine
    top-level 1-element list must round-trip as a list."""
    while isinstance(obj, dict) and len(obj) == 1 and next(iter(obj)) in (
        "data",
        "data_0",
        "hickle",
    ):
        obj = next(iter(obj.values()))
    return obj


def load_hkl(path: str) -> Any:
    """Load a hickle HDF5 archive into Python dicts/lists/arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        names = list(f.keys())
        if names == ["data_0"]:
            # hickle v3 wraps the top object as a root data_0 child;
            # unwrap it HERE (by layout, not by value) so real
            # singleton lists survive
            obj = _node_to_python(f["data_0"])
        else:
            obj = _node_to_python(f)
    return _unwrap(obj)


def find_mapping(obj: Any, required: Sequence[str]) -> dict | None:
    """Depth-first search for a dict containing all ``required`` keys —
    robust to extra wrapper levels or tuple containers (the reference's
    own loader tolerates a legacy ``(results_dict,)`` tuple wrapping,
    plotters.py:73-75)."""
    if isinstance(obj, dict):
        if all(k in obj for k in required):
            return obj
        for v in obj.values():
            found = find_mapping(v, required)
            if found is not None:
                return found
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            found = find_mapping(v, required)
            if found is not None:
                return found
    return None


def _write_node(group, name: str, value: Any) -> None:
    if isinstance(value, dict):
        sub = group.create_group(name)
        for k, v in value.items():
            _write_node(sub, str(k), v)
        return
    if isinstance(value, (list, tuple)) and not all(
        isinstance(v, (int, float, np.integer, np.floating)) for v in value
    ):
        sub = group.create_group(name)
        for i, v in enumerate(value):
            _write_node(sub, f"data_{i}", v)
        return
    arr = np.asarray(value)
    if arr.dtype.kind in ("U", "O"):
        arr = np.asarray(
            [str(v).encode("utf-8") for v in arr.ravel()]
        ).reshape(arr.shape)
    group.create_dataset(name, data=arr)


def save_hkl(path: str, obj: Any) -> str:
    """Write ``obj`` (dict/sequence/array nesting) as an .hkl-style HDF5
    file under a top-level ``data`` group (the hickle v4 layout)."""
    import h5py

    if not path.endswith(".hkl"):
        path += ".hkl"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.attrs["HICKLE_VERSION"] = "4"
        _write_node(f, "data", obj)
    return path
