"""Electrode anatomy: FreeSurfer-style electrode files → labels/coords.

Rebuilds the reference's anatomy plumbing (reference plotters.py:357-464):
``anatomy_labels`` pooled into grand areas, ``electrode_locs_3D`` +
hemisphere from an ``elecmatrix``.  The lab's files are MATLAB ``.mat``
with (per the reference's access patterns) an ``elecmatrix`` (N, 3)
coordinate array and an ``anatomy`` cell array whose last column is the
FreeSurfer label per electrode.  Loading is gated on scipy.io and file
presence; everything degrades to grid coordinates when absent
(plotting/plotters.py handles that).

The port's own copy of ``ecog2txt_tpu/plotting/anatomy.py``.
"""

from __future__ import annotations

import os

import numpy as np

# FreeSurfer label → grand anatomical area (the manifest's
# anatomy_grand_list, mocha-1_word_sequence.yaml)
GRAND_AREA_POOLING = {
    "rostralmiddlefrontal": "middle frontal",
    "caudalmiddlefrontal": "middle frontal",
    "middlefrontal": "middle frontal",
    "parsopercularis": "IFG",
    "parstriangularis": "IFG",
    "parsorbitalis": "IFG",
    "precentral": "vSMC",
    "postcentral": "vSMC",
    "inferiortemporal": "inferior temporal",
    "middletemporal": "middle temporal",
    "superiortemporal": "superior temporal",
    "supramarginal": "supramarginal",
}


def _normalize(label: str) -> str:
    return label.lower().replace("ctx-", "").replace("lh-", "").replace(
        "rh-", ""
    ).replace("_", "").replace(" ", "")


def pool_label(label: str) -> str:
    return GRAND_AREA_POOLING.get(_normalize(label), label)


def load_electrode_file(path: str) -> dict:
    """Electrode ``.mat`` → {'positions': (N, 3), 'labels': [str],
    'hemisphere': 'lh'|'rh'|None}."""
    from scipy.io import loadmat

    mat = loadmat(path, squeeze_me=True, simplify_cells=True)
    out: dict = {"positions": None, "labels": [], "hemisphere": None}
    if "elecmatrix" in mat:
        positions = np.asarray(mat["elecmatrix"], float)
        out["positions"] = positions
        if len(positions):
            # hemisphere from mean x-coordinate sign (RAS convention)
            out["hemisphere"] = "lh" if positions[:, 0].mean() < 0 else "rh"
    if "anatomy" in mat:
        rows = mat["anatomy"]
        labels = []
        for row in np.atleast_1d(rows):
            if isinstance(row, (list, tuple, np.ndarray)):
                labels.append(str(np.atleast_1d(row)[-1]))
            else:
                labels.append(str(row))
        out["labels"] = [pool_label(l) for l in labels]
    return out


def anatomy_labels_from_manifest(manifest) -> dict[int, str]:
    """{electrode: grand-area label} from the manifest's
    ``electrode_path``; empty when the file is absent."""
    path = manifest.resolve("electrode_path")
    if not path or not os.path.exists(path):
        return {}
    info = load_electrode_file(path)
    return {i: label for i, label in enumerate(info["labels"])}


def electrode_locs_3D(manifest) -> np.ndarray | None:
    """(N, 3) coordinates from the electrode file, or None."""
    path = manifest.resolve("electrode_path")
    if not path or not os.path.exists(path):
        return None
    return load_electrode_file(path)["positions"]


# --------------------------------------------------------------------------
# cortical surface (degraded brain rendering)
# --------------------------------------------------------------------------


def load_cortical_mesh(manifest) -> dict | None:
    """Cortical surface mesh for on-brain electrode rendering
    (reference plotters.py:771-795 renders via img_pipe with lab mesh
    assets).  Reads the manifest's ``cortical_mesh_file``:

    * ``.npz`` with ``vertices`` (V, 3) and ``faces`` (F, 3); or
    * MATLAB ``.mat`` with a ``cortex`` struct carrying ``vert``/``tri``
      (the img_pipe/FreeSurfer export convention; ``tri`` may be
      1-indexed).

    Returns {'vertices', 'faces'} or None when unconfigured/absent.
    """
    path = manifest.resolve("cortical_mesh_file")
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {
                "vertices": np.asarray(z["vertices"], float),
                "faces": np.asarray(z["faces"], int),
            }
    from scipy.io import loadmat

    mat = loadmat(path, squeeze_me=True, simplify_cells=True)
    cortex = mat.get("cortex", mat)
    vert = np.asarray(cortex["vert"], float)
    tri = np.asarray(cortex["tri"], int)
    if tri.min() == 1:  # MATLAB 1-indexing
        tri = tri - 1
    return {"vertices": vert, "faces": tri}


def generic_pial_mesh(
    positions: np.ndarray, n_theta: int = 24, n_phi: int = 36
) -> dict:
    """Fallback surface when no lab mesh asset exists: an ellipsoid
    fitted to the electrode cloud (scaled a little beyond it), so
    on-brain contribution figures still render with spatial context —
    the degraded path for the reference's img_pipe brain rendering."""
    center = positions.mean(axis=0)
    radii = 1.15 * np.maximum(
        np.abs(positions - center).max(axis=0), 1e-3
    )
    theta = np.linspace(0, np.pi, n_theta)
    phi = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    vertices = np.stack(
        [
            center[0] + radii[0] * np.sin(tt) * np.cos(pp),
            center[1] + radii[1] * np.sin(tt) * np.sin(pp),
            center[2] + radii[2] * np.cos(tt),
        ],
        axis=-1,
    ).reshape(-1, 3)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    return {"vertices": vertices, "faces": np.asarray(faces, int)}
