"""Electrode-grid geometry and channel referencing.

Rebuilds the channel-selection machinery of the reference's
``ECoGDataGenerator`` (reference data_generators.py:103-233, 489-500) and
``SubgridParams`` (reference subjects.py:411-483):

* physical grid layout with optional striding (low-density simulation),
* bad-electrode exclusion,
* three referencing modes (common-average style "plain", field-potential
  doubling, bipolar pairs),
* rectangular subgrid selection / subsampling / occlusion masks used for
  occlusion-saliency analyses.

Everything here is plain numpy at featurization/config time.

The port's own copy of ``ecog2txt_tpu/geometry.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


def electrode_layout(
    grid_size: Sequence[int], grid_step: int = 1
) -> np.ndarray:
    """Physical electrode layout.

    Electrodes are numbered ``prod(grid_size)-1 .. 0``, reshaped to
    ``grid_size``, transposed, then strided by ``grid_step`` along both
    axes (reference data_generators.py:103-109).  ``grid_step > 1``
    simulates a lower-density grid.
    """
    grid_size = tuple(int(g) for g in grid_size)
    n = int(np.prod(grid_size))
    layout = np.arange(n - 1, -1, -1).reshape(grid_size).T
    return layout[::grid_step, ::grid_step]


def bipolar_pairs(layout: np.ndarray) -> list[tuple[int, int]]:
    """All horizontally- then vertically-adjacent electrode pairs in the
    layout (reference's nominal ``bipolar_to_elec_map``,
    data_generators.py:489-500)."""
    pairs: list[tuple[int, int]] = []
    rows, cols = layout.shape
    for r in range(rows):
        for c in range(cols - 1):
            pairs.append((int(layout[r, c]), int(layout[r, c + 1])))
    for r in range(rows - 1):
        for c in range(cols):
            pairs.append((int(layout[r, c]), int(layout[r + 1, c])))
    return pairs


def load_bad_electrodes(path: str) -> set[int]:
    """Bad-electrode file: plain text, one 1-indexed electrode per line
    (reference README.md:47); returned zero-indexed."""
    bad: set[int] = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                bad.add(int(line) - 1)
    return bad


@dataclass
class ElectrodeGrid:
    """Grid geometry + referencing → ordered channel list.

    Channel order follows the flattened layout, NOT numeric electrode
    order (reference data_generators.py:212-215) — this ordering is part
    of the TFRecord data contract and must be stable.
    """

    grid_size: Sequence[int]
    grid_step: int = 1
    bad_electrodes: set[int] = field(default_factory=set)
    USE_FIELD_POTENTIALS: bool = False
    REFERENCE_BIPOLAR: bool = False

    def __post_init__(self):
        self.grid_size = tuple(int(g) for g in self.grid_size)
        self.bad_electrodes = set(int(e) for e in self.bad_electrodes)

    @property
    def num_electrodes(self) -> int:
        return int(np.prod(self.grid_size))

    @property
    def layout(self) -> np.ndarray:
        return electrode_layout(self.grid_size, self.grid_step)

    @property
    def good_electrodes(self) -> set[int]:
        """All electrodes minus the bad set (reference
        data_generators.py:173-197)."""
        return set(range(self.num_electrodes)) - self.bad_electrodes

    @property
    def bipolar_to_elec_map(self) -> list[tuple[int, int]]:
        return bipolar_pairs(self.layout)

    @property
    def good_channels(self) -> list[int]:
        """Ordered pseudo-channel list (reference
        data_generators.py:199-229).  Three modes:

        * plain: good electrodes in flattened-layout order;
        * ``USE_FIELD_POTENTIALS``: the plain list duplicated with offset
          ``+num_electrodes`` (high-gamma + raw LFP channels);
        * ``REFERENCE_BIPOLAR``: one channel per bipolar pair whose both
          electrodes are good; channel id = pair index.
        """
        good = self.good_electrodes
        if self.REFERENCE_BIPOLAR:
            return [
                i
                for i, (a, b) in enumerate(self.bipolar_to_elec_map)
                if a in good and b in good
            ]
        ordered = [int(e) for e in self.layout.flatten() if int(e) in good]
        if self.USE_FIELD_POTENTIALS:
            return ordered + [e + self.num_electrodes for e in ordered]
        return ordered

    @property
    def num_channels(self) -> int:
        return len(self.good_channels)

    def channel_positions(self) -> dict[int, tuple[int, int]]:
        """channel id → (row, col) position in the (strided) layout.
        Bipolar channels sit at their first electrode's position."""
        layout = self.layout
        pos = {
            int(layout[r, c]): (r, c)
            for r in range(layout.shape[0])
            for c in range(layout.shape[1])
        }
        if self.REFERENCE_BIPOLAR:
            pairs = self.bipolar_to_elec_map
            return {i: pos[pairs[i][0]] for i in self.good_channels}
        m = self.num_electrodes
        return {ch: pos[ch % m] for ch in self.good_channels}


@dataclass
class SubgridParams:
    """Rectangular subgrid selection / subsampling / occlusion over the
    electrode grid → channel index list (reference subjects.py:411-483).

    ``start`` = (row, col) top-left corner in layout coordinates;
    ``extent`` = (rows, cols) size; ``step`` subsamples inside the
    subgrid; ``OCCLUDE`` inverts the selection (channels *outside* the
    subgrid — used by occlusion-saliency sweeps, reference
    plotters.py:567-646).
    """

    start: tuple[int, int] = (0, 0)
    extent: tuple[int, int] | None = None
    step: int = 1
    OCCLUDE: bool = False

    def electrode_set(self, grid: ElectrodeGrid) -> set[int]:
        layout = grid.layout
        rows, cols = layout.shape
        r0, c0 = self.start
        er, ec = self.extent if self.extent is not None else (rows, cols)
        sub = layout[r0 : r0 + er : self.step, c0 : c0 + ec : self.step]
        selected = set(int(e) for e in sub.flatten())
        if self.OCCLUDE:
            return set(int(e) for e in layout.flatten()) - selected
        return selected

    def inds(self, grid: ElectrodeGrid) -> list[int]:
        """Indices *into the channel axis* (positions within
        ``grid.good_channels``) selected by this subgrid."""
        selected = self.electrode_set(grid)
        out = []
        if grid.REFERENCE_BIPOLAR:
            pairs = grid.bipolar_to_elec_map
            for pos, ch in enumerate(grid.good_channels):
                a, b = pairs[ch]
                if a in selected and b in selected:
                    out.append(pos)
        else:
            m = grid.num_electrodes
            for pos, ch in enumerate(grid.good_channels):
                if ch % m in selected:
                    out.append(pos)
        return out

    def channel_mask(self, grid: ElectrodeGrid) -> np.ndarray:
        """Boolean keep-mask over channels — the fixed-shape form of
        ``inds`` (static shape; multiply instead of gather)."""
        mask = np.zeros(grid.num_channels, dtype=bool)
        mask[self.inds(grid)] = True
        return mask
