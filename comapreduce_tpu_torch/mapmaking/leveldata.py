"""Flat destriper inputs (port of the ``DestriperData`` container of
``comapreduce_tpu/mapmaking/leveldata.py``).

Only the container is ported, with the fields the band solve reads
(``groups`` for the banded noise prior): the
Level-2 HDF5 reader needs ``h5py``, which the card's machine does not
have, and the WCS / HEALPix / file bookkeeping fields serve the writers,
which are not ported yet. Arrays stay numpy on the host;
:func:`~comapreduce_tpu_torch.cli.run_destriper.solve_band` uploads them
to the device it solves on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace

__all__ = ["DestriperData"]


@dataclass
class DestriperData:
    """Flat, concatenated inputs for the destriper (``leveldata.py:68``)."""

    tod: np.ndarray            # f32[N]
    pixels: np.ndarray         # i32[N] solver ids (compact when
    #                            pixel_space.compacted)
    weights: np.ndarray        # f32[N]
    ground_ids: np.ndarray     # i32[N] — per (file, feed) group
    az: np.ndarray             # f32[N] — normalised azimuth per group
    n_groups: int
    npix: int                  # solver segment count
    sky_pixels: np.ndarray | None = None   # compact -> sky pixel id
    pixel_space: PixelSpace | None = None  # the seen-pixel dictionary
    # per ground-id group metadata in concatenation order: {"file",
    # "feed", "sample_rate", "n_samples"} (the banded noise prior reads it)
    groups: list = field(default_factory=list)

    def expand_map(self, compact_map: np.ndarray) -> np.ndarray:
        """Compact-pixel map values, aligned with ``sky_pixels``."""
        return compact_map
