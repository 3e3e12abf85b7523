"""State carried across from the reference package: the pointing plan, the
reduction config, the two-level coarse system, the multigrid hierarchy,
the banded noise prior and the destriper's flat inputs.

The port has no weights; what it must share with ``comapreduce_tpu`` to
be held against it is state. These helpers take the reference's numpy
fields (never its objects' code), so this module imports nothing of the
reference either.
"""

from __future__ import annotations

import numpy as np
import torch

from comapreduce_tpu_torch.mapmaking.leveldata import DestriperData
from comapreduce_tpu_torch.mapmaking.pixel_space import PixelSpace
from comapreduce_tpu_torch.mapmaking.pointing_plan import PointingPlan
from comapreduce_tpu_torch.ops.reduce import ReduceConfig

__all__ = ["PLAN_ARRAY_FIELDS", "PLAN_STATIC_FIELDS", "plan_from_reference",
           "plan_arrays", "reduce_config_from_reference",
           "coarse_from_reference", "multigrid_from_reference",
           "banded_from_reference", "destriper_data_from_reference"]

PLAN_ARRAY_FIELDS = ("uniq_pixels", "sample_perm", "sample_pair",
                     "sample_base", "pair_rank", "pair_offset", "rank_base",
                     "pair_perm_off", "off_base")
PLAN_STATIC_FIELDS = ("npix", "offset_length", "n_offsets", "n_rank",
                      "sample_chunk", "sample_window", "n_pairs",
                      "pair_chunk", "rank_window", "off_window",
                      "pair_batch")

DATA_ARRAY_FIELDS = ("tod", "pixels", "weights", "ground_ids", "az")

_REDUCE_MASKS = ("mask_weights", "mask_band_avg", "mask_medfilt",
                 "mask_templates")


def plan_arrays(plan) -> tuple[dict, dict]:
    """``(arrays, static)`` of any plan object with the reference's field
    names — numpy copies of the index arrays, ints for the rest."""
    arrays = {k: np.asarray(getattr(plan, k)) for k in PLAN_ARRAY_FIELDS}
    static = {k: int(getattr(plan, k)) for k in PLAN_STATIC_FIELDS}
    return arrays, static


def plan_from_reference(arrays: dict[str, np.ndarray],
                        **static) -> PointingPlan:
    """The port's :class:`PointingPlan` from the reference plan's numpy
    fields (``arrays``: the nine index arrays; ``static``: the scalar
    fields, ``pair_batch`` defaulting to 1)."""
    missing = [k for k in PLAN_ARRAY_FIELDS if k not in arrays]
    missing += [k for k in PLAN_STATIC_FIELDS
                if k not in static and k != "pair_batch"]
    if missing:
        raise ValueError(f"reference plan fields missing: {missing}")
    kw = {k: np.array(arrays[k], copy=True) for k in PLAN_ARRAY_FIELDS}
    kw.update({k: int(v) for k, v in static.items()
               if k in PLAN_STATIC_FIELDS})
    return PointingPlan(**kw)


def reduce_config_from_reference(ref_cfg) -> ReduceConfig:
    """The port's :class:`ReduceConfig` with the knobs and the four
    channel masks of a reference ``ReduceConfig`` (read by attribute)."""
    cfg = ReduceConfig(int(ref_cfg.n_channels),
                       medfilt_window=int(ref_cfg.medfilt_window),
                       is_calibrator=bool(ref_cfg.is_calibrator),
                       bandwidth=float(ref_cfg.bandwidth),
                       tau=float(ref_cfg.tau),
                       medfilt_stride=ref_cfg.medfilt_stride,
                       scan_batch=ref_cfg.scan_batch)
    for name in _REDUCE_MASKS:
        setattr(cfg, name, torch.tensor(
            np.asarray(getattr(ref_cfg, name), np.float32)))
    return cfg


def coarse_from_reference(coarse) -> tuple[np.ndarray, np.ndarray]:
    """A reference ``(grp, ac_inv)`` coarse system as numpy copies: i32
    offset -> block map and the f32 inverse (any leading band axis
    kept)."""
    grp, ac_inv = coarse
    return (np.array(grp, dtype=np.int32, copy=True),
            np.array(ac_inv, dtype=np.float32, copy=True))


def multigrid_from_reference(mg) -> tuple:
    """A reference multigrid hierarchy (``build_multigrid_hierarchy`` or
    ``stack_multigrid``) as a tuple of per-level dicts of numpy copies,
    dtypes and any leading band axis kept."""
    return tuple({k: np.array(v, copy=True) for k, v in lv.items()}
                 for lv in mg)


def banded_from_reference(banded):
    """A reference ``(c0, cs)`` banded prior (single band or stacked) as
    f32 numpy copies; ``None`` (every group white) stays ``None``."""
    if banded is None:
        return None
    return tuple(np.array(b, dtype=np.float32, copy=True) for b in banded)


def destriper_data_from_reference(ref) -> DestriperData:
    """The port's :class:`DestriperData` from a reference one (read by
    attribute): numpy copies of the five flat arrays, the counts, the
    seen-pixel dictionary of a compacted pixel space and the per-group
    metadata."""
    kw = {k: np.array(getattr(ref, k), copy=True) for k in DATA_ARRAY_FIELDS}
    space = getattr(ref, "pixel_space", None)
    if space is not None:
        space = PixelSpace(int(space.npix_sky),
                           None if space.pixels is None
                           else np.asarray(space.pixels))
    sky = getattr(ref, "sky_pixels", None)
    return DestriperData(**kw, n_groups=int(ref.n_groups),
                         npix=int(ref.npix),
                         sky_pixels=None if sky is None else np.array(sky),
                         pixel_space=space,
                         groups=[dict(g) for g in getattr(ref, "groups",
                                                          None) or []])
