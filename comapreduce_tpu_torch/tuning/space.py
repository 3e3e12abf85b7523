"""The declarative knob space the autotuner sweeps (port of
``comapreduce_tpu/tuning/space.py``).

Every free performance knob with its candidate values and its validity
rule, the rule calling the port's own validators:

- ``feed_batch`` (group ``stage``): stage feed chunks, valid when
  :func:`~comapreduce_tpu_torch.ops.reduce.plan_stage_feed_batch` keeps
  the candidate as it is and :func:`~comapreduce_tpu_torch.ops.reduce.
  plan_reduce_memory` accepts it with some scan streaming;
- ``pair_batch`` (group ``plan``): merged pair chunks of the pointing
  plan, valid when the merged plan builds at the bucket and K3 and K4
  take every launch on its layouts (:func:`_valid_pair_batch`);
- ``mg_block`` / ``mg_smooth`` (group ``solver``): the multigrid
  ladder, valid under ``destriper._check_precond``, the config layer's
  ranges (``mg_block >= 2``, ``mg_smooth >= 1``) and the
  ladder-buildability bound (a block at least the offset count has no
  coarse level);
- ``kernels`` (group ``solver``): the binning implementation.

Differences from the reference's space, each because the port's
validator says so (the grids themselves are the reference's):

- ``pair_batch``: the reference keeps the candidates whose merged
  one-hot block (chunk x window, f32) fits its MXU budget; the card has
  no one-hot, so the port keeps those its kernels' wrappers take
  (:func:`_valid_pair_batch`), every candidate below two billion
  samples.
- ``kernels``: the only value is ``"auto"``, the one ``[Destriper]
  kernels`` value the map-maker's CLI accepts (``_refuse_kernels``: the
  port runs its CUDA kernels); the reference's ``xla`` / ``pallas`` are
  invalid. The ``solver`` grid never sweeps it (the reference sweeps it
  on a TPU only), so the grid is mg_block x mg_smooth on every device,
  as the reference's is off the TPU.

``SPACE_VERSION`` and the cache-key derivation are the reference's byte
for byte, so a winner of one package keys the same in the other; its
values are applied only where the port's validators accept them.
:func:`enumerate_group` yields valid combos only and counts what it
filtered.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SPACE_VERSION", "SpaceContext", "SpaceResult",
           "enumerate_group", "plan_bucket", "solver_bucket",
           "stage_bucket", "validate_combo"]

SPACE_VERSION = 1

#: candidate grids per knob (the reference's, but ``kernels``: the one
#: value the port runs)
CANDIDATES = {
    "feed_batch": (1, 2, 4, 8, 19),
    "pair_batch": (1, 2, 4, 8),
    "mg_block": (8, 16, 32),
    "mg_smooth": (1, 2),
    "kernels": ("auto",),
}

GROUPS = ("stage", "plan", "solver")


@dataclasses.dataclass(frozen=True)
class SpaceContext:
    """The shape/backend facts validity is judged against — one bucket
    of one campaign. Axes default to 0 = "not constrained" so each
    group only needs its own geometry filled in."""

    F: int = 0           # feeds
    B: int = 0           # bands
    C: int = 0           # channels
    T: int = 0           # samples per scan axis (stage group)
    S: int = 0           # scans
    L: int = 0           # padded scan-block / offset length
    n_samples: int = 0   # flat destriper sample count (plan group)
    offset_length: int = 0
    n_arrays: int = 1
    platform: str = ""
    hbm_bytes: int = 0   # 0 = ask device_hbm_bytes()


@dataclasses.dataclass
class SpaceResult:
    combos: list
    invalid_filtered: int


def stage_bucket(F: int, B: int, C: int, T: int,
                 n_arrays: int = 1) -> dict:
    """The stage group's cache-key bucket (the feed-batched program's
    shape identity)."""
    return {"group": "stage", "F": int(F), "B": int(B), "C": int(C),
            "T": int(T), "n_arrays": int(n_arrays)}


def plan_bucket(n_samples: int, offset_length: int) -> dict:
    """The plan group's cache-key bucket: the pointing plan's flat
    sample count and offset length (the two axes the merged one-hot
    geometry depends on)."""
    return {"group": "plan", "N": int(n_samples),
            "L": int(offset_length)}


def solver_bucket(offset_length: int, n_samples: int = 0) -> dict:
    """The solver group's cache-key bucket. ``n_samples`` may be 0 at
    config time (the destriper CLI keys on offset length before any
    file is read); sweeps that know the flat length include it."""
    out = {"group": "solver", "L": int(offset_length)}
    if n_samples:
        out["N"] = int(n_samples)
    return out


def _hbm(ctx: SpaceContext) -> int:
    from comapreduce_tpu_torch.ops.reduce import device_hbm_bytes

    return int(ctx.hbm_bytes) or device_hbm_bytes()


def _valid_feed_batch(fb: int, ctx: SpaceContext) -> bool:
    """Valid iff the stage planner keeps ``fb`` as it is and the
    reduction planner accepts it with some scan streaming."""
    from comapreduce_tpu_torch.ops.reduce import (plan_reduce_memory,
                                                  plan_stage_feed_batch)

    if ctx.F and fb > ctx.F:
        return False
    hbm = _hbm(ctx)
    kept = plan_stage_feed_batch(ctx.F or fb, ctx.B, ctx.C, ctx.T,
                                 requested=fb, n_arrays=ctx.n_arrays,
                                 hbm_bytes=hbm)
    if kept != fb:
        return False
    if ctx.S and ctx.L:
        try:
            plan_reduce_memory(fb, ctx.B, ctx.C, ctx.T, ctx.S, ctx.L,
                               scan_batch=None, hbm_bytes=hbm)
        except ValueError:
            return False
    return True


def _valid_pair_batch(pb: int, ctx: SpaceContext, pair_chunk: int = 4096,
                      sample_chunk: int = 8192) -> bool:
    """The port's rule: ``build_pointing_plan(..., pair_batch=pb)`` (its
    default chunks) builds at the bucket's ``N`` and ``L``, and every K3
    and K4 launch on that plan's layouts is one their wrappers take.

    - The plan builds when ``pb >= 1`` and ``L`` divides ``N``
      (``mapmaking/pointing_plan.py:185``).
    - K3's one-pass body, which every plan site takes, refuses ``M >=
      2**31 - 2 x ONE_PASS_TILE`` elements (``mapmaking/cuda_binning.py:
      150``). ``M`` is ``N`` padded to ``sample_chunk`` at the pair sums
      and the pair count padded to the merged chunk ``pair_chunk x pb``
      at the rank and offset sums; a plan has at most ``N`` pairs.
    - K4, the ground route's gather over the same padded pairs, refuses
      ``M > 2**31 - 1`` (``mapmaking/cuda_binning.py:242``), which K3's
      limit implies.
    - Neither places a limit on a window: K3's one-pass body tests
      ``id - base < window`` unsigned (``csrc/binned_window_sum.cu:548``)
      and K4 clamps each chunk's start (``csrc/windowed_gather.cu:38``).

    ``N = 0`` (not constrained) keeps every candidate. The reference's
    one-hot budget (``tuning/space.py:143``) bounds an MXU block, which
    the card does not have."""
    from comapreduce_tpu_torch.mapmaking.cuda_binning import ONE_PASS_TILE
    from comapreduce_tpu_torch.mapmaking.pointing_plan import _round_up

    pb, n, L = int(pb), int(ctx.n_samples), int(ctx.offset_length)
    if pb < 1:
        return False
    if not n:
        return True
    if L and n % L:
        return False
    k3_max = 2 ** 31 - 2 * ONE_PASS_TILE
    return (_round_up(n, sample_chunk) < k3_max
            and _round_up(n, pair_chunk * pb) < k3_max)


def _valid_solver(combo: dict, ctx: SpaceContext) -> bool:
    """The destriper's preconditioner rule, the config layer's mg ranges,
    the ladder-buildability bound, and ``kernels = auto``."""
    from comapreduce_tpu_torch.mapmaking.destriper import _check_precond

    mg_block = int(combo.get("mg_block", 8))
    mg_smooth = int(combo.get("mg_smooth", 1))
    if mg_block < 2 or mg_smooth < 1:
        return False
    mg = {"levels": 2, "smooth": mg_smooth, "block": mg_block}
    try:
        _check_precond("jacobi", coarse=None, mg=mg)
    except ValueError:
        return False
    if ctx.n_samples and ctx.offset_length:
        n_offsets = ctx.n_samples // max(ctx.offset_length, 1)
        if mg_block >= max(n_offsets, 2):
            return False  # no coarse level to build
    return str(combo.get("kernels", "auto")) in CANDIDATES["kernels"]


def validate_combo(group: str, combo: dict, ctx: SpaceContext) -> bool:
    """True iff ``combo`` passes the group's validity rules (the rule the
    tuner re-checks before measuring anything)."""
    if group == "stage":
        return _valid_feed_batch(int(combo.get("feed_batch", 1)), ctx)
    if group == "plan":
        return _valid_pair_batch(int(combo.get("pair_batch", 1)), ctx)
    if group == "solver":
        return _valid_solver(combo, ctx)
    raise ValueError(f"unknown tuning group {group!r} "
                     f"(groups: {list(GROUPS)})")


def enumerate_group(group: str, ctx: SpaceContext) -> SpaceResult:
    """All valid candidate combos of one group at one bucket, and the
    count of grid points the rules filtered."""
    if group == "stage":
        grid = [{"feed_batch": fb} for fb in CANDIDATES["feed_batch"]]
    elif group == "plan":
        grid = [{"pair_batch": pb} for pb in CANDIDATES["pair_batch"]]
    elif group == "solver":
        grid = [{"mg_block": b, "mg_smooth": s}
                for b in CANDIDATES["mg_block"]
                for s in CANDIDATES["mg_smooth"]]
    else:
        raise ValueError(f"unknown tuning group {group!r} "
                         f"(groups: {list(GROUPS)})")
    combos = [g for g in grid if validate_combo(group, g, ctx)]
    return SpaceResult(combos=combos,
                       invalid_filtered=len(grid) - len(combos))
