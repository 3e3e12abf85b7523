"""The measurement loop: build, time, halve, memoise (port of
``comapreduce_tpu/tuning/tuner.py``).

One :meth:`Tuner.tune` call answers "which knob values win for this
(platform, device kind, shape bucket, precision)?" by timing the
caller's own programs — ``build(combo)`` returns a zero-argument thunk
that runs the real solve or stage pass once and blocks until the device
is done (``torch.cuda.synchronize()``, where the reference's thunks call
``block_until_ready``) — and writes the winner to the durable cache, so
the question is never asked twice.

A sweep's cost is bounded three ways, as in the reference: only combos
the knob space's validators accept are measured (``invalid_proposed``
counts any that reach the measurement stage without passing, and stays
0); an optional cost prior orders the grid and caps it at
``max_candidates``; and successive halving gives every survivor 1
timed repetition, the faster half 2, then 4, up to ``repeats``. A
winner must beat the default by ``min_improvement`` and hold that on an
interleaved paired re-measurement against the default, else the default
is kept. Each candidate's thunk runs once untimed first (the kernel
libraries' build and the allocator's first growth stay out of the
timed reps).
"""

from __future__ import annotations

import logging
import math
import time

from comapreduce_tpu_torch.tuning.cache import TuningCache, content_key
from comapreduce_tpu_torch.tuning.space import (SPACE_VERSION,
                                                SpaceContext,
                                                enumerate_group,
                                                validate_combo)

__all__ = ["Tuner", "registry_prior"]

logger = logging.getLogger("comapreduce_tpu_torch")


def _combo_id(combo: dict) -> str:
    return "|".join(f"{k}={combo[k]}" for k in sorted(combo))


def registry_prior(records: list, name: str = "") -> "callable":
    """A grid-pruning prior from program-registry records: the
    predicted relative cost of a combo is the matching program's
    ``bytes_accessed`` (falling back to ``flops``; the port's records,
    measured on eager calls, carry neither, so there it is the bytes
    the call held: arguments, outputs and temporaries), scaled by any
    knob that multiplies the per-dispatch working set. Returns a
    ``prior(combo) -> float | None`` for :meth:`Tuner.tune`; combos
    the registry knows nothing about rank None (measured, never
    assumed cheap)."""
    base = None
    for rec in records:
        if name and rec.get("name") != name:
            continue
        cost = (rec.get("bytes_accessed") or rec.get("flops")
                or sum(rec.get(k) or 0 for k in ("argument_bytes",
                                                 "output_bytes",
                                                 "temp_bytes")))
        if cost:
            base = min(base, float(cost)) if base else float(cost)

    def prior(combo: dict) -> float | None:
        if base is None:
            return None
        scale = 1.0
        for k in ("pair_batch", "feed_batch", "mg_smooth"):
            if k in combo:
                scale *= max(int(combo[k]), 1)
        return base * scale

    return prior


class Tuner:
    """Per-bucket knob sweeps against a durable winners cache.

    Counters (the autotune gate's observables): ``measurements`` —
    timed program runs this tuner performed; ``cache_hits`` /
    ``cache_misses`` — sweeps answered from / missing in the cache;
    ``invalid_proposed`` — combos that reached the measurement stage
    without passing validation (always 0 by construction);
    ``pruned`` — grid points dropped by the cost prior / candidate
    cap (reported per sweep record too)."""

    def __init__(self, cache: TuningCache, platform: str = "",
                 device_kind: str = "", max_candidates: int = 8,
                 repeats: int = 3, min_improvement: float = 0.05):
        self.cache = cache
        self.platform = str(platform)
        self.device_kind = str(device_kind)
        self.max_candidates = max(int(max_candidates), 1)
        self.repeats = max(int(repeats), 1)
        self.min_improvement = float(min_improvement)
        self.measurements = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.invalid_proposed = 0
        self.pruned = 0

    # -- measurement --------------------------------------------------

    def _time_once(self, thunk) -> float:
        t0 = time.perf_counter()
        thunk()
        self.measurements += 1
        return time.perf_counter() - t0

    def _best_of(self, thunk, reps: int) -> float:
        """Min-of-reps wall seconds — min, not mean: scheduling noise
        only ever adds time, so the minimum is the least-noisy
        estimate of the program's true cost."""
        return min(self._time_once(thunk) for _ in range(reps))

    # -- the sweep ----------------------------------------------------

    def tune(self, group: str, bucket, ctx: SpaceContext, build,
             default: dict, precision_id: str = "",
             candidates: list | None = None, prior=None) -> dict:
        """Measure (or recall) the winning combo for one group/bucket.

        ``build(combo)`` -> zero-arg thunk running the actual program
        once (compile cost lands outside the timed reps: the thunk is
        called once untimed as warm-up). ``default`` is the pipeline's
        untuned combo — always measured, and kept unless a candidate
        beats it beyond the noise floor. Returns the full cache
        record; its ``winner`` field is the knob dict to apply."""
        key = content_key(self.platform, self.device_kind, bucket,
                          precision_id=precision_id,
                          space_version=SPACE_VERSION, group=group)
        cached = self.cache.get(key)
        if cached is not None:
            self.cache_hits += 1
            return cached
        self.cache_misses += 1
        sweep_start = self.measurements

        if candidates is None:
            candidates = enumerate_group(group, ctx).combos
        combos = []
        for combo in candidates:
            if not validate_combo(group, combo, ctx):
                # never measured: validation is the wall the gate
                # asserts holds (invalid_proposed == 0)
                self.invalid_proposed += 1
                continue
            combos.append(dict(combo))
        if not any(c == default for c in combos):
            combos.insert(0, dict(default))

        if prior is not None and len(combos) > 1:
            ranked = sorted(combos,
                            key=lambda c: (prior(c) is None,
                                           prior(c) or 0.0))
            kept = ranked[:self.max_candidates]
            # the default must survive any prune: the noise-floor
            # comparison below is against its measured wall
            if not any(c == default for c in kept):
                kept[-1] = dict(default)
            self.pruned += len(combos) - len(kept)
            combos = kept
        elif len(combos) > self.max_candidates:
            kept = combos[:self.max_candidates]
            if not any(c == default for c in kept):
                kept[-1] = dict(default)
            self.pruned += len(combos) - len(kept)
            combos = kept

        # successive halving: 1 rep for everyone, the faster half
        # advances to doubled reps, until one combo (or the rep budget)
        # remains
        walls = {}
        pool = []
        thunks = {}
        for combo in combos:
            try:
                thunk = build(combo)
                thunk()  # warm-up: compile cost stays untimed
            except Exception as exc:
                logger.warning("tuning: candidate %s failed to "
                               "build/warm (%s: %s) — dropped",
                               _combo_id(combo), type(exc).__name__,
                               exc)
                continue
            pool.append((combo, thunk))
            thunks[_combo_id(combo)] = thunk
        reps = 1
        while pool:
            timed = []
            for combo, thunk in pool:
                wall = self._best_of(thunk, reps)
                cid = _combo_id(combo)
                walls[cid] = min(walls.get(cid, math.inf), wall)
                timed.append((wall, combo, thunk))
            timed.sort(key=lambda t: t[0])
            if len(pool) == 1 or reps >= self.repeats:
                break
            pool = [(c, th) for _, c, th in
                    timed[:max(len(timed) // 2, 1)]]
            reps = min(reps * 2, self.repeats)

        default_id = _combo_id(default)
        default_ms = walls.get(default_id)
        best_id, best_wall = None, math.inf
        best_combo = dict(default)
        for combo in combos:
            cid = _combo_id(combo)
            if cid in walls and walls[cid] < best_wall:
                best_id, best_wall = cid, walls[cid]
                best_combo = dict(combo)
        if (default_ms is not None and best_id is not None
                and best_id != default_id
                and best_wall < default_ms * (1.0
                                              - self.min_improvement)):
            # paired confirmation: a challenger that crossed the floor
            # on sweep walls must hold it on fresh INTERLEAVED reps
            # against the default — min-of-few walls overfit transient
            # scheduler noise, and a noise winner taxes every later
            # campaign that consults the cache
            for _ in range(max((self.repeats + 1) // 2, 1)):
                walls[default_id] = min(
                    walls[default_id],
                    self._time_once(thunks[default_id]))
                walls[best_id] = min(
                    walls[best_id], self._time_once(thunks[best_id]))
            default_ms = walls[default_id]
            best_wall = walls[best_id]
        winner = dict(default)
        if (default_ms is not None and best_id is not None
                and best_id != default_id
                and best_wall < default_ms * (1.0
                                              - self.min_improvement)):
            winner = best_combo

        record = {
            "key": key, "group": str(group),
            "platform": self.platform,
            "device_kind": self.device_kind, "bucket": bucket,
            "precision_id": str(precision_id),
            "space_version": SPACE_VERSION,
            "winner": winner, "default": dict(default),
            "best_ms": round(best_wall * 1e3, 4)
            if best_wall < math.inf else None,
            "default_ms": round(default_ms * 1e3, 4)
            if default_ms is not None else None,
            "candidates": len(combos),
            "measurements": self.measurements - sweep_start,
            "walls_ms": {cid: round(w * 1e3, 4)
                         for cid, w in sorted(walls.items())},
        }
        return self.cache.put(record)
