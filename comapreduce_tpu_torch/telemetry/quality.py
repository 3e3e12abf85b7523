"""Per-(file, feed, band) data-quality ledger + declarative SLO rules (a
copy of ``comapreduce_tpu/telemetry/quality.py``: the same records, sealed
the same way, so each package reads the other's ledger).

The reference pipeline's data-selection criteria (COMAP Early Science
III: per-scan Tsys, 1/f knee/alpha, spike rates) are computed by
``ops/power.py`` / ``ops/spikes.py`` but — before this module — never
ledgered, thresholded, or trended. Here the Runner assembles one
**quality record** per (file, feed, band) after a file's stage chain
completes, appends it to ``quality.rank{r}.jsonl`` (the quarantine
ledger's torn-line-safe append discipline), and evaluates it against
the declarative ``[quality]``/``[slo]`` config tables. Records that
violate an SLO rule are *flagged*: an ``alert`` telemetry counter
fires (visible on the live ``/metrics`` plane and in
``campaign_report``), and ``run_destriper`` can exclude flagged files
like quarantines behind ``[slo] exclude_flagged`` (default OFF — the
science decision to drop data is the operator's, the pipeline only
makes it one knob away).

Record schema (one JSON object per line)::

    {"schema": 1, "file": "comap-0001.hd5", "feed": 0, "band": 1,
     "t": "2026-08-05T07:00:00Z", "rank": 0,
     "precision": "tod=bfloat16|accum=float32|cgdot=compensated",
     "tsys_k": 41.2, "gain": 0.031, "noise_model": "knee",
     "white_sigma": 0.0021, "fknee_hz": 0.9, "alpha": -1.6,
     "n_spikes": 3, "spike_fraction": 0.0002,
     "nonfinite_fraction": 0.0, "masked_fraction": 0.0,
     "n_samples": 600, "flags": [], "flagged": false}

Missing inputs are ``None`` fields, never errors — a minimal stage
chain still yields records carrying whatever science signals it
computed. ``precision`` is the run's precision-policy id
(docs/OPERATIONS.md §15) so a quality trend is attributable to a
numerics change. Reading is latest-wins per (file, feed, band) across
every rank's file, exactly like the quarantine ledger.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import os
import re
import time

import numpy as np

from comapreduce_tpu_torch.telemetry.core import TELEMETRY

__all__ = ["QualityConfig", "SloConfig", "append_quality",
           "assemble_quality_records", "emit_alerts", "evaluate_record",
           "flag_counts", "flagged_files", "masked_from_ledger",
           "quality_path", "read_quality", "worst_feeds"]

logger = logging.getLogger("comapreduce_tpu_torch")

QUALITY_SCHEMA = 1

_QUALITY_RE = re.compile(r"quality\.rank(\d+)\.jsonl$")


def _bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


class QualityConfig:
    """The ``[quality]`` config table: record assembly on/off.

    - ``enabled``  bool, default True — assembling a handful of
      reductions per file is cheap next to the stage chain, and the
      ledger is the input to every downstream SLO/trend feature, so it
      is on by default (unlike telemetry, which is opt-in).

    ``coerce`` rejects unknown keys like every other config table.
    """

    KNOBS = ("enabled",)

    __slots__ = KNOBS

    def __init__(self, enabled: bool = True):
        self.enabled = _bool(enabled)

    @classmethod
    def coerce(cls, value) -> "QualityConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        unknown = set(value) - set(cls.KNOBS)
        if unknown:
            raise ValueError(
                f"unknown [quality] option(s) {sorted(unknown)}; "
                f"valid: {list(cls.KNOBS)}")
        return cls(**dict(value))

    def __repr__(self) -> str:
        return f"QualityConfig(enabled={self.enabled})"


class SloConfig:
    """The ``[slo]`` table: declarative thresholds over quality records.

    Every threshold is OFF at ``0`` except ``max_masked_fraction``,
    whose default (1 %) encodes the one rule that should never need
    opting into: a feed whose samples were zero-weighted (or arrived
    non-finite) beyond the percent level is reduction-damaged, not
    science. Rule names (the ``flags`` vocabulary):

    ====================  =============================================
    ``tsys_high``         mean vane Tsys above ``max_tsys_k``
    ``tsys_low``          mean vane Tsys below ``min_tsys_k``
    ``white_sigma_high``  fitted white-noise sigma above
                          ``max_white_sigma``
    ``fknee_high``        fitted 1/f knee above ``max_fknee_hz``
    ``spike_high``        spike fraction above ``max_spike_fraction``
    ``masked_high``       max(masked, non-finite) fraction above
                          ``max_masked_fraction``
    ====================  =============================================

    ``exclude_flagged`` (default False) lets ``run_destriper`` drop
    flagged files from the filelist like quarantines.
    """

    KNOBS = ("max_tsys_k", "min_tsys_k", "max_white_sigma",
             "max_fknee_hz", "max_spike_fraction",
             "max_masked_fraction", "exclude_flagged")

    __slots__ = KNOBS

    def __init__(self, max_tsys_k: float = 0.0, min_tsys_k: float = 0.0,
                 max_white_sigma: float = 0.0,
                 max_fknee_hz: float = 0.0,
                 max_spike_fraction: float = 0.0,
                 max_masked_fraction: float = 0.01,
                 exclude_flagged: bool = False):
        self.max_tsys_k = float(max_tsys_k)
        self.min_tsys_k = float(min_tsys_k)
        self.max_white_sigma = float(max_white_sigma)
        self.max_fknee_hz = float(max_fknee_hz)
        self.max_spike_fraction = float(max_spike_fraction)
        self.max_masked_fraction = float(max_masked_fraction)
        self.exclude_flagged = _bool(exclude_flagged)

    @classmethod
    def coerce(cls, value) -> "SloConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        unknown = set(value) - set(cls.KNOBS)
        if unknown:
            raise ValueError(
                f"unknown [slo] option(s) {sorted(unknown)}; "
                f"valid: {list(cls.KNOBS)}")
        return cls(**dict(value))

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)}" for k in self.KNOBS)
        return f"SloConfig({body})"


def evaluate_record(rec: dict, slo: SloConfig) -> list:
    """Rule names violated by one record (None fields never fire — an
    absent signal is not evidence of a bad one)."""
    flags = []

    def over(value, limit) -> bool:
        return limit > 0 and value is not None and value > limit

    if over(rec.get("tsys_k"), slo.max_tsys_k):
        flags.append("tsys_high")
    if slo.min_tsys_k > 0 and rec.get("tsys_k") is not None \
            and rec["tsys_k"] < slo.min_tsys_k:
        flags.append("tsys_low")
    if over(rec.get("white_sigma"), slo.max_white_sigma):
        flags.append("white_sigma_high")
    if over(rec.get("fknee_hz"), slo.max_fknee_hz):
        flags.append("fknee_high")
    if over(rec.get("spike_fraction"), slo.max_spike_fraction):
        flags.append("spike_high")
    damaged = max(rec.get("masked_fraction") or 0.0,
                  rec.get("nonfinite_fraction") or 0.0)
    if slo.max_masked_fraction > 0 and damaged > slo.max_masked_fraction:
        flags.append("masked_high")
    return flags


def masked_from_ledger(ledger, filename: str) -> dict:
    """``(feed, band) -> n_masked`` for one file from the quarantine
    ledger's ``masked`` dispositions (``record_masked``'s message is
    ``"{n} non-finite sample(s) zero-weighted"``; its unit carries
    feed/band when the scrub was per-feed). A row without feed/band
    lands under the ``None`` key and applies file-wide. Max on
    collision: re-runs re-ledger the same scrub, they don't add to it.
    """
    base = os.path.basename(filename)
    out: dict = {}
    for e in getattr(ledger, "entries", ()):
        if e.disposition != "masked":
            continue
        unit = e.unit or {}
        if os.path.basename(str(unit.get("file", ""))) != base:
            continue
        m = re.match(r"\s*(\d+)", str(e.message))
        if not m:
            continue
        n = int(m.group(1))
        feed, band = unit.get("feed"), unit.get("band")
        key = (int(feed), int(band)) \
            if feed is not None and band is not None else None
        out[key] = max(out.get(key, 0), n)
    return out


# -- assembly ----------------------------------------------------------------

def _finite_mean(a) -> float | None:
    a = np.asarray(a, dtype=np.float64)
    good = np.isfinite(a) & (a != 0.0)
    if not good.any():
        return None
    return float(a[good].mean())


def _noise_fit(level2, ifeed: int, iband: int):
    """``(model, white_sigma, fknee_hz, alpha)`` from whichever noise
    fit the stage chain wrote: ``noise_statistics`` (knee model,
    params ``[sig2, fknee, alpha]``) preferred over ``fnoise_fits``
    (red-noise model ``sig2 + red2 |nu|^alpha``, whose knee is derived
    as ``(sig2/red2)^(1/alpha)``). Scan axis is nan-mean-reduced
    (unfittable scans are NaN rows by contract)."""
    for group, model in (("noise_statistics", "knee"),
                         ("fnoise_fits", "red_noise")):
        key = f"{group}/fnoise_fit_parameters"
        if key not in level2:
            continue
        params = np.asarray(level2[key], dtype=np.float64)
        if params.ndim != 4 or ifeed >= params.shape[0] \
                or iband >= params.shape[1]:
            continue
        p = params[ifeed, iband]  # (S, 3)
        good = np.isfinite(p).all(axis=-1)
        if not good.any():
            return model, None, None, None
        sig2, p1, alpha = (float(v) for v in p[good].mean(axis=0))
        sigma = float(np.sqrt(sig2)) if sig2 >= 0 else None
        if model == "knee":
            fknee = abs(p1)
        else:
            # sig2 = red2 |fknee|^alpha at the knee
            fknee = (abs(sig2 / p1) ** (1.0 / alpha)
                     if p1 != 0 and sig2 > 0 and alpha != 0 else None)
        return model, sigma, fknee, alpha
    return None, None, None, None


def assemble_quality_records(level2, filename: str, *, rank: int = 0,
                             precision_id: str = "",
                             masked: dict | None = None) -> list:
    """One record per (feed, band) of a finished file.

    ``masked`` maps ``(feed, band) -> n_masked_samples`` from the
    scrub ledger events (``disposition == "masked"``); a ``None`` key
    applies file-wide. Signals the stage chain did not compute are
    ``None`` fields.
    """
    try:
        tod = np.asarray(level2.tod)
    except (KeyError, AttributeError):
        return []
    if tod.ndim != 3:
        return []
    F, B, T = tod.shape
    masked = masked or {}

    tsys_m = gain_m = None
    if "vane/system_temperature" in level2:
        # lazy import: pipeline.stages imports the telemetry package
        from comapreduce_tpu_torch.pipeline.stages import mean_vane_tsys_gain

        try:
            tsys_m, gain_m = mean_vane_tsys_gain(level2)
        except (KeyError, ValueError):
            tsys_m = gain_m = None

    spikes = None
    if "spikes/spike_mask" in level2:
        spikes = np.asarray(level2["spikes/spike_mask"])

    t_iso = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    base = os.path.basename(filename)
    records = []
    for f in range(F):
        for b in range(B):
            model, sigma, fknee, alpha = _noise_fit(level2, f, b)
            n_spk = None
            if spikes is not None and f < spikes.shape[0] \
                    and b < spikes.shape[1]:
                n_spk = int(np.count_nonzero(spikes[f, b]))
            n_masked = masked.get((f, b), masked.get(None, 0))
            records.append({
                "schema": QUALITY_SCHEMA,
                "file": base, "feed": f, "band": b, "t": t_iso,
                "rank": int(rank), "precision": precision_id,
                "tsys_k": (_finite_mean(tsys_m[f, b])
                           if tsys_m is not None else None),
                "gain": (_finite_mean(gain_m[f, b])
                         if gain_m is not None else None),
                "noise_model": model, "white_sigma": sigma,
                "fknee_hz": fknee, "alpha": alpha,
                "n_spikes": n_spk,
                "spike_fraction": (n_spk / T if n_spk is not None and T
                                   else None),
                "nonfinite_fraction": float(
                    np.mean(~np.isfinite(tod[f, b]))),
                "masked_fraction": (n_masked / T if T else 0.0),
                "n_samples": T,
            })
    return records


def emit_alerts(records: list) -> int:
    """Fire one ``quality.alert`` telemetry counter (+ a log line) per
    flagged record; returns the alert count. No-op with telemetry
    disabled beyond the log lines — the ledger itself is the durable
    evidence either way."""
    n = 0
    for rec in records:
        if not rec.get("flagged"):
            continue
        n += 1
        rules = ",".join(rec.get("flags", ()))
        logger.warning(
            "QUALITY ALERT %s feed %s band %s: %s", rec.get("file"),
            rec.get("feed"), rec.get("band"), rules)
        TELEMETRY.counter("quality.alert", 1, file=rec.get("file", ""),
                          feed=rec.get("feed"), band=rec.get("band"),
                          rules=rules)
    if records:
        TELEMETRY.counter("quality.records", len(records))
    return n


# -- persistence (the quarantine ledger's append discipline) -----------------

def quality_path(directory: str, rank: int) -> str:
    return os.path.join(directory or ".",
                        f"quality.rank{int(rank)}.jsonl")


def append_quality(path: str, records: list) -> None:
    """Torn-line-safe append: heal a crashed writer's trailing stump
    with a newline first (the stump stays; the reader drops it), then
    append + flush + fsync — identical discipline to
    ``resilience/ledger.py``. I/O failures are logged and swallowed:
    quality bookkeeping must never kill the run."""
    if not records:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        needs_nl = False
        try:
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_nl = f.read(1) != b"\n"
        except OSError:
            pass
        from comapreduce_tpu_torch.resilience.integrity import seal_line

        payload = "".join(seal_line(r) + "\n" for r in records)
        with open(path, "a", encoding="utf-8") as f:
            f.write(("\n" if needs_nl else "") + payload)
            f.flush()
            os.fsync(f.fileno())
    except OSError as exc:
        logger.warning("quality ledger append to %s failed (%s: %s)",
                       path, type(exc).__name__, exc)


def read_quality(source) -> list:
    """All quality records, latest-wins per (file, feed, band).

    ``source``: a state directory (every ``quality.rank*.jsonl`` in
    it), one path, or a list of paths. Torn lines are dropped like
    every JSONL reader here; so are lines failing their embedded
    ``_sha256`` seal (a rotted flag flipping a file in or out of the
    destriper's exclusion set is a map-level corruption, not a
    bookkeeping blip) — ``python -m
    comapreduce_tpu_torch.cli.campaign_fsck --repair`` rewrites the file
    without them."""
    from comapreduce_tpu_torch.resilience.integrity import check_line

    if isinstance(source, (list, tuple)):
        paths = [str(p) for p in source]
    elif os.path.isdir(source):
        paths = sorted(_glob.glob(os.path.join(source,
                                               "quality.rank*.jsonl")))
    else:
        paths = [str(source)]
    latest: dict = {}
    corrupt = 0
    for path in paths:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                text = line.decode("utf-8")
            except UnicodeDecodeError:
                continue
            rec, verdict = check_line(text)
            if rec is None:
                if verdict is False and b"_sha256" in line:
                    corrupt += 1
                continue
            if not isinstance(rec, dict) or "file" not in rec:
                continue
            key = (rec.get("file"), rec.get("feed"), rec.get("band"))
            prev = latest.get(key)
            if prev is None or str(rec.get("t", "")) >= \
                    str(prev.get("t", "")):
                latest[key] = rec
    if corrupt:
        logger.warning("read_quality: dropped %d line(s) failing "
                       "their integrity seal", corrupt)
    return sorted(latest.values(),
                  key=lambda r: (str(r.get("file")),
                                 r.get("feed") or 0, r.get("band") or 0))


def flagged_files(source) -> set:
    """Basenames whose latest record (any feed/band) is flagged — the
    destriper's exclusion set."""
    return {r["file"] for r in read_quality(source) if r.get("flagged")}


def flag_counts(records: list) -> dict:
    """``{rule: count}`` over records' ``flags``."""
    out: dict = {}
    for r in records:
        for rule in r.get("flags") or ():
            out[rule] = out.get(rule, 0) + 1
    return out


def worst_feeds(records: list, n: int = 5) -> list:
    """The N worst (file, feed, band) rows by fitted knee frequency —
    the headline data-selection ranking."""
    rows = [r for r in records if r.get("fknee_hz") is not None]
    rows.sort(key=lambda r: -float(r["fknee_hz"]))
    return rows[:n]
