"""The quarantine ledger: a persistent JSONL record of failed units (a
copy of ``comapreduce_tpu/resilience/ledger.py``; both packages write
and read the same sealed lines).

One line per event, append-only — the format a kill can't corrupt
beyond its own last line (and :meth:`QuarantineLedger.load` tolerates
exactly that: a truncated trailing line is dropped, never fatal). The
*latest* entry for a unit wins, so re-admission and recovery are new
appended events, not in-place edits; the full failure history of a
campaign stays greppable.

Entry schema (one JSON object per line)::

    {"t": "2026-08-04T07:00:00Z",      # UTC timestamp
     "unit": {"file": "...", "feed": null, "band": null, "scan": null},
     "failure_class": "transient" | "permanent" | "numerical" | "hang",
     "error": "OSError",               # exception type name ('' if n/a)
     "message": "...",                 # str(exc), truncated
     "digest": "1f2e3d4c5b6a",         # sha1 of the traceback, 12 hex
     "retries": 2,                     # attempts burned before giving up
     "disposition": "quarantined" | "readmitted" | "recovered"
                    | "masked",
     "stage": "ingest.read"}           # where it was caught

Dispositions: ``quarantined`` — the unit is skipped on future runs
until re-admitted; ``readmitted`` — an operator ran
``--retry-quarantined`` and the unit is live again; ``recovered`` — a
retry succeeded (bookkeeping only, never skipped); ``masked`` — a
numerical tripwire zero-weighted part of the unit (the rest of the
unit still flows; never skipped); ``rejected`` — the unit failed this
run but is re-attempted on the next one (never skipped: used for
failures that may be config-dependent — a ``KeyError`` from a wrong
``tod_variant`` must not poison the ledger against the corrected
re-run — for lock contention, where the file itself is fine, and for
``hang``-class failures, which indict the environment — an NFS mount,
a dead rank — rather than the data); ``stalled`` — a watchdog soft
deadline fired mid-operation (informational; never skipped — the
operation itself may still have succeeded); ``stolen`` — an elastic
campaign survivor reclaimed this unit's expired lease from a dead or
zombie rank (``pipeline.scheduler``; never skipped — the unit is
being redone right now), paired with a later ``recovered`` once the
thief commits it; ``deferred`` — the control plane's admission gate
shed this (quality-flagged) unit under SLO pressure
(``control.admission``; never skipped — the unit stays in the queue
and is paired with a later ``readmitted`` when pressure clears or
the rest of the queue drains: shed, never dropped); ``corrupt`` — a
committed artifact for this unit failed sha256 verification
(``resilience.integrity``): skipped like ``quarantined``, with the
digest evidence in the message. Re-derivable artifacts (Level-2
checkpoints, spill, snapshots, tiles) are unlinked and rebuilt from
source, which appends the lifting ``recovered``; non-derivable
Level-1 inputs stay corrupt until an operator re-stages the data and
``--retry-quarantined``s the unit.

Every line appended since the integrity plane landed carries an
embedded ``_sha256`` seal (``resilience.integrity.seal_line``); a
line whose seal fails verification is dropped-and-counted on load
exactly like a torn line (``python -m
comapreduce_tpu_torch.cli.campaign_fsck --repair`` rewrites the file
without them). Pre-integrity lines have no seal and load unverified —
the scheme is additive.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import traceback
from dataclasses import asdict, dataclass, field

from comapreduce_tpu_torch.resilience.integrity import check_line, seal_line

__all__ = ["LedgerEntry", "QuarantineLedger", "traceback_digest"]

logger = logging.getLogger("comapreduce_tpu_torch")

# dispositions that make a unit skippable on the next run
_SKIPPING = ("quarantined", "corrupt")
_MSG_LIMIT = 500


def traceback_digest(exc: BaseException | None) -> str:
    """12-hex sha1 of the exception's formatted traceback — stable
    across runs for 'the same failure', unlike the message (which may
    embed retry counts or tmp paths)."""
    if exc is None:
        return ""
    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    return hashlib.sha1(tb.encode()).hexdigest()[:12]


@dataclass(frozen=True)
class LedgerEntry:
    """One ledger line (see the module docstring for field semantics)."""

    unit: dict
    failure_class: str = ""
    error: str = ""
    message: str = ""
    digest: str = ""
    retries: int = 0
    disposition: str = "quarantined"
    stage: str = ""
    t: str = ""
    # sub-second companion to ``t``: cross-rank latest-wins must order
    # a defer and its re-admission correctly even within one second
    # (0.0 on pre-control ledger lines — they sort first in their tie)
    t_unix: float = 0.0

    @property
    def key(self) -> tuple:
        """Identity of the unit this entry is about."""
        u = self.unit
        return (u.get("file"), u.get("feed"), u.get("band"),
                u.get("scan"))


def _unit(file: str, feed=None, band=None, scan=None) -> dict:
    return {"file": file, "feed": feed, "band": band, "scan": scan}


class QuarantineLedger:
    """Append-only JSONL quarantine ledger.

    Thread-safe (the ingest prefetcher's worker thread records read
    failures concurrently with the consumer). Every :meth:`record`
    appends one line and flushes, so a kill right after a failure still
    leaves that failure on disk for the next run to skip.
    """

    def __init__(self, path: str, read_paths: tuple = ()):
        """``path`` is the file this process APPENDS to (single-writer:
        JSONL appends only interleave safely with one writer per file);
        ``read_paths`` are sibling ledgers folded into the in-memory
        state read-only — how a run with a different rank count still
        sees every rank's quarantines (the auto path is per-rank on
        multi-rank runs)."""
        self.path = path
        self.read_paths = tuple(p for p in read_paths if p != path)
        self._lock = threading.Lock()
        self._latest: dict[tuple, LedgerEntry] = {}
        self.entries: list[LedgerEntry] = []
        # seal-failing lines dropped across load()s — surfaced by the
        # watchdog report so silent rot in the ledger itself is loud
        self.corrupt_lines = 0
        self.load()

    # -- persistence -------------------------------------------------------
    def _read_file(self, path: str) -> list[LedgerEntry]:
        if not path or not os.path.exists(path):
            return []
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        dropped = 0
        corrupt = 0
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            raw, verdict = check_line(line)
            if raw is None:
                # unparseable (torn by a kill) or failed its seal
                # (rotted in place) — either way one line is dropped,
                # never the ledger
                try:
                    json.loads(line)
                    corrupt += 1  # parsed fine: the seal failed
                except ValueError:
                    dropped += 1
                continue
            try:
                out.append(LedgerEntry(
                    **{k: raw[k] for k in
                       LedgerEntry.__dataclass_fields__ if k in raw}))
            except (ValueError, TypeError):
                dropped += 1
        if dropped:
            logger.warning("quarantine ledger %s: dropped %d unparseable "
                           "line(s) (truncated by a kill?)", path,
                           dropped)
        if corrupt:
            logger.warning("quarantine ledger %s: dropped %d line(s) "
                           "failing their _sha256 seal (bit rot? run "
                           "python -m comapreduce_tpu_torch.cli."
                           "campaign_fsck --repair)", path,
                           corrupt)
        self.corrupt_lines += corrupt
        return out

    def load(self) -> int:
        """(Re)read the ledger (own file + read-only siblings); returns
        the number of valid lines.

        A truncated/garbled trailing line (the signature of a kill
        mid-append) is dropped with a warning; a garbled line in the
        *middle* of a file is dropped too — one corrupt event must not
        cost the whole ledger. Cross-file ordering for latest-wins is
        by timestamp — ISO second first, then the sub-second ``t_unix``
        (admission control defers and re-admits within one second) —
        stable with the OWN file's entries read last so they win exact
        ties."""
        self.entries = []
        self._latest = {}
        self.corrupt_lines = 0
        merged = []
        for p in self.read_paths:
            merged.extend(self._read_file(p))
        merged.extend(self._read_file(self.path))
        # stable: own-file exact ties win
        merged.sort(key=lambda e: (e.t, e.t_unix))
        for entry in merged:
            self._remember(entry)
        return len(self.entries)

    def _remember(self, entry: LedgerEntry) -> None:
        self.entries.append(entry)
        self._latest[entry.key] = entry

    def _append(self, entry: LedgerEntry) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        # a kill mid-append can leave the file without its trailing
        # newline — gluing the next record onto that stump would corrupt
        # BOTH lines, so terminate the stump first
        needs_nl = False
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_nl = f.read(1) != b"\n"
        except OSError:
            pass
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(("\n" if needs_nl else "")
                    + seal_line(asdict(entry)) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- recording ---------------------------------------------------------
    def record(self, file: str, error: BaseException | None = None,
               failure_class: str = "", retries: int = 0,
               disposition: str = "quarantined", stage: str = "",
               feed=None, band=None, scan=None,
               message: str = "") -> LedgerEntry:
        """Append one event; returns the entry. ``error`` fills the
        type/message/digest fields; ``message`` overrides the text."""
        entry = LedgerEntry(
            unit=_unit(file, feed, band, scan),
            failure_class=failure_class,
            error=type(error).__name__ if error is not None else "",
            message=(message or (str(error) if error is not None
                                 else ""))[:_MSG_LIMIT],
            digest=traceback_digest(error),
            retries=int(retries),
            disposition=disposition,
            stage=stage,
            t=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            t_unix=time.time())
        with self._lock:
            self._append(entry)
            self._remember(entry)
        return entry

    def readmit(self, file: str, stage: str = "readmit") -> None:
        """Mark every quarantined unit of ``file`` live again (the
        ``--retry-quarantined`` action)."""
        with self._lock:
            keys = [k for k, e in self._latest.items()
                    if k[0] == file and e.disposition in _SKIPPING]
        for key in keys:
            self.record(file, feed=key[1], band=key[2], scan=key[3],
                        disposition="readmitted", stage=stage)

    # -- queries -----------------------------------------------------------
    def latest(self, file: str, feed=None, band=None,
               scan=None) -> LedgerEntry | None:
        """The winning (most recent) entry for this exact unit."""
        with self._lock:
            return self._latest.get((file, feed, band, scan))

    def is_quarantined(self, file: str, feed=None, band=None,
                       scan=None) -> bool:
        """True when the latest entry for this exact unit says skip."""
        with self._lock:
            e = self._latest.get((file, feed, band, scan))
        return e is not None and e.disposition in _SKIPPING

    def quarantined_files(self) -> set:
        """Files whose file-level unit is currently quarantined."""
        with self._lock:
            return {k[0] for k, e in self._latest.items()
                    if e.disposition in _SKIPPING}

    def summary(self) -> dict:
        """Counts by (failure_class, disposition) over the LATEST entry
        per unit — the current state, for the run-report line. (The
        full history stays in ``entries``: a campaign-old quarantine
        that was later re-admitted must not read as a rejection in
        today's report.)"""
        out: dict[str, int] = {}
        with self._lock:
            for e in self._latest.values():
                key = f"{e.failure_class or 'n/a'}:{e.disposition}"
                out[key] = out.get(key, 0) + 1
        return out
