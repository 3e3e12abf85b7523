"""Artifact integrity: sha256 sidecars and verify-on-read (the sidecar
half of ``comapreduce_tpu/resilience/integrity.py``, copied so that each
package verifies the other's artifacts; the reference's embedded JSON
seals are not ported).

A durable artifact (here: the solver's ``.npz`` snapshots) is committed
with a sidecar manifest ``<name>.s256``, a small JSON document next to
it::

    {"schema": 1, "kind": "solver", "algo": "sha256",
     "digests": ["<newest>", "<previous>", ...], "size": 12345}

``digests`` keeps a short history (newest first, capped at
:data:`HISTORY`): the sidecar is committed *before* the payload rename
inside :func:`committed_replace`, so a crash between the two renames
leaves the old payload under a new sidecar, whose history still holds
the old digest. Atomicity (``data.durable``) makes the rename
all-or-nothing; this module checks that the content under the name is
the content committed. A mismatch raises :class:`CorruptArtifactError`.

Verification is host-side hashing and adds no device work. The
``COMAP_VERIFY_READS`` environment knob (default on) turns it off, so
readers trust bytes again (forensics).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

from ..data import durable as _durable
from ..telemetry.core import TELEMETRY

logger = logging.getLogger(__name__)

__all__ = [
    "CorruptArtifactError", "verify_enabled", "sha256_path",
    "sidecar_path", "read_sidecar", "write_sidecar",
    "committed_replace", "refresh_sidecar", "drop_sidecar", "verify_file",
]

#: suffix of sidecar manifests (``map_band0.fits`` → ``map_band0.fits.s256``)
SIDECAR_SUFFIX = ".s256"

#: digest generations kept in a sidecar.  One would satisfy a clean
#: commit; the history absorbs the sidecar-first commit window (crash
#: after sidecar rename, before payload rename → old payload must
#: still verify) and repeated crashed commits in a row.
HISTORY = 4

_CHUNK = 1 << 20  # 1 MiB read chunks for hashing


class CorruptArtifactError(OSError):
    """Committed artifact whose bytes no longer match their manifest.

    An :class:`OSError` subclass so it rides the existing per-file
    safety nets (``TRANSIENT_ERRORS`` catch arcs), but
    ``classify_error`` recognises it FIRST and returns ``"corrupt"``:
    deterministic damage, never retried.  Carries the evidence the
    ledger records (expected vs actual digest)."""

    def __init__(self, path: str, kind: str = "",
                 expected: str = "", actual: str = "",
                 detail: str = ""):
        self.path = path
        self.kind = kind
        self.expected = expected
        self.actual = actual
        msg = f"corrupt artifact {path!r}"
        if kind:
            msg += f" (kind={kind})"
        if expected or actual:
            msg += (f": sha256 {actual[:12] or '?'} != committed "
                    f"{expected[:12] or '?'}")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def verify_enabled() -> bool:
    """Verify-on-read master switch: ``COMAP_VERIFY_READS`` (default
    on; ``0``/``false``/``off``/``no`` disable)."""
    v = os.environ.get("COMAP_VERIFY_READS", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


def sha256_path(path: str) -> str:
    """Hex sha256 of a file's bytes, chunked (constant memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def sidecar_path(path: str) -> str:
    return os.fspath(path) + SIDECAR_SUFFIX


def read_sidecar(path: str) -> dict | None:
    """The sidecar manifest for artifact ``path``, or None when
    absent/torn/foreign-schema (an unreadable sidecar means the
    artifact is *unverified*, not corrupt — sidecars are advisory
    metadata; the payload's own commit protocol guarantees its
    atomicity)."""
    sc = sidecar_path(path)
    try:
        with open(sc, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != 1:
        return None
    digs = doc.get("digests")
    if not isinstance(digs, list) or not all(
            isinstance(d, str) for d in digs):
        return None
    return doc


def write_sidecar(payload: str, dst: str, kind: str,
                  durable: bool = True) -> dict:
    """Commit a sidecar for artifact ``dst`` recording the digest of
    ``payload`` (usually the tmp file about to be renamed onto
    ``dst``).  Merges the existing sidecar's digest history so the
    sidecar-first commit window keeps the previous generation
    verifiable.  Atomic + durable like every other commit."""
    digest = sha256_path(payload)
    prev = read_sidecar(dst)
    history = [digest]
    if prev:
        for d in prev.get("digests", []):
            if d not in history:
                history.append(d)
    doc = {"schema": 1, "kind": kind, "algo": "sha256",
           "digests": history[:HISTORY],
           "size": os.path.getsize(payload)}
    sc = sidecar_path(dst)
    tmp = sc + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
    try:
        # module attribute, not a from-import: fault-injection tests
        # patch data.durable.durable_replace and the sidecar commit
        # must honour the same fault as the payload commit
        _durable.durable_replace(tmp, sc, durable=durable)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return doc


def committed_replace(tmp: str, dst: str, kind: str,
                      durable: bool = True) -> None:
    """The integrity-aware commit: sidecar first, then the payload's
    fsync-before-rename.  Ordering is the crash-safety argument —
    whatever point a SIGKILL lands, the payload under ``dst`` has its
    digest in the sidecar's history (old payload + old sidecar, old
    payload + new sidecar via history, or new payload + new sidecar)."""
    write_sidecar(tmp, dst, kind, durable=durable)
    _durable.durable_replace(tmp, dst, durable=durable)


def refresh_sidecar(dst: str, kind: str = "",
                    durable: bool = False) -> None:
    """Re-seal an artifact mutated in place (an in-place HDF5 append):
    rewrites only an existing sidecar, so a stale manifest never
    condemns honestly-updated bytes (``integrity.py:207``)."""
    prev = read_sidecar(dst)
    if prev is None:
        return
    write_sidecar(dst, dst, kind or str(prev.get("kind", "")),
                  durable=durable)


def drop_sidecar(path: str) -> None:
    """Remove the sidecar alongside a condemned/unlinked artifact."""
    try:
        os.unlink(sidecar_path(path))
    except OSError:
        pass


def verify_file(path: str, kind: str = "",
                required: bool = False) -> bool | None:
    """Verify artifact ``path`` against its sidecar.

    Returns True (digest in the committed history), None (no usable
    sidecar — unverified; unless ``required``), or raises
    :class:`CorruptArtifactError` on mismatch (counting an
    ``integrity.violations`` telemetry tick first, so /metrics shows
    ``comap_integrity_violations_total`` moving).  Honors
    :func:`verify_enabled` — disabled verification reads as
    unverified, never as OK."""
    if not verify_enabled():
        return None
    doc = read_sidecar(path)
    if doc is None:
        if required:
            raise CorruptArtifactError(
                path, kind=kind, detail="required sidecar missing")
        return None
    actual = sha256_path(path)
    digests = doc.get("digests", [])
    if actual in digests:
        return True
    TELEMETRY.counter("integrity.violations",
                      kind=str(doc.get("kind", kind) or kind))
    raise CorruptArtifactError(
        path, kind=str(doc.get("kind", "")) or kind,
        expected=digests[0] if digests else "", actual=actual)
