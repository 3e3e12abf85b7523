"""Offline integrity audit + repair for a campaign run directory.

The port of ``tools/campaign_fsck.py``. Usage::

    python -m comapreduce_tpu_torch.cli.campaign_fsck RUN_DIR \\
        [--repair] [--json]
    python -m comapreduce_tpu_torch.cli.campaign_fsck --selftest

Walks every durable artifact the campaign writes (the integrity plane,
docs/OPERATIONS.md §20) and verifies it with the SAME primitives the
online readers use (:mod:`comapreduce_tpu_torch.resilience.integrity`):

- ``*.s256`` **sidecars** — payload hashed against the digest history;
  a sidecar with no payload is an orphan (crash between the two
  renames of a committed_replace), a payload hashing outside the
  history is corrupt.
- **JSONL ledgers** (``quarantine*.jsonl``, ``quality.rank*.jsonl``,
  any other ``*.jsonl``) — per-line embedded ``_sha256`` seals; torn
  trailing lines are tolerated (append-crash), seal failures are
  corruption.
- **Sealed JSON state** (``queue.json``, ``heartbeat.rank*.json``) —
  embedded seal on the whole document.
- **Epoch dirs** (``epoch-NNNNNN/``) — every product re-hashed against
  the epoch's ``integrity.json`` (:func:`serving.epochs.verify_epoch`).
- **Tile roots** (``objects/`` + ``manifests/``) — every CAS object
  re-hashed against its name; every sealed tile manifest cross-checked
  (referenced object missing = problem; unreferenced object = orphan,
  reported but not an error — ``sweep_unreferenced`` owns GC).
- **Torn stumps** — ``*.tmp*`` files and ``.tmp-epoch.*`` dirs left by
  a killed writer (informational; ``--repair`` removes them).

``--repair`` triages by artifact class: re-derivable state (Level-2
checkpoints, spill, solver snapshots, epochs, tiles, control JSON) is
unlinked so the next run rebuilds it; corrupt ledger lines are dropped
by an atomic rewrite; a corrupt epoch is demoted (CURRENT rolled back
to the newest clean epoch, the dir removed); anything NOT re-derivable
(kind ``level1`` or unknown) is moved to ``<run>/fsck-quarantine/``
with a ``.evidence.json`` recording the expected and actual digests.
Repair iterates until stable (unlinking a corrupt tile object exposes
a dangling manifest reference, which demotes that manifest on the next
pass).

Exit code: 0 when no corruption remains (orphans/stumps/unverified
artifacts alone never fail); 1 otherwise. ``--selftest`` builds a
throwaway run dir with one artifact of every class, bit-flips each,
and asserts detect → repair → clean (exit 0/1) — CI runs it next to
``cli.check_resilience --integrity-only``.

It touches no device: the report and the repairs are the reference
tool's, byte for byte, on the same run directory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from comapreduce_tpu_torch.resilience.integrity import (
    SEAL_KEY, SIDECAR_SUFFIX, check_json, check_line, read_sidecar,
    seal_json, seal_line, sha256_path)
from comapreduce_tpu_torch.serving.epochs import (
    CURRENT_FILE, CURRENT_LINK, INTEGRITY, MANIFEST, epoch_name,
    parse_epoch_name, verify_epoch)
from comapreduce_tpu_torch.tiles.store import OBJECTS_DIR

#: artifact kinds fsck may destroy and let the pipeline rebuild.  An
#: empty kind ("" — pre-plane sidecar or unknown writer) is treated as
#: re-derivable only when the payload lives inside the run dir the
#: campaign owns; ``level1`` (and any unrecognised kind) is evidence,
#: not rebuild fodder.
REBUILDABLE_KINDS = frozenset(
    {"checkpoint", "spill", "solver", "epoch", "tile", "json", ""})

QUARANTINE_DIR = "fsck-quarantine"

#: JSON documents verified (and repaired) whole-document
_SEALED_JSON = ("queue.json",)


def _is_heartbeat(name: str) -> bool:
    return name.startswith("heartbeat.rank") and name.endswith(".json")


def _problem(path, cls, problem, detail="", kind=""):
    return {"path": path, "class": cls, "kind": kind,
            "problem": problem, "detail": detail, "repaired": False}


def scan(run_dir: str) -> dict:
    """One full audit pass; returns the report dict (see --json)."""
    run_dir = os.path.abspath(run_dir)
    problems, stumps, orphans = [], [], []
    n_verified = n_unverified = 0
    tile_roots, epoch_dirs = [], []

    for dirpath, dirnames, filenames in os.walk(run_dir):
        # never audit our own quarantine (it holds known-bad bytes)
        dirnames[:] = [d for d in dirnames if d != QUARANTINE_DIR]
        for d in list(dirnames):
            if d.startswith(".tmp-epoch."):
                stumps.append(os.path.join(dirpath, d))
                dirnames.remove(d)
            elif parse_epoch_name(d) is not None:
                epoch_dirs.append(os.path.join(dirpath, d))
        if OBJECTS_DIR in dirnames and "manifests" in dirnames:
            tile_roots.append(dirpath)
            # the tile pass owns these two subtrees
            dirnames[:] = [d for d in dirnames
                           if d not in (OBJECTS_DIR, "manifests")]
        inside_epoch = parse_epoch_name(
            os.path.basename(dirpath)) is not None
        for name in filenames:
            path = os.path.join(dirpath, name)
            if ".tmp" in name and not name.endswith(SIDECAR_SUFFIX):
                stumps.append(path)
                continue
            if name.endswith(SIDECAR_SUFFIX):
                res = _check_sidecar(path)
                if res is None:
                    n_verified += 1
                else:
                    problems.append(res)
            elif name.endswith(".jsonl"):
                ok, res = _check_jsonl(path)
                n_verified += ok
                problems.extend(res)
            elif name in _SEALED_JSON or _is_heartbeat(name):
                res = _check_sealed_json(path)
                if res is None:
                    n_verified += 1
                elif res == "unverified":
                    n_unverified += 1
                else:
                    problems.append(res)
            elif inside_epoch or name in (MANIFEST, INTEGRITY):
                continue  # the epoch pass owns these
            elif not os.path.exists(path + SIDECAR_SUFFIX) \
                    and name not in (CURRENT_FILE, CURRENT_LINK):
                n_unverified += 1

    for ed in epoch_dirs:
        ok, probs = verify_epoch(ed)
        n_verified += ok
        if not probs and ok == 0:
            n_unverified += 1  # pre-plane epoch: no integrity.json
        for name, detail in probs:
            problems.append(_problem(os.path.join(ed, name), "epoch",
                                     "corrupt", detail, kind="epoch"))

    for tr in tile_roots:
        v, probs, orph = _check_tiles(tr)
        n_verified += v
        problems.extend(probs)
        orphans.extend(orph)

    corrupt = [p for p in problems if p["problem"] == "corrupt"]
    return {
        "run_dir": run_dir,
        "n_verified": n_verified,
        "n_unverified": n_unverified,
        "problems": problems,
        "n_corrupt": len(corrupt),
        "stumps": sorted(stumps),
        "orphan_objects": sorted(orphans),
        "ok": not problems,
    }


def _check_sidecar(scpath: str):
    payload = scpath[:-len(SIDECAR_SUFFIX)]
    sc = read_sidecar(payload)
    if not os.path.exists(payload):
        return _problem(scpath, "sidecar", "orphan-sidecar",
                        "sidecar with no payload (crash between the "
                        "sidecar and payload renames)")
    if sc is None:
        return _problem(scpath, "sidecar", "torn-sidecar",
                        "sidecar unreadable — payload unverifiable")
    actual = sha256_path(payload)
    if actual not in sc.get("digests", []):
        return _problem(payload, "sidecar", "corrupt",
                        f"sha256 {actual[:12]} not in committed "
                        f"history", kind=str(sc.get("kind", "")))
    return None


def _check_jsonl(path: str):
    problems = []
    n_ok = torn = 0
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        return 0, [_problem(path, "jsonl", "unreadable", str(exc))]
    for i, line in enumerate(raw.split(b"\n")):
        if not line.strip():
            continue
        try:
            text = line.decode("utf-8")
        except UnicodeDecodeError:
            torn += 1
            continue
        body, verdict = check_line(text)
        if body is None:
            if verdict is False and SEAL_KEY.encode() in line:
                problems.append(_problem(
                    path, "jsonl", "corrupt",
                    f"line {i + 1} fails its embedded seal",
                    kind="ledger-line"))
            else:
                torn += 1
        elif verdict:
            n_ok += 1
    if torn:
        problems.append(_problem(path, "jsonl", "torn-lines",
                                 f"{torn} unparseable line(s)"))
    return n_ok, problems


def _check_sealed_json(path: str):
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        return _problem(path, "json", "corrupt",
                        f"unparseable: {exc}", kind="json")
    if not isinstance(doc, dict):
        return _problem(path, "json", "corrupt", "not an object",
                        kind="json")
    _, verdict = check_json(doc)
    if verdict is False:
        return _problem(path, "json", "corrupt",
                        "document fails its embedded seal",
                        kind="json")
    return None if verdict else "unverified"


def _check_tiles(tiles_root: str):
    problems, orphans = [], []
    n_verified = 0
    objects = os.path.join(tiles_root, OBJECTS_DIR)
    on_disk = set()
    for sub, _, names in os.walk(objects):
        for name in names:
            path = os.path.join(sub, name)
            if ".tmp" in name:
                problems.append(_problem(path, "tile", "torn-stump",
                                         "torn object write"))
                continue
            try:
                actual = sha256_path(path)
            except OSError as exc:
                problems.append(_problem(path, "tile", "corrupt",
                                         f"unreadable: {exc}",
                                         kind="tile"))
                continue
            if actual != name:
                problems.append(_problem(
                    path, "tile", "corrupt",
                    f"content hashes to {actual[:12]}, named "
                    f"{name[:12]}", kind="tile"))
            else:
                on_disk.add(name)
                n_verified += 1
    referenced = set()
    mandir = os.path.join(tiles_root, "manifests")
    try:
        mannames = sorted(os.listdir(mandir))
    except OSError:
        mannames = []
    for name in mannames:
        if not name.endswith(".json") or ".tmp" in name:
            continue
        mpath = os.path.join(mandir, name)
        res = _check_sealed_json(mpath)
        if isinstance(res, dict):
            res["class"], res["kind"] = "tile-manifest", "tile"
            problems.append(res)
            continue
        n_verified += 1
        try:
            with open(mpath, "r", encoding="utf-8") as f:
                man = json.load(f)
        except (OSError, ValueError):
            continue
        for key, entry in (man.get("tiles") or {}).items():
            digest = entry[0] if isinstance(entry, list) else None
            if not digest:
                continue
            referenced.add(digest)
            if digest not in on_disk and not man.get("prev"):
                # deltas reference only what changed; the FULL
                # manifest must resolve every tile
                problems.append(_problem(
                    mpath, "tile-manifest", "missing-object",
                    f"{key} references absent object "
                    f"{digest[:12]}", kind="tile"))
    orphans.extend(sorted(on_disk - referenced))
    return n_verified, problems, orphans


# -- repair ---------------------------------------------------------------


def repair(run_dir: str, report: dict) -> list:
    """One repair pass over ``report['problems']`` + stumps; returns
    human-readable action lines. Caller rescans afterwards."""
    actions = []

    def act(msg):
        actions.append(msg)

    for p in report["problems"]:
        path, prob, kind = p["path"], p["problem"], p["kind"]
        if prob in ("orphan-sidecar", "torn-sidecar"):
            _unlink(path)
            act(f"unlinked {prob}: {path}")
        elif prob == "torn-lines" or (prob == "corrupt"
                                      and p["class"] == "jsonl"):
            if _rewrite_jsonl(path):
                act(f"rewrote {path} without corrupt/torn lines")
        elif prob == "corrupt" and p["class"] == "epoch":
            ed = path if os.path.isdir(path) else os.path.dirname(path)
            _demote_epoch(ed)
            act(f"demoted corrupt epoch {ed} (CURRENT rolled back, "
                "dir removed — republish rebuilds it)")
        elif prob == "corrupt" and kind == "tile":
            _unlink(path)
            act(f"unlinked corrupt tile object {path} (re-tile "
                "re-puts it)")
        elif prob == "missing-object":
            _demote_tile_manifest(path)
            act(f"removed tile manifest {path} with dangling "
                "references (re-tile rebuilds it)")
        elif prob == "corrupt" and kind in REBUILDABLE_KINDS:
            _unlink(path)
            _unlink(path + SIDECAR_SUFFIX)
            act(f"unlinked corrupt {kind or 'artifact'}: {path} "
                "(re-derivable — the next run rebuilds it)")
        elif prob == "corrupt":
            dst = _quarantine(run_dir, path, p)
            act(f"quarantined NON-derivable corrupt artifact "
                f"{path} -> {dst} (evidence alongside)")
        elif prob == "unreadable":
            act(f"NOT repaired (unreadable, fix permissions): {path}")
    for s in report["stumps"]:
        if os.path.isdir(s):
            shutil.rmtree(s, ignore_errors=True)
        else:
            _unlink(s)
        act(f"removed torn stump {s}")
    return actions


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _rewrite_jsonl(path: str) -> bool:
    """Atomically rewrite ``path`` keeping only lines that parse and
    pass (or predate) their seal."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return False
    kept = []
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            body, verdict = check_line(line.decode("utf-8"))
        except UnicodeDecodeError:
            continue
        if body is not None and verdict is not False:
            kept.append(seal_line(body) if verdict else
                        json.dumps(body, separators=(",", ":"),
                                   default=str))
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("".join(k + "\n" for k in kept))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return True


def _demote_epoch(epoch_dir: str) -> None:
    """Remove a corrupt epoch; if CURRENT pointed at it, roll back to
    the newest remaining clean epoch (or clear the pointer)."""
    root = os.path.dirname(epoch_dir)
    victim = os.path.basename(epoch_dir)
    shutil.rmtree(epoch_dir, ignore_errors=True)
    cur_path = os.path.join(root, CURRENT_FILE)
    try:
        with open(cur_path, "r", encoding="utf-8") as f:
            cur = f.read().strip()
    except OSError:
        cur = None
    if cur != victim:
        return
    clean = sorted((n for n in os.listdir(root)
                    if parse_epoch_name(n) is not None
                    and not verify_epoch(os.path.join(root, n))[1]),
                   key=lambda n: parse_epoch_name(n))
    link = os.path.join(root, CURRENT_LINK)
    if not clean:
        _unlink(cur_path)
        _unlink(link)
        return
    target = clean[-1]
    tmp = cur_path + f".tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(target + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, cur_path)
    try:
        ltmp = link + f".tmp{os.getpid()}"
        _unlink(ltmp)
        os.symlink(target, ltmp)
        os.replace(ltmp, link)
    except OSError:
        pass


def _demote_tile_manifest(mpath: str) -> None:
    """Remove a tile manifest (and its delta / CURRENT reference) so a
    re-tile rebuilds the epoch's tiles from the source FITS."""
    mandir = os.path.dirname(mpath)
    name = os.path.basename(mpath)
    _unlink(mpath)
    _unlink(os.path.join(mandir, "delta-" + name))
    root = os.path.dirname(mandir)
    cur_path = os.path.join(root, CURRENT_FILE)
    try:
        with open(cur_path, "r", encoding="utf-8") as f:
            cur = f.read().strip()
    except OSError:
        return
    if cur + ".json" != name:
        return
    remaining = sorted(n for n in os.listdir(mandir)
                       if n.endswith(".json")
                       and not n.startswith("delta-")
                       and parse_epoch_name(n[:-5]) is not None)
    if remaining:
        with open(cur_path, "w", encoding="utf-8") as f:
            f.write(remaining[-1][:-5] + "\n")
    else:
        _unlink(cur_path)


def _quarantine(run_dir: str, path: str, p: dict) -> str:
    qdir = os.path.join(run_dir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, os.path.basename(path))
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = os.path.join(qdir, f"{os.path.basename(path)}.{i}")
    try:
        shutil.move(path, dst)
    except OSError:
        return path
    sc = read_sidecar(path)
    evidence = {"original_path": path, "kind": p["kind"],
                "detail": p["detail"],
                "actual_sha256": _safe_hash(dst),
                "committed_digests": (sc or {}).get("digests", [])}
    with open(dst + ".evidence.json", "w", encoding="utf-8") as f:
        json.dump(seal_json(evidence), f, indent=1, default=str)
    _unlink(path + SIDECAR_SUFFIX)
    return dst


def _safe_hash(path: str):
    try:
        return sha256_path(path)
    except OSError:
        return None


# -- selftest -------------------------------------------------------------


def selftest() -> int:
    """Build one artifact per class in a temp dir, bit-flip each,
    assert fsck detects all and --repair converges to clean."""
    import tempfile

    from comapreduce_tpu_torch.resilience.chaos import flip_byte
    from comapreduce_tpu_torch.resilience.integrity import (committed_replace,
                                                            write_sidecar)

    td = tempfile.mkdtemp(prefix="fsck-selftest-")
    try:
        # sidecar'd binary payload (stands in for checkpoint/spill/npz)
        ck = os.path.join(td, "fixture1_Level2.hd5")
        tmp = ck + ".tmp1"
        with open(tmp, "wb") as f:
            f.write(b"\x89HDF\r\n" + b"payload" * 64)
        committed_replace(tmp, ck, kind="checkpoint")

        # non-derivable payload -> quarantine path
        lv1 = os.path.join(td, "raw_input.h5")
        with open(lv1, "wb") as f:
            f.write(b"level1-bytes" * 32)
        write_sidecar(lv1, lv1, kind="level1")

        # sealed JSONL ledger
        led = os.path.join(td, "quarantine.jsonl")
        with open(led, "w", encoding="utf-8") as f:
            for i in range(3):
                f.write(seal_line({"i": i, "disposition": "ok"}) + "\n")

        # sealed whole-document JSON
        qj = os.path.join(td, "queue.json")
        with open(qj, "w", encoding="utf-8") as f:
            json.dump(seal_json({"schema": 1, "files": ["a", "b"]}), f)

        # epoch dir with integrity manifest
        ed = os.path.join(td, "epochs", epoch_name(1))
        os.makedirs(ed)
        fits = os.path.join(ed, "map_band0.fits")
        with open(fits, "wb") as f:
            f.write(b"SIMPLE  =                    T" + b"\x00" * 64)
        with open(os.path.join(ed, INTEGRITY), "w",
                  encoding="utf-8") as f:
            json.dump(seal_json({"schema": 1, "products": {
                "map_band0.fits": sha256_path(fits)}}), f)
        with open(os.path.join(ed, MANIFEST), "w",
                  encoding="utf-8") as f:
            json.dump(seal_json({"schema": 2, "epoch": 1,
                                 "maps": ["map_band0.fits"],
                                 "census": []}), f)
        with open(os.path.join(td, "epochs", CURRENT_FILE), "w",
                  encoding="utf-8") as f:
            f.write(epoch_name(1) + "\n")

        # tile root: one object + a sealed manifest referencing it
        troot = os.path.join(td, "tiles")
        blob = b"tile-blob-bytes" * 16
        import hashlib as _h
        digest = _h.sha256(blob).hexdigest()
        obj = os.path.join(troot, OBJECTS_DIR, digest[:2], digest)
        os.makedirs(os.path.dirname(obj))
        with open(obj, "wb") as f:
            f.write(blob)
        os.makedirs(os.path.join(troot, "manifests"))
        with open(os.path.join(troot, "manifests",
                               epoch_name(1) + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(seal_json({"schema": 1, "kind": "tiles",
                                 "epoch": 1,
                                 "tiles": {"b0/0": [digest,
                                                    len(blob), 16]}}),
                      f)

        rep = scan(td)
        if rep["problems"] or rep["n_verified"] < 6:
            print(f"selftest: clean scan not clean: {rep}")
            return 1

        victims = [ck, lv1, fits, obj]
        for v in victims:
            flip_byte(v, seed=7)
        # corrupt one ledger line + the sealed queue doc in place
        with open(led, "r+", encoding="utf-8") as f:
            lines = f.read().splitlines()
            lines[1] = lines[1].replace('"disposition":"ok"',
                                        '"disposition":"no"')
            f.seek(0)
            f.truncate()
            f.write("\n".join(lines) + "\n")
        with open(qj, "r+", encoding="utf-8") as f:
            doc = f.read().replace('"a"', '"z"')
            f.seek(0)
            f.truncate()
            f.write(doc)

        rep = scan(td)
        ncorrupt = sum(1 for p in rep["problems"]
                       if p["problem"] == "corrupt")
        if ncorrupt != 6:
            print("selftest: expected 6 corrupt artifacts, found "
                  f"{ncorrupt}:")
            for p in rep["problems"]:
                print(f"  {p['problem']:<14} {p['class']:<13} "
                      f"{p['path']}")
            return 1

        for _ in range(4):
            repair(td, rep)
            rep = scan(td)
            if rep["ok"]:
                break
        if not rep["ok"]:
            print(f"selftest: repair did not converge: "
                  f"{rep['problems']}")
            return 1
        qn = os.path.join(td, QUARANTINE_DIR, "raw_input.h5")
        if not os.path.exists(qn) or \
                not os.path.exists(qn + ".evidence.json"):
            print("selftest: level1 victim not quarantined with "
                  "evidence")
            return 1
        if os.path.exists(ck) or os.path.exists(obj) \
                or os.path.exists(ed):
            print("selftest: re-derivable victims not removed")
            return 1
        print("selftest: ok — 6/6 corruptions detected, repair "
              "converged, level1 quarantined with evidence")
        return 0
    finally:
        shutil.rmtree(td, ignore_errors=True)


# -- CLI ------------------------------------------------------------------


def render(rep: dict, actions: list) -> str:
    lines = [f"campaign fsck — {rep['run_dir']}",
             f"  verified {rep['n_verified']} artifact(s), "
             f"{rep['n_unverified']} unverified (pre-plane)"]
    for p in rep["problems"]:
        lines.append(f"  {p['problem'].upper():<14} "
                     f"[{p['kind'] or p['class']}] {p['path']}"
                     + (f" — {p['detail']}" if p["detail"] else ""))
    for s in rep["stumps"]:
        lines.append(f"  torn stump: {s}")
    if rep["orphan_objects"]:
        lines.append(f"  {len(rep['orphan_objects'])} unreferenced "
                     "tile object(s) (GC fodder, not corruption)")
    for a in actions:
        lines.append(f"  repair: {a}")
    lines.append("clean" if rep["ok"] else
                 f"{len(rep['problems'])} problem(s)"
                 f" ({rep['n_corrupt']} corrupt)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="the campaign run directory to audit")
    ap.add_argument("--repair", action="store_true",
                    help="triage per artifact class: unlink+rebuild "
                    "re-derivable state, quarantine-with-evidence "
                    "anything else")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    ap.add_argument("--selftest", action="store_true",
                    help="audit + repair a synthetic corrupted run "
                    "dir; exit 0 on full convergence")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()
    if not args.run_dir:
        ap.error("run_dir is required (or --selftest)")

    rep = scan(args.run_dir)
    actions = []
    if args.repair and not rep["ok"]:
        for _ in range(4):  # cascade: object unlink -> manifest demote
            actions.extend(repair(args.run_dir, rep))
            rep = scan(args.run_dir)
            if rep["ok"]:
                break
    print(json.dumps({**rep, "repair_actions": actions})
          if args.json else render(rep, actions))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
