"""The port's integrity tools (``comapreduce_tpu_torch/cli/
campaign_fsck.py`` and the integrity drill) against the reference's
(``tools/campaign_fsck.py``, ``run_integrity_drill``) on the CPU.

- A seeded damaged run directory — one artifact of every class the
  integrity plane seals (a Level-2 checkpoint, a Level-1 input, a spill
  entry, a solver snapshot, a sealed ledger, the queue manifest, a clean
  and a corrupt epoch, a tile root with a rotted object, an orphan
  sidecar, torn stumps), each damaged by a seeded byte flip — goes
  through both tools from the same path: the ``--json`` reports, the
  text reports and the exit codes are equal, and after ``--repair`` the
  directory holds the same bytes (file for file, the quarantined
  evidence included).
- ``--selftest`` passes, and the module runs as ``python -m``.
- ``run_integrity_drill`` in both packages: every class detected, the
  same triage, the same repaired map (the reference's ``test_integrity``
  fsck and repair contracts, mirrored).
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from comapreduce_tpu_torch.cli import campaign_fsck as port_fsck
from comapreduce_tpu_torch.resilience.chaos import flip_byte
from comapreduce_tpu_torch.resilience.integrity import (committed_replace,
                                                        seal_json, seal_line,
                                                        sha256_path,
                                                        write_sidecar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import campaign_fsck as ref_fsck  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (the suite's workers share the
    cores); the old count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _commit(path, data: bytes, kind: str) -> None:
    tmp = path + ".tmp1"
    with open(tmp, "wb") as f:
        f.write(data)
    committed_replace(tmp, path, kind=kind)


def _epoch(root, n: int, payload: bytes) -> str:
    d = os.path.join(root, f"epoch-{n:06d}")
    os.makedirs(d)
    fits = os.path.join(d, "map_band0.fits")
    with open(fits, "wb") as f:
        f.write(b"SIMPLE  =                    T" + payload)
    with open(os.path.join(d, "integrity.json"), "w") as f:
        json.dump(seal_json({"schema": 1, "products": {
            "map_band0.fits": sha256_path(fits)}}), f)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(seal_json({"schema": 2, "epoch": n,
                             "maps": ["map_band0.fits"], "census": []}), f)
    return fits


def _damaged_run(run: str, seed: int) -> None:
    """One artifact of every class, each damaged (seeded), beside intact
    ones that must survive the repair."""
    rng = np.random.default_rng(seed)
    os.makedirs(run)
    blob = lambda n: rng.bytes(n)  # noqa: E731
    ck = os.path.join(run, "Level2_comap-0001.hd5")
    _commit(ck, b"\x89HDF\r\n" + blob(600), "checkpoint")
    _commit(os.path.join(run, "Level2_comap-0002.hd5"), blob(300),
            "checkpoint")
    spill = os.path.join(run, "spill", "a1b2c3.ingest.pkl")
    os.makedirs(os.path.dirname(spill))
    _commit(spill, blob(400), "spill")
    snap = os.path.join(run, "solver_band0.npz")
    _commit(snap, blob(200), "solver")
    lv1 = os.path.join(run, "comap-0000007.hd5")
    with open(lv1, "wb") as f:
        f.write(blob(500))
    write_sidecar(lv1, lv1, kind="level1")
    led = os.path.join(run, "quarantine.rank0.jsonl")
    with open(led, "w") as f:
        for i in range(4):
            f.write(seal_line({"i": i, "disposition": "recovered",
                               "unit": {"file": f"f{i}.hd5"}}) + "\n")
    with open(os.path.join(run, "queue.json"), "w") as f:
        json.dump(seal_json({"schema": 1, "n": 2, "files": ["a", "b"]}), f)
    epochs = os.path.join(run, "epochs")
    _epoch(epochs, 1, blob(64))
    bad_fits = _epoch(epochs, 2, blob(64))
    with open(os.path.join(epochs, "CURRENT"), "w") as f:
        f.write("epoch-000002\n")
    troot = os.path.join(run, "tiles")
    digests = []
    for k in range(2):
        data = blob(256)
        dg = hashlib.sha256(data).hexdigest()
        obj = os.path.join(troot, "objects", dg[:2], dg)
        os.makedirs(os.path.dirname(obj), exist_ok=True)
        with open(obj, "wb") as f:
            f.write(data)
        digests.append((dg, len(data), obj))
    os.makedirs(os.path.join(troot, "manifests"))
    with open(os.path.join(troot, "manifests", "epoch-000001.json"),
              "w") as f:
        json.dump(seal_json({"schema": 1, "kind": "tiles", "epoch": 1,
                             "tiles": {f"b0/{k}": [dg, n, 16]
                                       for k, (dg, n, _) in
                                       enumerate(digests)}}), f)
    with open(os.path.join(troot, "CURRENT"), "w") as f:
        f.write("epoch-000001\n")
    gone = os.path.join(run, "gone.bin")
    with open(gone, "wb") as f:
        f.write(b"x")
    write_sidecar(gone, gone, kind="checkpoint")
    os.unlink(gone)
    with open(os.path.join(run, "half.hd5.tmp42"), "wb") as f:
        f.write(b"torn")
    os.makedirs(os.path.join(epochs, ".tmp-epoch.77"))
    # the damage
    for path in (ck, spill, snap, lv1, bad_fits, digests[int(
            rng.integers(2))][2]):
        flip_byte(path, seed=seed + 1)
    with open(led) as f:
        lines = f.read().splitlines()
    j = int(rng.integers(len(lines)))
    doc = json.loads(lines[j])
    doc["disposition"] = "quarantined"   # body edited, seal left stale
    lines[j] = json.dumps(doc, separators=(",", ":"))
    with open(led, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(run, "queue.json"), "r+b") as f:
        f.seek(12)
        f.write(b"9")


def _tree(root: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            p = os.path.join(d, name)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.readlink(p))
            elif os.path.isdir(p):
                out[rel] = ("dir",)
            else:
                with open(p, "rb") as f:
                    out[rel] = ("file", f.read())
    return out


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fsck_reports_and_repairs_like_the_reference(tmp_path, seed,
                                                     capsys):
    run = str(tmp_path / "run")
    pristine = str(tmp_path / "pristine")
    _damaged_run(run, seed)
    shutil.copytree(run, pristine, symlinks=True)
    got = {}
    for pkg, main in (("ref", ref_fsck.main), ("port", port_fsck.main)):
        shutil.rmtree(run)
        shutil.copytree(pristine, run, symlinks=True)
        rc_scan, scan = _run(main, [run, "--json"], capsys)
        rc_text, text = _run(main, [run], capsys)
        rc_rep, rep = _run(main, [run, "--repair", "--json"], capsys)
        got[pkg] = dict(scan=(rc_scan, json.loads(scan)),
                        text=(rc_text, text),
                        repair=(rc_rep, json.loads(rep)), tree=_tree(run))
    for key in ("scan", "text", "repair"):
        assert got["port"][key] == got["ref"][key], key
    assert got["port"]["tree"] == got["ref"]["tree"]
    rc, rep = got["port"]["scan"]
    classes = {p["problem"] for p in rep["problems"]}
    assert rc == 1 and {"corrupt", "orphan-sidecar"} <= classes
    assert rep["n_corrupt"] >= 7 and rep["stumps"]
    rc, rep = got["port"]["repair"]
    assert rc == 0 and rep["ok"] and rep["repair_actions"]
    assert "fsck-quarantine/comap-0000007.hd5.evidence.json" in \
        got["port"]["tree"]


@pytest.mark.parametrize("case", ["checkpoint", "orphan_and_stump"])
def test_scan_and_repair_functions_match_the_reference(tmp_path, case):
    """The reference's ``test_campaign_fsck_*`` cases through both
    packages' ``scan`` / ``repair``."""
    reps = {}
    for pkg, mod in (("ref", ref_fsck), ("port", port_fsck)):
        run = str(tmp_path / pkg)
        os.makedirs(run)
        if case == "checkpoint":
            p = os.path.join(run, "Level2_x.hd5")
            _commit(p, b"checkpoint-bytes" * 8, "checkpoint")
            assert mod.scan(run)["ok"]
            flip_byte(p, seed=23)
        else:
            p = os.path.join(run, "gone.bin")
            with open(p, "wb") as f:
                f.write(b"x")
            write_sidecar(p, p, kind="blob")
            os.unlink(p)
            with open(os.path.join(run, "half.bin.tmp42"), "wb") as f:
                f.write(b"torn")
        rep = mod.scan(run)
        acts = mod.repair(run, rep)
        rep2 = mod.scan(run)
        reps[pkg] = [json.loads(json.dumps(r).replace(run, "RUN"))
                     for r in (rep, acts, rep2)]
        assert rep2["ok"] and not os.path.exists(p)
    assert reps["port"] == reps["ref"]


def test_selftest_and_module_entry(tmp_path):
    for argv in (["--selftest"], [str(tmp_path), "--json"]):
        proc = subprocess.run(
            [sys.executable, "-m", "comapreduce_tpu_torch.cli.campaign_fsck",
             *argv], capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["ok"] is True


def test_integrity_drill_matches_reference(tmp_path):
    from comapreduce_tpu.resilience.drill import run_integrity_drill as ref
    from comapreduce_tpu_torch.resilience.drill import run_integrity_drill

    want = ref(str(tmp_path / "ref"), seed=0)
    got = run_integrity_drill(str(tmp_path / "port"), seed=0, device="cpu")
    for key in ("criterion", "n_classes", "n_detected",
                "ledger_lines_dropped", "map_identical"):
        assert got[key] == want[key], key
    named = {"Level2_comap-0001.hd5", "map_band0.fits", "quarantine.jsonl",
             "solver_band0.npz"}
    assert named <= set(got["corrupt_paths"])
    assert named <= set(want["corrupt_paths"])
    assert len(got["corrupt_paths"]) == len(want["corrupt_paths"]) == 6
