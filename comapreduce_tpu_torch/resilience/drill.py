"""The chaos drill: inject every fault class, assert the promises hold
(port of ``comapreduce_tpu/resilience/drill.py``).

This is the executable form of the resilience layer's contract, run by
``python -m comapreduce_tpu_torch.cli.check_resilience``:

1. a chaos run (read error + truncated file + NaN burst + slow read +
   first-attempt flake + HANGING read injected over a synthetic
   fixture set) completes with no unhandled exception;
2. every injected fault appears in the quarantine ledger with the
   correct classification (read error/truncate -> ``transient``
   quarantines, NaN burst -> ``numerical``/``masked``, flake ->
   ``transient``/``recovered``, hang -> ``hang``/``rejected`` after a
   ``hang``/``stalled`` soft warning);
3. the destriped map from the chaos run is byte-identical to the
   clean run's map with the faulted units zero-weighted (dead and
   hung files dropped, NaN-touched samples at weight 0);
4. a second pass consults the ledger: quarantined files are skipped
   without a read, the HUNG file is re-attempted (rejected, not
   quarantined — a hang indicts the environment), and
   ``retry_quarantined`` re-admits exactly the quarantined set;
5. the watchdog honoured its deadline budget: each hung read was
   cancelled within ``hard + grace`` seconds (every retry gets its
   own fresh budget), and the run never joined a stuck read;
6. the async writeback path: a ``write_stall`` fault on the
   background writer thread is cancelled by the ``writeback.write``
   hard deadline within ``hard + grace``, ledgered ``hang``/
   ``rejected`` (environment, never the file), the flush barrier
   surfaces the failure, committed checkpoints are never dropped or
   reordered (the surviving file holds its LAST submitted generation,
   complete), and the abandoned writer's late commit is skipped at the
   generation gate;
7. the elastic campaign (``run_elastic_drill``): three REAL
   processes share one lease-file queue; a ``rank_kill`` rank is
   SIGKILLed mid-lease and a ``rank_pause`` zombie stops heartbeating
   but keeps working. The survivor steals both expired leases
   (ledgered ``stolen`` then ``recovered``), every file is committed
   EXACTLY once, the zombie's late commit is rejected at the
   generation fence, and the map over the committed set is
   byte-identical to a clean run over the same filelist.

8. incremental map serving (``run_serving_drill``): a
   ``serving.MapServer`` folds committed waves into versioned epochs.
   Asserts: every committed file lands in EXACTLY one epoch's
   ``new_files`` (exactly-once folding); a ``kill_mid_publish``
   SIGKILL never moves ``current`` off a complete epoch; a killed and
   resumed server's epochs are byte-identical to an uninterrupted
   twin's (map FITS and offsets compared byte-for-byte); a cold
   one-shot serving epoch is byte-identical to a batch
   read+solve over the same census (incremental assembly parity); and
   the warm-started final epoch needs STRICTLY fewer CG iterations
   than the cold one-shot while agreeing with it modulo the offset
   null mode (a global constant — docs/OPERATIONS.md §12).

9. the map tile read tier (``run_tiles_drill``): served
   epochs are cut into content-addressed tiles behind an HTTP front.
   Asserts: a SIGKILL between the tile object writes and the tile
   manifest rename leaves the tile tier serving the PREVIOUS complete
   epoch whole (old-or-new, never torn) while the epoch itself stands;
   the CLI backfill repairs the gap and a fresh-root re-tile yields
   byte-identical tile hashes (deterministic blob encoding), making
   the published delta the exact manifest diff; an HTTP cutout is
   bit-identical to slicing the expanded epoch FITS and revalidates
   (304) across an atomic ``/v1/current`` rollback; every serving
   process lands on its own auto-incremented telemetry lane (rank >=
   1000); and ``MapServer.evict`` publishes a ``downdated`` epoch
   whose tiles are byte-identical to the pre-eviction epoch's
   (content addressing across history), with the retracted file never
   re-admitted by the commit scan.

10. the integrity plane (docs/OPERATIONS.md §20,
   ``run_integrity_drill``): one byte is flipped in a committed
   artifact of EVERY class — Level-2 checkpoint, spill entry, solver
   snapshot, epoch FITS, tile object, ledger line. Asserts 100%
   detection by ``cli.campaign_fsck``, the correct per-class
   triage at each read boundary (checkpoint -> ``corrupt`` ledger
   disposition, spill -> cache miss + unlink, snapshot -> cold solve,
   epoch -> ``verify_epoch`` problem, tile ->
   ``CorruptArtifactError`` + unlink, ledger line ->
   dropped-and-counted), that chaos ``bit_rot`` rots only
   post-commit (always detectable) at most once per basename, and
   that ``--repair`` + re-derivation yields a final map
   byte-identical to the clean run's.

Everything is deterministic by seed (chaos decisions, jitter, synthetic
data), so a CI failure reproduces locally bit-for-bit. (Deadline
checks bound wall time from ABOVE only — cancels must not be late;
nothing asserts a minimum, so fast machines stay green.)

Every drill takes ``device`` (default ``cuda``; without a card it raises
unless ``device="cpu"``): the reads, solves and map servers run there,
and a drill's child processes receive it on their command line. The
drills write Level-2 HDF5 files, so they need ``h5py``. Evidence keys,
on-disk names and worker command lines are the reference's, so a drill's
state directory reads the same through either package.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

__all__ = ["run_drill", "run_elastic_drill", "run_integrity_drill",
           "run_live_drill", "run_serving_drill", "run_tiles_drill"]

logger = logging.getLogger("comapreduce_tpu_torch")


def _child_env(**extra) -> dict:
    """Environment for drill subprocesses: one intra-op thread for torch
    (the children are many small processes on one host; their device
    comes on their command line), and the repo root on PYTHONPATH so
    ``python -m comapreduce_tpu_torch...`` resolves regardless of the
    caller's cwd (the package need not be installed)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    parts = [root] + [p for p in
                      env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


def _write_level2(path: str, seed: int, F: int = 2, T: int = 600,
                  drift: float = 0.0, rw: float = 0.0,
                  raster: bool = False) -> None:
    """Minimal single-band Level-2 store the destriper reader accepts
    (same schema as the pipeline's checkpoint output).

    ``drift`` adds slow per-feed sinusoids and ``rw`` a random walk —
    the 1/f structure destriping exists to remove, which the SERVING
    drill needs so a warm-started epoch has real offset structure to
    reuse (white noise has none and warm starts save nothing).
    ``raster`` swaps the random per-sample pointing for a smooth
    boustrophedon sweep (scan-like pixel coupling)."""
    from comapreduce_tpu_torch.data.hdf5io import HDF5Store

    rng = np.random.default_rng(seed)
    store = HDF5Store(name="l2")
    t = np.arange(T)
    tod = (rng.normal(size=(F, 1, T))
           + np.sin(t / 37.0)).astype(np.float32)
    if drift:
        for f in range(F):
            ph = rng.uniform(0.0, 2.0 * np.pi, size=3)
            tod[f, 0] += drift * (
                np.sin(2 * np.pi * t / 401.0 + ph[0])
                + 0.5 * np.sin(2 * np.pi * t / 173.0 + ph[1])
                + 0.25 * np.sin(2 * np.pi * t / 83.0 + ph[2])
            ).astype(np.float32)
    if rw:
        tod += (rw * np.cumsum(rng.normal(size=(F, 1, T)),
                               axis=-1)).astype(np.float32)
    store["averaged_tod/tod"] = tod
    store["averaged_tod/weights"] = np.ones((F, 1, T), np.float32)
    store["averaged_tod/scan_edges"] = np.array([[0, T]], np.int64)
    if raster:
        ph = rng.uniform(0.0, 2.0 * np.pi, size=(F, 1))
        ra = (170.0 + 0.25 * (1 + np.sin(2 * np.pi * t / 97.0 + ph))
              ) * np.ones((F, T))
        dec = (52.0 + 0.5 * ((t[None, :] / T + rng.random((F, 1)))
                             % 1.0)) * np.ones((F, T))
    else:
        ra = 170.0 + 0.5 * rng.random((F, T))
        dec = 52.0 + 0.5 * rng.random((F, T))
    store["spectrometer/pixel_pointing/pixel_ra"] = ra
    store["spectrometer/pixel_pointing/pixel_dec"] = dec
    store["spectrometer/pixel_pointing/pixel_az"] = ra
    store["spectrometer/pixel_pointing/pixel_el"] = dec
    store.set_attrs("comap", "source", "co2,sky")
    store.set_attrs("comap", "obsid", seed)
    store.write(path)


def _read(files, wcs, resilience=None, prefetch: int = 0, device=None):
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data

    return read_comap_data(files, band=0, wcs=wcs, offset_length=50,
                           medfilt_window=51, use_calibration=False,
                           prefetch=prefetch, resilience=resilience,
                           device=device)


def _solve(data, device=None):
    from comapreduce_tpu_torch.cli.run_destriper import solve_band

    return solve_band(data, offset_length=50, n_iter=50, threshold=1e-5,
                      device=device)


def _join_released(timeout_s: float = 30.0) -> None:
    """Wait for the watchdog workers a chaos release let go: a released
    hung read goes on into h5py, and an interpreter that exits under it
    deadlocks in h5py's teardown (so the reference's check_resilience
    hangs at exit after printing its evidence)."""
    deadline = time.monotonic() + timeout_s
    for th in threading.enumerate():
        if th.name.startswith("watchdog-call:") \
                and th is not threading.current_thread():
            th.join(max(deadline - time.monotonic(), 0.0))


def _device_arg(device) -> str:
    """The ``--device`` a child process receives: the parent's device,
    resolved (so a parent without a card raises before spawning)."""
    from comapreduce_tpu_torch._device import resolve_device

    return str(resolve_device(device))


def run_drill(workdir: str, seed: int = 0, n_files: int = 7,
              prefetch: int = 2, hard_deadline_s: float = 0.4,
              soft_deadline_s: float = 0.1,
              grace_s: float = 1.0, device=None) -> dict:
    """Run the full drill in ``workdir``; returns the evidence dict.

    Raises ``AssertionError`` (with a named criterion) on any broken
    promise — the CI contract is 'exit 0 means all five held'.
    """
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience import (QuarantineLedger, Resilience,
                                                  Watchdog, parse_deadlines)
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey
    from comapreduce_tpu_torch.resilience.retry import RetryPolicy

    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    files = []
    for i in range(n_files):
        path = os.path.join(workdir, f"Level2_comap-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=1000 + seed * 10 + i)
        files.append(path)
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))

    # one fault of every class, each aimed at a known file; the hang
    # blocks far past the hard deadline (abandoned workers are released
    # in the finally below so they die promptly, not after hang_s)
    spec = ("read_error@0001,truncate@0002,flaky@0003,"
            "nan_burst@0004,slow_read@0000,hang@0005")
    monkey = ChaosMonkey(spec, seed=seed, slow_s=0.01, burst_frac=0.1,
                         hang_s=60.0)
    ledger_path = os.path.join(workdir, "quarantine.jsonl")
    if os.path.exists(ledger_path):
        os.unlink(ledger_path)
    ledger = QuarantineLedger(ledger_path)
    watchdog = Watchdog(
        deadlines=parse_deadlines(
            f"ingest.read={soft_deadline_s}/{hard_deadline_s}"),
        ledger=ledger, grace_s=grace_s)
    res = Resilience(ledger=ledger,
                     retry=RetryPolicy(max_retries=1, base_s=0.0,
                                       seed=seed),
                     chaos=monkey, watchdog=watchdog)

    try:
        return _run_drill_criteria(
            workdir, files, wcs, res, monkey, ledger_path, watchdog,
            hard_deadline_s, grace_s, prefetch, n_files, t0, seed=seed,
            device=device)
    finally:
        monkey.release()
        _join_released()


def _run_drill_criteria(workdir, files, wcs, res, monkey, ledger_path,
                        watchdog, hard_deadline_s, grace_s, prefetch,
                        n_files, t0, seed=0, device=None) -> dict:
    from comapreduce_tpu_torch.resilience import QuarantineLedger, Resilience

    # -- 1. chaos run completes ------------------------------------------
    data_chaos = _read(files, wcs, resilience=res, prefetch=prefetch,
                       device=device)
    result_chaos = _solve(data_chaos, device)
    assert np.isfinite(
        np.asarray(result_chaos.destriped_map)).all(), \
        "criterion 1: chaos-run map contains non-finite pixels"

    dead = [files[1], files[2]]          # read_error, truncate
    hung = [files[5]]                    # hang (cancelled, rejected)
    survivors = [f for f in files if f not in dead and f not in hung]
    assert data_chaos.files == survivors, \
        f"criterion 1: expected survivors {survivors}, " \
        f"got {data_chaos.files}"

    # -- 2. every injected fault is ledgered, correctly classified ------
    ledger = QuarantineLedger(ledger_path)  # re-read from disk
    by_file = {}
    for e in ledger.entries:
        by_file.setdefault(os.path.basename(e.unit["file"]), []).append(e)

    def _has(fname, failure_class, disposition):
        return any(e.failure_class == failure_class
                   and e.disposition == disposition
                   for e in by_file.get(os.path.basename(fname), []))

    assert _has(files[1], "transient", "quarantined"), \
        "criterion 2: injected read_error not quarantined as transient"
    assert _has(files[2], "transient", "quarantined"), \
        "criterion 2: injected truncate not quarantined as transient"
    assert _has(files[3], "transient", "recovered"), \
        "criterion 2: flaky read not recorded as recovered-by-retry"
    assert _has(files[4], "numerical", "masked"), \
        "criterion 2: NaN burst not recorded as numerical/masked"
    assert _has(files[5], "hang", "stalled"), \
        "criterion 2: hung read fired no soft-deadline 'stalled' event"
    assert _has(files[5], "hang", "rejected"), \
        "criterion 2: cancelled hang not ledgered as hang/rejected " \
        "(a hang indicts the environment — it must never quarantine)"
    injected_kinds = {k for _, k in monkey.injected}
    assert injected_kinds >= {"read_error", "truncate", "flaky",
                              "nan_burst", "slow_read", "hang"}, \
        f"chaos harness fired only {sorted(injected_kinds)}"

    # -- 3. chaos map == clean map with faulted units zero-weighted -----
    # The reference run reads clean copies of the SURVIVING files with
    # the burst unit (file 4's (feed, start, n), reconstructed from the
    # monkey's own deterministic placement) zero-weighted at the source:
    # value 0, weight 0 — exactly what the tripwire turns the NaNs into,
    # so every downstream operator (median filter included) sees
    # identical inputs and the maps must agree to the last byte.
    import h5py
    import shutil

    ref_dir = os.path.join(workdir, "ref")
    os.makedirs(ref_dir, exist_ok=True)
    ref_files = []
    n_masked = 0
    for f in survivors:
        dst = os.path.join(ref_dir, os.path.basename(f))
        shutil.copy2(f, dst)
        if f == files[4]:
            with h5py.File(dst, "a") as h:
                shape = h["averaged_tod/tod"].shape    # (F, B, T)
                feed, start, n = monkey.burst_coords(f, shape)
                h["averaged_tod/tod"][feed, ..., start:start + n] = 0.0
                h["averaged_tod/weights"][feed, ...,
                                          start:start + n] = 0.0
                n_masked = n
        ref_files.append(dst)
    assert n_masked > 0, "criterion 3: NaN burst masked no samples"
    data_ref = _read(ref_files, wcs, device=device)
    assert data_ref.tod.size == data_chaos.tod.size, \
        "criterion 3: chaos run changed the sample stream shape"
    result_ref = _solve(data_ref, device)
    identical = np.array_equal(np.asarray(result_chaos.destriped_map),
                               np.asarray(result_ref.destriped_map))
    assert identical, \
        "criterion 3: chaos map != clean map with faulted units " \
        "zero-weighted"

    # -- 4. resume consults the ledger; retry_quarantined re-admits -----
    # the HUNG file is rejected, not quarantined: resume re-attempts it
    expected_admit = [f for f in files if f not in dead]
    res2 = Resilience(ledger=QuarantineLedger(ledger_path))
    admitted = [f for f in files if res2.admit(f)]
    assert admitted == expected_admit, \
        f"criterion 4: resume admitted {admitted}, " \
        f"expected {expected_admit}"
    res3 = Resilience(ledger=QuarantineLedger(ledger_path),
                      retry_quarantined=True)
    readmitted = [f for f in files if res3.admit(f)]
    assert readmitted == files, \
        "criterion 4: retry_quarantined did not re-admit the " \
        "quarantined set"
    # ... and exactly the quarantined set was re-admitted
    assert sorted(res3._readmitted) == sorted(dead), \
        f"criterion 4: re-admitted {sorted(res3._readmitted)}, " \
        f"expected {sorted(dead)}"

    # -- 5. deadline budget honoured -------------------------------------
    # every cancelled attempt must land within hard + grace of its own
    # start (the watchdog's audit trail records per-event elapsed); one
    # event per attempt (retry = a fresh budget, so 2 with max_retries=1)
    hangs = [e for e in watchdog.events if e[0] == "hang"]
    assert len(hangs) == 2, \
        f"criterion 5: expected 2 cancelled hang attempts (1 retry), " \
        f"saw {len(hangs)}: {hangs}"
    late = [e for e in hangs if e[3] > hard_deadline_s + grace_s]
    assert not late, \
        f"criterion 5: cancel latency exceeded hard deadline " \
        f"{hard_deadline_s} s + grace {grace_s} s: {late}"

    # -- 6. async writeback: stalled writer cancelled, ordering kept ----
    wb_evidence = _writeback_drill(workdir, res, seed=seed, soft_s=0.1,
                                   hard_s=hard_deadline_s,
                                   grace_s=grace_s)

    return {
        **wb_evidence,
        "n_files": n_files,
        "injected": sorted({(os.path.basename(f), k)
                            for f, k in monkey.injected}),
        "quarantined": sorted(os.path.basename(f)
                              for f in ledger.quarantined_files()),
        "ledger_summary": ledger.summary(),
        "n_masked_samples": n_masked,
        "map_byte_identical": bool(identical),
        "cg_iters_chaos": int(result_chaos.n_iter),
        "hang_cancel_s": [round(e[3], 4) for e in hangs],
        "hard_deadline_s": hard_deadline_s,
        "hang_grace_s": grace_s,
        "watchdog_events": [list(e) for e in watchdog.events][:50],
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _writeback_drill(workdir, res, seed, soft_s, hard_s, grace_s) -> dict:
    """Criterion 6: async writeback under a ``write_stall`` fault.

    A stalled background writer must be cancelled by the
    ``writeback.write`` hard deadline (within ``hard + grace``),
    ledgered ``hang``/``rejected``, must never drop or reorder a
    committed checkpoint, and its abandoned late commit must be skipped
    at the generation gate. Returns the evidence fields merged into the
    drill record."""
    import h5py

    from comapreduce_tpu_torch.data.hdf5io import HDF5Store
    from comapreduce_tpu_torch.data.writeback import Writeback
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey
    from comapreduce_tpu_torch.resilience.watchdog import (HangError, Watchdog,
                                                           parse_deadlines)

    wb_dir = os.path.join(workdir, "writeback")
    os.makedirs(wb_dir, exist_ok=True)
    ok = os.path.join(wb_dir, "Level2_ok.hd5")
    victim = os.path.join(wb_dir, "Level2_stall.hd5")
    for p in (ok, victim):
        if os.path.exists(p):
            os.unlink(p)

    def payload(gen: int) -> dict:
        store = HDF5Store(name="wb-drill")
        store["averaged_tod/tod"] = np.full((2, 64), float(gen),
                                            np.float32)
        store["meta/gen"] = np.array([gen])
        return store.export_payload()

    monkey = ChaosMonkey("write_stall@stall", seed=seed, hang_s=60.0)
    watchdog = Watchdog(
        deadlines=parse_deadlines(f"writeback.write={soft_s}/{hard_s}"),
        ledger=res.ledger, grace_s=grace_s)
    wb = Writeback(depth=4, watchdog=watchdog, chaos=monkey)
    try:
        # ordering: three generations for the healthy file, committed
        # in submission order; the survivor must hold the LAST one
        for gen in (1, 2, 3):
            wb.submit_store(ok, payload(gen))
        wb.flush(ok)
        with h5py.File(ok, "r") as h:
            got = int(h["meta/gen"][0])
            torn = not (h["averaged_tod/tod"][...] == float(got)).all()
        assert got == 3 and not torn, \
            f"criterion 6: committed checkpoint dropped/reordered " \
            f"(gen {got}, torn={torn})"

        err = None
        try:
            wb.submit_store(victim, payload(1))
            wb.flush(victim)
        except OSError as exc:    # HangError is an OSError subclass
            err = exc
        assert isinstance(err, HangError), \
            "criterion 6: stalled writeback was not cancelled by the " \
            "watchdog hard deadline"
        res.record_failure(victim, err, stage="writeback.write",
                           may_quarantine=False)
        hangs = [e for e in watchdog.events if e[0] == "hang"]
        late = [e for e in hangs if e[3] > hard_s + grace_s]
        assert hangs and not late, \
            f"criterion 6: writeback cancel latency exceeded " \
            f"{hard_s} + {grace_s} s: {late}"
        assert not os.path.exists(victim), \
            "criterion 6: a cancelled write must not commit"
        entries = [e for e in res.ledger.entries
                   if e.unit["file"] == victim]
        assert any(e.failure_class == "hang" and
                   e.disposition == "rejected" for e in entries), \
            "criterion 6: stalled write not ledgered hang/rejected"

        # the abandoned writer, released, must SKIP its late commit
        monkey.release()
        deadline = time.perf_counter() + 10.0
        while wb.stats["late_skips"] < 1 and \
                time.perf_counter() < deadline:
            time.sleep(0.02)
        assert wb.stats["late_skips"] >= 1, \
            "criterion 6: abandoned writer's late commit not skipped"
        assert not os.path.exists(victim), \
            "criterion 6: late commit landed after cancellation"
        return {
            "writeback_hang_cancel_s": [round(e[3], 4) for e in hangs],
            "writeback_writes": wb.stats["writes"],
            "writeback_late_skips": wb.stats["late_skips"],
        }
    finally:
        monkey.release()
        wb.close()


def run_elastic_drill(workdir: str, seed: int = 0, n_files: int = 7,
                      ttl_s: float = 1.0, hold_s: float = 10.0,
                      timeout_s: float = 180.0, device=None) -> dict:
    """Criterion 7: the elastic campaign under ``rank_kill`` +
    ``rank_pause``, with REAL processes (a SIGKILL cannot be faked
    in-process).

    Three worker ranks (``python -m comapreduce_tpu_torch.resilience.drill``)
    share one lease directory over the same ``n_files`` fixtures:

    - rank 1 draws ``rank_kill`` on its first rotation unit — SIGKILLed
      the instant the lease is claimed, leaking it;
    - rank 2 draws ``rank_pause`` on its first unit — the zombie: its
      heartbeat freezes but it keeps "working" for ``hold_s`` (far past
      the TTL) and then tries to commit;
    - rank 0, the survivor, waits for both targets' leases to exist
      (so the faults deterministically land on their ranks) and then
      drains the whole queue, stealing both expired leases.

    Asserts: the killed rank died by SIGKILL and wrote nothing; every
    file was committed exactly once (by the survivor); both steals are
    ledgered ``stolen`` then ``recovered``; the zombie's late commit
    was fence-rejected exactly once; every lease file ends ``done`` by
    the survivor; and the destriped map over the committed set is
    byte-identical to a clean run over the same filelist.
    """
    import json
    import shutil
    import subprocess
    import sys

    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience import QuarantineLedger
    from comapreduce_tpu_torch.resilience.lease import (lease_key, lease_path,
                                                        read_lease)

    t0 = time.perf_counter()
    _device_arg(device)  # no card: raise before any rank starts
    os.makedirs(workdir, exist_ok=True)
    files = []
    for i in range(n_files):
        path = os.path.join(workdir, f"Level2_comap-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=1000 + seed * 10 + i)
        files.append(os.path.abspath(path))
    state = os.path.join(workdir, "elastic")
    shutil.rmtree(state, ignore_errors=True)
    os.makedirs(state)
    flist = os.path.join(state, "filelist.txt")
    with open(flist, "w", encoding="utf-8") as f:
        f.write("\n".join(files) + "\n")
    # each fault targets its rank's FIRST rotation unit, so the rank
    # dies/pauses before doing anything else — the worst case for the
    # queue (nothing of its shard completed)
    kill_target = os.path.basename(files[1])
    pause_target = os.path.basename(files[2])
    env = _child_env()

    def spawn(rank: int, **kw):
        cmd = [sys.executable, "-m", "comapreduce_tpu_torch.resilience.drill",
               f"--rank={rank}", "--n-ranks=3", f"--state-dir={state}",
               f"--filelist={flist}", f"--ttl={ttl_s}",
               f"--seed={seed}"]
        cmd += [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    procs = {
        "killer": spawn(1, chaos=f"rank_kill@{kill_target}"),
        "zombie": spawn(2, chaos=f"rank_pause@{pause_target}",
                        hold_s=hold_s, max_files=1),
        "survivor": spawn(0, wait_for=f"{kill_target},{pause_target}"),
    }
    rc, out = {}, {}
    for name, pr in procs.items():
        try:
            stdout, _ = pr.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        rc[name] = pr.returncode
        out[name] = (stdout or b"").decode(errors="replace")

    assert rc["killer"] == -9, \
        f"criterion 7: rank_kill rank exited {rc['killer']}, expected " \
        f"SIGKILL (-9):\n{out['killer']}"
    assert rc["zombie"] == 0, \
        f"criterion 7: zombie rank failed ({rc['zombie']}):\n" \
        f"{out['zombie']}"
    assert rc["survivor"] == 0, \
        f"criterion 7: survivor rank failed ({rc['survivor']}):\n" \
        f"{out['survivor']}"
    assert not os.path.exists(os.path.join(state, "result.rank1.json")), \
        "criterion 7: the SIGKILLed rank wrote a result"

    def result(rank: int) -> dict:
        with open(os.path.join(state, f"result.rank{rank}.json"),
                  encoding="utf-8") as f:
            return json.load(f)

    surv, zomb = result(0), result(2)
    names = sorted(os.path.basename(f) for f in files)
    committed = sorted(surv["committed"] + zomb["committed"])
    # exactly once: equality of sorted MULTISETS catches both a lost
    # unit and a double commit
    assert committed == names, \
        f"criterion 7: committed {committed} != filelist {names} " \
        f"(unit lost or committed twice)"
    assert zomb["committed"] == [] \
        and zomb["stats"]["fence_rejects"] == 1, \
        f"criterion 7: zombie's late commit was not fence-rejected " \
        f"exactly once: {zomb}"
    assert pause_target in zomb["processed"], \
        f"criterion 7: zombie never claimed its pause target: {zomb}"
    assert surv["stats"]["stolen"] == 2 \
        and surv["stats"]["recovered"] == 2, \
        f"criterion 7: survivor should steal AND recover exactly the " \
        f"2 faulted units: {surv['stats']}"
    ledger = QuarantineLedger(os.path.join(state,
                                           "quarantine.rank0.jsonl"))
    stolen = sorted({os.path.basename(e.unit["file"])
                     for e in ledger.entries
                     if e.disposition == "stolen"})
    recovered = sorted({os.path.basename(e.unit["file"])
                        for e in ledger.entries
                        if e.disposition == "recovered"})
    assert stolen == recovered == sorted([kill_target, pause_target]), \
        f"criterion 7: ledger stole {stolen} / recovered {recovered}, " \
        f"expected {sorted([kill_target, pause_target])}"
    for f in files:
        st = read_lease(lease_path(state, lease_key(f)))
        assert st is not None and st.get("state") == "done", \
            f"criterion 7: lease for {os.path.basename(f)} not done: {st}"
        assert int(st.get("done_by", -1)) == 0, \
            f"criterion 7: {os.path.basename(f)} finished by rank " \
            f"{st.get('done_by')}, expected the survivor (0)"

    # the map over the committed set must match a clean static run over
    # the same filelist to the last byte — stealing moved units between
    # ranks, it must not change WHAT gets reduced
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    by_name = {os.path.basename(f): f for f in files}
    map_elastic = np.asarray(_solve(_read(
        [by_name[n] for n in committed], wcs, device=device),
        device).destriped_map)
    map_clean = np.asarray(_solve(_read(
        sorted(files), wcs, device=device), device).destriped_map)
    identical = bool(np.array_equal(map_elastic, map_clean))
    assert identical, \
        "criterion 7: elastic-campaign map != clean run over the " \
        "same filelist"

    return {
        "elastic_returncodes": dict(rc),
        "elastic_committed": {"survivor": surv["committed"],
                              "zombie": zomb["committed"]},
        "elastic_stats": {"survivor": surv["stats"],
                          "zombie": zomb["stats"]},
        "elastic_stolen": stolen,
        "elastic_recovered": recovered,
        "elastic_fence_rejects": zomb["stats"]["fence_rejects"],
        "elastic_map_byte_identical": identical,
        "elastic_wall_s": round(time.perf_counter() - t0, 3),
    }


def run_live_drill(workdir: str, seed: int = 0, n_files: int = 6,
                   ttl_s: float = 2.0, timeout_s: float = 180.0,
                   device=None) -> dict:
    """Criterion 8: the live observability plane over a real elastic
    campaign with a real SIGKILL (docs/OPERATIONS.md §16).

    Two worker ranks share one lease directory; rank 1 draws
    ``rank_kill`` on its first unit and dies mid-claim; rank 0 (the
    survivor) steals the leaked lease and drains the queue; rank 1 is
    then RESTARTED (a restarted rank beats again and finds every unit
    done elsewhere). A :class:`telemetry.live.LiveServer` watches the
    state dir throughout.

    Asserts: ``/healthz`` flips to 503 within one heartbeat TTL of the
    SIGKILL and back to 200 after the steal + restart (clean ``.done``
    heartbeats probe healthy); the ``/metrics`` Prometheus page parses
    line-by-line and its ``comap_scheduler_committed_total`` summed
    across ranks equals the scheduler's own commit count EXACTLY (one
    counter event per commit — the live file-done count is trustworthy);
    and ``/v1/campaign`` serves the schema-2 report.
    """
    import json
    import re as _re
    import shutil
    import subprocess
    import sys
    from urllib.error import URLError
    from urllib.request import urlopen

    from comapreduce_tpu_torch.telemetry.live import LiveServer

    t0 = time.perf_counter()
    _device_arg(device)  # no card: raise before any rank starts
    os.makedirs(workdir, exist_ok=True)
    files = []
    for i in range(n_files):
        path = os.path.join(workdir, f"Level2_comap-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=1000 + seed * 10 + i)
        files.append(os.path.abspath(path))
    state = os.path.join(workdir, "live")
    shutil.rmtree(state, ignore_errors=True)
    os.makedirs(state)
    flist = os.path.join(state, "filelist.txt")
    with open(flist, "w", encoding="utf-8") as f:
        f.write("\n".join(files) + "\n")
    kill_target = os.path.basename(files[1])
    env = _child_env()
    srv = LiveServer(state, port=0, stale_s=ttl_s, n_ranks=2).start()

    def spawn(rank: int, **kw):
        cmd = [sys.executable, "-m", "comapreduce_tpu_torch.resilience.drill",
               f"--rank={rank}", "--n-ranks=2", f"--state-dir={state}",
               f"--filelist={flist}", f"--ttl={ttl_s}",
               f"--seed={seed}", "--telemetry"]
        cmd += [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def wait(pr):
        try:
            stdout, _ = pr.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        return pr.returncode, (stdout or b"").decode(errors="replace")

    def probe() -> int:
        try:
            with urlopen(f"http://{srv.host}:{srv.port}/healthz",
                         timeout=10) as r:
                return r.status
        except URLError as exc:
            code = getattr(exc, "code", None)
            if code is not None:
                return int(code)  # urlopen raises on 503
            raise

    def poll_until(status: int, deadline_s: float, what: str) -> float:
        t_start = time.monotonic()
        while True:
            if probe() == status:
                return time.monotonic() - t_start
            if time.monotonic() - t_start > deadline_s:
                raise AssertionError(
                    f"criterion 8: /healthz never reached {status} "
                    f"within {deadline_s:.1f} s ({what})")
            time.sleep(0.05)

    try:
        killer = spawn(1, chaos=f"rank_kill@{kill_target}")
        survivor = spawn(0, wait_for=kill_target)
        rc_kill, out_kill = wait(killer)
        t_kill = time.monotonic()
        assert rc_kill == -9, \
            f"criterion 8: rank_kill rank exited {rc_kill}, expected " \
            f"SIGKILL (-9):\n{out_kill}"
        # the dead rank's heartbeat freezes mid-stage: the probe must
        # flip unhealthy within one TTL of the kill (plus poll slack)
        poll_until(503, ttl_s + 2.0, "after SIGKILL")
        t_503 = time.monotonic() - t_kill
        rc_surv, out_surv = wait(survivor)
        assert rc_surv == 0, \
            f"criterion 8: survivor failed ({rc_surv}):\n{out_surv}"
        # the survivor finished cleanly (.done) but the dead rank's
        # stale beat still pins the probe at 503 — only a restart (or
        # operator retirement of the rank) clears it
        assert probe() == 503, \
            "criterion 8: /healthz went 200 while the killed rank's " \
            "stale heartbeat was still unresolved"
        rc_again, out_again = wait(spawn(1))
        assert rc_again == 0, \
            f"criterion 8: restarted rank failed ({rc_again}):" \
            f"\n{out_again}"
        poll_until(200, 10.0, "after steal + restart")

        with urlopen(f"http://{srv.host}:{srv.port}/metrics",
                     timeout=10) as r:
            assert r.status == 200
            prom = r.read().decode("utf-8")
        line_re = _re.compile(
            r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? \S+$")
        bad = [ln for ln in prom.splitlines()
               if ln and not ln.startswith("#")
               and not line_re.match(ln)]
        assert not bad, \
            f"criterion 8: unparseable /metrics line(s): {bad[:3]}"
        committed_metric = 0.0
        for ln in prom.splitlines():
            if ln.startswith("comap_scheduler_committed_total{"):
                committed_metric += float(ln.rsplit(" ", 1)[1])
        results = {}
        for rank in (0, 1):
            with open(os.path.join(state, f"result.rank{rank}.json"),
                      encoding="utf-8") as f:
                results[rank] = json.load(f)
        committed_true = sum(r["stats"]["committed"]
                             for r in results.values())
        # EXACT: every scheduler commit emitted exactly one counter
        # event and the tail absorbed every one of them
        assert committed_metric == committed_true == n_files, \
            f"criterion 8: /metrics committed {committed_metric} != " \
            f"scheduler committed {committed_true} (n_files {n_files})"
        assert "comap_live_healthy 1" in prom, \
            "criterion 8: /metrics lacks comap_live_healthy 1"
        with urlopen(f"http://{srv.host}:{srv.port}/v1/campaign",
                     timeout=10) as r:
            rep = json.load(r)
        assert rep.get("schema") == 2 and not rep.get("n_stale"), \
            f"criterion 8: /v1/campaign unhealthy after recovery: " \
            f"{ {k: rep.get(k) for k in ('schema', 'n_stale')} }"
    finally:
        srv.stop()

    return {
        "live_t_503_after_kill_s": round(t_503, 3),
        "live_ttl_s": ttl_s,
        "live_committed_metric": committed_metric,
        "live_committed_true": committed_true,
        "live_metrics_lines": len(prom.splitlines()),
        "live_requests": srv.stats["n_requests"],
        "live_wall_s": round(time.perf_counter() - t0, 3),
    }


def _elastic_worker_main(argv=None) -> int:
    """One elastic-drill rank (the ``python -m`` entry): heartbeat +
    scheduler over the shared state dir, committing every claimed unit.
    The chaos spec (``rank_kill``/``rank_pause``) makes this rank the
    drill's victim; ``--wait-for`` makes it the survivor (it defers
    claiming until the victims' leases exist, so the faults land
    deterministically). Results land in ``result.rank<r>.json``."""
    import argparse
    import json

    from comapreduce_tpu_torch.pipeline.scheduler import Scheduler
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey
    from comapreduce_tpu_torch.resilience.heartbeat import Heartbeat
    from comapreduce_tpu_torch.resilience.ledger import QuarantineLedger
    from comapreduce_tpu_torch.resilience.lease import lease_key, lease_path

    p = argparse.ArgumentParser(prog="drill-elastic-worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--n-ranks", type=int, required=True)
    p.add_argument("--state-dir", required=True)
    p.add_argument("--filelist", required=True)
    p.add_argument("--ttl", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chaos", default="")
    p.add_argument("--wait-for", default="")
    p.add_argument("--hold-s", type=float, default=0.0)
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--telemetry", action="store_true")
    a = p.parse_args(argv)
    with open(a.filelist, encoding="utf-8") as f:
        files = [ln.strip() for ln in f if ln.strip()]
    if a.telemetry:
        # the live drill scrapes this rank's counter stream off disk
        # while it runs — flush fast so commits land within a poll
        from comapreduce_tpu_torch.telemetry import TELEMETRY

        TELEMETRY.configure(a.state_dir, rank=a.rank, flush_s=0.2)
    hb = Heartbeat(a.state_dir, rank=a.rank,
                   period_s=max(a.ttl / 5.0, 0.05))
    hb.start()
    monkey = ChaosMonkey(a.chaos, seed=a.seed) if a.chaos else None
    ledger = QuarantineLedger(os.path.join(
        a.state_dir, f"quarantine.rank{a.rank}.jsonl"))
    sched = Scheduler(files, a.state_dir, rank=a.rank,
                      n_ranks=a.n_ranks, lease_ttl_s=a.ttl,
                      poll_s=min(a.ttl / 5.0, 0.25), ledger=ledger,
                      chaos=monkey, heartbeat=hb)
    if a.wait_for:
        want = [lease_path(a.state_dir, lease_key(k))
                for k in a.wait_for.split(",") if k]
        deadline = time.monotonic() + 60.0
        while not all(os.path.exists(w) for w in want):
            if time.monotonic() > deadline:
                raise RuntimeError(f"peer leases never appeared: {want}")
            time.sleep(0.05)
    processed, committed = [], []
    for f in sched.claim_iter():
        processed.append(os.path.basename(f))
        if a.hold_s and getattr(hb, "_paused", False):
            # the zombie: keep "working" far past the TTL so the
            # survivor steals and redoes the unit before this commit
            time.sleep(a.hold_s)
        if sched.commit(f):
            committed.append(os.path.basename(f))
        if a.max_files and len(processed) >= a.max_files:
            break
    out = {"rank": a.rank, "processed": processed,
           "committed": committed, "stats": sched.stats}
    tmp = os.path.join(a.state_dir, f".result.rank{a.rank}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(a.state_dir,
                                 f"result.rank{a.rank}.json"))
    if a.telemetry:
        from comapreduce_tpu_torch.telemetry import TELEMETRY

        TELEMETRY.close()  # drain the counter buffer before exit
    hb.stop(final_stage="drill.elastic.done")
    return 0


def _commit_done(state_dir: str, files) -> None:
    """Mark ``files`` committed in ``state_dir``'s lease layout — the
    drill's stand-in for a campaign's reduce+commit of each unit."""
    from comapreduce_tpu_torch.resilience.lease import LeaseBoard

    board = LeaseBoard(state_dir, rank=0, lease_ttl_s=60.0)
    for f in files:
        lease = board.claim(f)
        assert lease is not None, f"drill setup: could not claim {f}"
        assert board.commit(lease), f"drill setup: could not commit {f}"


def _epoch_products(epochs_dir: str, n: int) -> dict:
    """Byte-compare material for epoch ``n``: raw map FITS bytes plus
    the published offsets vector."""
    from comapreduce_tpu_torch.serving.epochs import EpochStore
    from comapreduce_tpu_torch.serving.server import load_epoch_offsets

    d = EpochStore(epochs_dir).epoch_dir(n)
    with open(os.path.join(d, "map_band0.fits"), "rb") as f:
        fits = f.read()
    off = load_epoch_offsets(os.path.join(d, "solver_band0.npz"))
    return {"fits": fits, "offsets": off["offsets"]}


def _read_epoch_map(epochs_dir: str, n: int, name: str = "DESTRIPED"):
    from comapreduce_tpu_torch.mapmaking.fits_io import read_fits_image
    from comapreduce_tpu_torch.serving.epochs import EpochStore

    d = EpochStore(epochs_dir).epoch_dir(n)
    for hname, _, arr in read_fits_image(os.path.join(d,
                                                      "map_band0.fits")):
        if hname.upper() == name:
            return np.asarray(arr)
    raise AssertionError(f"epoch {n} map has no {name} HDU")


def run_serving_drill(workdir: str, seed: int = 0, n_files: int = 8,
                      timeout_s: float = 300.0, device=None) -> dict:
    """Criterion 8: the incremental map server, with REAL processes for
    the mid-publish SIGKILL (docstring item 8 for the full contract).

    Three waves of committed files drive four server invocations
    (``python -m comapreduce_tpu_torch.resilience.drill --serving``, one
    epoch attempt each):

    - wave 1 (``n_files - 2`` files) publishes ``epoch-000001``
      cleanly;
    - wave 2 (1 file) is solved but the publisher draws
      ``kill_mid_publish`` — SIGKILLed after writing its temp epoch
      dir, before the atomic rename;
    - wave 3 (1 file) resumes the server: temp garbage is swept and
      all pending files publish as ``epoch-000002``.

    An uninterrupted TWIN run over the same waves and a COLD one-shot
    run over the full census provide the byte-identity references.
    The fixtures carry drift + random-walk noise over raster pointing
    (``_write_level2``) so offsets have real 1/f structure — that is
    what makes the warm-started epoch's CG converge in strictly fewer
    iterations than the cold one-shot.
    """
    import json
    import shutil
    import subprocess
    import sys

    from comapreduce_tpu_torch.cli.run_destriper import solve_band
    from comapreduce_tpu_torch.mapmaking.leveldata import read_comap_data
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.serving.epochs import EpochStore
    from comapreduce_tpu_torch.serving.ledger import ServedLedger

    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    files = []
    for i in range(n_files):
        path = os.path.join(workdir, f"Level2_serving-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=1000 + seed * 10 + i,
                          drift=6.0, rw=0.3, raster=True)
        files.append(os.path.abspath(path))
    names = sorted(os.path.basename(f) for f in files)
    wave1, wave2, wave3 = files[:-2], files[-2:-1], files[-1:]
    dev = _device_arg(device)

    dirs = {k: os.path.join(workdir, f"serving-{k}")
            for k in ("state", "epochs", "twin-state", "twin",
                      "cold-epochs")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    env = _child_env()

    def run_server(state_dir, epochs_dir, chaos=""):
        cmd = [sys.executable, "-m",
               "comapreduce_tpu_torch.resilience.drill", "--serving",
               f"--state-dir={state_dir}", f"--epochs-dir={epochs_dir}",
               f"--seed={seed}", f"--device={dev}"]
        if chaos:
            cmd.append(f"--chaos={chaos}")
        pr = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, timeout=timeout_s)
        return pr.returncode, (pr.stdout or b"").decode(errors="replace")

    # ---- the drilled run: publish, die mid-publish, resume ----
    _commit_done(dirs["state"], wave1)
    rc, out = run_server(dirs["state"], dirs["epochs"])
    assert rc == 0, f"criterion 8: epoch-1 publish failed ({rc}):\n{out}"
    store = EpochStore(dirs["epochs"])
    assert store.current() == 1 and \
        store.census(1) == {os.path.basename(f) for f in wave1}, \
        f"criterion 8: epoch-1 wrong: current={store.current()} " \
        f"census={store.census(1)}"

    _commit_done(dirs["state"], wave2)
    rc, out = run_server(dirs["state"], dirs["epochs"],
                         chaos="kill_mid_publish@epoch-000002")
    assert rc == -9, \
        f"criterion 8: mid-publish rank exited {rc}, expected SIGKILL " \
        f"(-9):\n{out}"
    # the reader-facing promise: a publisher SIGKILLed mid-publish
    # leaves `current` on a COMPLETE epoch and no epoch-2 directory
    assert store.current() == 1 and store.manifest(1) is not None, \
        f"criterion 8: current torn after mid-publish kill: " \
        f"{store.current()}"
    assert store.latest() == 1 and not os.path.isdir(store.epoch_dir(2)), \
        "criterion 8: a half-published epoch-2 is visible"
    tmp_left = [x for x in os.listdir(dirs["epochs"])
                if x.startswith(".tmp-epoch.")]
    assert tmp_left, \
        "criterion 8: kill_mid_publish fired after the rename " \
        "(drill aimed it before)"

    _commit_done(dirs["state"], wave3)
    rc, out = run_server(dirs["state"], dirs["epochs"])
    assert rc == 0, f"criterion 8: resume failed ({rc}):\n{out}"
    assert store.current() == 2 and store.census(2) == set(names), \
        f"criterion 8: resumed epoch wrong: current={store.current()} " \
        f"census={store.census(2)}"
    assert not [x for x in os.listdir(dirs["epochs"])
                if x.startswith(".tmp-epoch.")], \
        "criterion 8: resume left dead .tmp-epoch.* garbage"

    # exactly-once folding: the epochs' new_files partition the census,
    # and the admission ledger holds each file exactly once
    folded = []
    for n in store.list_epochs():
        folded += list(store.manifest(n).get("new_files", []))
    assert sorted(folded) == names, \
        f"criterion 8: files folded {sorted(folded)} != committed " \
        f"{names} (lost or double-folded)"
    ledger = ServedLedger(os.path.join(dirs["epochs"], "served.jsonl"))
    assert sorted(ledger.files) == names and len(ledger) == len(names), \
        f"criterion 8: admission ledger {sorted(ledger.files)} != " \
        f"{names}"

    # ---- the uninterrupted twin: same waves, no chaos ----
    _commit_done(dirs["twin-state"], wave1)
    rc, out = run_server(dirs["twin-state"], dirs["twin"])
    assert rc == 0, f"criterion 8: twin epoch-1 failed ({rc}):\n{out}"
    _commit_done(dirs["twin-state"], wave2 + wave3)
    rc, out = run_server(dirs["twin-state"], dirs["twin"])
    assert rc == 0, f"criterion 8: twin epoch-2 failed ({rc}):\n{out}"
    for n in (1, 2):
        got = _epoch_products(dirs["epochs"], n)
        want = _epoch_products(dirs["twin"], n)
        assert got["fits"] == want["fits"] and \
            np.array_equal(got["offsets"], want["offsets"]), \
            f"criterion 8: killed+resumed epoch-{n} differs from the " \
            f"uninterrupted twin's"

    # ---- cold one-shot over the full census: assembly parity ----
    rc, out = run_server(dirs["state"], dirs["cold-epochs"])
    assert rc == 0, f"criterion 8: cold one-shot failed ({rc}):\n{out}"
    cold_store = EpochStore(dirs["cold-epochs"])
    assert cold_store.current() == 1 and \
        cold_store.census(1) == set(names), \
        "criterion 8: cold one-shot census wrong"
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    batch_data = read_comap_data(sorted(files), band=0, wcs=wcs,
                                 offset_length=50, medfilt_window=201,
                                 use_calibration=False, device=dev)
    batch = solve_band(batch_data, offset_length=50, n_iter=300,
                       threshold=1e-8, device=dev)
    batch_map = np.asarray(batch.destriped_map).reshape(64, 64)
    cold_map = _read_epoch_map(dirs["cold-epochs"], 1)
    parity = bool(np.array_equal(cold_map, batch_map, equal_nan=True))
    assert parity, \
        "criterion 8: cold serving epoch != batch read+solve over the " \
        "same census (incremental assembly broke parity)"

    # ---- warm vs cold: fewer iterations, equal modulo the null mode
    warm_cg = store.manifest(2)["cg"]
    cold_cg = cold_store.manifest(1)["cg"]
    assert warm_cg["x0"] == "epoch-000001" and cold_cg["x0"] == "cold", \
        f"criterion 8: warm-start provenance wrong: {warm_cg} {cold_cg}"
    assert warm_cg["n_iter"] < cold_cg["n_iter"], \
        f"criterion 8: warm epoch used {warm_cg['n_iter']} CG " \
        f"iterations, cold used {cold_cg['n_iter']} — warm start " \
        f"saved nothing"
    warm_map = _read_epoch_map(dirs["epochs"], 2)
    wmap = _read_epoch_map(dirs["epochs"], 2, "WEIGHTS")
    hit = wmap > 0
    diff = warm_map[hit] - cold_map[hit]
    null_mode = float(np.sum(diff * wmap[hit]) / np.sum(wmap[hit]))
    resid = float(np.max(np.abs(diff - null_mode)))
    assert resid < 1e-4, \
        f"criterion 8: warm and cold maps disagree beyond the null " \
        f"mode (max {resid:.2e} after removing the {null_mode:.2e} " \
        f"constant)"

    return {
        "serving_epochs": store.list_epochs(),
        "serving_folded": sorted(folded),
        "serving_kill_rc": -9,
        "serving_twin_byte_identical": True,
        "serving_cold_parity": parity,
        "serving_warm_iters": int(warm_cg["n_iter"]),
        "serving_cold_iters": int(cold_cg["n_iter"]),
        "serving_null_mode_resid": resid,
        "serving_freshness_s": float(
            store.manifest(2).get("freshness_s", 0.0)),
        "serving_wall_s": round(time.perf_counter() - t0, 3),
    }


def run_tiles_drill(workdir: str, seed: int = 0, n_files: int = 4,
                    timeout_s: float = 300.0, device=None) -> dict:
    """Criterion 9: the map tile read tier end-to-end.

    Real server subprocesses reduce committed waves into epochs and
    cut them into a content-addressed tiles root; a real
    ``python -m comapreduce_tpu_torch.cli.tile_server serve`` process
    fronts it over HTTP.
    Asserts, in order:

    - wave 1 publishes ``epoch-000001`` and tiles it (the map
      server's publish hook); the tiles ``CURRENT`` points at it;
    - wave 2's publisher draws ``kill_mid_publish@tiles-epoch-000002``
      — SIGKILLed after the epoch publish, after the tile OBJECTS are
      written, before the tile manifest lands. The epoch stands, the
      tile tier still serves epoch 1 whole (old-or-new, never torn);
    - the CLI backfill (``cli.tile_server tile``) repairs the gap
      idempotently, and a full re-tile of epoch 2 into a FRESH root
      yields byte-identical tile hashes (deterministic encoding), so
      the published delta is exactly the full-retile diff;
    - an HTTP cutout of epoch 2 is bit-identical to slicing the
      expanded epoch FITS; conditional requests 304; a tiles rollback
      moves ``/v1/current`` atomically while the epoch-addressed URLs
      keep validating (a pinned reader's cache stays warm);
    - each serving process landed on its OWN telemetry lane
      (auto-incremented rank >= 1000 streams in the state dir);
    - ``MapServer.evict`` retracts a served file: the downdated epoch
      passes the (relaxed) fence with the SHRUNKEN census, its tiles
      are byte-identical to epoch 1's (content addressing across
      history), and the admission scan does NOT re-admit the
      retracted file.
    """
    import json
    import shutil
    import subprocess
    import sys
    import urllib.error
    import urllib.request

    from comapreduce_tpu_torch.mapmaking.fits_io import read_fits_image
    from comapreduce_tpu_torch.serving.epochs import EpochStore
    from comapreduce_tpu_torch.serving.ledger import ServedLedger
    from comapreduce_tpu_torch.tiles.blob import decode_tile
    from comapreduce_tpu_torch.tiles.tiler import TileSet, tile_epoch

    t0 = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    files = []
    for i in range(n_files):
        path = os.path.join(workdir, f"Level2_tiles-{i:04d}.hd5")
        if not os.path.exists(path):
            _write_level2(path, seed=2000 + seed * 10 + i,
                          drift=6.0, rw=0.3, raster=True)
        files.append(os.path.abspath(path))
    names = sorted(os.path.basename(f) for f in files)
    wave1, wave2 = files[:-1], files[-1:]
    dev = _device_arg(device)

    dirs = {k: os.path.join(workdir, f"tiles-{k}")
            for k in ("state", "epochs", "root", "retile")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    env = _child_env()
    tile_cli = [sys.executable, "-m", "comapreduce_tpu_torch.cli.tile_server"]

    def run_server(chaos=""):
        cmd = [sys.executable, "-m",
               "comapreduce_tpu_torch.resilience.drill", "--serving",
               f"--state-dir={dirs['state']}",
               f"--epochs-dir={dirs['epochs']}",
               f"--tiles-dir={dirs['root']}", "--tile-px=16",
               "--telemetry", f"--seed={seed}", f"--device={dev}"]
        if chaos:
            cmd.append(f"--chaos={chaos}")
        pr = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, timeout=timeout_s)
        return pr.returncode, (pr.stdout or b"").decode(errors="replace")

    # ---- wave 1: publish + tile ----
    _commit_done(dirs["state"], wave1)
    rc, out = run_server()
    assert rc == 0, f"criterion 9: epoch-1 publish failed ({rc}):\n{out}"
    store = EpochStore(dirs["epochs"])
    ts = TileSet(dirs["root"])
    man1 = ts.manifest(1)
    assert store.current() == 1 and ts.current() == 1 and man1, \
        f"criterion 9: epoch-1 not tiled (tiles CURRENT={ts.current()})"
    assert man1["n_tiles"] > 1, \
        f"criterion 9: {man1['n_tiles']} tile(s) — the 16px grid " \
        "should cut the 64x64 field into several"

    # ---- wave 2: SIGKILL between the epoch publish and the tile
    # manifest write (the widest tile-tier window) ----
    _commit_done(dirs["state"], wave2)
    rc, out = run_server(chaos="kill_mid_publish@tiles-epoch-000002")
    assert rc == -9, \
        f"criterion 9: mid-tile-publish rank exited {rc}, expected " \
        f"SIGKILL (-9):\n{out}"
    assert store.current() == 2, \
        "criterion 9: the EPOCH publish should have completed before " \
        f"the tile kill (current={store.current()})"
    ts = TileSet(dirs["root"])
    assert ts.latest() == 1 and ts.current() == 1 and \
        ts.manifest(2) is None, \
        "criterion 9: tile tier torn after mid-tile-publish kill " \
        f"(latest={ts.latest()} current={ts.current()})"

    # ---- CLI backfill repairs the gap ----
    pr = subprocess.run(
        tile_cli + ["tile", f"--epochs-dir={dirs['epochs']}",
                    f"--tiles-dir={dirs['root']}", "--tile-px=16"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=timeout_s)
    assert pr.returncode == 0, \
        f"criterion 9: tile backfill failed:\n{pr.stdout.decode()}"
    man2 = ts.manifest(2)
    assert man2 is not None and ts.current() == 2, \
        "criterion 9: backfill did not publish the epoch-2 tile set"

    # ---- delta == full-retile diff; hashes byte-stable across roots
    retile = tile_epoch(store.epoch_dir(2), dirs["retile"], tile_px=16)
    assert retile["tiles"] == man2["tiles"], \
        "criterion 9: re-tiling epoch 2 into a fresh root changed " \
        "tile hashes — the blob encoding is not deterministic"
    delta = ts.delta(2)
    want_changed = {k for k, v in man2["tiles"].items()
                    if (man1["tiles"].get(k) or [None])[0] != v[0]}
    want_removed = sorted(k for k in man1["tiles"]
                          if k not in man2["tiles"])
    assert set(delta["changed"]) == want_changed and \
        delta["removed"] == want_removed, \
        f"criterion 9: delta ({delta['n_changed']} changed, " \
        f"{delta['n_removed']} removed) is not the exact manifest diff"
    n_unchanged = sum(1 for k, v in man2["tiles"].items()
                      if (man1["tiles"].get(k) or [None])[0] == v[0])
    assert delta["n_unchanged"] == n_unchanged, \
        "criterion 9: delta n_unchanged miscounts byte-stable tiles"

    # ---- HTTP: cutout bit-identity, 304s, rollback ----
    srv = subprocess.Popen(
        tile_cli + ["serve", f"--tiles-dir={dirs['root']}", "--port=0",
                    f"--epochs-dir={dirs['epochs']}",
                    f"--telemetry-dir={dirs['state']}",
                    f"--max-wall-s={timeout_s}", f"--device={dev}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        line = srv.stdout.readline().decode()
        assert "listening on http://" in line, \
            f"criterion 9: tile server did not start: {line}"
        base = line.split("listening on ")[1].split("/ ")[0]

        def fetch(url, etag=None):
            rq = urllib.request.Request(base + url)
            if etag:
                rq.add_header("If-None-Match", etag)
            try:
                with urllib.request.urlopen(rq, timeout=10) as r:
                    return r.status, dict(r.headers), r.read()
            except urllib.error.HTTPError as e:
                return e.code, dict(e.headers), b""

        st, _, body = fetch("/v1/current")
        assert st == 200 and json.loads(body)["epoch"] == 2, \
            f"criterion 9: /v1/current wrong: {st} {body!r}"
        x0, y0, w, h = 5, 9, 37, 21   # crosses 16px tile boundaries
        st, hdrs, blob = fetch(
            f"/v1/epochs/2/cutout?x0={x0}&y0={y0}&w={w}&h={h}")
        assert st == 200 and "immutable" in hdrs.get("Cache-Control", ""),\
            f"criterion 9: cutout fetch failed ({st})"
        cut = decode_tile(blob)["products"]
        full = {nm: np.asarray(arr, np.float32) for nm, _, arr in
                read_fits_image(os.path.join(store.epoch_dir(2),
                                             "map_band0.fits"))}
        for nm, ref in full.items():
            got = cut[nm]
            assert np.array_equal(got, ref[y0:y0 + h, x0:x0 + w]), \
                f"criterion 9: HTTP cutout {nm} != expanded FITS slice"
        etag = hdrs["ETag"]
        st, _, _ = fetch(
            f"/v1/epochs/2/cutout?x0={x0}&y0={y0}&w={w}&h={h}", etag)
        assert st == 304, f"criterion 9: cutout revalidation got {st}"
        st, mh, _ = fetch("/v1/epochs/2/manifest.json")
        man_etag = mh["ETag"]
        # rollback: /v1/current swaps atomically; epoch-addressed URLs
        # keep validating (the pinned reader's cache stays intact)
        ts.set_current(1, force=True)
        st, _, body = fetch("/v1/current")
        assert st == 200 and json.loads(body)["epoch"] == 1, \
            "criterion 9: /v1/current did not follow the rollback"
        st, _, _ = fetch("/v1/epochs/2/manifest.json", man_etag)
        assert st == 304, \
            "criterion 9: epoch-2 manifest ETag broke across rollback"
        ts.set_current(2)
        st, _, body = fetch("/v1/status")
        assert st == 200 and json.loads(body)["current"] == 2
    finally:
        srv.kill()
        srv.wait(timeout=30)

    # ---- telemetry: every serving process on its own lane ----
    lanes = sorted(int(f.split("rank")[1].split(".")[0])
                   for f in os.listdir(dirs["state"])
                   if f.startswith("events.rank")
                   and int(f.split("rank")[1].split(".")[0]) >= 1000)
    assert len(lanes) >= 3 and len(set(lanes)) == len(lanes), \
        f"criterion 9: serving-lane ranks collided: {lanes} (two map " \
        "server runs + the tile server must each get a fresh stream)"

    # ---- evict: downdated epoch past the fence, byte-stable tiles --
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.serving.server import MapServer

    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    server = MapServer(
        dirs["state"], dirs["epochs"], wcs=wcs, band=0,
        offset_length=50, n_iter=300, threshold=1e-8,
        medfilt_window=201, use_calibration=False, warm_start=False,
        tiles_root=dirs["root"], tile_px=16, device=dev)
    evicted = os.path.basename(wave2[0])
    n3 = server.evict(evicted)
    assert n3 == 3, f"criterion 9: evict published {n3}, expected 3"
    man_e = store.manifest(3)
    assert man_e.get("downdated") is True and \
        man_e.get("evicted") == [evicted] and \
        store.census(3) == {os.path.basename(f) for f in wave1}, \
        "criterion 9: downdated epoch census/flags wrong"
    man3 = TileSet(dirs["root"]).manifest(3)
    assert man3 is not None and man3["tiles"] == man1["tiles"], \
        "criterion 9: evicting back to epoch-1's census did not " \
        "reproduce epoch-1's tile hashes (content addressing broke)"
    # the watcher still lists the evicted commit; admission must skip
    assert server.admit_new() == [] and evicted not in server.ledger, \
        "criterion 9: the admission scan re-admitted an evicted file"
    led = ServedLedger(os.path.join(dirs["epochs"], "served.jsonl"))
    assert evicted in led.retracted and evicted not in led, \
        "criterion 9: retraction did not survive a ledger reload"

    return {
        "tiles_epochs": ts.list_tiled(),
        "tiles_n_tiles": [man1["n_tiles"], man2["n_tiles"],
                          man3["n_tiles"]],
        "tiles_kill_rc": -9,
        "tiles_delta_changed": int(delta["n_changed"]),
        "tiles_delta_unchanged": int(delta["n_unchanged"]),
        "tiles_retile_byte_identical": True,
        "tiles_cutout_bit_identical": True,
        "tiles_serving_lanes": lanes,
        "tiles_evict_epoch": int(n3),
        "tiles_census": names,
        "tiles_wall_s": round(time.perf_counter() - t0, 3),
    }


def run_integrity_drill(workdir: str, seed: int = 0,
                        n_files: int = 4, device=None) -> dict:
    """Criterion 10 (the integrity plane, docs/OPERATIONS.md §20): one
    byte flipped per durable artifact class — Level-2 checkpoint,
    BlockCache spill, solver snapshot, epoch FITS, tile object, ledger
    line — asserting 100% detection by the offline fsck, the correct
    per-class triage at every read boundary (``corrupt`` ledger
    disposition + skip for the checkpoint; cache-miss + unlink for the
    spill; cold solve for the snapshot; ``verify_epoch`` problems for
    the FITS; ``CorruptArtifactError`` + unlink for the tile;
    dropped-and-counted for the ledger line), that chaos ``bit_rot``
    fires post-commit (always detectable) at most once per basename,
    and that after ``campaign_fsck --repair`` + re-derivation the
    final map is byte-identical to the clean run's."""
    import json as _json
    import subprocess
    import sys as _sys

    from comapreduce_tpu_torch.ingest.cache import BlockCache
    from comapreduce_tpu_torch.mapmaking.destriper import (
        load_solver_checkpoint, save_solver_checkpoint)
    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience import QuarantineLedger, Resilience
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey, flip_byte
    from comapreduce_tpu_torch.resilience.integrity import (
        CorruptArtifactError, seal_json, verify_file, write_sidecar)
    from comapreduce_tpu_torch.resilience.retry import RetryPolicy
    from comapreduce_tpu_torch.serving.epochs import (EpochStore, verify_epoch,
                                                      verify_epoch_product)
    from comapreduce_tpu_torch.tiles.store import TileStore

    t0 = time.perf_counter()
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)

    def _fixture(i: int) -> None:
        path = os.path.join(workdir, f"Level2_comap-{i:04d}.hd5")
        if os.path.exists(path):
            os.unlink(path)  # HDF5Store.write appends into rotted files
        _write_level2(path, seed=3000 + seed * 10 + i)
        write_sidecar(path, path, kind="checkpoint")
        return path

    files = [_fixture(i) for i in range(n_files)]
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    clean_map = np.asarray(_solve(_read(files, wcs, device=device),
                                  device).destriped_map).tobytes()

    # -- one committed artifact of every other class --------------------
    spill_dir = os.path.join(workdir, "spill")
    cache = BlockCache(max_bytes=64, spill_dir=spill_dir)
    spill_payload = np.arange(4096, dtype=np.float32)
    cache.put(files[0], spill_payload)   # oversized -> straight to disk
    spill_file = [os.path.join(spill_dir, n)
                  for n in sorted(os.listdir(spill_dir))
                  if not n.endswith(".s256")][0]

    sck = os.path.join(workdir, "solver_band0.npz")
    save_solver_checkpoint(sck, np.ones(32, np.float32), 7,
                           [1e-3, 1e-4], "precond-drill")

    epochs_dir = os.path.join(workdir, "epochs")
    es = EpochStore(epochs_dir)

    def _products(tmpdir: str) -> dict:
        with open(os.path.join(tmpdir, "map_band0.fits"), "wb") as f:
            f.write(b"SIMPLE  =                    T" + b"\x07" * 256)
        return {"maps": ["map_band0.fits"]}

    n_epoch = es.publish([os.path.basename(f) for f in files],
                         _products)
    epoch_dir = es.epoch_dir(n_epoch)
    fits_path = os.path.join(epoch_dir, "map_band0.fits")

    tiles_root = os.path.join(workdir, "tiles")
    tstore = TileStore(tiles_root)
    tile_blob = bytes(range(256)) * 3
    digest, _ = tstore.put(tile_blob)
    os.makedirs(os.path.join(tiles_root, "manifests"), exist_ok=True)
    with open(os.path.join(tiles_root, "manifests",
                           "epoch-000001.json"), "w",
              encoding="utf-8") as f:
        _json.dump(seal_json({"schema": 1, "kind": "tiles", "epoch": 1,
                              "tiles": {"b0/0": [digest, len(tile_blob),
                                                 256]}}), f)

    ledger_path = os.path.join(workdir, "quarantine.jsonl")
    led = QuarantineLedger(ledger_path)
    for f in (files[2], files[3]):
        led.record(f, failure_class="transient",
                   disposition="recovered", stage="drill",
                   message="integrity-drill warmup")

    # -- chaos bit_rot: post-commit, once per basename, detectable ------
    monkey = ChaosMonkey("bit_rot", seed=seed)
    assert monkey.maybe_bit_rot(files[2]), \
        "criterion 10: bit_rot did not fire on a committed checkpoint"
    assert not monkey.maybe_bit_rot(files[2]), \
        "criterion 10: bit_rot re-rotted the same basename (repairs " \
        "could never converge)"
    try:
        verify_file(files[2], kind="checkpoint")
        raise AssertionError(
            "criterion 10: post-commit bit_rot escaped verify_file — "
            "the sidecar did not hash the honest bytes")
    except CorruptArtifactError:
        pass
    _fixture(2)  # re-derive: same seed, same data, fresh sidecar

    # -- flip one byte per artifact class -------------------------------
    victims = {"checkpoint": files[1], "spill": spill_file,
               "solver": sck, "epoch": fits_path,
               "tile": tstore.path(digest)}
    for path in victims.values():
        flip_byte(path, seed=seed + 1)
    with open(ledger_path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    doc = _json.loads(lines[0])
    doc["disposition"] = "quarantined"  # body edited, seal left stale
    lines[0] = _json.dumps(doc, separators=(",", ":"), default=str)
    with open(ledger_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

    # -- 100% detection: the offline fsck sees every class --------------
    def _fsck(*extra) -> tuple:
        proc = subprocess.run(
            [_sys.executable, "-m", "comapreduce_tpu_torch.cli.campaign_fsck",
             workdir, "--json", *extra],
            capture_output=True, text=True, env=_child_env(),
            timeout=300)
        assert proc.stdout, \
            f"criterion 10: fsck produced no report: {proc.stderr}"
        return proc.returncode, _json.loads(proc.stdout)

    rc, rep = _fsck()
    corrupt_paths = {p["path"] for p in rep["problems"]
                     if p["problem"] == "corrupt"}
    missed = {cls for cls, path in victims.items()
              if path not in corrupt_paths}
    assert not missed, \
        f"criterion 10: fsck missed corrupt class(es) {sorted(missed)}"
    assert ledger_path in corrupt_paths, \
        "criterion 10: fsck missed the corrupt ledger line"
    assert rc == 1, "criterion 10: fsck exited 0 over corruption"

    # -- per-class runtime triage ---------------------------------------
    triage_path = os.path.join(workdir, "quarantine-triage.jsonl")
    res = Resilience(ledger=QuarantineLedger(triage_path),
                     retry=RetryPolicy(max_retries=1, base_s=0.0,
                                       seed=seed))
    data_tri = _read(files, wcs, resilience=res, device=device)
    assert files[1] not in data_tri.files, \
        "criterion 10: a corrupt checkpoint fed the solve"
    tri = QuarantineLedger(triage_path)
    assert any(e.failure_class == "corrupt"
               and e.disposition == "corrupt"
               and e.unit.get("file") == files[1]
               for e in tri.entries), \
        "criterion 10: corrupt checkpoint not ledgered corrupt/corrupt"
    assert not any(e.disposition == "quarantined" for e in tri.entries), \
        "criterion 10: corruption mis-triaged as a quarantine"

    assert cache.get(files[0]) is None, \
        "criterion 10: a rotted spill entry was served"
    assert not os.path.exists(spill_file), \
        "criterion 10: rotted spill entry not unlinked"
    cache.put(files[0], spill_payload)
    assert np.array_equal(cache.get(files[0]), spill_payload), \
        "criterion 10: re-spilled entry unreadable"

    assert load_solver_checkpoint(sck, "precond-drill") is None, \
        "criterion 10: a rotted solver snapshot warm-started a solve"
    assert not os.path.exists(sck), \
        "criterion 10: rotted solver snapshot not unlinked"
    save_solver_checkpoint(sck, np.ones(32, np.float32), 7,
                           [1e-3, 1e-4], "precond-drill")
    assert load_solver_checkpoint(sck, "precond-drill")["n_done"] == 7

    nok, problems = verify_epoch(epoch_dir)
    assert [p[0] for p in problems] == ["map_band0.fits"], \
        f"criterion 10: verify_epoch reported {problems}"
    assert verify_epoch_product(epoch_dir, "map_band0.fits") is False, \
        "criterion 10: rotted epoch product verified True/None"

    try:
        tstore.get(digest)
        raise AssertionError("criterion 10: a rotted tile object was "
                             "served (CAS name no longer matches "
                             "content)")
    except CorruptArtifactError:
        pass
    assert not os.path.exists(tstore.path(digest)), \
        "criterion 10: rotted tile object not unlinked"
    d2, renewed = tstore.put(tile_blob)
    assert d2 == digest and renewed and tstore.get(digest) == tile_blob, \
        "criterion 10: tile re-put did not repair the object"

    led2 = QuarantineLedger(ledger_path)
    assert led2.corrupt_lines == 1, \
        f"criterion 10: expected 1 dropped ledger line, counted " \
        f"{led2.corrupt_lines}"
    assert len(led2.entries) == 1, \
        "criterion 10: the intact ledger line did not survive the drop"

    # -- fsck --repair + re-derivation -> byte-identical map ------------
    rc, rep = _fsck("--repair")
    assert rc == 0 and rep["ok"], \
        f"criterion 10: fsck --repair did not converge: " \
        f"{rep['problems']}"
    assert not os.path.exists(files[1]), \
        "criterion 10: repair kept a corrupt re-derivable checkpoint"
    assert not os.path.exists(epoch_dir), \
        "criterion 10: repair kept a corrupt epoch"
    _fixture(1)  # the re-reduction the runner would perform
    n2 = EpochStore(epochs_dir).publish(
        [os.path.basename(f) for f in files], _products)
    assert not verify_epoch(es.epoch_dir(n2))[1], \
        "criterion 10: republished epoch failed verification"
    final_map = np.asarray(_solve(_read(files, wcs, device=device),
                                  device).destriped_map).tobytes()
    assert final_map == clean_map, \
        "criterion 10: repaired campaign's map != clean run's map"

    return {
        "criterion": "10-integrity",
        "n_classes": 6,
        "n_detected": 6,
        "corrupt_paths": sorted(os.path.basename(p)
                                for p in corrupt_paths),
        "ledger_lines_dropped": led2.corrupt_lines,
        "map_identical": True,
        "integrity_wall_s": round(time.perf_counter() - t0, 3),
    }


def _serving_worker_main(argv=None) -> int:
    """One serving-drill server invocation (``python -m ... --serving``):
    build a ``MapServer`` over the shared state dir and attempt exactly
    one epoch (``poll_once(force=True)``) — resume recovery
    (tmp sweep + orphan adoption) runs in the constructor, so a
    restarted invocation IS the resumed server."""
    import argparse

    from comapreduce_tpu_torch.mapmaking.wcs import WCS
    from comapreduce_tpu_torch.resilience.chaos import ChaosMonkey
    from comapreduce_tpu_torch.serving.server import MapServer

    p = argparse.ArgumentParser(prog="drill-serving-worker")
    p.add_argument("--state-dir", required=True)
    p.add_argument("--epochs-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chaos", default="")
    p.add_argument("--no-warm-start", action="store_true")
    p.add_argument("--tiles-dir", default="",
                   help="also cut each published epoch into this tiles "
                   "root (the tiles drill)")
    p.add_argument("--tile-px", type=int, default=16)
    p.add_argument("--telemetry", action="store_true",
                   help="configure the serving telemetry lane (auto "
                   "rank >= 1000) in the state dir")
    p.add_argument("--device", default=None,
                   help="the parent drill's device (default cuda)")
    a = p.parse_args(argv)
    if a.telemetry:
        from comapreduce_tpu_torch.telemetry import (TELEMETRY,
                                                     serving_lane_rank)

        TELEMETRY.configure(a.state_dir,
                            rank=serving_lane_rank(a.state_dir))
    wcs = WCS.from_field((170.25, 52.25), (1.0 / 60, 1.0 / 60), (64, 64))
    monkey = ChaosMonkey(a.chaos, seed=a.seed) if a.chaos else None
    server = MapServer(
        a.state_dir, a.epochs_dir, wcs=wcs, band=0, offset_length=50,
        n_iter=300, threshold=1e-8, medfilt_window=201,
        use_calibration=False, warm_start=not a.no_warm_start,
        tiles_root=a.tiles_dir, tile_px=a.tile_px, chaos=monkey,
        device=a.device)
    n = server.poll_once(force=True)
    print(f"serving-worker: published {n}")
    return 0


if __name__ == "__main__":
    import sys as _sys

    _argv = _sys.argv[1:]
    if "--serving" in _argv:
        _argv.remove("--serving")
        raise SystemExit(_serving_worker_main(_argv))
    raise SystemExit(_elastic_worker_main(_argv))
